"""End-to-end LM training in the PyTorch port (the counterpart of
``examples/train_lm.py``): a qwen1.5-family LM on the synthetic token
stream with the whole substrate — sharded, prefetched batches, AdamW with
warm-up and cosine decay, optional gradient compression, checkpoints and
auto-resume.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --steps 200 --resume  # restart
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20

The default config is small (~10M parameters); ``--d-model/--layers``
scale it up. Checkpoints are written, and resumed from, with ``--resume``.
"""

import argparse
import dataclasses
import os

import torch

from repro_torch.configs.lm_archs import qwen1_5_0_5b
from repro_torch.data.pipeline import prefetch, sharded_batches
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch.steps import lm_loss_fn
from repro_torch.models.transformer import init_lm
from repro_torch.train.checkpoint import latest_checkpoint
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainConfig, train

DEFAULT_CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
                            "torch_train_lm_ckpt")


def main(argv=None) -> list:
    """Parse ``argv``, train, print the first and last logged loss and
    return the history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--compression", default="none", choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(
        qwen1_5_0_5b(),
        n_layers=args.layers, d_model=args.d_model,
        n_heads=max(args.d_model // 64, 2),
        n_kv_heads=max(args.d_model // 64, 2), head_dim=64,
        d_ff=args.d_model * 3, vocab=args.vocab,
        dtype=torch.float32, param_dtype=torch.float32, remat=False, block_q=None,
    )
    print(f"model: {cfg.param_count() / 1e6:.1f}M params ({cfg.n_layers}L x {cfg.d_model})")
    params = init_lm(torch.Generator(device=args.device).manual_seed(0), cfg, device=args.device)

    tc = TrainConfig(
        opt=AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
        compression=args.compression,
        checkpoint_every=50, log_every=10,
    )
    ckpt = args.ckpt_dir if args.resume else None
    # a resumed run draws the batches from the checkpoint's step on, as a
    # run that never stopped would (a batch is a function of its step)
    start = (latest_checkpoint(ckpt) or 0) if ckpt else 0
    data = prefetch(
        sharded_batches(
            lambda step, shard: lm_batch(0, step, shard, batch=args.batch, seq=args.seq, vocab=cfg.vocab,
                                         device=args.device),
            shard_id=0, start_step=start,
        )
    )
    _, history = train(lm_loss_fn(cfg), params, data, tc=tc, n_steps=args.steps, ckpt_dir=ckpt)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} ({'DECREASED' if last < first else 'no progress'})")
    return history


if __name__ == "__main__":
    main()
