"""What one rank of the LM serving and training cells holds, reckoned from
the code's tensor shapes and specs (no run at the cells' sizes): what one
80 GB card cannot hold as one rank of a mesh.

    PYTHONPATH=src python tests/witness_lm_rank_bytes.py

For qwen2-72b and moonshot-v1-16b-a3b at their full configs, on a (data 1,
model m) mesh for m in 1, 2, 4, 8: ``init_lm``'s tree as meta tensors
(nothing is allocated) placed by ``lm_param_specs`` (a leaf's bytes over
the sizes of the axes its spec names), as stored (``param_dtype``) and as
the bf16 serving copy (``serving_params``), and the caches of
``decode_32k`` (B 128 × 32,768) and ``long_500k`` (B 1 × 524,288) placed
by ``lm_decode_bundle``'s specs: batched decode splits the sequence over
``"model"`` (the batch over ``"data"``, 1 here), long context over every
axis. Activations and the allocator's slack come on top, so "fits" is a
floor's verdict: weights (serving copy) + a cell's caches ≤ 80 GB. Prints
one JSON line per config and m.

Training (``train_4k``, B 256 × S 4,096), for the four GQA models
(``TRAIN_ARCHS``) at the same m: a rank's float32-or-stored masters, their
gradients (the parameters' dtype) and both Adam moments (``lm_opt_cfg``'s
dtype: bfloat16 for qwen2-72b), placed by ``lm_state_specs``; and, with
the batch over ``"data"`` of width d (``DATA``: B / d rows a rank), what
remat keeps of the activations at the least: every layer's input (B / d,
S, D) in the compute dtype, and one float32 (B / d, S, V / m) block of the
vocabulary-parallel logits. "fits" is state + those ≤ 80 GB, a floor.
Prints one JSON line per config and m, marked ``"cell": "train_4k"``.
"""

from __future__ import annotations

import json
import math

import torch

from repro_torch.configs.registry import ShapeSpec, get_arch
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as tfm
from repro_torch.train.elastic import map_with_specs

ARCHS = ("qwen2-72b", "moonshot-v1-16b-a3b")
TRAIN_ARCHS = ("qwen2-72b", "qwen1.5-0.5b", "llama3.2-3b", "moonshot-v1-16b-a3b")
TRAIN_SHAPE = (256, 4096)  # train_4k's global batch × sequence
DATA = (1, 16, 256)
MODEL = (1, 2, 4, 8)
CARD_GB = 80.0
CELLS = {"decode_32k": (128, 32768), "long_500k": (1, 524288)}


def rank_bytes(tree, specs, mesh) -> int:
    """The bytes of ``tree``'s shards that one rank holds under ``specs``."""
    total = 0

    def count(t, spec):
        nonlocal total
        split = 1
        for dim, names in enumerate(spec):
            if names is None:
                continue
            names = names if isinstance(names, tuple) else (names,)
            size = math.prod(mesh.shape[n] for n in names)
            if t.shape[dim] % size:
                raise ValueError(f"{tuple(t.shape)} does not split by {spec} over {mesh.shape}")
            split *= size
        total += t.numel() * t.element_size() // split
        return t

    map_with_specs(count, tree, specs)
    return total


def main() -> None:
    for arch in ARCHS:
        cfg = get_arch(arch).make_full()
        params = tfm.init_lm(torch.Generator(), cfg, device="meta")
        serving = tfm.serving_params(params, cfg)
        specs = tfm.lm_param_specs(cfg)
        for m in MODEL:
            mesh = Mesh({"data": 1, "model": m}, range(m), "cpu")  # no process group: shapes alone
            row = {"arch": arch, "mesh": {"data": 1, "model": m},
                   "weights_stored_gb": rank_bytes(params, specs, mesh) / 1e9,
                   "stored_dtype": str(cfg.param_dtype).replace("torch.", ""),
                   "weights_bf16_gb": rank_bytes(serving, specs, mesh) / 1e9}
            for cell, (b, s) in CELLS.items():
                bundle = steps.lm_decode_bundle(cfg, ShapeSpec(cell, "decode", {"global_batch": b, "seq_len": s}),
                                                mesh)
                caches = tfm.make_caches(cfg, b, s, device="meta")
                gb = rank_bytes(caches, bundle.in_specs[1], mesh) / 1e9
                row[f"{cell}_caches_gb"] = gb
                row[f"{cell}_fits_{CARD_GB:g}gb"] = row["weights_bf16_gb"] + gb <= CARD_GB
            print(json.dumps(row), flush=True)
    for arch in TRAIN_ARCHS:
        cfg = get_arch(arch).make_full()
        params = tfm.init_lm(torch.Generator(), cfg, device="meta")
        pspecs, ospecs = steps.lm_state_specs(cfg)
        opt = steps.adamw_init(params, state_dtype=steps.lm_opt_cfg(cfg).state_dtype)
        b, s = TRAIN_SHAPE
        act_bytes = torch.tensor([], dtype=cfg.dtype).element_size()
        for m in MODEL:
            mesh = Mesh({"data": 1, "model": m}, range(m), "cpu")
            masters = rank_bytes(params, pspecs, mesh)
            moments = rank_bytes(opt, ospecs, mesh)
            state = 2 * masters + moments  # masters, gradients, moments
            row = {"arch": arch, "cell": "train_4k", "mesh_model": m, "masters_gb": masters / 1e9,
                   "grads_gb": masters / 1e9, "moments_gb": moments / 1e9,
                   "moments_dtype": steps.lm_opt_cfg(cfg).state_dtype, "state_gb": state / 1e9}
            for d in DATA:
                rows = b // d
                remat = cfg.n_layers * rows * s * cfg.d_model * act_bytes + rows * s * (cfg.vocab // m) * 4
                row[f"remat_floor_gb_data{d}"] = remat / 1e9
                row[f"fits_{CARD_GB:g}gb_data{d}"] = (state + remat) / 1e9 <= CARD_GB
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
