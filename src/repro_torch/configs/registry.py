"""Architecture registry of the port: ``get_arch(<id>)`` resolution.

Ported: the five LM architectures (``qwen2-72b``, ``qwen1.5-0.5b``,
``llama3.2-3b``, ``deepseek-v3-671b``, ``moonshot-v1-16b-a3b``; serving
through ``models/transformer.py``) and the recsys model ``bert4rec``
(serving and training, ``repro_torch.train``), each with its full and
reduced configs and its assigned input shapes (the reference's
``configs/registry.py``). ``train_batch``'s 65,536 sessions are the
reference's global batch; one card takes a cut of it per step. The GNN
architectures raise ``NotImplementedError`` until they are ported
(ROADMAP queue 1, item 9).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.configs import lm_archs
from repro_torch.models.recsys.bert4rec import Bert4RecConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | serve | bulk_serve | retrieval
    dims: dict[str, int] = field(default_factory=dict)


LM_SHAPES = [
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
]

RECSYS_SHAPES = [
    ShapeSpec("train_batch", "train", {"global_batch": 65536}),
    ShapeSpec("serve_p99", "serve", {"global_batch": 512}),
    ShapeSpec("serve_bulk", "bulk_serve", {"global_batch": 262144}),
    ShapeSpec("retrieval_cand", "retrieval", {"global_batch": 1, "n_candidates": 1_000_000}),
]


@dataclass(frozen=True)
class Arch:
    arch_id: str
    family: str
    make_full: Callable[[], Any]
    make_reduced: Callable[[], Any]
    shapes: tuple[ShapeSpec, ...]
    notes: str = ""


def _reduced_bert4rec() -> Bert4RecConfig:
    return Bert4RecConfig(n_items=2000, embed_dim=32, n_blocks=2, n_heads=2, seq_len=24)


def _lm(arch_id: str, make_full: Callable[[], Any], notes: str) -> Arch:
    return Arch(arch_id, "lm", make_full, lambda: lm_archs.reduced_lm(make_full()), tuple(LM_SHAPES), notes)


REGISTRY: dict[str, Arch] = {
    "qwen2-72b": _lm("qwen2-72b", lm_archs.qwen2_72b, "dense GQA kv=8, QKV bias [arXiv:2407.10671]"),
    "qwen1.5-0.5b": _lm("qwen1.5-0.5b", lm_archs.qwen1_5_0_5b, "dense MHA (kv=16), QKV bias [hf:Qwen/Qwen1.5-0.5B]"),
    "llama3.2-3b": _lm("llama3.2-3b", lm_archs.llama3_2_3b, "dense GQA kv=8 [hf:meta-llama/Llama-3.2-3B]"),
    "deepseek-v3-671b": _lm("deepseek-v3-671b", lm_archs.deepseek_v3_671b,
                            "MLA + MoE 1s+256r top-8 + MTP [arXiv:2412.19437]"),
    "moonshot-v1-16b-a3b": _lm("moonshot-v1-16b-a3b", lm_archs.moonshot_v1_16b_a3b,
                               "MoE 64e top-6 + 2 shared [hf:moonshotai/Moonlight-16B-A3B]"),
    "bert4rec": Arch(
        "bert4rec", "recsys",
        # 2^20 − 1 items, so the table with its [MASK] row has 2^20 rows
        lambda: Bert4RecConfig(n_items=1_048_575, embed_dim=64, n_blocks=2, n_heads=2, seq_len=200),
        _reduced_bert4rec, tuple(RECSYS_SHAPES),
        notes="bidirectional sequential recsys [arXiv:1904.06690]",
    ),
}


def get_arch(arch_id: str) -> Arch:
    if arch_id not in REGISTRY:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP queue 1, item 9); "
            f"ported: {sorted(REGISTRY)}"
        )
    return REGISTRY[arch_id]
