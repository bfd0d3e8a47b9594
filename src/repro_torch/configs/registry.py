"""Architecture registry of the port: ``get_arch(<id>)`` resolution.

Only the recsys model is ported: ``bert4rec`` with its full and reduced
configs and its assigned input shapes (the reference's
``configs/registry.py``), for serving and for training
(``repro_torch.train``). ``train_batch``'s 65,536 sessions are the
reference's global batch; one card takes a cut of it per step. Every other
architecture of the reference raises ``NotImplementedError`` until the
model zoo is ported (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.models.recsys.bert4rec import Bert4RecConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | serve | bulk_serve | retrieval
    dims: dict[str, int] = field(default_factory=dict)


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


REGISTRY: dict[str, Arch] = {
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
