"""Architecture registry of the port: ``get_arch(<id>)`` resolution for
the ten assigned architectures and the paper's own ``flash-ann`` workload
(the reference's ``configs/registry.py``, entry for entry).

Each entry holds its full and reduced configs and its assigned input
shapes: the five LM architectures (``qwen2-72b``, ``qwen1.5-0.5b``,
``llama3.2-3b``, ``deepseek-v3-671b``, ``moonshot-v1-16b-a3b``;
``models/transformer.py``), the four GNN architectures (``gatedgcn``,
``egnn``, ``nequip``, ``equiformer-v2``; ``models/gnn/``), the recsys
model ``bert4rec`` and ``flash-ann``, whose configs are the Flash coder's
settings (a dict) and whose two cells are a segment build and a fan-out
search (``graph/segmented.py``). ``assigned_cells`` lists the 40 graded
(arch, shape) pairs, ``flash-ann`` left out. Steps per cell live in
``launch/steps.py``; this module is metadata. The shapes are the
reference's global sizes: one card takes a cut of a pod's batch per step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.configs import lm_archs
from repro_torch.models.gnn.egnn import EGNNConfig
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config
from repro_torch.models.gnn.gatedgcn import GatedGCNConfig
from repro_torch.models.gnn.nequip import NequIPConfig
from repro_torch.models.recsys.bert4rec import Bert4RecConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | serve | bulk_serve | retrieval | ann_build | ann_search
    dims: dict[str, int] = field(default_factory=dict)


LM_SHAPES = [
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
]

GNN_SHAPES = [
    ShapeSpec(
        "full_graph_sm", "train",
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_graphs": 1},
    ),
    ShapeSpec(
        "minibatch_lg", "train",
        # batch_nodes=1024, fanout 15-10 → padded sampled subgraph
        {"n_nodes": 1024 + 1024 * 15 + 1024 * 150, "n_edges": 1024 * 15 + 1024 * 150,
         "d_feat": 602, "n_graphs": 1, "batch_nodes": 1024},
    ),
    ShapeSpec(
        "ogb_products", "train",
        {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100, "n_graphs": 1},
    ),
    ShapeSpec(
        "molecule", "train",
        {"n_nodes": 30 * 128, "n_edges": 64 * 128, "d_feat": 8, "n_graphs": 128},
    ),
]

RECSYS_SHAPES = [
    ShapeSpec("train_batch", "train", {"global_batch": 65536}),
    ShapeSpec("serve_p99", "serve", {"global_batch": 512}),
    ShapeSpec("serve_bulk", "bulk_serve", {"global_batch": 262144}),
    ShapeSpec("retrieval_cand", "retrieval", {"global_batch": 1, "n_candidates": 1_000_000}),
]

FLASH_ANN_SHAPES = [
    # the paper's own workload: per-device segment build + fan-out search
    ShapeSpec("segment_build", "ann_build", {"segment_size": 100_000, "dim": 768}),
    ShapeSpec("fanout_search", "ann_search", {"n_queries": 1024, "dim": 768, "k": 10}),
]


@dataclass(frozen=True)
class Arch:
    arch_id: str
    family: str  # lm | gnn | recsys | ann
    make_full: Callable[[], Any]
    make_reduced: Callable[[], Any]
    shapes: tuple[ShapeSpec, ...]
    notes: str = ""


def _reduced_gatedgcn() -> GatedGCNConfig:
    return GatedGCNConfig(n_layers=3, d_hidden=16, d_in=16, n_classes=4)


def _reduced_egnn() -> EGNNConfig:
    return EGNNConfig(n_layers=2, d_hidden=16, d_in=8)


def _reduced_nequip() -> NequIPConfig:
    return NequIPConfig(n_layers=2, channels=8, l_max=2, n_rbf=4)


def _reduced_equiformer() -> EquiformerV2Config:
    return EquiformerV2Config(n_layers=2, channels=16, l_max=3, m_max=2, n_heads=4, n_rbf=4)


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
    "nequip": Arch(
        "nequip", "gnn",
        lambda: NequIPConfig(n_layers=5, channels=32, l_max=2, n_rbf=8, cutoff=5.0),
        _reduced_nequip, tuple(GNN_SHAPES),
        notes="E(3) tensor-product potential [arXiv:2101.03164]",
    ),
    "gatedgcn": Arch(
        "gatedgcn", "gnn",
        lambda: GatedGCNConfig(n_layers=16, d_hidden=70, d_in=1433, n_classes=64),
        _reduced_gatedgcn, tuple(GNN_SHAPES),
        notes="gated aggregator [arXiv:2003.00982]",
    ),
    "egnn": Arch(
        "egnn", "gnn",
        lambda: EGNNConfig(n_layers=4, d_hidden=64, d_in=16),
        _reduced_egnn, tuple(GNN_SHAPES),
        notes="E(n)-equivariant [arXiv:2102.09844]",
    ),
    "equiformer-v2": Arch(
        "equiformer-v2", "gnn",
        lambda: EquiformerV2Config(n_layers=12, channels=128, l_max=6, m_max=2, n_heads=8, n_rbf=8),
        _reduced_equiformer, tuple(GNN_SHAPES),
        notes="SO(2) eSCN graph attention [arXiv:2306.12059]",
    ),
    "bert4rec": Arch(
        "bert4rec", "recsys",
        # 2^20 − 1 items, so the table with its [MASK] row has 2^20 rows
        lambda: Bert4RecConfig(n_items=1_048_575, embed_dim=64, n_blocks=2, n_heads=2, seq_len=200),
        _reduced_bert4rec, tuple(RECSYS_SHAPES),
        notes="bidirectional sequential recsys [arXiv:1904.06690]",
    ),
    "flash-ann": Arch(
        "flash-ann", "ann",
        lambda: {"d_f": 256, "m_f": 16, "l_f": 4, "h": 8, "dim": 768},
        lambda: {"d_f": 32, "m_f": 16, "l_f": 4, "h": 8, "dim": 64},
        tuple(FLASH_ANN_SHAPES),
        notes="the paper's own workload: segmented HNSW-Flash build/search",
    ),
}


def get_arch(arch_id: str) -> Arch:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def assigned_cells() -> list[tuple[str, str]]:
    """The 40 graded (arch, shape) cells in registry order, ``flash-ann``
    (family ``ann``) left out."""
    return [(aid, s.name) for aid, arch in REGISTRY.items() if arch.family != "ann" for s in arch.shapes]
