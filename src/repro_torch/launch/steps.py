"""The LM and GNN families' train steps, optimizer settings and model
FLOPs (reference: ``repro.launch.steps``, its LM and GNN parts). The
reference builds each step for a mesh; the mesh's shardings wait for
ROADMAP queue 1, item 7, and the recsys bundles for item 9d.

The FLOPs are the reference's analytic counts: 6·N_active per trained
token, 2·N_active per prefilled token, a decode step's 2·N_active per
row plus attention against the whole cache, and a GNN step's
6·edges·d_h²·layers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.registry import ShapeSpec
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn.common import GraphBatch, pad_graph, random_graph_batch
from repro_torch.models.gnn.egnn import EGNNConfig, egnn_loss, init_egnn
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config, equiformer_v2_loss, init_equiformer_v2
from repro_torch.models.gnn.gatedgcn import GatedGCNConfig, gatedgcn_loss, init_gatedgcn
from repro_torch.models.gnn.nequip import NequIPConfig, init_nequip, nequip_loss
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainConfig, make_train_step
from repro_torch.utils import round_up


def lm_opt_cfg(cfg: tfm.TransformerConfig) -> AdamWConfig:
    """AdamW with bfloat16 moments above 5e10 parameters, else float32
    (``_lm_opt_cfg``, ``launch/steps.py:81-83``)."""
    return AdamWConfig(state_dtype="bf16" if cfg.param_count() > 5e10 else "f32")


def lm_loss_fn(cfg: tfm.TransformerConfig):
    """(params, batch) -> (loss, metrics): ``lm_loss`` over a batch's
    ``tokens`` and ``labels``."""
    return lambda params, batch: tfm.lm_loss(params, cfg, batch["tokens"], batch["labels"])


def lm_train_step(cfg: tfm.TransformerConfig, tc: TrainConfig, *, donate: bool = False):
    """step(state_tree, batch) -> (state_tree, metrics): ``make_train_step``
    over ``lm_loss`` (``lm_train_bundle``'s step, ``launch/steps.py:103-137``)."""
    return make_train_step(lm_loss_fn(cfg), tc, donate=donate)


def lm_train_flops(cfg: tfm.TransformerConfig, batch: int, seq: int) -> float:
    """6·N_active·tokens, MoE counting its activated experts alone
    (``launch/steps.py:132``)."""
    return 6.0 * cfg.active_param_count() * batch * seq


def lm_prefill_flops(cfg: tfm.TransformerConfig, batch: int, seq: int) -> float:
    """The forward alone, 2·N_active·tokens (``launch/steps.py:162``)."""
    return 2.0 * cfg.active_param_count() * batch * seq


def lm_decode_flops(cfg: tfm.TransformerConfig, batch: int, s_max: int) -> float:
    """One token per row: 2·N_active per row plus attention against the
    whole cache (``launch/steps.py:219-226``)."""
    if cfg.attn == "mla":
        attn = 2.0 * batch * s_max * cfg.n_heads * (cfg.kv_lora_rank * 2 + cfg.qk_rope_dim) * cfg.n_layers
    else:
        attn = 4.0 * batch * s_max * cfg.n_heads * cfg.head_dim * cfg.n_layers
    return 2.0 * cfg.active_param_count() * batch + attn


# ---------------------------------------------------------------------------
# GNN family (``launch/steps.py:238-324``)
# ---------------------------------------------------------------------------

_GNN_FNS = {
    GatedGCNConfig: (init_gatedgcn, gatedgcn_loss),
    EGNNConfig: (init_egnn, egnn_loss),
    NequIPConfig: (init_nequip, nequip_loss),
    EquiformerV2Config: (init_equiformer_v2, equiformer_v2_loss),
}
GNN_NODE_PAD = 512  # nodes padded to a multiple of this
GNN_EDGE_PAD = 512 * 8  # edges padded to a multiple of this


def gnn_adapt_config(cfg, shape: ShapeSpec):
    """Bind the dataset's width (d_feat → d_in) into GatedGCN's and EGNN's
    configs; NequIP and Equiformer read the species from ``nodes[:, 0]``."""
    if isinstance(cfg, (GatedGCNConfig, EGNNConfig)):
        return dataclasses.replace(cfg, d_in=shape.dims["d_feat"])
    return cfg


def gnn_padded_sizes(n_nodes: int, n_edges: int) -> tuple[int, int]:
    """The bundle's static sizes: nodes up to a multiple of 512, edges of
    4,096."""
    return round_up(n_nodes, GNN_NODE_PAD), round_up(n_edges, GNN_EDGE_PAD)


def gnn_init(cfg, gen: torch.Generator, *, device: str | torch.device = "cuda"):
    """The arch's parameters (its ``init_*``) drawn from ``gen``."""
    return _GNN_FNS[type(cfg)][0](gen, cfg, device=device)


def gnn_loss_fn(cfg):
    """(params, batch) -> (loss, {}): the arch's loss over a batch's
    ``graph`` and ``labels``."""
    loss = _GNN_FNS[type(cfg)][1]
    return lambda params, batch: (loss(params, batch["graph"], batch["labels"], cfg), {})


def gnn_train_step(cfg, tc: TrainConfig | None = None, *, donate: bool = False):
    """step(state_tree, batch) -> (state_tree, metrics ``loss``,
    ``grad_norm``, ``lr``): ``value_and_grad`` of the loss, then AdamW
    (``gnn_train_bundle``'s step; ``AdamWConfig()`` unless ``tc`` says
    otherwise)."""
    return make_train_step(gnn_loss_fn(cfg), tc or TrainConfig(opt=AdamWConfig()), donate=donate)


def gnn_train_flops(cfg, n_edges: int) -> float:
    """The reference's model-FLOPs proxy: messages × hidden² × layers × 6
    (forward and backward), hidden ``d_hidden`` or ``channels``."""
    d_h = getattr(cfg, "d_hidden", getattr(cfg, "channels", 64))
    return 6.0 * n_edges * d_h * d_h * cfg.n_layers


def _labels(cfg, n_nodes: int, n_graphs: int, gen: torch.Generator, dev) -> torch.Tensor:
    """Node classes (N,) int32 for GatedGCN, else (n_graphs, 1) float32
    targets, as the bundle's label shapes."""
    if isinstance(cfg, GatedGCNConfig):
        return torch.randint(0, cfg.n_classes, (n_nodes,), generator=gen, device=dev, dtype=torch.int32)
    return torch.randn((n_graphs, 1), generator=gen, device=dev, dtype=torch.float32)


def gnn_batch(cfg, shape: ShapeSpec, gen: torch.Generator, *, device: str | torch.device = "cuda") -> dict:
    """A synthetic batch of ``shape``: ``random_graph_batch`` at the shape's
    sizes (positions for the geometric archs), padded as the bundle pads,
    and labels. ``{"graph", "labels"}``."""
    d = shape.dims
    g = random_graph_batch(gen, n_nodes=d["n_nodes"], n_edges=d["n_edges"], d_feat=d["d_feat"],
                           with_positions=not isinstance(cfg, GatedGCNConfig), n_graphs=d.get("n_graphs", 1),
                           device=device)
    g = pad_graph(g, *gnn_padded_sizes(d["n_nodes"], d["n_edges"]))
    return {"graph": g, "labels": _labels(cfg, g.nodes.shape[0], g.n_graphs, gen, g.nodes.device)}


def gnn_minibatch(cfg, sub: dict, *, node_labels, positions=None, device: str | torch.device = "cuda") -> dict:
    """One ``data.sampler.minibatch_stream`` batch as the bundle takes it:
    its padded subgraph (edges padded on to a multiple of 4,096) with the
    batch's ``features``. ``node_labels`` (the whole graph's classes,
    indexed by the batch's node ids) label every sampled node for GatedGCN;
    the geometric archs take ``positions`` (the whole graph's, indexed the
    same way) and the seeds' mean class as the one graph's target."""
    dev = torch.device(device)
    safe = np.where(sub["node_ids"] >= 0, sub["node_ids"], 0)

    def t(x):
        return x.to(dev) if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)).to(dev)

    n = len(safe)
    g = GraphBatch(nodes=t(sub["features"]), positions=None if positions is None else t(positions[safe]), edges=None,
                   senders=t(sub["senders"]), receivers=t(sub["receivers"]), node_mask=t(sub["node_mask"]),
                   edge_mask=t(sub["edge_mask"]), graph_id=torch.zeros((n,), dtype=torch.int32, device=dev),
                   n_graphs=1)
    g = pad_graph(g, *gnn_padded_sizes(n, len(sub["senders"])))
    if isinstance(cfg, GatedGCNConfig):
        labels = torch.zeros((g.nodes.shape[0],), dtype=torch.int32, device=dev)
        labels[:n] = t(node_labels[safe]).to(torch.int32)
    else:
        labels = t(np.asarray(sub["labels"], np.float32).mean(keepdims=True)[None])
    return {"graph": g, "labels": labels}
