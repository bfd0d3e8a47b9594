"""EGNN, the E(n)-equivariant GNN (Satorras et al., arXiv:2102.09844), the
reference's ``repro.models.gnn.egnn`` in PyTorch.

    m_ij  = φ_e(h_i, h_j, ‖x_i − x_j‖²)
    x_i'  = x_i + Σ_j (x_i − x_j) φ_x(m_ij) / (deg_i + 1)
    h_i'  = h_i + φ_h(h_i, Σ_j m_ij)

Positions update equivariantly, features invariantly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.gnn.common import (
    GraphBatch,
    Params,
    mlp_apply,
    mlp_init,
    scatter_edges_to_nodes,
    segment_sum,
    stack_layers,
    to_edges,
    unstack_layers,
)
from repro_torch.utils import resolve_device


@dataclass(frozen=True)
class EGNNConfig:
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    d_out: int = 1  # graph-level regression target


#: the parameters that act on edges (``common.edge_param_leaves``)
EDGE_PARAMS = ("layers/phi_e", "layers/phi_x")


def init_egnn(gen: torch.Generator, cfg: EGNNConfig, *, device: str | torch.device = "cuda") -> Params:
    dev = resolve_device(device)
    d = cfg.d_hidden
    params = {"embed": mlp_init(gen, (cfg.d_in, d), device=dev), "head": mlp_init(gen, (d, d, cfg.d_out), device=dev)}
    params["layers"] = stack_layers([
        {"phi_e": mlp_init(gen, (2 * d + 1, d, d), device=dev), "phi_x": mlp_init(gen, (d, d, 1), device=dev),
         "phi_h": mlp_init(gen, (2 * d, d, d), device=dev)}
        for _ in range(cfg.n_layers)])
    return params


def egnn_forward(p: Params, g: GraphBatch, cfg: EGNNConfig):
    """(graph-level outputs (n_graphs, d_out), final positions (N, 3))."""
    n = g.nodes.shape[0]
    h = mlp_apply(p["embed"], g.nodes)
    x = g.positions
    emask = g.edge_mask[:, None].to(h.dtype)
    snd, rcv = g.senders.long(), g.receivers.long()
    ax = g.edge_axes
    for lp in unstack_layers(p["layers"]):
        xe, he = to_edges(x, ax), to_edges(h, ax)
        diff = xe.index_select(0, rcv) - xe.index_select(0, snd)
        d2 = torch.sum(diff * diff, -1, keepdim=True)
        m = mlp_apply(lp["phi_e"], torch.cat([he.index_select(0, rcv), he.index_select(0, snd), d2], -1)) * emask
        w = mlp_apply(lp["phi_x"], m)  # receiver-centric position update
        dx = scatter_edges_to_nodes(diff * w * emask, rcv, n, over=ax)
        deg = scatter_edges_to_nodes(emask, rcv, n, over=ax) + 1.0
        x = x + dx / deg
        agg = scatter_edges_to_nodes(m, rcv, n, over=ax)
        h = h + mlp_apply(lp["phi_h"], torch.cat([h, agg], -1))
    out = mlp_apply(p["head"], h) * g.node_mask[:, None]
    return segment_sum(out, g.graph_id, g.n_graphs), x


def egnn_loss(p: Params, g: GraphBatch, targets: torch.Tensor, cfg: EGNNConfig) -> torch.Tensor:
    """Graph-level regression MSE; targets (n_graphs, d_out)."""
    pred, _ = egnn_forward(p, g, cfg)
    return torch.mean((pred - targets) ** 2)
