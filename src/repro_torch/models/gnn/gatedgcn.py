"""GatedGCN (Bresson & Laurent; benchmarked in arXiv:2003.00982), the
reference's ``repro.models.gnn.gatedgcn`` in PyTorch.

Node update:  h_i' = h_i + ReLU(BN(A h_i + Σ_{j→i} η_ij ⊙ (B h_j)))
Edge gates:   e_ij' = e_ij + ReLU(BN(C e_ij + D h_i + E h_j)),
              η_ij = σ(e_ij') / (Σ_{j'→i} σ(e_ij') + ε)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.gnn.common import (
    GraphBatch,
    Params,
    normal,
    scatter_edges_to_nodes,
    stack_layers,
    to_edges,
    unstack_layers,
)
from repro_torch.utils import resolve_device


@dataclass(frozen=True)
class GatedGCNConfig:
    n_layers: int = 16
    d_hidden: int = 70
    d_in: int = 1433
    d_edge_in: int = 0
    n_classes: int = 7


#: the parameters that act on edges (``common.edge_param_leaves``)
EDGE_PARAMS = ("embed_e", "layers/B", "layers/C", "layers/D", "layers/E", "layers/ln_e")


def _lin(gen, din, dout, device):
    return normal(gen, (din, dout), device, 1.0 / np.sqrt(din))


def init_gatedgcn(gen: torch.Generator, cfg: GatedGCNConfig, *, device: str | torch.device = "cuda") -> Params:
    """The reference's tree (``embed_h``, ``embed_e``, ``head`` and the
    layers stacked on a leading axis), drawn from ``gen`` on ``device``."""
    dev = resolve_device(device)
    d = cfg.d_hidden
    params = {"embed_h": _lin(gen, cfg.d_in, d, dev), "embed_e": _lin(gen, max(cfg.d_edge_in, 1), d, dev),
              "head": _lin(gen, d, cfg.n_classes, dev)}
    layers = [{**{k: _lin(gen, d, d, dev) for k in "ABCDE"},
               "ln_h": torch.ones((d,), device=dev), "ln_e": torch.ones((d,), device=dev)}
              for _ in range(cfg.n_layers)]
    params["layers"] = stack_layers(layers)
    return params


def _norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Feature-wise normalisation with the POPULATION variance: ``jnp.var``
    divides by n, so ``unbiased=False``; ``jax.lax.rsqrt`` is ``torch.rsqrt``."""
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.var(x, -1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * gamma


def gatedgcn_forward(p: Params, g: GraphBatch, cfg: GatedGCNConfig) -> torch.Tensor:
    """Per-node logits (N, n_classes)."""
    n = g.nodes.shape[0]
    h = g.nodes @ p["embed_h"]
    if g.edges is not None:
        e = g.edges @ p["embed_e"]
    else:
        e = torch.zeros((g.senders.shape[0], cfg.d_hidden), dtype=h.dtype, device=h.device)
    emask = g.edge_mask[:, None].to(h.dtype)
    snd, rcv = g.senders.long(), g.receivers.long()
    ax = g.edge_axes
    for lp in unstack_layers(p["layers"]):
        he = to_edges(h, ax)
        hs, hr = he.index_select(0, snd), he.index_select(0, rcv)
        e_new = e + F.relu(_norm(e @ lp["C"] + hr @ lp["D"] + hs @ lp["E"], lp["ln_e"]))
        gate = torch.sigmoid(e_new) * emask
        msg = gate * (hs @ lp["B"])
        num = scatter_edges_to_nodes(msg, rcv, n, over=ax)
        den = scatter_edges_to_nodes(gate, rcv, n, over=ax) + 1e-6
        h = h + F.relu(_norm(h @ lp["A"] + num / den, lp["ln_h"]))
        e = e_new
    return h @ p["head"]


def gatedgcn_loss(p: Params, g: GraphBatch, labels: torch.Tensor, cfg: GatedGCNConfig) -> torch.Tensor:
    """Masked node-classification cross entropy; labels (N,) int."""
    logits = gatedgcn_forward(p, g, cfg)
    ll = torch.log_softmax(logits, -1).gather(-1, labels.long()[:, None])[:, 0]
    m = g.node_mask.to(torch.float32)
    return -torch.sum(ll * m) / torch.clamp_min(torch.sum(m), 1.0)
