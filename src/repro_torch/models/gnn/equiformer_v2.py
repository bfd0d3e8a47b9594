"""Equiformer-v2, equivariant graph attention with eSCN convolutions
(arXiv:2306.12059), l_max = 6, m_max = 2: the reference's
``repro.models.gnn.equiformer_v2`` in PyTorch.

Each neighbour's irreps are rotated into the edge frame (edge ↦ +z),
mixed per |m| ≤ m_max by an SO(2) convolution, scaled radially, rotated
back and aggregated with attention scored from the invariant channel.

Two places differ in form from the reference and not in value:
* its ``.at[].set`` / ``.at[].add`` updates are out of place here (a
  concatenation and one ``index_select``), so no tensor that autograd
  saved is written;
* a receiver whose incoming edges are ALL masked (self-loops with
  r ≤ 1e-6, padding) has ``segment_max`` −inf. The reference's
  ``exp(−inf − (−inf))`` is nan there and its ``where`` zeroes it; here
  the shift is 0 on such a receiver, so the weights are the same zeros
  and the backward carries no nan.

With its edges sharded across ranks (``GraphBatch.edge_axes``) the
softmax over a receiver's edges spans every rank: the shift is the
maximum over every rank's edges (no gradient: the softmax does not
depend on it), the denominator the sum over all of them; a receiver
whose edges are all masked on every rank keeps the 0 shift.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.gnn import so3
from repro_torch.models.gnn.common import (
    GraphBatch,
    Params,
    mlp_apply,
    mlp_init,
    normal,
    radial_basis,
    scatter_edges_to_nodes,
    segment_max,
    segment_sum,
    stack_layers,
    to_edges,
    unstack_layers,
)
from repro_torch.models.gnn.nequip import species_of
from repro_torch.utils import resolve_device


@dataclass(frozen=True)
class EquiformerV2Config:
    n_layers: int = 12
    channels: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 8

    @property
    def dim(self) -> int:
        return so3.n_coeffs(self.l_max)


#: the parameters that act on edges (``common.edge_param_leaves``)
EDGE_PARAMS = ("layers/w_m0", "layers/w_mr", "layers/radial", "layers/attn")


def _m_indices(l_max: int, m: int) -> list[int]:
    """Flat coefficient indices of order m across the degrees l ≥ |m|."""
    return [l * l + l + m for l in range(abs(m), l_max + 1)]


def init_equiformer_v2(gen: torch.Generator, cfg: EquiformerV2Config, *,
                       device: str | torch.device = "cuda") -> Params:
    """The reference's tree; ``layers["w_mr"]`` is a list over m = 1..m_max
    of (L, 2, n_l(m), n_l(m), C, C) stacks (the cos/sin pair)."""
    dev = resolve_device(device)
    c = cfg.channels
    n_l = cfg.l_max + 1

    def n_lm(m):
        return cfg.l_max + 1 - m

    params = {"species_embed": normal(gen, (cfg.n_species, c), dev),
              "energy_head": mlp_init(gen, (c, 64, 1), device=dev)}
    params["layers"] = stack_layers([
        {"w_m0": normal(gen, (n_l, n_l, c, c), dev, 1.0 / np.sqrt(n_l * c)),
         "w_mr": [normal(gen, (2, n_lm(m), n_lm(m), c, c), dev, 1.0 / np.sqrt(n_lm(m) * c))
                  for m in range(1, cfg.m_max + 1)],
         "radial": mlp_init(gen, (cfg.n_rbf, 64, c), device=dev),
         "attn": mlp_init(gen, (c, 64, cfg.n_heads), device=dev),
         "proj": normal(gen, (c, c), dev, 1.0 / np.sqrt(c)),
         "ffn_s": mlp_init(gen, (c, 2 * c, c), device=dev)}
        for _ in range(cfg.n_layers)])
    return params


def _so2_conv(feat_rot: torch.Tensor, lp: Params, cfg: EquiformerV2Config) -> torch.Tensor:
    """SO(2) convolution in the edge frame. feat_rot (E, dim, C). m = 0: a
    real degree and channel mix; 1 ≤ m ≤ m_max: the paired (cos, sin) mix
    with shared weights; orders above m_max pass through."""
    dev = feat_rot.device

    def take(m):
        return feat_rot.index_select(1, torch.tensor(_m_indices(cfg.l_max, m), device=dev))

    def mix(f, w):
        return torch.einsum("enc,nmcd->emd", f, w)

    blocks = [(_m_indices(cfg.l_max, 0), mix(take(0), lp["w_m0"]))]
    for m in range(1, cfg.m_max + 1):
        fp, fm = take(m), take(-m)
        wr, wi = lp["w_mr"][m - 1][0], lp["w_mr"][m - 1][1]
        blocks.append((_m_indices(cfg.l_max, m), mix(fp, wr) - mix(fm, wi)))
        blocks.append((_m_indices(cfg.l_max, -m), mix(fp, wi) + mix(fm, wr)))
    mixed = {i for idx, _ in blocks for i in idx}
    kept = [i for i in range(cfg.dim) if i not in mixed]
    order = kept + [i for idx, _ in blocks for i in idx]  # the coefficient at each position of the cat
    parts = [feat_rot.index_select(1, torch.tensor(kept, device=dev))] + [b for _, b in blocks]
    where = torch.tensor(np.argsort(order), device=dev)  # position in the cat of each coefficient
    return torch.cat(parts, 1).index_select(1, where)


def equiformer_v2_forward(p: Params, g: GraphBatch, cfg: EquiformerV2Config):
    """(per-graph energy (n_graphs, 1), features (N, dim, C))."""
    n = g.nodes.shape[0]
    scalars = p["species_embed"].index_select(0, species_of(g.nodes, cfg.n_species))
    h = torch.cat([scalars[:, None, :], scalars.new_zeros((n, cfg.dim - 1, cfg.channels))], 1)

    snd, rcv = g.senders.long(), g.receivers.long()
    vec = g.positions.index_select(0, rcv) - g.positions.index_select(0, snd)
    r = torch.linalg.norm(vec, dim=-1)
    valid = (g.edge_mask & (r > 1e-6))[:, None]  # (E, 1)
    emask = valid.to(torch.float32)
    rot = so3.edge_rotation(vec)  # (E, 3, 3): edge -> +z
    rot_inv = rot.transpose(-1, -2)
    rbf = radial_basis(r, n_rbf=cfg.n_rbf, cutoff=cfg.cutoff)
    heads = cfg.n_heads
    e = snd.shape[0]
    ax = g.edge_axes

    for lp in unstack_layers(p["layers"]):
        # into the edge frame, SO(2) conv, radial scale, back
        f = so3.rotate_coeffs(cfg.l_max, to_edges(h, ax).index_select(0, snd), rot)
        f = _so2_conv(f, lp, cfg)
        f = f * mlp_apply(lp["radial"], rbf)[:, None, :]
        f = so3.rotate_coeffs(cfg.l_max, f, rot_inv)
        # attention from the invariant channel
        scores = torch.where(valid, mlp_apply(lp["attn"], f[:, 0, :]), -torch.inf)  # (E, heads)
        smax = segment_max(scores, rcv, n, over=ax)  # across ranks: the max over every shard
        smax = torch.where(torch.isfinite(smax), smax, 0.0)  # all-masked receivers (module docstring)
        w = torch.where(valid, torch.exp(scores - smax.index_select(0, rcv)), 0.0)
        denom = segment_sum(w, rcv, n, over=ax) + 1e-9
        alpha = w / to_edges(denom, ax).index_select(0, rcv)  # (E, heads)
        msg = f.reshape(e, cfg.dim, heads, cfg.channels // heads) * alpha[:, None, :, None]
        msg = msg.reshape(e, cfg.dim, cfg.channels) * emask[:, :, None]
        agg = torch.einsum("nmc,cd->nmd", scatter_edges_to_nodes(msg, rcv, n, over=ax), lp["proj"])
        h = h + agg
        h0 = h[:, 0, :]  # the invariant FFN on the scalars
        h = torch.cat([(h0 + mlp_apply(lp["ffn_s"], h0))[:, None, :], h[:, 1:, :]], 1)
    e_atom = mlp_apply(p["energy_head"], h[:, 0, :]) * g.node_mask[:, None]
    return segment_sum(e_atom, g.graph_id, g.n_graphs), h


def equiformer_v2_loss(p: Params, g: GraphBatch, targets: torch.Tensor, cfg: EquiformerV2Config) -> torch.Tensor:
    e, _ = equiformer_v2_forward(p, g, cfg)
    return torch.mean((e - targets) ** 2)
