"""NequIP, the E(3)-equivariant interatomic potential (arXiv:2101.03164),
the reference's ``repro.models.gnn.nequip`` in PyTorch.

Node features are real-SH irreps up to l_max with C channels per degree.
Per layer:

    msg_ij = Σ_{l1,l2→l3}  G^{l1l2l3} · [ h_j^{l1} ⊗ Y^{l2}(r̂_ij) ] · R_{l1l2l3}(‖r_ij‖)

segment-summed into the receivers, then a per-degree channel mix with a
gated nonlinearity on the scalars. Energy: the l = 0 channels → per-atom
energy → graph sum.

The reference's functional updates (``.at[].set`` / ``.at[].add``) are
written out of place: each degree's block is summed on its own and the
blocks are concatenated, so no tensor that autograd saved is written.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.gnn import so3
from repro_torch.models.gnn.common import (
    GraphBatch,
    Params,
    mlp_apply,
    mlp_init,
    normal,
    radial_basis,
    scatter_edges_to_nodes,
    segment_sum,
    stack_layers,
    to_edges,
    unstack_layers,
)
from repro_torch.utils import resolve_device


@dataclass(frozen=True)
class NequIPConfig:
    n_layers: int = 5
    channels: int = 32  # d_hidden per degree
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 8

    @property
    def paths(self) -> list[tuple[int, int, int]]:
        """All (l1, l2, l3) with a non-vanishing Gaunt tensor, l* ≤ l_max."""
        out = []
        for l1 in range(self.l_max + 1):
            for l2 in range(self.l_max + 1):
                for l3 in range(self.l_max + 1):
                    if abs(l1 - l2) <= l3 <= l1 + l2 and (l1 + l2 + l3) % 2 == 0:
                        out.append((l1, l2, l3))
        return out


#: the parameters that act on edges (``common.edge_param_leaves``)
EDGE_PARAMS = ("layers/radial",)


def init_nequip(gen: torch.Generator, cfg: NequIPConfig, *, device: str | torch.device = "cuda") -> Params:
    dev = resolve_device(device)
    c = cfg.channels
    n_paths = len(cfg.paths)
    params = {"species_embed": normal(gen, (cfg.n_species, c), dev),
              "energy_head": mlp_init(gen, (c, 32, 1), device=dev)}
    params["layers"] = stack_layers([
        {"radial": mlp_init(gen, (cfg.n_rbf, 32, n_paths * c), device=dev),  # rbf -> (path, channel) weights
         "mix": normal(gen, (cfg.l_max + 1, c, c), dev, 1.0 / np.sqrt(c)),  # per-degree channel mixing
         "gate": normal(gen, (c, cfg.l_max), dev, 1.0 / np.sqrt(c))}  # gate scalars of the l ≥ 1 degrees
        for _ in range(cfg.n_layers)])
    return params


def species_of(nodes: torch.Tensor, n_species: int) -> torch.Tensor:
    """``nodes[:, 0]`` as an integer species id: the cast truncates toward
    zero (``astype(int32)`` and ``.to(int32)`` alike), then the clip."""
    return torch.clamp(nodes[:, 0].to(torch.int32), 0, n_species - 1).long()


def nequip_forward(p: Params, g: GraphBatch, cfg: NequIPConfig):
    """(per-graph energy (n_graphs, 1), final features (N, dim, C)).
    ``g.nodes[:, 0]`` is the species id."""
    n = g.nodes.shape[0]
    dim = so3.n_coeffs(cfg.l_max)
    scalars = p["species_embed"].index_select(0, species_of(g.nodes, cfg.n_species))
    h = torch.cat([scalars[:, None, :], scalars.new_zeros((n, dim - 1, cfg.channels))], 1)

    snd, rcv = g.senders.long(), g.receivers.long()
    vec = g.positions.index_select(0, rcv) - g.positions.index_select(0, snd)  # (E, 3)
    r = torch.linalg.norm(vec, dim=-1)
    y_edge = so3.real_sph_harm(cfg.l_max, vec)  # (E, dim)
    rbf = radial_basis(r, n_rbf=cfg.n_rbf, cutoff=cfg.cutoff)  # (E, n_rbf)
    emask = (g.edge_mask & (r < cfg.cutoff) & (r > 1e-6)).to(torch.float32)
    sl = so3.l_slices(cfg.l_max)
    gaunts = {path: torch.from_numpy(so3.gaunt_tensor(*path)).to(torch.float32).to(h.device) for path in cfg.paths}

    for lp in unstack_layers(p["layers"]):
        rw = mlp_apply(lp["radial"], rbf)  # (E, n_paths*C)
        rw = rw.reshape(rw.shape[0], len(cfg.paths), cfg.channels)
        h_src = to_edges(h, g.edge_axes).index_select(0, snd)  # (E, dim, C)
        blocks: list = [None] * (cfg.l_max + 1)  # each degree's sum over its paths, in path order
        for pi, (l1, l2, l3) in enumerate(cfg.paths):
            part = torch.einsum("eac,eb,abd->edc", h_src[:, sl[l1], :], y_edge[:, sl[l2]], gaunts[(l1, l2, l3)])
            part = part * rw[:, pi, None, :]  # (E, 2l3+1, C)
            blocks[l3] = part if blocks[l3] is None else blocks[l3] + part
        msg = torch.cat(blocks, 1) * emask[:, None, None]
        agg = scatter_edges_to_nodes(msg, rcv, n, over=g.edge_axes)  # (N, dim, C)
        scal = agg[:, 0, :] @ lp["mix"][0]
        gates = torch.sigmoid(scal @ lp["gate"])  # (N, l_max)
        new = [F.silu(scal)[:, None, :]]
        for l in range(1, cfg.l_max + 1):
            mixed = torch.einsum("nmc,cd->nmd", agg[:, sl[l], :], lp["mix"][l])
            new.append(mixed * gates[:, None, l - 1:l])
        h = h + torch.cat(new, 1)
    e_atom = mlp_apply(p["energy_head"], h[:, 0, :]) * g.node_mask[:, None]
    return segment_sum(e_atom, g.graph_id, g.n_graphs), h


def nequip_loss(p: Params, g: GraphBatch, targets: torch.Tensor, cfg: NequIPConfig) -> torch.Tensor:
    """Energy regression MSE; targets (n_graphs, 1)."""
    e, _ = nequip_forward(p, g, cfg)
    return torch.mean((e - targets) ** 2)
