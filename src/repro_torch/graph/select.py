"""Neighbor selection: the MRNG heuristic (paper §2.2, line 6), batched
over rows.

Candidate v is kept iff no already-kept u has α·δ(u, v) < δ(v, x). Per row
the scan is sequential in candidate order; here every step runs across all
rows of a block at once, over the block's (B, C, C) pair matrix
(``backend.pair_matrix``: SDT sums for Flash, no vector fetches). Blocks
bound the pair matrix's memory (``backend.pair_matrix_bytes`` says what one
row of it holds); rows are independent, so the block size does not change
any result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.graph.beam import INF, stable_smallest

#: bytes of pair matrix (and what the backend holds to make it) per block
_SELECT_BYTES = 1 << 29


class Selection(NamedTuple):
    ids: torch.Tensor  # (B, r) int32, −1 padded, ascending by distance
    dists: torch.Tensor  # (B, r) f32, +inf padded
    count: torch.Tensor  # (B,) int32


def _select_block(backend, cand_ids, cand_dists, r: int, alpha: float) -> Selection:
    b, c = cand_ids.shape
    valid = cand_ids >= 0
    safe = torch.where(valid, cand_ids, 0)
    pair = backend.pair_matrix(safe)
    pair = torch.where(valid[:, :, None] & valid[:, None, :], pair, INF)
    scaled = alpha * pair
    sel = torch.zeros((b, c), dtype=torch.bool, device=cand_ids.device)
    count = torch.zeros(b, dtype=torch.int32, device=cand_ids.device)
    for i in range(c):
        # kept u's all have δ(u,x) <= δ(v,x) (sorted), so the rule reduces to:
        # exclude v iff some kept u has α·δ(u,v) < δ(v,x)
        conflict = (sel & (scaled[:, i, :] < cand_dists[:, i:i + 1])).any(1)
        ok = valid[:, i] & ~conflict & (count < r)
        sel[:, i] = ok
        count += ok
    key = torch.where(sel, cand_dists, INF)
    kk = min(r, c)
    _, idx = stable_smallest(key, kk)
    took = sel.gather(1, idx)
    ids = torch.where(took, cand_ids.gather(1, idx), -1)
    dists = torch.where(took, cand_dists.gather(1, idx), INF)
    if kk < r:
        ids = torch.nn.functional.pad(ids, (0, r - kk), value=-1)
        dists = torch.nn.functional.pad(dists, (0, r - kk), value=INF)
    return Selection(ids=ids, dists=dists, count=count)


def select_neighbors(
    backend, cand_ids: torch.Tensor, cand_dists: torch.Tensor, *, r: int, alpha: float = 1.0
) -> Selection:
    """Heuristic selection of ≤ r neighbors per row.

    cand_ids   (B, C) int32, −1 = invalid, each row ascending by cand_dists
               (invalid at +inf — exactly a beam result).
    cand_dists (B, C) f32 distances to the inserted vector (backend scale).
    """
    b, c = cand_ids.shape
    if b == 0:
        z = torch.zeros((0, r), dtype=torch.int32, device=cand_ids.device)
        return Selection(z, z.to(torch.float32), z[:, 0])
    block = max(1, _SELECT_BYTES // max(1, backend.pair_matrix_bytes(c)))
    if b <= block:
        return _select_block(backend, cand_ids, cand_dists, r, alpha)
    parts = [
        _select_block(backend, cand_ids[s:s + block], cand_dists[s:s + block], r, alpha)
        for s in range(0, b, block)
    ]
    return Selection(*(torch.cat(t) for t in zip(*parts)))


def prune_list(
    backend,
    cand_ids: torch.Tensor,
    cand_dists: torch.Tensor,
    *,
    r: int,
    alpha: float = 1.0,
    mode: str = "heuristic",
) -> Selection:
    """Prune unsorted candidate rows (B, C) down to ≤ r entries each.

    mode="heuristic" sorts (stably) then runs :func:`select_neighbors`;
    mode="farthest" keeps the r closest (the NSW-style ablation).
    """
    d = torch.where(cand_ids >= 0, cand_dists, INF)
    d_s, order = torch.sort(d, dim=1, stable=True)
    ids_s = cand_ids.gather(1, order)
    if mode == "farthest":
        ids = torch.where(torch.isfinite(d_s[:, :r]), ids_s[:, :r], -1)
        return Selection(ids=ids, dists=d_s[:, :r], count=(ids >= 0).sum(1).to(torch.int32))
    if mode != "heuristic":
        raise ValueError(f"unknown prune mode {mode!r}")
    return select_neighbors(backend, ids_s, d_s, r=r, alpha=alpha)
