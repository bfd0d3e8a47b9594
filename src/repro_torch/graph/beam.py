"""Candidate acquisition: the multi-expansion beam search, batched over Q.

The reference runs one ``lax.while_loop`` per query under ``vmap``; here
the Q queries run together in one Python loop over batched tensors, each
with its own stopping test: a query whose test fails is frozen (it selects
nothing, marks nothing, and merging nothing into a sorted beam is the
identity) while the others go on. The loop ends when no query is active.

Per query and iteration, as in the reference: expand the ``width`` best
unexpanded beam entries, score their W·R neighbor block in one call — the
fused ``backend.expand`` (kernel ``flash_expand``) when the backend offers
it for this adjacency width, else the gather + ``neighbor_dists_batch``
(kernel ``flash_scan_blocked``) — mark visited row by row, and merge.

Tie order is the reference's: ``lax.top_k`` keeps the lowest index among
equal keys and ``jnp.argsort`` is stable, so every selection here is a
``torch.sort(stable=True)`` and a slice. The visited bitmap is (Q, n + 1)
bool whose last column takes the writes of masked slots, so marking is one
scatter of the constant True (order-free, no host sync).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.utils import first_argmin

INF = float("inf")

#: beam iterations between host checks for "no query active" (each check
#: waits for the card)
_CHECK_EVERY = 4


class BeamResult(NamedTuple):
    ids: torch.Tensor  # (Q, keep) int32, −1 padded, ascending by dist
    dists: torch.Tensor  # (Q, keep) f32, +inf padded
    n_hops: torch.Tensor  # (Q,) int64 expanded-vertex count
    n_dists: torch.Tensor  # (Q,) int64 distance evaluations


class DescentResult(NamedTuple):
    node: torch.Tensor  # (Q,) int32 closest vertex reached
    dist: torch.Tensor  # (Q,) f32
    n_dists: torch.Tensor  # (Q,) int64


def stable_smallest(d: torch.Tensor, k: int):
    """The k smallest entries of each row, ascending, lowest index first on
    ties (``lax.top_k(-d, k)``'s order): (values, indices)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def uses_fused_expand(backend, r: int) -> bool:
    """Does ``backend`` serve the fused single-kernel step for rows of width r?"""
    return bool(getattr(backend, "supports_expand", lambda _r: False)(r))


def _mark(visited: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor) -> None:
    """visited[q, idx[q, j]] = True where ok[q, j] (others hit the sink column)."""
    visited.scatter_(1, torch.where(ok, idx.long(), visited.shape[1] - 1), True)


def beam_search(
    backend,
    qctx,
    adjacency: torch.Tensor,
    entry_ids: torch.Tensor,
    *,
    ef: int,
    width: int = 1,
    max_iters: int | None = None,
    banned: torch.Tensor | None = None,
    fused: bool | None = None,
    n_keep: int | None = None,
) -> BeamResult:
    """Greedy multi-expansion beam search over one layer for Q queries.

    qctx       backend.prepare_query output, leading axis Q.
    adjacency  (n, R) int32, −1 = empty slot.
    entry_ids  (Q, E) int32 entry points (−1 padded).
    ef, width, max_iters, banned, fused, n_keep: as in the reference
    (``fused=None`` picks the fused step iff the backend offers it).
    """
    n, r = adjacency.shape
    q, e = entry_ids.shape
    dev = adjacency.device
    if e > ef:
        raise ValueError(f"entries ({e}) must fit the beam (ef={ef})")
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    keep = ef if n_keep is None else min(max(int(n_keep), 1), ef)
    w = min(width, ef)
    max_iters = max_iters if max_iters is not None else -(-(4 * ef + 8) // w)
    use_fused = uses_fused_expand(backend, r) if fused is None else fused
    if use_fused and not uses_fused_expand(backend, r):
        raise ValueError(
            f"fused=True but {type(backend).__name__} does not support the "
            f"fused expand() path for adjacency width R={r}"
        )

    entry_ids = entry_ids.to(torch.int32)
    valid_e = entry_ids >= 0
    safe_e = torch.where(valid_e, entry_ids, 0)
    d_e = torch.where(valid_e, backend.query_dists(qctx, safe_e), INF)
    visited = torch.zeros((q, n + 1), dtype=torch.bool, device=dev)
    _mark(visited, safe_e, valid_e)

    pad = ef - e
    beam_ids = torch.cat([entry_ids, torch.full((q, pad), -1, dtype=torch.int32, device=dev)], 1)
    beam_d = torch.cat([d_e, torch.full((q, pad), INF, device=dev)], 1)
    beam_exp = torch.cat([~valid_e, torch.ones((q, pad), dtype=torch.bool, device=dev)], 1)
    beam_d, order = torch.sort(beam_d, dim=1, stable=True)
    beam_ids, beam_exp = beam_ids.gather(1, order), beam_exp.gather(1, order)

    nd = valid_e.sum(1).to(torch.int64)
    nh = torch.zeros(q, dtype=torch.int64, device=dev)
    # A query that fails the stopping test never passes it again (it changes
    # nothing while inactive), so an active query's iteration count is the
    # step index and the reference's per-query cap is the loop bound.
    for step in range(max_iters):
        key = torch.where(beam_exp, INF, beam_d)
        best_unexp = key.amin(1)
        active = (best_unexp <= beam_d[:, ef - 1]) & (best_unexp < INF)
        # the host looks every few iterations: an iteration with no active
        # query changes nothing, so the extra ones are exact no-ops
        if step % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        kv, bi = stable_smallest(key, w)  # (Q, W) distinct beam positions
        sel_ok = (kv < INF) & active[:, None]
        # marking an inactive query's picks expanded only raises its best
        # unexpanded distance: it stays inactive, its results unchanged
        beam_exp.scatter_(1, bi, True)
        nodes = torch.where(sel_ok, beam_ids.gather(1, bi), -1)  # (Q, W)
        if use_fused:
            rows, d_block = backend.expand(qctx, nodes, adjacency)  # (Q, W, R) x2
        else:
            rows = adjacency[nodes.clamp_min(0).long()]
            d_block = backend.neighbor_dists_batch(qctx, nodes, rows.clamp_min(0))
        pre_ok = (rows >= 0) & (nodes >= 0)[..., None]
        safe = torch.where(pre_ok, rows, 0).long()
        ok = pre_ok
        # row i sees the bitmap already marked by rows < i: a neighbor shared
        # by two expanded vertices survives only in its first row
        for i in range(w):
            row_ok = ok[:, i] > visited.gather(1, safe[:, i])  # ok and not visited
            _mark(visited, safe[:, i], row_ok)
            ok[:, i] = row_ok
        flat_ok = ok.reshape(q, w * r)
        d_new = torch.where(flat_ok, d_block.reshape(q, w * r), INF)
        ids_new = torch.where(flat_ok, safe.reshape(q, w * r).to(torch.int32), -1)
        beam_d, idx = stable_smallest(torch.cat([beam_d, d_new], 1), ef)
        beam_ids = torch.cat([beam_ids, ids_new], 1).gather(1, idx)
        beam_exp = torch.cat([beam_exp, ~flat_ok], 1).gather(1, idx)
        nd += flat_ok.sum(1)
        nh += sel_ok.sum(1)

    if banned is not None:
        # strike tombstoned vertices from the results (traversal ignored them)
        dead = (beam_ids >= 0) & banned[beam_ids.clamp_min(0).long()]
        beam_d = torch.where(dead, INF, beam_d)
        beam_ids = torch.where(dead, -1, beam_ids)
        beam_d, order = torch.sort(beam_d, dim=1, stable=True)
        beam_ids = beam_ids.gather(1, order)
    return BeamResult(ids=beam_ids[:, :keep], dists=beam_d[:, :keep], n_hops=nh, n_dists=nd)


def greedy_descent(
    backend, qctx, adjacency: torch.Tensor, entry_id: torch.Tensor, *, max_iters: int = 64
) -> DescentResult:
    """ef=1 greedy walk (upper-layer descent) for Q queries: move to the
    closest neighbor while it improves. entry_id (Q,) int32."""
    q = entry_id.shape[0]
    node = entry_id.to(torch.int32).clone()
    valid = node >= 0
    d0 = backend.query_dists(qctx, node.clamp_min(0)[:, None])[:, 0]
    d = torch.where(valid, d0, INF)
    moved = valid.clone()
    nd = valid.to(torch.int64)
    for _ in range(max_iters):
        if not bool(moved.any()):
            break
        nbrs = adjacency[node.clamp_min(0).long()]  # (Q, R)
        ok = (nbrs >= 0) & (node >= 0)[:, None] & moved[:, None]
        safe = torch.where(ok, nbrs, 0)
        d_n = torch.where(ok, backend.query_dists(qctx, safe), INF)
        j = first_argmin(d_n, 1)
        dj = d_n.gather(1, j[:, None])[:, 0]
        better = (dj < d) & moved
        node = torch.where(better, safe.gather(1, j[:, None])[:, 0], node)
        d = torch.where(better, dj, d)
        nd += ok.sum(1)
        moved = better
    return DescentResult(node=node, dist=d, n_dists=nd)
