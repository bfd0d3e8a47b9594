"""Candidate acquisition: the multi-expansion beam search, batched over Q.

The reference runs one ``lax.while_loop`` per query under ``vmap``. Here
the entries are scored and the initial beam sorted in torch, then the loop
runs in one of two ways, both bit-equal to the reference:

* the fused path (the blocked backend's base layer, ``uses_fused_expand``):
  ``backend.fused_beam``, which on the card is ONE ``flash_beam`` launch
  running every query's loop to its end, and on the CPU its plain version;
* otherwise (``fused=False``, other widths, backends without a mirror):
  ``kernels.ref.beam_loop``, the batched Python loop, whose step is the
  gather + ``backend.neighbor_dists_batch`` (kernel ``flash_scan_blocked``).

Per query and iteration, as in the reference: expand the ``width`` best
unexpanded beam entries, score their W·R neighbor block, mark visited row
by row, and merge (``ref.beam_loop`` holds the details).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import INF, stable_smallest  # noqa: F401  (the graph modules import both from here)
from repro_torch.utils import first_argmin


class BeamResult(NamedTuple):
    ids: torch.Tensor  # (Q, keep) int32, −1 padded, ascending by dist
    dists: torch.Tensor  # (Q, keep) f32, +inf padded
    n_hops: torch.Tensor  # (Q,) int64 expanded-vertex count
    n_dists: torch.Tensor  # (Q,) int64 distance evaluations


class DescentResult(NamedTuple):
    node: torch.Tensor  # (Q,) int32 closest vertex reached
    dist: torch.Tensor  # (Q,) f32
    n_dists: torch.Tensor  # (Q,) int64


def uses_fused_expand(backend, r: int) -> bool:
    """Does ``backend`` serve the fused single-kernel step for rows of width r?"""
    return bool(getattr(backend, "supports_expand", lambda _r: False)(r))


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
    e = entry_ids.shape[1]
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
            f"fused beam path for adjacency width R={r}"
        )

    entry_ids = entry_ids.to(torch.int32).contiguous()
    valid_e = entry_ids >= 0
    safe_e = torch.where(valid_e, entry_ids, 0)
    d_e = torch.where(valid_e, backend.query_dists(qctx, safe_e), INF)
    beam_d, beam_ids, beam_exp = ref.initial_beam(entry_ids, d_e, ef)

    if use_fused:
        beam_d, beam_ids, nd, nh = backend.fused_beam(
            qctx, adjacency, beam_d, beam_ids, beam_exp, entry_ids, width=w, max_iters=max_iters
        )
    else:
        def step(nodes):
            rows = adjacency[nodes.clamp_min(0).long()]
            return rows, backend.neighbor_dists_batch(qctx, nodes, rows.clamp_min(0))

        beam_d, beam_ids, nd, nh = ref.beam_loop(
            step, beam_d, beam_ids, beam_exp, entry_ids, n, width=w, max_iters=max_iters
        )
    nd = nd + valid_e.sum(1)

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
