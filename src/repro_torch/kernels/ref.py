"""Plain PyTorch versions of the port's kernels (the Flash kernels,
``l2_batch`` and ``sq_l2``) and the beam loop that ``flash_beam`` runs.

Each function is the semantic ground truth of its CUDA kernel in
``csrc/``: the wrappers in ``ops.py`` take these for CPU tensors, the CPU
tests hold them against the reference package's oracles, and
``chip_smoke.py`` holds each kernel against them on the card. Integer
tables give exact sums; float tables sum in torch's own order.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import quantize as qz

INF = float("inf")

#: beam iterations between host checks for "no query active" (each check
#: waits for the card)
_CHECK_EVERY = 4


def _sum_m(vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return vals.sum(-1).to(dtype)


def flash_scan(codes: torch.Tensor, adt: torch.Tensor) -> torch.Tensor:
    """Flat ADT scan: codes (N, M) int in [0, K), adt (M, K) -> (N,) in
    adt's dtype, Σ_m adt[m, codes[n, m]]. The sum runs in m order, the
    kernel's order, so float tables agree with the kernel bit for bit."""
    n, m = codes.shape
    out = torch.zeros(n, dtype=adt.dtype, device=codes.device)
    for j in range(m):
        out += adt[j][codes[:, j].long()]
    return out


def flash_round(codes: torch.Tensor, adts: torch.Tensor) -> torch.Tensor:
    """Bulk refinement-round scan: codes (B, C, M) int in [0, K), adts
    (B, M, K) per-row tables -> (B, C), Σ_m adts[b, m, codes[b, c, m]]."""
    b, _, m = codes.shape
    bi = torch.arange(b, device=codes.device)[:, None, None]
    mi = torch.arange(m, device=codes.device)[None, None, :]
    return _sum_m(adts[bi, mi, codes.long()], adts.dtype)


def flash_expand(
    nodes: torch.Tensor,
    adjacency: torch.Tensor,
    mirror: torch.Tensor,
    adt: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused beam-expansion step, batched over Q queries.

    nodes (Q, W) int32 frontier ids (−1 clamped to row 0, caller-masked);
    adjacency (n, R) int32; mirror (n, R, ⌈M/2⌉) uint8 packed 4-bit codes or
    (n, R, M) int32 unpacked; adt (Q, M, K).
    Returns rows (Q, W, R) int32 = adjacency[max(nodes, 0)] and sums
    (Q, W, R) = Σ_m adt[q, m, code_m] over the mirror row's codes.
    """
    q, m, _ = adt.shape
    safe = nodes.clamp_min(0).long()
    rows = adjacency[safe]
    mir = mirror[safe]  # (Q, W, R, Mp)
    if mirror.dtype == torch.uint8:
        codes = qz.unpack4(mir)[..., :m]
    else:
        codes = mir
    qi = torch.arange(q, device=adt.device)[:, None, None, None]
    mi = torch.arange(m, device=adt.device)[None, None, None, :]
    return rows, _sum_m(adt[qi, mi, codes.long()], adt.dtype)


def stable_smallest(d: torch.Tensor, k: int):
    """The k smallest entries of each row, ascending, lowest index first on
    ties (``lax.top_k(-d, k)``'s order): (values, indices)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _mark(visited: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor) -> None:
    """visited[q, idx[q, j]] = True where ok[q, j] (others hit the sink column)."""
    visited.scatter_(1, torch.where(ok, idx.long(), visited.shape[1] - 1), True)


def initial_beam(entry_ids: torch.Tensor, d_e: torch.Tensor, ef: int):
    """The beam a search starts from: entries (Q, E) int32 (−1 = none) with
    their distances d_e (Q, E) (inf where −1), padded to ef and sorted
    stably by distance -> (beam_d, beam_ids, beam_exp), each (Q, ef). Pads
    and −1 entries count as expanded."""
    q, e = entry_ids.shape
    dev = entry_ids.device
    pad = ef - e
    beam_ids = torch.cat([entry_ids, torch.full((q, pad), -1, dtype=torch.int32, device=dev)], 1)
    beam_d = torch.cat([d_e, torch.full((q, pad), INF, device=dev)], 1)
    beam_exp = torch.cat([entry_ids < 0, torch.ones((q, pad), dtype=torch.bool, device=dev)], 1)
    beam_d, order = torch.sort(beam_d, dim=1, stable=True)
    return beam_d, beam_ids.gather(1, order), beam_exp.gather(1, order)


def beam_loop(
    step: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    beam_d: torch.Tensor,
    beam_ids: torch.Tensor,
    beam_exp: torch.Tensor,
    entry_ids: torch.Tensor,
    n: int,
    *,
    width: int,
    max_iters: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The base-layer beam loop of Q queries, batched: the reference's
    ``lax.while_loop`` (``repro/graph/beam.py``) with every query's own
    stopping test. A query whose test fails is frozen (it selects nothing,
    marks nothing, and merging nothing into a sorted beam is the identity)
    while the others go on; the loop ends when no query is active.

    step       nodes (Q, W) int32 (−1 = no pick) -> (rows (Q, W, R) int32 =
               adjacency[max(nodes, 0)], d_block (Q, W, R) float32): one
               expansion step (``flash_expand``, or the unfused gather and
               ``flash_scan_blocked``).
    beam_*     the sorted initial beam (Q, ef): float32 d, int32 ids, bool
               expanded; entry_ids (Q, E) int32 are marked visited; n
               vertices.
    Returns the final (beam_d, beam_ids) and the loop's (n_dists, n_hops),
    each (Q,) int64. ``flash_beam`` is this loop with ``flash_expand`` as
    its step, in one kernel.

    Tie order is the reference's: ``lax.top_k`` keeps the lowest index among
    equal keys and ``jnp.argsort`` is stable, so every selection here is a
    ``torch.sort(stable=True)`` and a slice. The visited bitmap is (Q, n + 1)
    bool whose last column takes the writes of masked slots, so marking is
    one scatter of the constant True (order-free, no host sync).
    """
    q, ef = beam_d.shape
    dev = beam_d.device
    w = width
    valid_e = entry_ids >= 0
    visited = torch.zeros((q, n + 1), dtype=torch.bool, device=dev)
    _mark(visited, torch.where(valid_e, entry_ids, 0), valid_e)
    beam_exp = beam_exp.clone()
    nd = torch.zeros(q, dtype=torch.int64, device=dev)
    nh = torch.zeros(q, dtype=torch.int64, device=dev)
    # A query that fails the stopping test never passes it again (it changes
    # nothing while inactive), so an active query's iteration count is the
    # step index and the reference's per-query cap is the loop bound.
    for it in range(max_iters):
        key = torch.where(beam_exp, INF, beam_d)
        best_unexp = key.amin(1)
        active = (best_unexp <= beam_d[:, ef - 1]) & (best_unexp < INF)
        # the host looks every few iterations: an iteration with no active
        # query changes nothing, so the extra ones are exact no-ops
        if it % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        kv, bi = stable_smallest(key, w)  # (Q, W) distinct beam positions
        sel_ok = (kv < INF) & active[:, None]
        # marking an inactive query's picks expanded only raises its best
        # unexpanded distance: it stays inactive, its results unchanged
        beam_exp.scatter_(1, bi, True)
        nodes = torch.where(sel_ok, beam_ids.gather(1, bi), -1)  # (Q, W)
        rows, d_block = step(nodes)
        r = rows.shape[-1]
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
    return beam_d, beam_ids, nd, nh


def flash_beam(
    adt: torch.Tensor,
    adjacency: torch.Tensor,
    mirror: torch.Tensor,
    beam_d: torch.Tensor,
    beam_ids: torch.Tensor,
    beam_exp: torch.Tensor,
    entry_ids: torch.Tensor,
    *,
    width: int,
    max_iters: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole base-layer beam search: :func:`beam_loop` with
    :func:`flash_expand` (sums as float32) as its step. adt (Q, M, K),
    adjacency (n, R), mirror as ``flash_expand`` takes it, the sorted
    initial beam (Q, ef) and entry_ids (Q, E) -> (beam_d, beam_ids,
    n_dists, n_hops)."""

    def step(nodes):
        rows, sums = flash_expand(nodes, adjacency, mirror, adt)
        return rows, sums.to(torch.float32)

    return beam_loop(step, beam_d, beam_ids, beam_exp, entry_ids, adjacency.shape[0],
                     width=width, max_iters=max_iters)


def flash_scan_blocked(blocks: torch.Tensor, adt: torch.Tensor) -> torch.Tensor:
    """Access-aware blocked scan: blocks (G, M, B) with adt (M, K) -> (G, B),
    or batched blocks (Q, G, M, B) with adt (Q, M, K) -> (Q, G, B);
    Σ_m adt[m, blocks[g, m, b]]."""
    if blocks.dim() == 3:
        return flash_scan_blocked(blocks[None], adt[None])[0]
    q, _, m, _ = blocks.shape
    qi = torch.arange(q, device=adt.device)[:, None, None, None]
    mi = torch.arange(m, device=adt.device)[None, None, :, None]
    return adt[qi, mi, blocks.long()].sum(-2).to(adt.dtype)


def l2_batch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2: x (N, D), y (C, D) -> (N, C) float32,
    ``max(‖x‖² + ‖y‖² − 2·x·yᵀ, 0)``, in full float32 (the matrix product on
    the card too, as long as TF32 is off, which the port never turns on).
    The kernel reaches float32 accuracy through three TF32 products
    (:func:`l2_batch_split_tf32` emulates its arithmetic); this version is
    what it is held against."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1)
    return torch.clamp_min(x2 + y2[None, :] - 2.0 * (x @ y.T), 0.0)


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 bit patterns: the 23-bit mantissa
    rounded to TF32's 10 bits, to nearest with ties away from zero (finite
    inputs), as a float32 whose low 13 bits are zero."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def l2_batch_split_tf32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """An emulation of ``csrc/l2_batch.cu``'s arithmetic, for the tests only:
    no path calls it. Each operand is split into hi = rna(v) and lo =
    rna(v − hi); the three products hi·hi + hi·lo + lo·hi (exact in float32,
    as on the tensor cores) sum in one float32 accumulator, and the norms are
    float32 sums of the unsplit squares."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xh, yh = tf32_rna(x), tf32_rna(y)
    xl, yl = tf32_rna(x - xh), tf32_rna(y - yh)
    xy = torch.cat([xh, xh, xl], 1) @ torch.cat([yh, yl, yh], 1).T
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1)
    return torch.clamp_min(x2 + y2[None, :] - 2.0 * xy, 0.0)


def sq_l2(q: torch.Tensor, db: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Quantized-domain scaled L2: q (D,) int codes, db (N, D) int codes,
    s2 (D,) float32 -> (N,) float32, Σ_d s2_d (db[n, d] − q_d)², with the
    subtraction in int32 (the reference's ``sq_l2_ref``)."""
    diff = (db.to(torch.int32) - q.to(torch.int32)).to(torch.float32)
    return (s2.to(torch.float32)[None, :] * diff * diff).sum(-1)
