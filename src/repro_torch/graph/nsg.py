"""NSG-style flat graph build (paper §4.5.3's generality target), in
PyTorch (reference: repro.graph.nsg).

NSG acquires candidates by searching a prebuilt k-NN graph from the medoid
and keeps them with the MRNG rule: the CA + NS decomposition of HNSW, which
is the paper's generality argument. The incremental build: (1) the exact
k-NN graph (``graph.knn.exact_knn``, kernel ``l2_batch``), (2) per batch of
P vertices, a beam over the k-NN graph from the medoid, (3) the union with
each vertex's own k-NN row, sorted stably by distance with repeats struck,
(4) MRNG selection, forward commit and the reverse pass. The bulk build
takes the refined pools of ``vamana.bulk_flat`` as its k-NN graph.

One reference behaviour is kept on purpose: when the k-NN graph has the
blocked mirror's width (``knn_k == r_base`` over ``flash_blocked``), the
beam takes the fused path, which scores each k-NN row with the mirror row
of the graph under construction, not with the k-NN neighbors' codes
(ROADMAP queue 3 records it as a reference-and-port decision).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.graph.engine import (
    INF,
    PH_BEAM_BASE,
    BuildEngine,
    BuildParams,
    BuildStats,
    CostAccount,
    commit_forward,
    reverse_pass,
)
from repro_torch.graph.hnsw import _timed
from repro_torch.graph.knn import exact_knn
from repro_torch.graph.vamana import FlatIndex, bulk_flat, medoid_id


def _build_nsg_incremental(data, backend, knn_adj, entry: int, *, params: BuildParams,
                           seconds: dict) -> tuple[FlatIndex, BuildStats]:
    """One batch of P vertices at a time (the reference's ``fori_loop``)."""
    engine = BuildEngine(params)
    n = int(data.shape[0])
    p = params.batch
    r = params.r_base
    dev = data.device
    adj = torch.full((n, r), -1, dtype=torch.int32, device=dev)
    adj_d = torch.full((n, r), INF, device=dev)
    backend = backend.clone()  # the build writes the mirror in place
    acct = CostAccount()
    ar = torch.arange(p, dtype=torch.int32, device=dev)
    entries = torch.full((p,), entry, dtype=torch.int32, device=dev)
    knn_adj = knn_adj.to(device=dev, dtype=torch.int32).contiguous()
    # beam (ef) ∪ k-NN row: the candidate width is the same every batch
    c = params.ef + knn_adj.shape[1]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev), -1)
    with _timed(dev, seconds, "insert_batches"):
        for b in range(-(-n // p)):
            ids = b * p + ar
            mask = ids < n
            ids = ids.clamp_max(n - 1)
            qctx = backend.prepare_query(data[ids.long()])
            # acquisition on the k-NN graph from the medoid
            res = engine.acquire(backend, qctx, knn_adj, entries)
            acct.add_beam(res, phase=PH_BEAM_BASE)
            # candidates: the beam ∪ the vertex's own k-NN row, self struck
            own = knn_adj[ids.long()]  # (P, k)
            own_d = torch.where(own >= 0, backend.query_dists(qctx, own.clamp_min(0)), INF)
            acct.add_dists(int((own >= 0).sum()), phase=PH_BEAM_BASE)
            own = torch.where(own == ids[:, None], -1, own)
            own_d = torch.where(own == -1, INF, own_d)
            cand_d, order = torch.sort(torch.cat([res.dists, own_d], 1), dim=1, stable=True)
            cand_ids = torch.cat([res.ids, own], 1).gather(1, order)
            # strike every id seen at an earlier slot
            dup = ((cand_ids[:, :, None] == cand_ids[:, None, :]) & tri[None]).any(2)
            cand_ids = torch.where(dup | (cand_ids < 0), -1, cand_ids)
            cand_d = torch.where(cand_ids < 0, INF, cand_d)
            sel = engine.select(backend, cand_ids, cand_d, r=r)
            sel_ids = torch.where(mask[:, None], sel.ids, -1)
            sel_d = torch.where(mask[:, None], sel.dists, INF)
            commit_forward(adj, adj_d, backend, ids, sel_ids, sel_d, mask)
            reverse_pass(adj, adj_d, backend, ids, sel_ids, sel_d, mask, params=params)
    index = FlatIndex(adj=adj, adj_d=adj_d, entry=entry, backend=backend)
    return index, BuildStats(n_dists=acct.n_dists, n_hops=acct.n_hops, phases=list(acct.phases),
                             seconds=dict(seconds))


def build_nsg_stats(
    data: torch.Tensor,
    backend,
    *,
    params: BuildParams = BuildParams(),
    knn_k: int = 16,
    strategy: str = "incremental",
    seed: int = 0,
    knn_adj: torch.Tensor | None = None,
    seconds: dict | None = None,
) -> tuple[FlatIndex, torch.Tensor, BuildStats]:
    """:func:`build_nsg` with the build's cost as a third result. The
    reference's NSG returns none (its facade reports no stats); the port
    counts the beams and the own k-NN rows scored (incremental), or the
    bulk rounds and the repair (bulk), by the engine's phases."""
    seconds = {} if seconds is None else seconds
    entry = medoid_id(data)
    if strategy == "bulk":
        flat = dataclasses.replace(params, max_layers=1)
        index, stats, pool_ids = bulk_flat(data, backend, entry, params=flat, seed=seed, seconds=seconds)
        n = int(data.shape[0])
        knn = torch.full((n, knn_k), -1, dtype=torch.int32, device=data.device)
        if pool_ids is not None:
            w = min(knn_k, pool_ids.shape[1])
            knn[:, :w] = pool_ids[:, :w]
        return index, knn, stats
    if strategy != "incremental":
        raise ValueError(f"unknown build strategy {strategy!r}")
    if knn_adj is None:
        with _timed(data.device, seconds, "knn"):
            ids, _ = exact_knn(data, data, k=knn_k + 1)
            knn_adj = ids[:, 1:]  # the first column is the point itself
    index, stats = _build_nsg_incremental(data, backend, knn_adj, entry, params=params, seconds=seconds)
    return index, knn_adj, stats


def build_nsg(
    data: torch.Tensor,
    backend,
    *,
    params: BuildParams = BuildParams(),
    knn_k: int = 16,
    strategy: str = "incremental",
    seed: int = 0,
    knn_adj: torch.Tensor | None = None,
) -> tuple[FlatIndex, torch.Tensor]:
    """Build an NSG-style index over ``data`` -> (FlatIndex, knn_adj).

    ``strategy="bulk"`` replaces both the exact k-NN pass and the per-batch
    beams with the refinement rounds; ``knn_adj`` then comes from the
    refined pools. ``knn_adj`` (n, knn_k) given to an incremental build is
    used instead of the exact k-NN graph.
    """
    index, knn, _ = build_nsg_stats(data, backend, params=params, knn_k=knn_k, strategy=strategy,
                                    seed=seed, knn_adj=knn_adj)
    return index, knn
