"""Vamana-style flat graph build (paper §4.5.3's generality target), in
PyTorch (reference: repro.graph.vamana).

The CA + NS skeleton of HNSW on one layer: the entry is the medoid (the
vector closest to the data mean), selection is the robust prune with slack
α, and the incremental schedule is DiskANN's two passes — pass 1 inserts
batches 1 … ⌈n/P⌉ − 1 after the exact seed batch with α = 1, pass 2
re-inserts every batch from 0 with ``params.alpha`` against the built graph.
Each pass is the engine's ``insert_batch`` loop (the reference's
``fori_loop``). The bulk build replaces both passes with the RNN-Descent
rounds (``engine.bulk_refine``, kernel ``flash_round`` for Flash backends),
one α-relaxed commit and reachability repair from the medoid.

A flat graph's rows have the blocked mirror's width, so with
``flash_blocked`` every beam of the build (insert batches, repair) and of
the search is one ``flash_beam`` launch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.graph.engine import (
    INF,
    PH_BULK,
    PH_REPAIR,
    BuildEngine,
    BuildParams,
    BuildStats,
    CostAccount,
    bulk_commit,
    bulk_refine,
    repair_reachability,
)
from repro_torch.graph.hnsw import HNSWIndex, SearchResult, _timed, search_hnsw
from repro_torch.graph.rerank import SearchSpec


class FlatIndex(NamedTuple):
    """A built flat graph. adjacency rows: −1 = empty slot."""

    adj: torch.Tensor  # (n, R) int32
    adj_d: torch.Tensor  # (n, R) f32
    entry: int  # the medoid
    backend: object


def medoid_id(data: torch.Tensor) -> int:
    """The vector closest to the dataset mean (the navigating start),
    first on ties; computed on the host so that every device picks the
    same vertex."""
    x = data.detach().cpu()
    mean = x.mean(0)
    d = ((x - mean[None, :]) ** 2).sum(-1)
    return int(torch.argmin(d)) if x.shape[0] else 0


def _empty_graph(n: int, r: int, r_upper: int, l_up: int, dev):
    adj = torch.full((n, r), -1, dtype=torch.int32, device=dev)
    adj_d = torch.full((n, r), INF, device=dev)
    adj_up = torch.full((l_up, n, r_upper), -1, dtype=torch.int32, device=dev)
    adj_up_d = torch.full((l_up, n, r_upper), INF, device=dev)
    return adj, adj_d, adj_up, adj_up_d


def _build_flat(data, backend, entry: int, *, params: BuildParams, two_pass: bool,
                seconds: dict) -> tuple[FlatIndex, BuildStats]:
    """The incremental two-pass build (the reference's ``_build_flat_jit``):
    the exact seed batch, pass 1 (α = 1, batches 1 …), pass 2 (α =
    ``params.alpha``, batches 0 …). Returns pass 1's account, as the
    reference does."""
    n = int(data.shape[0])
    p = params.batch
    dev = data.device
    flat = dataclasses.replace(params, max_layers=1)
    levels = torch.zeros(n, dtype=torch.int32, device=dev)
    # the reference allocates a one-layer upper stack that no layer reads
    adj0, adj0_d, adj_up, adj_up_d = _empty_graph(n, flat.r_base, flat.r_upper, 1, dev)
    backend = backend.clone()  # the build writes the mirror in place
    with _timed(dev, seconds, "bootstrap"):
        adj0, adj0_d, adj_up, adj_up_d, backend, acct = BuildEngine(flat).bootstrap(
            data, adj0, adj0_d, adj_up, adj_up_d, backend, levels
        )
    nb = -(-n // p)
    ar = torch.arange(p, dtype=torch.int32, device=dev)

    def run_pass(alpha: float, start: int, acct: CostAccount) -> None:
        engine = BuildEngine(dataclasses.replace(flat, alpha=alpha))
        for b in range(start, nb):
            ids = b * p + ar
            engine.insert_batch(
                data, adj0, adj0_d, adj_up, adj_up_d, backend, levels,
                ids.clamp_max(n - 1), entry, ids < n, acct=acct,
            )

    with _timed(dev, seconds, "pass1"):
        run_pass(1.0, 1, acct)
    if two_pass:
        # refinement: every vertex again with the relaxed α against the
        # built graph (a fresh beam's candidates dominate DiskANN's visited set)
        with _timed(dev, seconds, "pass2"):
            run_pass(params.alpha, 0, CostAccount())
    index = FlatIndex(adj=adj0, adj_d=adj0_d, entry=entry, backend=backend)
    return index, BuildStats(n_dists=acct.n_dists, n_hops=acct.n_hops, phases=list(acct.phases),
                             seconds=dict(seconds))


def bulk_flat(data, backend, entry: int, *, params: BuildParams, seed: int, seconds: dict):
    """The flat bulk build shared by Vamana and NSG: refined pools over
    every vertex, one commit (selection slack ``bulk_select_alpha``) and
    reachability repair from ``entry``. Returns (FlatIndex, BuildStats,
    pool_ids) — NSG takes its k-NN graph from the pools."""
    n = int(data.shape[0])
    dev = data.device
    flat = dataclasses.replace(params, max_layers=1)
    engine = BuildEngine(flat)
    adj, adj_d, adj_up, adj_up_d = _empty_graph(n, flat.r_base, flat.r_upper, 0, dev)
    levels = torch.zeros(n, dtype=torch.int32, device=dev)
    backend = backend.clone()  # the build writes the mirror in place
    acct = CostAccount()
    pool_ids = None
    if n >= 2:
        members = np.arange(n, dtype=np.int32)
        with _timed(dev, seconds, "bulk_refine_l0"):
            pool_ids, pool_d, nd, nh, _ = bulk_refine(
                data, backend, members, r=flat.r_base, params=flat, seed=seed, layer=0,
            )
        acct.add_dists(nd, phase=PH_BULK, n_hops=nh)
        with _timed(dev, seconds, "bulk_commit_l0"):
            _, _, backend = bulk_commit(
                engine, adj, adj_d, backend, torch.from_numpy(members).to(dev),
                pool_ids, pool_d, r=flat.r_base,
            )
        del pool_d
    with _timed(dev, seconds, "repair"):
        adj, adj_d, _, _, backend, rd, rh, unreach = repair_reachability(
            data, adj, adj_d, adj_up, adj_up_d, backend, levels, entry, params=flat,
            seconds=seconds,
        )
    acct.add_dists(rd, phase=PH_REPAIR, n_hops=rh)
    index = FlatIndex(adj=adj, adj_d=adj_d, entry=entry, backend=backend)
    stats = BuildStats(n_dists=acct.n_dists, n_hops=acct.n_hops, phases=list(acct.phases),
                       seconds=dict(seconds), repair_unreachable=unreach)
    return index, stats, pool_ids


def build_vamana(
    data: torch.Tensor,
    backend,
    *,
    params: BuildParams = BuildParams(alpha=1.2),
    two_pass: bool = True,
    strategy: str = "incremental",
    seed: int = 0,
    seconds: dict | None = None,
) -> tuple[FlatIndex, BuildStats]:
    """Build a Vamana graph over ``data`` (a tensor on the backend's device).

    ``strategy``: ``"incremental"`` (the two-pass schedule; ``two_pass=False``
    stops after pass 1) or ``"bulk"`` (the refinement rounds replace both
    passes, so ``two_pass`` is accepted and ignored). ``seconds`` collects
    the phase times.
    """
    seconds = {} if seconds is None else seconds
    entry = medoid_id(data)
    if strategy == "bulk":
        index, stats, _ = bulk_flat(data, backend, entry, params=params, seed=seed, seconds=seconds)
        return index, stats
    if strategy != "incremental":
        raise ValueError(f"unknown build strategy {strategy!r}")
    return _build_flat(data, backend, entry, params=params, two_pass=two_pass, seconds=seconds)


def as_layered(index: FlatIndex) -> HNSWIndex:
    """A flat graph seen as a one-layer HNSW index (no upper layers, every
    level 0): the layered search then runs exactly the flat one, a beam
    from the entry over ``adj``."""
    n = index.adj.shape[0]
    dev = index.adj.device
    return HNSWIndex(
        adj0=index.adj, adj0_d=index.adj_d,
        adj_up=torch.empty((0, n, 1), dtype=torch.int32, device=dev),
        adj_up_d=torch.empty((0, n, 1), dtype=torch.float32, device=dev),
        levels=torch.zeros(n, dtype=torch.int32, device=dev),
        entry=int(index.entry), backend=index.backend,
    )


def search_flat_result(
    index: FlatIndex,
    queries: torch.Tensor,
    *,
    spec: SearchSpec,
    reranker=None,
    banned: torch.Tensor | None = None,
    fused: bool | None = None,
) -> SearchResult:
    """Flat two-stage search of queries (Q, D): the quantized beam from the
    medoid over the best ``spec.n_keep`` candidates, then the reranker's
    second stage (the layered pipeline with no layer to descend)."""
    return search_hnsw(as_layered(index), queries, spec=spec, reranker=reranker,
                       banned=banned, fused=fused)
