"""HNSW index construction (bulk strategy) and layered search, in PyTorch.

The bulk build bootstraps each layer's k-NN pools with whole-dataset
refinement rounds (``engine.bulk_refine``, kernel ``flash_round``), commits
them through MRNG selection and the batched reverse pass
(``engine.bulk_commit``), then re-inserts any vertex the base layer cannot
reach from the entry (``engine.repair_reachability``, whose base-layer
beam searches run the ``flash_beam`` kernel).

Search is the two-stage pipeline: greedy descent through the upper
layers, a quantized multi-expansion beam on the base layer (one
``flash_beam`` launch, or the loop of ``flash_scan_blocked`` steps with
``fused=False``), then the reranker's second stage.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.graph.beam import beam_search, greedy_descent
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
    sample_levels,
)
from repro_torch.graph.rerank import SearchSpec, rerank_topk
from repro_torch.utils import sync

#: bytes of (Q, n) visited bitmap one search block may hold
_VISITED_BUDGET = 1 << 31


class HNSWIndex(NamedTuple):
    """Built index. adjacency rows: −1 = empty slot."""

    adj0: torch.Tensor  # (n, r_base) int32
    adj0_d: torch.Tensor  # (n, r_base) f32 backend-scale dist to each neighbor
    adj_up: torch.Tensor  # (L−1, n, r_upper) int32
    adj_up_d: torch.Tensor  # (L−1, n, r_upper) f32
    levels: torch.Tensor  # (n,) int32
    entry: int  # vertex with the max level
    backend: object


@contextmanager
def _timed(device, sink: dict, name: str):
    """Add the wall seconds of the block to ``sink[name]``, the card
    synchronised at both ends."""
    sync(device)
    t0 = time.perf_counter()
    yield
    sync(device)
    sink[name] = sink.get(name, 0.0) + time.perf_counter() - t0


def _build_hnsw_bulk(
    data: torch.Tensor, backend, levels: np.ndarray, *, params: BuildParams, seed: int,
    seconds: dict | None = None,
) -> tuple[HNSWIndex, BuildStats]:
    """Bulk construction (``strategy="bulk"``): refine + commit each layer,
    then repair base-layer reachability. ``seconds`` collects phase times."""
    dev = data.device
    n = data.shape[0]
    seconds = {} if seconds is None else seconds
    backend = backend.clone()  # the build writes the mirror in place
    engine = BuildEngine(params)
    l_up = params.max_layers - 1
    adj0 = torch.full((n, params.r_base), -1, dtype=torch.int32, device=dev)
    adj0_d = torch.full((n, params.r_base), INF, device=dev)
    adj_up = torch.full((l_up, n, params.r_upper), -1, dtype=torch.int32, device=dev)
    adj_up_d = torch.full((l_up, n, params.r_upper), INF, device=dev)
    acct = CostAccount()
    levels_np = np.asarray(levels)

    for l in range(params.max_layers):
        members = np.nonzero(levels_np >= l)[0].astype(np.int32) if l else np.arange(n, dtype=np.int32)
        if members.size < 2:
            continue
        r = params.r_base if l == 0 else params.r_upper
        with _timed(dev, seconds, f"bulk_refine_l{l}"):
            pool_ids, pool_d, nd, nh, _ = bulk_refine(
                data, backend, members, r=r, params=params, seed=seed, layer=l,
            )
        acct.add_dists(nd, phase=PH_BULK, n_hops=nh)
        adj, adj_d = (adj0, adj0_d) if l == 0 else (adj_up[l - 1], adj_up_d[l - 1])
        with _timed(dev, seconds, f"bulk_commit_l{l}"):
            _, _, backend = bulk_commit(
                engine, adj, adj_d, backend, torch.from_numpy(members).to(dev),
                pool_ids, pool_d, r=r,
            )
        del pool_ids, pool_d

    entry = int(np.argmax(levels_np)) if n else 0
    lv = torch.from_numpy(levels_np.astype(np.int32)).to(dev)
    with _timed(dev, seconds, "repair"):
        adj0, adj0_d, adj_up, adj_up_d, backend, rd, rh, unreach = repair_reachability(
            data, adj0, adj0_d, adj_up, adj_up_d, backend, lv, entry, params=params,
            seconds=seconds,
        )
    acct.add_dists(rd, phase=PH_REPAIR, n_hops=rh)
    index = HNSWIndex(
        adj0=adj0, adj0_d=adj0_d, adj_up=adj_up, adj_up_d=adj_up_d,
        levels=lv, entry=entry, backend=backend,
    )
    return index, BuildStats(
        n_dists=acct.n_dists, n_hops=acct.n_hops, phases=list(acct.phases),
        seconds=dict(seconds), repair_unreachable=unreach,
    )


def build_hnsw(
    data: torch.Tensor,
    backend,
    *,
    params: BuildParams = BuildParams(),
    seed: int = 0,
    levels: np.ndarray | None = None,
    strategy: str = "bulk",
    seconds: dict | None = None,
) -> tuple[HNSWIndex, BuildStats]:
    """Build an HNSW index over ``data`` (a tensor on the backend's device).

    Only ``strategy="bulk"`` is ported; ``"incremental"`` raises.
    """
    n = data.shape[0]
    if levels is None:
        levels = sample_levels(seed, n, r_upper=params.r_upper, max_layers=params.max_layers)
    if strategy == "incremental":
        raise NotImplementedError(
            "the incremental build strategy (bootstrap/build_layered) is not "
            "ported yet: ROADMAP queue 1, item 5a"
        )
    if strategy != "bulk":
        raise ValueError(f"unknown build strategy {strategy!r}")
    return _build_hnsw_bulk(data, backend, levels, params=params, seed=seed, seconds=seconds)


class SearchResult(NamedTuple):
    """ids/dists (Q, k); n_dists = n_scan + n_rerank totals (ints)."""

    ids: torch.Tensor
    dists: torch.Tensor
    n_dists: int
    n_scan: int | None = None
    n_rerank: int | None = None


def _search_block(index: HNSWIndex, queries, banned, reranker, spec: SearchSpec, fused, n_layers):
    backend = index.backend
    q = queries.shape[0]
    qctx = backend.prepare_query(queries)
    ep = torch.full((q,), index.entry, dtype=torch.int32, device=queries.device)
    nd = torch.zeros(q, dtype=torch.int64, device=queries.device)
    for l in range(n_layers - 1, 0, -1):
        desc = greedy_descent(backend, qctx, index.adj_up[l - 1], ep)
        ep = desc.node
        nd = nd + desc.n_dists
    res = beam_search(
        backend, qctx, index.adj0, ep[:, None], ef=spec.ef, width=spec.width,
        banned=banned, n_keep=spec.n_keep, fused=fused,
    )
    n_scan = int((nd + res.n_dists).sum())
    if reranker is None:
        return res.ids[:, : spec.k], res.dists[:, : spec.k], n_scan, 0
    ids, dists, n_rr = rerank_topk(reranker, queries, res.ids, res.dists, spec.k)
    return ids, dists, n_scan, int(n_rr.sum())


def search_hnsw(
    index: HNSWIndex,
    queries: torch.Tensor,
    *,
    spec: SearchSpec,
    reranker=None,
    banned: torch.Tensor | None = None,
    fused: bool | None = None,
    max_layers: int | None = None,
) -> SearchResult:
    """Layered two-stage search of queries (Q, D) on the index's device.

    ``fused=False`` forces the unfused base-layer step (parity checks);
    ``max_layers`` searches a shallower prefix of the hierarchy (default:
    every layer built); queries run in blocks that bound the (Q, n) visited
    bitmap.
    """
    if spec.rerank != "none" and reranker is None:
        raise ValueError(f"spec.rerank={spec.rerank!r} needs a reranker")
    n_layers = index.adj_up.shape[0] + 1 if max_layers is None else max_layers
    n = index.adj0.shape[0]
    block = max(1, _VISITED_BUDGET // max(1, n + 1))
    ids, dists, ns, nr = [], [], 0, 0
    for s in range(0, queries.shape[0], block):
        i, d, a, b = _search_block(
            index, queries[s:s + block], banned, reranker, spec, fused, n_layers
        )
        ids.append(i)
        dists.append(d)
        ns += a
        nr += b
    return SearchResult(
        ids=torch.cat(ids), dists=torch.cat(dists), n_dists=ns + nr, n_scan=ns, n_rerank=nr
    )
