"""Shape-bucketed query runtime (reference: repro.serve.engine; DESIGN.md §9).

A serving loop that dispatches whatever query-block size arrives makes
every block a new shape. :class:`SearchEngine` fixes the shapes once:
incoming blocks are padded up to the next configured Q bucket (default
1 / 8 / 32), blocks larger than the top bucket are served in bucket-sized
chunks, and every (bucket × :class:`~repro_torch.graph.rerank.SearchSpec`)
key is warmed once (eagerly via :meth:`warmup`, else on first use).

What "compile" counts in the port: the reference traces one XLA program
per (bucket, spec) and again when the index's ``n`` changes, and ticks
``serve_engine_compiles_total`` at each trace. The port dispatches eagerly
(the search runs as PyTorch calls and the ``flash_beam`` kernel, with no
graph capture), so it keeps the reference's key table ``(bucket, spec, n)``
and ticks the same counter at the FIRST dispatch of each key — the same
count the reference's traces give for the same sequence of calls. A first
dispatch warms what eager dispatch has to warm: the kernels' loading, the
caching allocator's blocks at the key's shapes.

Telemetry is the reference's: per-call wall latency (p50/p99), QPS,
distance evaluations per query with the scan/rerank split, and the
compile-vs-cache-hit counters, all backed by the ``repro_torch.obs``
registry (``serve_engine_*`` series); the latency window is a bounded obs
histogram of ``latency_window`` calls.

The engine reads the index's graph per call, so in-place maintenance is
picked up at once; :meth:`refresh` re-syncs the tombstone mask (a bool
tensor on the index's device, or no mask when nothing is deleted — what
``AnnIndex.search`` passes). ``search(view=...)`` serves a pinned
copy-on-write :class:`~repro_torch.serve.handle.Generation` through the
same key table, ``refresh(index=new)`` rebinds the default index across a
flip, and ``warm_view`` warms a grown generation's keys off the request
path (the mutator thread).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.graph.hnsw import SearchResult, search_hnsw
from repro_torch.graph.rerank import SearchSpec, rerank_mode
from repro_torch.graph.vamana import search_flat_result

#: Default padded-shape buckets: singles, small coalesced blocks, full blocks.
DEFAULT_BUCKETS = (1, 8, 32)


class SearchEngine:
    """Long-lived search runtime over a built :class:`repro_torch.index.AnnIndex`.

    One engine serves one default :class:`SearchSpec`; keys are
    (Q-bucket × spec × n), so a per-call ``spec=`` override costs one warm
    dispatch per bucket on first use. Construct, :meth:`warmup`, then
    :meth:`search` arbitrary query blocks.
    """

    def __init__(
        self,
        index,
        *,
        k: int = 10,
        ef: int = 64,
        width: int = 1,
        rerank: bool | str = True,
        rerank_mult: int | None = None,
        spec: SearchSpec | None = None,
        q_buckets: tuple = DEFAULT_BUCKETS,
        latency_window: int = 4096,
    ):
        buckets = tuple(sorted({int(b) for b in q_buckets}))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"q_buckets must be positive ints, got {q_buckets}")
        self.index = index
        if spec is None:
            spec = SearchSpec(
                k=int(k), ef=int(ef), width=int(width),
                rerank=rerank_mode(rerank), rerank_mult=rerank_mult,
            )
        self.spec = spec
        self.q_buckets = buckets
        self._compiled: set = set()  # (bucket, spec, n) that have dispatched
        inst = str(obs.REGISTRY.next_instance())
        self._m_compiles = obs.counter("serve_engine_compiles_total", inst=inst)
        self._m_hits = obs.counter("serve_engine_cache_hits_total", inst=inst)
        self._m_calls = obs.counter("serve_engine_calls_total", inst=inst)
        self._m_queries = obs.counter("serve_engine_queries_total", inst=inst)
        self._n_blocks = 0         # padded-block dispatches
        self._n_padded = 0         # padded queries dispatched (>= real)
        self._dists = 0.0
        self._scan_dists = 0.0     # compact-code stage (split accounting)
        self._rerank_dists = 0.0   # second stage
        self._time_total = 0.0     # all-time busy seconds (for qps)
        self.latency_window = int(latency_window)
        self._lat = obs.histogram(
            "serve_engine_latency_seconds", window=self.latency_window,
            inst=inst,
        )
        self._bucket_hits = {b: 0 for b in buckets}
        self.refresh()

    # views of the pinned spec (the constructor's keyword form)
    @property
    def k(self) -> int:
        return self.spec.k

    @property
    def ef(self) -> int:
        return self.spec.ef

    @property
    def width(self) -> int:
        return self.spec.width

    @property
    def rerank(self) -> bool:
        return self.spec.rerank != "none"

    # ---- lifecycle ------------------------------------------------------

    def refresh(self, index=None) -> "SearchEngine":
        """Re-sync the tombstone mask with the index (call after
        ``delete``/``add``/``compact``). ``index=`` rebinds the engine to
        another index object (the generation-flip hand-off) and keeps the
        key table."""
        if index is not None:
            self.index = index
        dead = self.index.deleted_ids
        mask = np.zeros(self.index.n, bool)
        mask[dead] = True
        self._mask_n = self.index.n
        self._banned = torch.from_numpy(mask).to(self.index.device) if dead.size else None
        return self

    def warmup(self, *, specs: tuple = ()) -> "SearchEngine":
        """Dispatch every configured (bucket × spec) key now (off the
        request path), so steady-state serving starts at zero cold keys.
        ``specs`` pre-warms additional per-call override specs."""
        self._warm(self.index, None, (self.spec, *specs))
        return self

    def _warm(self, index, view, specs) -> None:
        """One dummy dispatch per (bucket × spec) key of ``index`` not yet
        warm."""
        d = int(index.data.shape[1])
        for sp in dict.fromkeys(specs):
            for b in self.q_buckets:
                if (b, sp, index.n) in self._compiled:
                    continue
                dummy = torch.zeros((b, d), dtype=torch.float32, device=index.device)
                self._dispatch(b, dummy, sp, view=view)

    # ---- the bucketed search path ---------------------------------------

    def _dispatch(
        self, bucket: int, queries_padded, spec: SearchSpec, *,
        record: bool = False, view=None,
    ) -> SearchResult:
        """One padded-bucket dispatch. ``view`` (anything with ``index``,
        ``banned`` and ``any_banned`` — a Generation) serves that pinned
        index instead of ``self.index`` through the same key table."""
        if view is None:
            index, banned = self.index, self._banned
        else:
            index = view.index
            banned = view.banned if view.any_banned else None
        key = (bucket, spec, index.n)
        hit = key in self._compiled
        if not hit:
            # the reference traces here (once per key); the port counts the
            # key's first dispatch
            self._m_compiles.inc()
        search = search_hnsw if index.layered else search_flat_result
        res = search(
            index.graph, queries_padded, spec=spec,
            reranker=index.reranker(spec.rerank), banned=banned,
        )
        self._compiled.add(key)
        if record and hit:
            self._m_hits.inc()
        return res

    def _bucket_for(self, q: int) -> int:
        for b in self.q_buckets:
            if q <= b:
                return b
        return self.q_buckets[-1]

    def padded_queries(self, q: int) -> int:
        """How many padded query slots a block of ``q`` real queries
        dispatches (chunking included) — the denominator for per-query
        cost accounting (the scheduler uses this)."""
        total, off = 0, 0
        while off < q:
            c = min(q - off, self.q_buckets[-1])
            total += self._bucket_for(c)
            off += c
        return total

    def is_warm(
        self, q: int, spec: SearchSpec | None = None, *, n: int | None = None
    ) -> bool:
        """Whether serving a block of ``q`` queries with ``spec`` against an
        index of ``n`` vectors (default: the bound index) would hit only
        warm keys — the scheduler's cold-dispatch meter."""
        spec = self.spec if spec is None else spec
        n = self.index.n if n is None else int(n)
        off = 0
        while off < q:
            c = min(q - off, self.q_buckets[-1])
            if (self._bucket_for(c), spec, n) not in self._compiled:
                return False
            off += c
        return True

    def warm_view(self, view, *, specs: tuple = ()) -> "SearchEngine":
        """Dispatch every not-yet-warm (bucket × spec) key of ``view``'s
        index — the generation-flip prepare hook, run on the mutator thread
        before the flip publishes. Same-``n`` generations (delete, compact)
        find every key warm and this is a no-op."""
        self._warm(view.index, view, (self.spec, *specs))
        return self

    # ---- serving --------------------------------------------------------

    def search(
        self, queries, *, spec: SearchSpec | None = None, record: bool = True,
        view=None,
    ) -> SearchResult:
        """Serve one query block (1D single query or (Q, d) batch).

        Pads Q up to the bucket shape (padding replicates the first query;
        its rows are sliced away), chunks blocks larger than the top bucket,
        and folds latency/cost into the telemetry. ``spec=`` overrides the
        engine default for this call. ``view=`` serves a pinned Generation
        instead of the bound index. The counts are Python ints, as
        ``AnnIndex.search`` returns them.
        """
        spec = self.spec if spec is None else spec
        index = self.index if view is None else view.index
        queries = torch.as_tensor(queries, dtype=torch.float32).to(index.device)
        single = queries.dim() == 1
        if single:
            queries = queries[None]
        q_total = int(queries.shape[0])
        if q_total == 0:
            raise ValueError("empty query block")
        if view is None and self._mask_n != self.index.n:
            # index grew since the last refresh(): a stale mask would not
            # cover the new ids
            self.refresh()
        t0 = obs.now()
        out_ids, out_dists, nd, n_scan, n_rerank = [], [], 0, 0, 0
        off = 0
        while off < q_total:
            q = min(q_total - off, self.q_buckets[-1])
            chunk = queries[off:off + q]
            bucket = self._bucket_for(q)
            if q < bucket:
                chunk = torch.cat([chunk, chunk[:1].expand(bucket - q, -1)])
            res = self._dispatch(bucket, chunk, spec, record=record, view=view)
            out_ids.append(res.ids[:q])
            out_dists.append(res.dists[:q])
            nd += res.n_dists  # host ints: the search has synced
            n_scan += res.n_scan
            n_rerank += res.n_rerank
            if record:
                self._n_blocks += 1
                self._n_padded += bucket
                self._bucket_hits[bucket] += 1
            off += q
        ids = out_ids[0] if len(out_ids) == 1 else torch.cat(out_ids)
        dists = out_dists[0] if len(out_dists) == 1 else torch.cat(out_dists)
        if record:
            elapsed = obs.now() - t0
            self._lat.observe(elapsed)
            self._time_total += elapsed
            self._m_calls.inc()
            self._m_queries.inc(q_total)
            self._dists += nd
            self._scan_dists += n_scan
            self._rerank_dists += n_rerank
        if single:
            ids, dists = ids[0], dists[0]
        return SearchResult(ids=ids, dists=dists, n_dists=nd, n_scan=n_scan, n_rerank=n_rerank)

    # ---- telemetry ------------------------------------------------------

    @property
    def n_compiles(self) -> int:
        return int(self._m_compiles.value)

    def stats(self) -> dict:
        """Serving telemetry since construction (warmup excluded).

        qps counts *real* queries (padding excluded); n_dists_per_query is
        averaged over padded queries; cache_hits are dispatches whose key
        was already warm. Latency percentiles cover the most recent
        ``latency_window`` calls."""
        p50, p99 = self._lat.pcts_ms()
        queries = int(self._m_queries.value)
        total = self._time_total
        return {
            "calls": int(self._m_calls.value),
            "blocks": self._n_blocks,
            "queries": queries,
            "padded_queries": self._n_padded,
            "compiles": int(self._m_compiles.value),
            "cache_hits": int(self._m_hits.value),
            "qps": queries / total if total > 0 else 0.0,
            "p50_ms": p50,
            "p99_ms": p99,
            "n_dists_per_query": (
                self._dists / self._n_padded if self._n_padded else 0.0
            ),
            "n_scan_per_query": (
                self._scan_dists / self._n_padded if self._n_padded else 0.0
            ),
            "n_rerank_per_query": (
                self._rerank_dists / self._n_padded if self._n_padded else 0.0
            ),
            "bucket_hits": dict(self._bucket_hits),
        }

    def reset_stats(self) -> "SearchEngine":
        """Zero the latency/throughput counters (the compile counter is
        kept: it tracks the engine's whole key history)."""
        self._m_calls.reset()
        self._m_hits.reset()
        self._m_queries.reset()
        self._n_blocks = self._n_padded = 0
        self._dists = self._scan_dists = self._rerank_dists = 0.0
        self._time_total = 0.0
        self._lat.reset()
        self._bucket_hits = {b: 0 for b in self.q_buckets}
        return self

    #: steady-state measurement alias (the obs-wide reset spelling).
    reset = reset_stats

    def __repr__(self) -> str:
        return (
            f"SearchEngine(index={self.index!r}, spec={self.spec}, "
            f"buckets={self.q_buckets}, compiles={self.n_compiles})"
        )
