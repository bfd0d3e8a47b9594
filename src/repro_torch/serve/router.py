"""Segmented serving: centroid-routed fan-out + shared rerank merge
(reference: repro.serve.router; DESIGN.md §9, §11).

``SegmentedAnnIndex.search`` fans every query to every segment — correct,
but at serving time most segments can't contain a query's neighbors.
:class:`SegmentRouter` probes only the ``n_probe`` nearest build-time
segment centroids per query (the same routing table ``add`` uses for
growth), batches each segment's routed queries through that segment's own
bucketed :class:`~repro_torch.serve.engine.SearchEngine`, and merges the
candidates into a global top-k.

Merge rule (DESIGN.md §11): per-segment engines run the *scan* half of the
router's spec only (``spec.scan_spec()`` — quantized candidate supersets,
no local rerank), and the merge is the one shared second stage,
:func:`repro_torch.graph.rerank.merge_rerank_topk`: dedup by global id, one
collection-level re-score, global top-k. Quantized sums never cross the
segment boundary, and a global id surfaced by two probed segments
(replicated deployments, overlapping probes) is scored exactly once.
``n_probe = S`` reproduces the full fan-out semantics; smaller ``n_probe``
trades recall for fewer segment dispatches — the standard IVF-style
serving knob.

Routing stays the reference's float64 numpy product over the frozen
centroids, not ``ops.nearest_centroid``: the float32 kernel may order a
near tie otherwise, and the probe sets must be the reference's. The
candidates are assembled on the host and merged on the collection's
device; the result's ids and distances are tensors there, as
``SegmentedAnnIndex.search`` returns them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.hnsw import SearchResult
from repro_torch.graph.rerank import SearchSpec, merge_rerank_topk, rerank_mode
from repro_torch.graph.sharded import fanout_map
from repro_torch.serve.engine import DEFAULT_BUCKETS, SearchEngine


class SegmentRouter:
    """Serving coordinator over a :class:`repro_torch.graph.segmented.SegmentedAnnIndex`.

    Owns one :class:`SearchEngine` per segment (shared shape buckets,
    shared scan spec) plus the routing logic and the collection-level
    reranker the merge re-scores through. ``warmup()`` warms every
    segment × bucket key.
    """

    def __init__(
        self,
        seg_index,
        *,
        n_probe: int = 1,
        k: int = 10,
        ef: int = 64,
        width: int = 1,
        rerank: bool | str = True,
        rerank_mult: int | None = None,
        spec: SearchSpec | None = None,
        q_buckets: tuple = DEFAULT_BUCKETS,
        fanout: bool = True,
    ):
        n_seg = len(seg_index.segments)
        if not 1 <= n_probe <= n_seg:
            raise ValueError(
                f"n_probe must be in [1, {n_seg}] for {n_seg} segments, "
                f"got {n_probe}"
            )
        self.seg_index = seg_index
        self.n_probe = int(n_probe)
        if spec is None:
            spec = SearchSpec(
                k=int(k), ef=int(ef), width=int(width),
                rerank=rerank_mode(rerank), rerank_mult=rerank_mult,
            )
        self.spec = spec
        self.k = spec.k
        # segments generate candidates; the router owns the second stage.
        # Validate (and for exact rerank, pre-build) the collection-level
        # reranker now — an unsupported mode must fail here, not after a
        # search has already paid the full per-segment scan fan-out.
        seg_index.reranker(spec.rerank)
        self._scan_spec = spec.scan_spec()
        self.engines = [
            SearchEngine(seg, spec=self._scan_spec, q_buckets=q_buckets)
            for seg in seg_index.segments
        ]
        self._centroids = _host_f64(seg_index.centroids)
        #: dispatch the probed segment scans on the shared fan-out thread
        #: pool instead of a sequential loop; results are identical either
        #: way
        self.fanout = bool(fanout)

    def warmup(self) -> "SegmentRouter":
        for engine in self.engines:
            engine.warmup()
        return self

    def refresh(self, seg_index=None) -> "SegmentRouter":
        """Re-sync every segment engine after maintenance on the index.

        ``seg_index=`` rebinds the router to a different
        ``SegmentedAnnIndex`` object — the copy-on-write flip path: a
        mutator builds the next collection version privately, then swaps it
        in here without dropping any segment engine's warm keys (segment
        count must match; grown segments warm only their own keys)."""
        if seg_index is not None:
            if len(seg_index.segments) != len(self.engines):
                raise ValueError(
                    f"segment count changed: router has {len(self.engines)} "
                    f"engines, new index has {len(seg_index.segments)} "
                    "segments; build a new SegmentRouter instead"
                )
            self.seg_index = seg_index
            self._centroids = _host_f64(seg_index.centroids)
            seg_index.reranker(self.spec.rerank)
            for engine, seg in zip(self.engines, seg_index.segments):
                engine.refresh(index=seg)
            return self
        for engine in self.engines:
            engine.refresh()
        return self

    def route(self, queries) -> np.ndarray:
        """(Q, n_probe) segment ids, nearest build-time centroid first."""
        q = np.asarray(queries, np.float64)
        d2 = ((q[:, None, :] - self._centroids[None, :, :]) ** 2).sum(axis=-1)
        if self.n_probe == 1:
            return np.argmin(d2, axis=1)[:, None]
        return np.argsort(d2, axis=1, kind="stable")[:, : self.n_probe]

    def search(self, queries, k: int | None = None) -> SearchResult:
        """Fan a block out across probed segments, merge global top-k.

        Returns a ``SearchResult`` with *global* ids (−1 padding where a
        probe set yields fewer than k candidates), distances on the
        reranker scale (exact squared L2 by default), both tensors on the
        collection's device, and the split scan/rerank cost counters
        (ints) summed over the probed segments and the merge."""
        if isinstance(queries, torch.Tensor):
            queries = queries.cpu().numpy()
        queries = np.asarray(queries, np.float32)
        single = queries.ndim == 1
        if single:
            queries = queries[None]
        k = self.k if k is None else int(k)
        if k > self.k:
            raise ValueError(
                f"k={k} exceeds the router's configured k={self.k}"
            )
        n_q = queries.shape[0]
        probe = self.route(queries)
        n_keep = self._scan_spec.k  # candidates per probed segment
        width = self.n_probe * n_keep
        cand_ids = np.full((n_q, width), -1, np.int32)
        cand_d = np.full((n_q, width), np.inf, np.float32)
        # one dispatch over the probed segments: each routed sub-batch runs
        # on its segment's engine (on the shared fan-out thread pool, or a
        # loop) and the merge below stays sequential and positional, so
        # results match the loop form exactly
        hit_rows = []
        for s in range(len(self.engines)):
            rows = np.nonzero((probe == s).any(axis=1))[0]
            if rows.size:
                hit_rows.append((s, rows))

        def scan_one(item):
            s, rows = item
            return self.engines[s].search(queries[rows])

        fan = fanout_map(scan_one, hit_rows, parallel=self.fanout)
        n_scan = 0
        for (s, rows), res in zip(hit_rows, fan):
            n_scan += res.n_scan
            gids = self.seg_index.global_ids(s)
            ids = res.ids.cpu().numpy()
            dists = res.dists.cpu().numpy()
            # probe slot of segment s for each routed query (fancy indexing
            # copies, so write into the sub-block and assign it back)
            slot = np.argmax(probe[rows] == s, axis=1)
            cols = slot[:, None] * n_keep + np.arange(n_keep)[None, :]
            valid = ids >= 0
            sub_ids, sub_d = cand_ids[rows], cand_d[rows]
            np.put_along_axis(
                sub_ids, cols,
                np.where(valid, gids[np.maximum(ids, 0)], -1).astype(np.int32),
                axis=1,
            )
            np.put_along_axis(
                sub_d, cols, np.where(valid, dists, np.inf), axis=1
            )
            cand_ids[rows], cand_d[rows] = sub_ids, sub_d
        # the one shared second stage, on the collection's device. The
        # reranker is re-derived per call: seg_index.add() grows the
        # collection rerank corpus, and a captured table would miss the new
        # global ids.
        dev = self.seg_index.device
        ids, dists, n_rerank = merge_rerank_topk(
            self.seg_index.reranker(self.spec.rerank),
            torch.from_numpy(queries).to(dev), torch.from_numpy(cand_ids).to(dev),
            torch.from_numpy(cand_d).to(dev), k,
        )
        ids = ids.to(torch.int32)
        if single:
            ids, dists = ids[0], dists[0]
        return SearchResult(
            ids=ids, dists=dists, n_dists=n_scan + n_rerank,
            n_scan=n_scan, n_rerank=n_rerank,
        )

    def stats(self) -> dict:
        """Aggregate per-segment engine telemetry."""
        per = [e.stats() for e in self.engines]
        return {
            "segments": len(self.engines),
            "n_probe": self.n_probe,
            "fanout": self.fanout,
            "compiles": sum(p["compiles"] for p in per),
            "queries": sum(p["queries"] for p in per),
            "per_segment": per,
        }


def _host_f64(t) -> np.ndarray:
    """The routing table as float64 numpy (the reference's routing dtype)."""
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    return np.asarray(t, np.float64)
