"""Segmented index: S independent facades + a coordinator, in PyTorch
(reference: repro.graph.segmented.SegmentedAnnIndex).

Production vector databases shard a collection into segments, build each
segment's index on its own and fan queries out; a coordinator merges the
per-segment candidates. This is that serving form on one card:

  * global ids are stable insertion order across the collection; the
    coordinator's ``locate`` table maps an id to (segment, local id);
  * search fans out to every segment's scan half (``spec.scan_spec()``),
    on ``fanout_map``'s threads only when the segments span more than one
    device, and merges the union through
    ``merge_rerank_topk``: dedup by global id, one exact re-score on the
    collection's raw vectors, global top-k. Quantized sums are only
    comparable within one coder, so a cross-segment merge re-scores;
  * ``add`` routes each new vector to the segment with the nearest frozen
    centroid (``ops.nearest_centroid``, kernel ``csrc/l2_batch.cu``) and
    grows that segment in place; ``delete``/``compact`` map global ids to
    their segments.

The paper's own workload (the registry's ``flash-ann`` cells) runs the
reference's stacked programs, here on one card:

  * ``fit_shared_coder`` fits one Flash coder for every segment (an
    offline job);
  * ``build_segment`` encodes a segment and runs the incremental build
    (``hnsw.build_hnsw_jit``) over the unblocked ``FlashBackend``;
    ``build_segments_vmapped`` runs it segment after segment and stacks
    the results (``SegmentedIndexes``: a leading (S,) axis on every
    tensor);
  * ``search_segment`` searches one segment and offsets its ids;
    ``search_segments_local`` merges the S·k candidates of every segment
    into a global top-k (``jax.lax.top_k``'s order on ties).

The reference's ``shard_map`` forms of the last two run across ranks
(``launch.mesh``: one ``torch.distributed`` process a device):

  * ``make_segmented_build_fn``: each rank builds its own segments with
    ``build_segment`` on its device, then every tensor of the stack is
    gathered along the segment axes, so every rank holds the whole
    ``SegmentedIndexes``, bit-equal to ``build_segments_vmapped``;
  * ``make_segmented_search_fn``: each rank searches its one segment, the
    (Q, k) candidates are gathered axis by axis into (Q, S·k) and every
    rank takes the same global top-k (the coordinator).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import flash as fl
from repro_torch.graph.backends import FlashBackend
from repro_torch.graph.beam import INF
from repro_torch.graph.engine import BuildParams
from repro_torch.graph.hnsw import HNSWIndex, SearchResult, build_hnsw_jit, search_hnsw
from repro_torch.graph.index import AnnIndex
from repro_torch.graph.rerank import (
    ExactReranker,
    RawVectors,
    SearchSpec,
    merge_rerank_topk,
    rerank_mode,
)
from repro_torch.kernels import ops
from repro_torch.utils import resolve_device, topk_first

class SegmentedIndexes(NamedTuple):
    """Stacked per-segment indexes: every tensor of ``index`` has a leading
    (S,) axis (``entry`` is an (S,) int32 tensor), and its backend is one
    ``FlashBackend`` holding the shared coder and the (S, n_s, M) codes."""

    index: HNSWIndex

    @property
    def n_segments(self) -> int:
        return int(self.index.adj0.shape[0])

    def segment(self, s: int) -> HNSWIndex:
        """Segment ``s``'s index, as :func:`build_segment` returned it."""
        ix = self.index
        return HNSWIndex(
            adj0=ix.adj0[s], adj0_d=ix.adj0_d[s], adj_up=ix.adj_up[s], adj_up_d=ix.adj_up_d[s],
            levels=ix.levels[s], entry=int(ix.entry[s]),
            backend=FlashBackend(ix.backend.coder, ix.backend.codes[s]),
        )


def fit_shared_coder(seed: int, sample, *, d_f: int, m_f: int, l_f: int = 4, h: int = 8,
                     kmeans_iters: int = 25, device: str | torch.device = "cuda") -> fl.FlashCoder:
    """Offline: one Flash coder for all segments, fitted on ``sample``
    (``core.flash.fit_flash``; ``seed`` seeds its k-means as the
    reference's key does)."""
    return fl.fit_flash(sample, d_f=d_f, m_f=m_f, l_f=l_f, h=h, kmeans_iters=kmeans_iters,
                        seed=seed, device=device)


def build_segment(data_seg: torch.Tensor, coder: fl.FlashCoder, levels, entries, *,
                  params: BuildParams, stats: list | None = None) -> HNSWIndex:
    """One segment's build: encode ``data_seg`` (n_s, D), wrap the codes in
    the unblocked ``FlashBackend`` and run the incremental build
    (``build_hnsw_jit``) with the host plans ``levels`` / ``entries``
    (``sample_levels`` / ``prefix_entries``). Every segment runs this same
    program; ``params.width`` widens every segment's beam at once.
    ``stats`` (a list) receives the build's ``BuildStats``."""
    backend = FlashBackend(coder, fl.encode(coder, data_seg))
    index, st = build_hnsw_jit(data_seg, backend, levels, entries, params=params)
    if stats is not None:
        stats.append(st)
    return index


def build_segments_vmapped(data_segs: torch.Tensor, coder: fl.FlashCoder, levels, entries, *,
                           params: BuildParams, stats: list | None = None) -> SegmentedIndexes:
    """The reference's local form (a ``vmap`` over the segment axis of
    ``data_segs`` (S, n_s, D), with ``levels`` / ``entries`` (S, …)): on one
    card the segments build one after another, and the results stack.
    ``stats`` (a list) receives each segment's ``BuildStats`` in order."""
    built = [build_segment(data_segs[s], coder, np.asarray(levels[s]), np.asarray(entries[s]), params=params,
                           stats=stats)
             for s in range(data_segs.shape[0])]
    return SegmentedIndexes(index=_stacked_index(coder, _stack(built)))


#: the graph tensors of an ``HNSWIndex`` (``entry`` and the codes apart)
_GRAPH = ("adj0", "adj0_d", "adj_up", "adj_up_d", "levels")


def _stack(built: list) -> dict:
    """Per-segment ``HNSWIndex``es' tensors, entries and codes stacked
    along a new leading axis."""
    t = {f: torch.stack([getattr(b, f) for b in built]) for f in _GRAPH}
    t["entry"] = torch.tensor([b.entry for b in built], dtype=torch.int32, device=built[0].adj0.device)
    t["codes"] = torch.stack([b.backend.codes for b in built])
    return t


def _stacked_index(coder: fl.FlashCoder, t: dict) -> HNSWIndex:
    return HNSWIndex(**{f: t[f] for f in (*_GRAPH, "entry")}, backend=FlashBackend(coder, t["codes"]))


def _seg_axes(mesh, seg_axes) -> tuple[str, ...]:
    if mesh is None:
        raise ValueError("the mesh programs need a mesh (launch.mesh.make_segment_mesh); on one device "
                         "use build_segments_vmapped / search_segments_local")
    return tuple(a for a in seg_axes if a in mesh.axis_names)


def make_segmented_build_fn(mesh, *, params: BuildParams, seg_axes=("pod", "data")):
    """The mesh form of :func:`build_segments_vmapped` (the reference's
    ``shard_map`` program). Returns ``build(data_segs, coder, levels,
    entries)``, which every rank of ``mesh`` calls with the whole (S, n_s,
    D) stack and the (S, …) host plans. The rank at position p along the
    segment axes (row-major, the first axis major: where ``P(seg_axes)``
    puts it) builds segments [p·S/G, (p+1)·S/G) of the G positions with
    :func:`build_segment` on its device; ranks that differ only off those
    axes build the same ones. Each tensor is then gathered along the
    segment axes, and every rank returns the whole ``SegmentedIndexes`` on
    its device."""
    axes = _seg_axes(mesh, seg_axes)

    def build(data_segs: torch.Tensor, coder: fl.FlashCoder, levels, entries) -> SegmentedIndexes:
        s_total = int(data_segs.shape[0])
        width = math.prod(mesh.shape[a] for a in axes)
        if s_total % width:
            raise ValueError(f"{s_total} segments do not tile the {width} positions of the mesh axes {axes}")
        per, dev = s_total // width, mesh.device
        first = mesh.axis_index(axes) * per
        coder_dev = fl.FlashCoder(*(t.to(dev) for t in coder))
        own = _stack([build_segment(data_segs[s].to(dev), coder_dev, np.asarray(levels[s]),
                                    np.asarray(entries[s]), params=params)
                      for s in range(first, first + per)])
        return SegmentedIndexes(index=_stacked_index(coder_dev, {
            f: torch.cat(mesh.all_gather(t, axes)) for f, t in own.items()}))

    return build


def search_segment(index: HNSWIndex, queries: torch.Tensor, *, k: int, ef_search: int, id_offset: int,
                   max_layers: int | None = None, rerank_vectors: torch.Tensor | None = None):
    """One segment's search (W = 1): (global ids (Q, k) int32, dists).
    Local ids move by ``id_offset``; −1 stays −1. With ``rerank_vectors``
    (the segment's originals) the dists are exact squared L2, which a
    cross-segment merge needs: quantized sums compare only within a coder."""
    if rerank_vectors is None:
        spec, reranker = SearchSpec(k=k, ef=ef_search, rerank="none"), None
    else:
        spec, reranker = SearchSpec(k=k, ef=ef_search), ExactReranker(RawVectors(rerank_vectors))
    res = search_hnsw(index, queries, spec=spec, reranker=reranker, max_layers=max_layers)
    gids = torch.where(res.ids >= 0, res.ids + int(id_offset), -1).to(torch.int32)
    return gids, res.dists


def search_segments_local(seg: SegmentedIndexes, queries: torch.Tensor, seg_sizes, *, k: int, ef_search: int,
                          max_layers: int | None = None, seg_vectors: torch.Tensor | None = None):
    """Fan-out search of every segment and the coordinator's merge: the
    S·k candidates of each query, ordered segment-major as the reference
    lays them out, and their global top-k by distance (the lower position
    first on ties). Segment s's ids start at the sum of ``seg_sizes[:s]``.
    Returns (ids (Q, k) int32, dists (Q, k))."""
    offsets = np.concatenate([[0], np.cumsum(np.asarray(seg_sizes, np.int64))[:-1]])
    gids, dists = zip(*[
        search_segment(seg.segment(s), queries, k=k, ef_search=ef_search, id_offset=int(offsets[s]),
                       max_layers=max_layers, rerank_vectors=None if seg_vectors is None else seg_vectors[s])
        for s in range(seg.n_segments)
    ])
    all_ids, all_d = torch.cat(gids, dim=1), torch.cat(dists, dim=1)  # (Q, S·k)
    neg, pos = topk_first(-all_d, k)
    return all_ids.gather(1, pos), -neg


def make_segmented_search_fn(mesh, *, k: int, ef_search: int, max_layers: int | None = None,
                             seg_axes=("pod", "data")):
    """The mesh form of :func:`search_segments_local` (the reference's
    ``shard_map`` program). Returns ``search(index_stack, queries,
    id_offsets, seg_vectors)``, which every rank calls with the whole
    stack: the rank at position s along the segment axes searches segment
    s on its device (exact rerank on ``seg_vectors[s]``, ids moved by
    ``id_offsets[s]``); the (Q, k) ids and distances are gathered one axis
    after another, in ``seg_axes``' order, as the reference's loop of
    ``all_gather``s does, and every rank returns the same global top-k
    (ids (Q, k) int32, dists). One segment a position: S must equal the
    positions along the segment axes."""
    axes = _seg_axes(mesh, seg_axes)

    def search(index_stack: SegmentedIndexes, queries: torch.Tensor, id_offsets, seg_vectors: torch.Tensor):
        width = math.prod(mesh.shape[a] for a in axes)
        if index_stack.n_segments != width:
            raise ValueError(f"the search program takes one segment a position of the mesh axes {axes}: "
                             f"{index_stack.n_segments} segments, {width} positions")
        s, dev = mesh.axis_index(axes), mesh.device
        one = index_stack.segment(s)
        one = one._replace(backend=FlashBackend(fl.FlashCoder(*(t.to(dev) for t in one.backend.coder)),
                                                one.backend.codes.to(dev)),
                           **{f: getattr(one, f).to(dev) for f in _GRAPH})
        ids, d = search_segment(one, queries.to(dev), k=k, ef_search=ef_search,
                                id_offset=int(id_offsets[s]), max_layers=max_layers,
                                rerank_vectors=seg_vectors[s].to(dev))
        for ax in axes:
            ids = torch.cat(mesh.all_gather(ids, (ax,)), dim=1)
            d = torch.cat(mesh.all_gather(d, (ax,)), dim=1)
        neg, pos = topk_first(-d, k)
        return ids.gather(1, pos), -neg

    return search


class SegmentedAnnIndex:
    """S :class:`AnnIndex` segments on one device + the coordinator state:
    the frozen (S, D) routing table, the per-segment local→global id maps
    and the (N, 2) global→(segment, local) locator (host numpy)."""

    def __init__(self, segments, centroids, global_of, locate):
        self.segments = segments  # list[AnnIndex | None] (None = lost)
        self._centroids = centroids  # (S, D) float32 tensor (frozen)
        self._global_of = global_of  # list[np int64]: local -> global
        self._locate = locate  # np (N, 2): global -> (seg, local)
        self._raw_cache = None  # (N, D) rerank corpus, built lazily
        #: segments lost at restore: their ids stay allocated, never served
        self._quarantined = frozenset(s for s, seg in enumerate(segments) if seg is None)

    @classmethod
    def build(
        cls,
        data_segs,
        *,
        algo: str = "hnsw",
        backend: str = "flash_blocked",
        params: BuildParams | None = None,
        seed: int = 0,
        backend_kwargs: dict | None = None,
        strategy: str = "bulk",
        device: str | torch.device = "cuda",
        **algo_kwargs,
    ) -> "SegmentedAnnIndex":
        """data_segs: (S, n_s, D) array or an iterable of per-segment
        (n_s, D) arrays, built one at a time (segment s with seed
        ``seed + s``; ``algo_kwargs`` to every ``AnnIndex.build``); the
        routing table is the segments' means."""
        dev = resolve_device(device)
        segments, global_of, means = [], [], []
        next_gid = 0
        for s, seg_data in enumerate(data_segs):
            seg = AnnIndex.build(
                seg_data, algo=algo, backend=backend, params=params, seed=seed + s,
                backend_kwargs=backend_kwargs, strategy=strategy, device=dev, **algo_kwargs,
            )
            segments.append(seg)
            means.append(seg.data.mean(0).cpu().numpy())
            global_of.append(np.arange(next_gid, next_gid + seg.n, dtype=np.int64))
            next_gid += seg.n
        return cls.from_parts(segments, np.stack(means), global_of, device=dev)

    @classmethod
    def from_parts(cls, segments, centroids, global_of, *,
                   device: str | torch.device = "cuda") -> "SegmentedAnnIndex":
        """Assemble a collection from already-built segments and the routing
        state; ``global_of`` may be any partition of [0, N)."""
        dev = resolve_device(device)
        global_of = [np.asarray(g, np.int64) for g in global_of]
        n = sum(int(g.shape[0]) for g in global_of)
        locate = np.empty((n, 2), np.int64)
        for s, gids in enumerate(global_of):
            locate[gids, 0] = s
            locate[gids, 1] = np.arange(gids.shape[0])
        cent = torch.from_numpy(np.array(centroids, np.float32)).to(dev)
        return cls(segments, cent, global_of, locate)

    @classmethod
    def build_streaming(
        cls,
        source,
        *,
        n_segments: int,
        chunk_size: int = 65536,
        workers: int | None = None,
        mesh=None,
        workdir: str | None = None,
        snapshot_path: str | None = None,
        algo: str = "hnsw",
        backend: str = "flash_blocked",
        params: BuildParams | None = None,
        seed: int = 0,
        backend_kwargs: dict | None = None,
        strategy: str = "bulk",
        device: str | torch.device = "cuda",
        **algo_kwargs,
    ) -> "SegmentedAnnIndex":
        """Build from a chunked stream through the sharded pipeline:
        streaming nearest-centroid assignment, then the per-segment builds
        (inline; see :class:`repro_torch.graph.sharded.ShardedBuilder`)."""
        from repro_torch.graph.sharded import ShardConfig, ShardedBuilder

        builder = ShardedBuilder(
            ShardConfig(
                n_segments=n_segments, chunk_size=chunk_size, algo=algo,
                backend=backend, params=params, strategy=strategy,
                backend_kwargs=backend_kwargs, algo_kwargs=algo_kwargs, seed=seed,
            ),
            workers=workers, mesh=mesh, workdir=workdir, device=device,
        )
        return builder.build(source, snapshot_path=snapshot_path).index

    # ---- introspection --------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._centroids.device

    @property
    def n(self) -> int:
        return int(self._locate.shape[0])

    def __len__(self) -> int:
        return self.n

    @property
    def n_active(self) -> int:
        return sum(s.n_active for s in self.segments if s is not None)

    @property
    def quarantined(self) -> frozenset:
        """Segments lost at restore (empty when healthy)."""
        return self._quarantined

    def health(self) -> dict:
        """Which segments are quarantined and how many ids that strands."""
        lost = sum(len(self._global_of[s]) for s in self._quarantined)
        return {
            "healthy": not self._quarantined,
            "degraded": bool(self._quarantined),
            "n": self.n,
            "n_active": self.n_active,
            "n_segments": len(self.segments),
            "quarantined": sorted(self._quarantined),
            "lost_ids": int(lost),
            "lost_fraction": float(lost) / self.n if self.n else 0.0,
        }

    @property
    def centroids(self) -> torch.Tensor:
        """(S, D) frozen routing table."""
        return self._centroids

    def global_ids(self, s: int) -> np.ndarray:
        """Copy of segment ``s``'s local→global id map."""
        return np.asarray(self._global_of[s], np.int64).copy()

    @property
    def raw_vectors(self) -> torch.Tensor:
        """(N, D) raw vectors in global id order — the collection's rerank
        corpus, assembled on the device from the segments' tables (zeros
        for quarantined segments' rows, which search never surfaces);
        rebuilt after ``add``."""
        if self._raw_cache is None or int(self._raw_cache.shape[0]) != self.n:
            d = int(self._centroids.shape[1])
            out = torch.zeros((self.n, d), dtype=torch.float32, device=self.device)
            for s, seg in enumerate(self.segments):
                if seg is not None:
                    out[torch.from_numpy(self._global_of[s]).to(self.device)] = seg.data
            self._raw_cache = out
        return self._raw_cache

    def reranker(self, mode: str = "exact"):
        """The collection's second stage (None for "none"): exact squared
        L2 over :attr:`raw_vectors`. "reconstruct" decodes per coder, so a
        cross-segment merge rejects it."""
        mode = rerank_mode(mode)
        if mode == "none":
            return None
        if mode == "reconstruct":
            raise ValueError(
                "reconstruct rerank is per-coder; a cross-segment merge "
                "needs rerank='exact' (or 'none' for single-coder fleets)"
            )
        return ExactReranker(RawVectors(self.raw_vectors))

    # ---- state ----------------------------------------------------------

    def export_state(self) -> tuple[dict, dict, list]:
        """(meta, coordinator arrays, per-segment ``AnnIndex.export_state``
        tuples), the reference's layout."""
        if self._quarantined:
            raise RuntimeError(
                f"cannot export a degraded collection: segments "
                f"{sorted(self._quarantined)} are quarantined"
            )
        meta = {"n_segments": len(self.segments)}
        arrays = {
            "centroids": self._centroids.cpu().numpy(),
            "locate": self._locate.copy(),
        }
        for s, gids in enumerate(self._global_of):
            arrays[f"global_of.{s}"] = np.asarray(gids, np.int64)
        return meta, arrays, [seg.export_state() for seg in self.segments]

    @classmethod
    def restore(cls, meta: dict, arrays: dict, segments: list, *,
                device: str | torch.device = "cuda") -> "SegmentedAnnIndex":
        """Inverse of :meth:`export_state` (either package's) on ``device``;
        a ``None`` segment restores as quarantined."""
        dev = resolve_device(device)
        segs = [
            None if st is None else AnnIndex.restore(st[0], st[1], device=dev)
            for st in segments
        ]
        global_of = [
            np.asarray(arrays[f"global_of.{s}"], np.int64)
            for s in range(int(meta["n_segments"]))
        ]
        cent = torch.from_numpy(np.array(arrays["centroids"], np.float32)).to(dev)
        return cls(segs, cent, global_of, np.asarray(arrays["locate"], np.int64).copy())

    # ---- search ---------------------------------------------------------

    def search(
        self, queries, k: int = 10, *, ef: int = 64, width: int = 1,
        rerank: bool | str = True, rerank_mult: int | None = None,
        spec: SearchSpec | None = None, fanout: bool | None = None,
    ) -> SearchResult:
        """Fan out to every live segment, merge the global top-k.

        Each segment runs the scan half only (``spec.scan_spec()``); the
        coordinator dedups the union by global id, re-scores it once and
        takes the top k (``merge_rerank_topk``). ``fanout=True`` runs the
        segment scans on the fan-out threads, ``fanout=False`` in a loop;
        the default takes the threads only when the live segments lie on
        more than one device (on one card every thread enqueues on the same
        stream, and the loop is faster). Results are merged positionally and
        are equal either way.
        """
        from repro_torch.graph.sharded import fanout_map

        dev = self.device
        queries = torch.as_tensor(queries, dtype=torch.float32).to(dev)
        if spec is None:
            spec = SearchSpec(k=k, ef=ef, width=width, rerank=rerank_mode(rerank),
                              rerank_mult=rerank_mult)
        reranker = self.reranker(spec.rerank)  # fail fast on bad modes
        scan = spec.scan_spec()
        live = [(s, seg) for s, seg in enumerate(self.segments) if seg is not None]

        def scan_one(item):
            s, seg = item
            res = seg.search(queries, spec=scan)
            gids = torch.from_numpy(self._global_of[s].astype(np.int32)).to(dev)
            ok = res.ids >= 0
            ids = torch.where(ok, gids[res.ids.clamp_min(0).long()], -1)
            return ids, torch.where(ok, res.dists, INF), res.n_scan

        if fanout is None:
            fanout = len({seg.device for _, seg in live}) > 1
        results = fanout_map(scan_one, live, parallel=fanout)
        n_scan = sum(int(r[2]) for r in results)
        cat_ids = torch.cat([r[0] for r in results], 1)  # (Q, S·n_keep)
        cat_d = torch.cat([r[1] for r in results], 1)
        ids, dists, n_rerank = merge_rerank_topk(reranker, queries, cat_ids, cat_d, spec.k)
        return SearchResult(
            ids=ids.to(torch.int32), dists=dists, n_dists=n_scan + n_rerank,
            n_scan=n_scan, n_rerank=n_rerank,
        )

    # ---- maintenance ----------------------------------------------------

    def add(self, new_vectors) -> np.ndarray:
        """Route each new vector to the nearest-centroid segment (never a
        quarantined one) and grow that segment in place. Returns the global
        ids assigned, in input order."""
        new = torch.as_tensor(new_vectors, dtype=torch.float32).to(self.device)
        if new.dim() == 1:
            new = new[None]
        banned = None
        if self._quarantined:
            banned = torch.zeros(len(self.segments), dtype=torch.bool, device=self.device)
            banned[sorted(self._quarantined)] = True
        route, _ = ops.nearest_centroid(new, self._centroids, banned=banned)
        route = route.cpu().numpy()
        m = int(new.shape[0])
        gids = self.n + np.arange(m, dtype=np.int64)
        new_locate = np.empty((m, 2), np.int64)
        self._raw_cache = None  # the collection's rerank corpus grows
        for s, seg in enumerate(self.segments):
            rows = np.nonzero(route == s)[0]
            if rows.size == 0:
                continue
            local0 = seg.n
            seg.add(new[torch.from_numpy(rows).to(self.device)])
            self._global_of[s] = np.concatenate([self._global_of[s], gids[rows]])
            new_locate[rows, 0] = s
            new_locate[rows, 1] = local0 + np.arange(rows.size)
        self._locate = np.concatenate([self._locate, new_locate])
        return gids

    def delete(self, global_ids) -> int:
        """Tombstone by global id; returns the number newly tombstoned."""
        gids = np.atleast_1d(np.asarray(global_ids, np.int64))
        if gids.size == 0:
            return 0
        if gids.min() < 0 or gids.max() >= self.n:
            raise IndexError(
                f"global ids must be in [0, {self.n}); got [{gids.min()}, {gids.max()}]"
            )
        n_new = 0
        loc = self._locate[gids]
        for s, seg in enumerate(self.segments):
            if seg is None:
                continue  # id already unreachable
            local = loc[loc[:, 0] == s, 1]
            if local.size:
                n_new += seg.delete(local)
        return n_new

    def compact(self) -> None:
        """Compact every segment (purge + rewire, ``AnnIndex.compact``)."""
        for seg in self.segments:
            if seg is not None:
                seg.compact()
