"""`AnnIndex` — the index facade of the port (reference: repro.graph.index).

    index = AnnIndex.build(data, algo="hnsw", backend="flash_blocked")
    res   = index.search(queries, k=10, ef=64)        # exact rerank
    index.add(new_vectors)    # grow the frozen graph: more insert batches
    index.delete(ids)         # tombstone: traversable, never returned
    index.compact()           # purge tombstones, re-insert the vertices
                              # that lost a neighbor
    meta, arrays = index.export_state()               # the reference's format
    index = AnnIndex.restore(meta, arrays)            # either package's state

One registry (:func:`register_algo`, :func:`algos`) fronts every graph
algorithm — ``hnsw`` (layered), ``vamana`` and ``nsg`` (flat: one layer, a
0-d medoid entry) — over every backend kind (``graph.backends.KINDS``),
built with ``strategy="bulk"`` or ``"incremental"``. Search, maintenance,
``clone`` and ``export_state``/``restore`` follow the reference's
``layered`` branches (``repro_torch.serve.snapshot`` puts the state on
disk). The state uses exactly the reference's ``(meta, arrays)`` layout,
so an index built by the JAX package restores here and searches
identically, and the reverse.

Maintenance is the reference's (DESIGN.md §8; a flat graph inserts as a
one-layer build with a zero-length upper stack): ``add`` runs the new
vertices through ``BuildEngine.insert_batch`` as more batches of the build
program (the backend grows through ``backend.extend``, the blocked mirror's
new rows fill in as edges commit); ``compact`` purges tombstoned ids from
every row on the host (``_purge_rows``), resyncs the mirror and re-inserts
every live vertex that lost a neighbor. With the same state and inputs the
graph, levels, entry, mirror and ``n_dists`` come out bit-equal.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.graph import backends as bk
from repro_torch.graph.engine import (
    BuildEngine,
    BuildParams,
    BuildStats,
    batch_schedule,
    prefix_entries,
    run_insert_schedule,
    sample_levels,
)
from repro_torch.graph.hnsw import HNSWIndex, SearchResult, build_hnsw, search_hnsw
from repro_torch.graph.nsg import build_nsg_stats
from repro_torch.graph.rerank import SearchSpec, make_reranker, rerank_mode
from repro_torch.graph.vamana import FlatIndex, build_vamana, search_flat_result
from repro_torch.utils import resolve_device, sync

__all__ = ["AlgoSpec", "AnnIndex", "SearchResult", "SearchSpec", "algos", "register_algo"]


# ---------------------------------------------------------------------------
# Algorithm registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    """One pluggable graph algorithm.

    builder(data, backend, params, seed, *, strategy, seconds, **algo_kwargs)
    -> (graph, stats): ``graph`` an HNSWIndex (layered) or a FlatIndex,
    ``stats`` a BuildStats or None; ``seconds`` collects phase times.
    ``layered`` picks the search routine and whether added vectors draw
    levels.
    """

    name: str
    layered: bool
    default_params: BuildParams
    builder: Callable[..., tuple]


_REGISTRY: dict[str, AlgoSpec] = {}


def register_algo(spec: AlgoSpec) -> AlgoSpec:
    """Register (or replace) an algorithm; returns the spec."""
    _REGISTRY[spec.name] = spec
    return spec


def algos() -> tuple[str, ...]:
    """Registered algorithm names, in registration order."""
    return tuple(_REGISTRY)


def _spec_of(algo: str) -> AlgoSpec:
    spec = _REGISTRY.get(algo)
    if spec is None:
        raise ValueError(f"unknown algo {algo!r}; registered: {', '.join(algos())}")
    return spec


def _build_hnsw_adapter(data, backend, params, seed, *, strategy="incremental", seconds=None,
                        levels=None):
    return build_hnsw(data, backend, params=params, seed=seed, levels=levels, strategy=strategy,
                      seconds=seconds)


def _build_vamana_adapter(data, backend, params, seed, *, strategy="incremental", seconds=None,
                          two_pass=True):
    # seed steers only the bulk pools; the incremental schedule is fixed
    return build_vamana(data, backend, params=params, two_pass=two_pass, strategy=strategy,
                        seed=seed, seconds=seconds)


def _build_nsg_adapter(data, backend, params, seed, *, strategy="incremental", seconds=None,
                       knn_k=16):
    index, _, stats = build_nsg_stats(data, backend, params=params, knn_k=knn_k, strategy=strategy,
                                      seed=seed, seconds=seconds)
    return index, stats


register_algo(AlgoSpec(name="hnsw", layered=True, default_params=BuildParams(),
                       builder=_build_hnsw_adapter))
register_algo(AlgoSpec(name="vamana", layered=False, default_params=BuildParams(alpha=1.2),
                       builder=_build_vamana_adapter))
register_algo(AlgoSpec(name="nsg", layered=False, default_params=BuildParams(),
                       builder=_build_nsg_adapter))

#: exact type -> make_backend kind, for prebuilt backend instances (a
#: subclass lookup would file FlashBlockedBackend under "flash")
_KIND_OF_TYPE: dict[type, str] = {
    bk.FP32Backend: "fp32",
    bk.PCABackend: "pca",
    bk.SQBackend: "sq",
    bk.PQBackend: "pq",
    bk.FlashBackend: "flash",
    bk.FlashBlockedBackend: "flash_blocked",
}


def _record_build(sp, stats: BuildStats | None) -> None:
    """Fold a finished build's cost into its span and the per-phase
    ``build_dists_total`` counters (obs-enabled paths only; ``sp`` is the
    null span otherwise)."""
    if stats is None or not obs.enabled():
        return
    sp.add_cost(stats.n_dists, stats.n_hops)
    phases = stats.phase_dict()
    if phases is not None:
        sp.set(phases=phases)
        for name, v in phases.items():
            if v:
                obs.tick("build_dists_total", n=float(v), phase=name)


def _tensor(x, dev, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device=dev, dtype=dtype) if dtype is not None else t.to(dev)


def _purge_rows(adj: np.ndarray, adj_d: np.ndarray, dead: np.ndarray):
    """Drop dead ids from every row (survivors shift left, order kept) and
    clear dead vertices' own rows. Returns (adj', adj_d', affected), where
    affected marks live rows that lost at least one neighbor."""
    keep = (adj >= 0) & ~dead[np.maximum(adj, 0)]
    affected = ((adj >= 0) & ~keep).any(axis=1) & ~dead
    order = np.argsort(~keep, axis=1, kind="stable")  # kept slots first
    adj2 = np.take_along_axis(np.where(keep, adj, -1), order, axis=1)
    adj_d2 = np.take_along_axis(np.where(keep, adj_d, np.inf), order, axis=1)
    adj2[dead] = -1
    adj_d2[dead] = np.inf
    return adj2, adj_d2.astype(np.float32), affected


def _schedule(ids: np.ndarray, batch: int, dev):
    """(nb, P) id batches and mask on ``dev`` (the engine's host padder)."""
    ids_p, mask = batch_schedule(ids, batch)
    return torch.from_numpy(ids_p).to(dev), torch.from_numpy(mask).to(dev)


class AnnIndex:
    """One index API over every registered algorithm and backend, on one
    device. Ids are insertion-order positions; ``data`` is the rerank
    corpus."""

    def __init__(self, *, spec: AlgoSpec, params, graph, data, backend_kind, seed,
                 stats=None, strategy="bulk"):
        self._spec = spec
        self.params = params
        self._graph = graph
        self._data = data
        self.backend_kind = backend_kind
        self.build_strategy = strategy
        self._seed = seed
        self._n_adds = 0
        self._tombs = np.zeros(int(data.shape[0]), bool)
        self._retired = np.zeros(int(data.shape[0]), bool)
        self.last_stats = stats

    @classmethod
    def build(
        cls,
        data,
        *,
        algo: str = "hnsw",
        backend: str | Any = "flash_blocked",
        params: BuildParams | None = None,
        seed: int = 0,
        backend_kwargs: dict | None = None,
        strategy: str = "bulk",
        device: str | torch.device = "cuda",
        **algo_kwargs,
    ) -> "AnnIndex":
        """Build an index over ``data`` (n, D) on ``device``.

        algo      one of :func:`algos` (``hnsw`` | ``vamana`` | ``nsg``).
        backend   a ``graph.backends.KINDS`` name (the coder is fitted on
                  ``data`` with ``backend_kwargs``, k-means seeded by
                  ``seed``) or a prebuilt backend instance.
        params    BuildParams; default the algorithm's registered set.
        algo_kwargs  to the builder (``knn_k`` for nsg, ``two_pass`` for
                  vamana, ``levels`` for hnsw).
        ``last_stats.seconds`` holds the wall time of each build phase.
        """
        dev = resolve_device(device)
        spec = _spec_of(algo)
        if strategy not in ("bulk", "incremental"):
            raise ValueError(f"unknown build strategy {strategy!r}; valid: 'bulk', 'incremental'")
        params = spec.default_params if params is None else params
        data = _tensor(data, dev, torch.float32)
        seconds: dict = {}
        if isinstance(backend, str):
            if backend not in bk.KINDS:
                raise ValueError(
                    f"unknown backend kind {backend!r}; valid kinds: {', '.join(bk.KINDS)}"
                )
            kw = dict(backend_kwargs or {})
            if backend == "flash_blocked":
                kw.setdefault("r_for_blocked", params.r_base)
            sync(dev)
            t0 = time.perf_counter()
            be = bk.make_backend(backend, data, seed=seed, device=dev, **kw)
            sync(dev)
            seconds["coder_fit"] = time.perf_counter() - t0
            kind = backend
        else:
            if backend_kwargs:
                raise ValueError(
                    "backend_kwargs only apply when backend is a kind string; "
                    "got a prebuilt backend instance"
                )
            be = backend
            kind = _KIND_OF_TYPE.get(type(backend), "custom")
        with obs.span("build", algo=algo, strategy=strategy, backend=kind,
                      n=int(data.shape[0])) as sp:
            graph, stats = spec.builder(
                data, be, params, seed, strategy=strategy, seconds=seconds, **algo_kwargs
            )
            _record_build(sp, stats)
        return cls(spec=spec, params=params, graph=graph, data=data, backend_kind=kind,
                   seed=seed, stats=stats, strategy=strategy)

    @classmethod
    def from_graph(
        cls,
        graph,
        data,
        *,
        algo: str = "hnsw",
        params: BuildParams | None = None,
        backend_kind: str = "flash",
        seed: int = 0,
        stats: BuildStats | None = None,
        strategy: str = "incremental",
        device: str | torch.device = "cuda",
    ) -> "AnnIndex":
        """Wrap an already-built graph (an ``HNSWIndex`` from ``build_hnsw``
        for a layered algorithm, a ``FlatIndex`` for a flat one) in the
        facade on ``device``, without refitting or rebuilding; ``data`` is
        the raw vectors in id order (the rerank corpus). A graph on another
        device is moved there (its backend through its state)."""
        dev = resolve_device(device)
        spec = _spec_of(algo)
        want = HNSWIndex if spec.layered else FlatIndex
        if not isinstance(graph, want):
            raise ValueError(
                f"algo {algo!r} is {'layered' if spec.layered else 'flat'} and takes a "
                f"{want.__name__}, got a {type(graph).__name__}"
            )
        if graph.backend.device.type != dev.type:
            be = graph.backend
            moved = {f: t.to(dev) for f, t in graph._asdict().items() if isinstance(t, torch.Tensor)}
            graph = graph._replace(backend=type(be).from_state(be.state_dict(), device=dev), **moved)
        return cls(spec=spec, params=spec.default_params if params is None else params, graph=graph,
                   data=_tensor(data, dev, torch.float32), backend_kind=backend_kind,
                   seed=seed, stats=stats, strategy=strategy)

    # ---- introspection --------------------------------------------------

    @property
    def algo(self) -> str:
        return self._spec.name

    @property
    def layered(self) -> bool:
        """Whether the graph is layered (HNSW) or flat (Vamana/NSG)."""
        return self._spec.layered

    @property
    def graph(self):
        """The algorithm's graph (HNSWIndex or FlatIndex)."""
        return self._graph

    @property
    def backend(self):
        return self._graph.backend

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @property
    def device(self) -> torch.device:
        return self._data.device

    @property
    def n(self) -> int:
        """Id slots ever allocated (tombstoned and retired included)."""
        return int(self._data.shape[0])

    @property
    def n_active(self) -> int:
        return int(self.n - (self._tombs | self._retired).sum())

    @property
    def tombstones(self) -> np.ndarray:
        """Copy of the (n,) tombstone mask (True = deleted, not compacted)."""
        return self._tombs.copy()

    @property
    def deleted_ids(self) -> np.ndarray:
        return np.nonzero(self._tombs)[0]

    def health(self) -> dict:
        """The degradation surface shared with ``SegmentedAnnIndex``: a single
        index has no parts to quarantine, so it is healthy once loaded."""
        return {"healthy": True, "degraded": False, "n": self.n, "n_active": self.n_active}

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        return (
            f"AnnIndex(algo={self.algo!r}, backend={self.backend_kind!r}, n={self.n}, "
            f"active={self.n_active}, device={self.device})"
        )

    # ---- search ---------------------------------------------------------

    def reranker(self, mode: str = "exact"):
        return make_reranker(mode, backend=self.backend, raw_vectors=self._data)

    def search(
        self,
        queries,
        k: int = 10,
        *,
        ef: int = 64,
        width: int = 1,
        rerank: bool | str = True,
        rerank_mult: int | None = None,
        spec: SearchSpec | None = None,
        fused: bool | None = None,
    ) -> SearchResult:
        """Batched top-k search: quantized beam scan + second stage.

        ``rerank`` True/"exact" re-scores on raw vectors, False/"none"
        passes scan distances through, "reconstruct" re-scores on the
        coder's decoded vectors. ``fused=False`` forces the unfused
        base-layer step (the parity check against the fused kernel).
        """
        queries = _tensor(queries, self.device, torch.float32)
        single = queries.dim() == 1
        if single:
            queries = queries[None]
        if spec is None:
            spec = SearchSpec(k=k, ef=ef, width=width, rerank=rerank_mode(rerank),
                              rerank_mult=rerank_mult)
        banned = torch.from_numpy(self._tombs).to(self.device) if self._tombs.any() else None
        search = search_hnsw if self._spec.layered else search_flat_result
        res = search(
            self._graph, queries, spec=spec, reranker=self.reranker(spec.rerank),
            banned=banned, fused=fused,
        )
        if single:
            res = res._replace(ids=res.ids[0], dists=res.dists[0])
        return res

    # ---- state ----------------------------------------------------------

    def export_state(self) -> tuple[dict, dict]:
        """``(meta, arrays)`` in the reference's layout: JSON meta and a flat
        dict of numpy arrays incl. the ``backend.*`` dotted keys."""
        meta = {
            "algo": self.algo,
            "layered": self._spec.layered,
            "backend_kind": self.backend_kind,
            "backend_class": type(self.backend).__name__,
            "params": dataclasses.asdict(self.params),
            "seed": int(self._seed),
            "n_adds": int(self._n_adds),
            "strategy": self.build_strategy,
        }
        g = self._graph
        arrays = {
            "data": self._data.cpu().numpy(),
            "tombs": self._tombs.copy(),
            "retired": self._retired.copy(),
            "entry": np.asarray(g.entry, np.int32),
        }
        if self._spec.layered:
            arrays.update(
                adj0=g.adj0.cpu().numpy(), adj0_d=g.adj0_d.cpu().numpy(),
                adj_up=g.adj_up.cpu().numpy(), adj_up_d=g.adj_up_d.cpu().numpy(),
                levels=g.levels.cpu().numpy(),
            )
        else:
            arrays.update(adj=g.adj.cpu().numpy(), adj_d=g.adj_d.cpu().numpy())
        for name, arr in self.backend.state_dict().items():
            arrays[f"backend.{name}"] = arr
        return meta, arrays

    @classmethod
    def restore(cls, meta: dict, arrays: dict, *, device: str | torch.device = "cuda") -> "AnnIndex":
        """Inverse of ``export_state`` (either package's) on ``device``."""
        dev = resolve_device(device)
        spec = _REGISTRY.get(meta["algo"])
        if spec is None:
            raise ValueError(
                f"snapshot needs unregistered algo {meta['algo']!r}; registered: {', '.join(algos())}"
            )
        if bool(meta["layered"]) != spec.layered:
            raise ValueError(
                f"algo {meta['algo']!r} is registered as {'layered' if spec.layered else 'flat'} "
                f"but the snapshot was taken from a {'layered' if meta['layered'] else 'flat'} index"
            )
        be_cls = bk.CLASSES.get(meta["backend_class"])
        if be_cls is None:
            raise ValueError(
                f"unknown backend class {meta['backend_class']!r}; custom backends must be "
                "registered in graph.backends.CLASSES to be restorable"
            )
        backend = be_cls.from_state(
            {k[len("backend."):]: v for k, v in arrays.items() if k.startswith("backend.")},
            device=dev,
        )
        entry = int(np.asarray(arrays["entry"]))
        if spec.layered:
            graph = HNSWIndex(
                adj0=_tensor(arrays["adj0"], dev, torch.int32),
                adj0_d=_tensor(arrays["adj0_d"], dev, torch.float32),
                adj_up=_tensor(arrays["adj_up"], dev, torch.int32),
                adj_up_d=_tensor(arrays["adj_up_d"], dev, torch.float32),
                levels=_tensor(arrays["levels"], dev, torch.int32),
                entry=entry, backend=backend,
            )
        else:
            graph = FlatIndex(
                adj=_tensor(arrays["adj"], dev, torch.int32),
                adj_d=_tensor(arrays["adj_d"], dev, torch.float32),
                entry=entry, backend=backend,
            )
        obj = cls(
            spec=spec, params=BuildParams(**meta["params"]), graph=graph,
            data=_tensor(arrays["data"], dev, torch.float32),
            backend_kind=meta["backend_kind"], seed=int(meta["seed"]),
            strategy=meta.get("strategy", "incremental"),
        )
        obj._n_adds = int(meta["n_adds"])
        obj._tombs = np.asarray(arrays["tombs"], bool).copy()
        obj._retired = np.asarray(arrays["retired"], bool).copy()
        return obj

    def clone(self) -> "AnnIndex":
        """A fully independent copy on the same device (through
        ``export_state``/``restore``): maintenance on either side is
        invisible to the other."""
        return type(self).restore(*self.export_state(), device=self.device)

    # ---- dynamic maintenance -------------------------------------------

    def _maint_params(self) -> BuildParams:
        """Engine params for maintenance: a flat graph inserts as a
        one-layer build whatever the user's max_layers."""
        if self._spec.layered:
            return self.params
        return dataclasses.replace(self.params, max_layers=1)

    def _graph_arrays(self):
        """(adj0, adj0_d, adj_up, adj_up_d) in the engine's layout; a flat
        graph gets a zero-length upper stack."""
        g = self._graph
        if self._spec.layered:
            return g.adj0, g.adj0_d, g.adj_up, g.adj_up_d
        shape = (0, g.adj.shape[0], self.params.r_upper)
        return (g.adj, g.adj_d, torch.zeros(shape, dtype=torch.int32, device=self.device),
                torch.zeros(shape, dtype=torch.float32, device=self.device))

    def _set_graph(self, adj0, adj0_d, adj_up, adj_up_d, levels, entry: int, backend) -> None:
        g = self._graph
        if self._spec.layered:
            self._graph = g._replace(adj0=adj0, adj0_d=adj0_d, adj_up=adj_up, adj_up_d=adj_up_d,
                                     levels=levels, entry=entry, backend=backend)
        else:
            self._graph = g._replace(adj=adj0, adj_d=adj0_d, entry=entry, backend=backend)

    def add(self, new_vectors) -> BuildStats:
        """Insert a batch of vectors into the existing frozen graph.

        No rebuild, no coder refit: the backend grows through
        ``backend.extend`` and the new vertices run through
        ``BuildEngine.insert_batch`` like the next batches of the build
        (a flat graph keeps its medoid entry: the drift is accepted until
        ``compact``). New ids are ``range(old_n, old_n + m)`` in input
        order. Returns the growth's build stats.
        """
        dev = self.device
        new = _tensor(new_vectors, dev, torch.float32)
        if new.dim() == 1:
            new = new[None]
        if new.shape[-1] != self._data.shape[1]:
            raise ValueError(
                f"dim mismatch: index is d={self._data.shape[1]}, got d={new.shape[-1]}"
            )
        m = int(new.shape[0])
        if m == 0:
            return BuildStats(n_dists=0.0, n_hops=0.0)
        n_old = self.n
        params = self._maint_params()
        g = self._graph
        self._n_adds += 1

        # levels and the per-batch entry plan, continued from the built
        # prefix and seeded with the live entry
        if self._spec.layered:
            lv_new = sample_levels(
                self._seed + 7919 * self._n_adds, m,
                r_upper=params.r_upper, max_layers=params.max_layers,
            )
            levels_all = np.concatenate([g.levels.cpu().numpy(), lv_new]).astype(np.int32)
        else:
            levels_all = np.zeros(n_old + m, np.int32)
        cur = int(g.entry)
        ent = prefix_entries(levels_all, params.batch, start=n_old, entry0=cur)
        # a new vertex displaces the entry only if it strictly out-levels it
        cand = int(np.argmax(levels_all))
        best = cand if levels_all[cand] > levels_all[cur] else cur
        ids, mask = _schedule(np.arange(n_old, n_old + m, dtype=np.int32), params.batch, dev)

        adj0, adj0_d, adj_up, adj_up_d = self._graph_arrays()
        r_base = adj0.shape[1]
        adj0 = torch.cat([adj0, torch.full((m, r_base), -1, dtype=torch.int32, device=dev)])
        adj0_d = torch.cat([adj0_d, torch.full((m, r_base), float("inf"), device=dev)])
        l_up, _, r_up = adj_up.shape
        adj_up = torch.cat(
            [adj_up, torch.full((l_up, m, r_up), -1, dtype=torch.int32, device=dev)], 1
        )
        adj_up_d = torch.cat([adj_up_d, torch.full((l_up, m, r_up), float("inf"), device=dev)], 1)
        backend = g.backend.extend(new)
        data_all = torch.cat([self._data, new])
        levels_t = torch.from_numpy(levels_all).to(dev)

        with obs.span("build/add", algo=self.algo, m=m) as sp:
            adj0, adj0_d, adj_up, adj_up_d, backend, acct = run_insert_schedule(
                BuildEngine(params), data_all, adj0, adj0_d, adj_up, adj_up_d,
                backend, levels_t, ids, ent, mask,
            )
            stats = BuildStats(n_dists=acct.n_dists, n_hops=acct.n_hops, phases=list(acct.phases))
            _record_build(sp, stats)
        self._set_graph(adj0, adj0_d, adj_up, adj_up_d, levels_t,
                        best if self._spec.layered else cur, backend)
        self._data = data_all
        self._tombs = np.concatenate([self._tombs, np.zeros(m, bool)])
        self._retired = np.concatenate([self._retired, np.zeros(m, bool)])
        self.last_stats = stats
        return stats

    def delete(self, ids) -> int:
        """Tombstone vertices: still traversable (the graph stays connected)
        but never returned by ``search``. Returns the number newly
        tombstoned; idempotent."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if ids.size == 0:
            return 0
        if ids.min() < 0 or ids.max() >= self.n:
            raise IndexError(
                f"delete ids must be in [0, {self.n}); got [{ids.min()}, {ids.max()}]"
            )
        newly = int((~(self._tombs | self._retired)[ids]).sum())
        self._tombs[ids] = True
        return newly

    def compact(self) -> BuildStats:
        """Physically rewire around tombstones.

        Purges tombstoned ids from every adjacency row (and the blocked
        mirror), clears their own rows, then re-inserts every live vertex
        that lost a neighbor through the same engine program as ``add``.
        Tombstoned slots become retired for good (ids are never reused). A
        flat graph whose medoid entry died takes the live vertex nearest to
        the live mean. Returns the rewiring's build stats.
        """
        zero = BuildStats(n_dists=0.0, n_hops=0.0)
        if not self._tombs.any():
            return zero
        g = self._graph
        dev = self.device
        params = self._maint_params()
        dead = self._tombs.copy()
        gone = dead | self._retired
        active = ~gone
        adj0_g, adj0_d_g, adj_up_g, adj_up_d_g = self._graph_arrays()

        # host-side purge of every layer's rows
        adj0, adj0_d, affected = _purge_rows(adj0_g.cpu().numpy(), adj0_d_g.cpu().numpy(), dead)
        up_layers = []
        for l in range(adj_up_g.shape[0]):
            a, d, aff = _purge_rows(adj_up_g[l].cpu().numpy(), adj_up_d_g[l].cpu().numpy(), dead)
            up_layers.append((a, d))
            affected |= aff
        affected &= active

        # the new entry over the survivors
        if self._spec.layered:
            levels = g.levels.cpu().numpy().copy()
            levels[gone] = 0
            entry = int(np.argmax(np.where(active, levels, -1))) if active.any() else int(g.entry)
        else:
            levels = np.zeros(self.n, np.int32)
            entry = int(g.entry)
            if gone[entry] and active.any():
                data_np = self._data.cpu().numpy()
                mean = data_np[active].mean(axis=0)
                d = ((data_np - mean) ** 2).sum(axis=1)
                d[gone] = np.inf
                entry = int(np.argmin(d))

        adj0_t = torch.from_numpy(adj0).to(dev)
        adj0_d_t = torch.from_numpy(adj0_d).to(dev)
        if up_layers:
            adj_up_t = torch.from_numpy(np.stack([a for a, _ in up_layers])).to(dev)
            adj_up_d_t = torch.from_numpy(np.stack([d for _, d in up_layers])).to(dev)
        else:
            adj_up_t, adj_up_d_t = adj_up_g[:0].clone(), adj_up_d_g[:0].clone()
        # resync the blocked mirror with the purged base layer (on a copy:
        # the mirror is written in place)
        backend = g.backend.clone().with_updated_edges(
            torch.arange(self.n, dtype=torch.int32, device=dev), adj0_t
        )
        levels_t = torch.from_numpy(levels).to(dev)

        stats = zero
        aff_ids = np.nonzero(affected)[0].astype(np.int32)
        if aff_ids.size:
            ids, mask = _schedule(aff_ids, params.batch, dev)
            ent = np.full((ids.shape[0],), entry, np.int32)
            with obs.span("build/compact", algo=self.algo, rewired=int(aff_ids.size)) as sp:
                adj0_t, adj0_d_t, adj_up_t, adj_up_d_t, backend, acct = run_insert_schedule(
                    BuildEngine(params), self._data, adj0_t, adj0_d_t, adj_up_t, adj_up_d_t,
                    backend, levels_t, ids, ent, mask,
                )
                stats = BuildStats(n_dists=acct.n_dists, n_hops=acct.n_hops,
                                   phases=list(acct.phases))
                _record_build(sp, stats)

        self._set_graph(adj0_t, adj0_d_t, adj_up_t, adj_up_d_t, levels_t, entry, backend)
        self._retired |= dead
        self._tombs = np.zeros(self.n, bool)
        self.last_stats = stats
        return stats
