"""`AnnIndex` — the index facade of the port (reference: repro.graph.index).

    index = AnnIndex.build(data, algo="hnsw", backend="flash_blocked")
    res   = index.search(queries, k=10, ef=64)        # exact rerank
    meta, arrays = index.export_state()               # the reference's format
    index = AnnIndex.restore(meta, arrays)            # either package's state

This slice ports build (``algo="hnsw"``, ``strategy="bulk"``), search,
``export_state`` and ``restore``; ``export_state``/``restore`` use exactly
the reference's ``(meta, arrays)`` layout, so an index built by the JAX
package restores here and searches identically. ``add``/``delete``/
``compact`` are still to port (ROADMAP queue 1, item 5b).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.graph import backends as bk
from repro_torch.graph.engine import BuildParams
from repro_torch.graph.hnsw import HNSWIndex, SearchResult, build_hnsw, search_hnsw
from repro_torch.graph.rerank import SearchSpec, make_reranker, rerank_mode
from repro_torch.utils import resolve_device, sync

__all__ = ["AnnIndex", "SearchResult", "SearchSpec"]

_KIND_OF_TYPE = {bk.FlashBackend: "flash", bk.FlashBlockedBackend: "flash_blocked"}


def _tensor(x, dev, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device=dev, dtype=dtype) if dtype is not None else t.to(dev)


class AnnIndex:
    """One HNSW index over a Flash backend, on one device.

    Ids are insertion-order positions; ``data`` is the rerank corpus.
    """

    def __init__(self, *, params, graph: HNSWIndex, data, backend_kind, seed,
                 stats=None, strategy="bulk"):
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
        backend="flash_blocked",
        params: BuildParams | None = None,
        seed: int = 0,
        backend_kwargs: dict | None = None,
        strategy: str = "bulk",
        device: str | torch.device = "cuda",
    ) -> "AnnIndex":
        """Build an index over ``data`` (n, D) on ``device``.

        backend   "flash" | "flash_blocked" (the coder is fitted on ``data``
                  with ``backend_kwargs``, k-means seeded by ``seed``) or a
                  prebuilt backend instance.
        ``last_stats.seconds`` holds the wall time of each build phase.
        """
        dev = resolve_device(device)
        if algo != "hnsw":
            raise NotImplementedError(
                f"algo {algo!r} is not ported yet: vamana/nsg are ROADMAP queue 1, item 6"
            )
        if strategy not in ("bulk", "incremental"):
            raise ValueError(f"unknown build strategy {strategy!r}; valid: 'bulk', 'incremental'")
        params = BuildParams() if params is None else params
        data = _tensor(data, dev, torch.float32)
        seconds: dict = {}
        if isinstance(backend, str):
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
        graph, stats = build_hnsw(
            data, be, params=params, seed=seed, strategy=strategy,
            seconds=seconds,
        )
        return cls(params=params, graph=graph, data=data, backend_kind=kind,
                   seed=seed, stats=stats, strategy=strategy)

    # ---- introspection --------------------------------------------------

    @property
    def algo(self) -> str:
        return "hnsw"

    @property
    def graph(self) -> HNSWIndex:
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
        return int(self._data.shape[0])

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        return f"AnnIndex(algo='hnsw', backend={self.backend_kind!r}, n={self.n}, device={self.device})"

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
        passes scan distances through. ``fused=False`` forces the unfused
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
        res = search_hnsw(
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
            "algo": "hnsw",
            "layered": True,
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
            "adj0": g.adj0.cpu().numpy(),
            "adj0_d": g.adj0_d.cpu().numpy(),
            "adj_up": g.adj_up.cpu().numpy(),
            "adj_up_d": g.adj_up_d.cpu().numpy(),
            "levels": g.levels.cpu().numpy(),
        }
        for name, arr in self.backend.state_dict().items():
            arrays[f"backend.{name}"] = arr
        return meta, arrays

    @classmethod
    def restore(cls, meta: dict, arrays: dict, *, device: str | torch.device = "cuda") -> "AnnIndex":
        """Inverse of ``export_state`` (either package's) on ``device``."""
        dev = resolve_device(device)
        if meta["algo"] != "hnsw" or not bool(meta["layered"]):
            raise NotImplementedError(
                f"restoring algo {meta['algo']!r} is not ported yet (ROADMAP queue 1, item 6)"
            )
        be_cls = bk.CLASSES.get(meta["backend_class"])
        if be_cls is None:
            raise NotImplementedError(
                f"backend class {meta['backend_class']!r} is not ported yet "
                "(ROADMAP queue 1, item 5d)"
            )
        backend = be_cls.from_state(
            {k[len("backend."):]: v for k, v in arrays.items() if k.startswith("backend.")},
            device=dev,
        )
        graph = HNSWIndex(
            adj0=_tensor(arrays["adj0"], dev, torch.int32),
            adj0_d=_tensor(arrays["adj0_d"], dev, torch.float32),
            adj_up=_tensor(arrays["adj_up"], dev, torch.int32),
            adj_up_d=_tensor(arrays["adj_up_d"], dev, torch.float32),
            levels=_tensor(arrays["levels"], dev, torch.int32),
            entry=int(np.asarray(arrays["entry"])),
            backend=backend,
        )
        obj = cls(
            params=BuildParams(**meta["params"]), graph=graph,
            data=_tensor(arrays["data"], dev, torch.float32),
            backend_kind=meta["backend_kind"], seed=int(meta["seed"]),
            strategy=meta.get("strategy", "incremental"),
        )
        obj._n_adds = int(meta["n_adds"])
        obj._tombs = np.asarray(arrays["tombs"], bool).copy()
        obj._retired = np.asarray(arrays["retired"], bool).copy()
        return obj
