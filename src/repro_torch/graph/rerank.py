"""Two-stage search: compressed candidate scan + exact rerank.

The scan returns a candidate superset of ``n_keep = min(ef, k·rerank_mult)``
ids with backend-scale distances; the rerank re-scores exactly those
candidates at full precision and takes the true top-k. :class:`SearchSpec`
freezes the read-side configuration into one hashable value.

``merge_rerank_topk`` is the coordinator's second stage over several
sources' candidates (``SegmentedAnnIndex.search``). The stages: "exact"
(raw vectors), "none" (scan distances pass through) and "reconstruct"
(the backend's coder decodes the candidates: no raw table kept).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.graph.beam import INF, stable_smallest

#: (query × candidate × dim) elements one merge block gathers for rerank
_MERGE_BUDGET = 1 << 27

#: valid ``SearchSpec.rerank`` modes, production default first
RERANK_MODES = ("exact", "none", "reconstruct")


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """k results; scan beam ef (clamped to >= k); multi-expansion width W;
    rerank mode; rerank_mult (None = rerank the whole beam)."""

    k: int = 10
    ef: int = 64
    width: int = 1
    rerank: str = "exact"
    rerank_mult: int | None = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.width < 1:
            raise ValueError(f"width must be >= 1, got {self.width}")
        if self.rerank not in RERANK_MODES:
            raise ValueError(f"rerank must be one of {RERANK_MODES}, got {self.rerank!r}")
        if self.rerank_mult is not None and self.rerank_mult < 1:
            raise ValueError(f"rerank_mult must be >= 1 or None, got {self.rerank_mult}")
        object.__setattr__(self, "ef", max(int(self.ef), int(self.k)))

    @property
    def n_keep(self) -> int:
        """Candidates the scan stage hands to the rerank stage."""
        if self.rerank == "none":
            return self.k
        if self.rerank_mult is None:
            return self.ef
        return min(self.ef, self.k * self.rerank_mult)

    def scan_spec(self) -> "SearchSpec":
        """The candidate half of this spec: the same beam, no second stage,
        ``n_keep`` results — what a segment runs before the coordinator
        reranks the union (``merge_rerank_topk``)."""
        return SearchSpec(k=self.n_keep, ef=self.ef, width=self.width, rerank="none")


def rerank_mode(rerank) -> str:
    """``True`` → "exact", ``False`` → "none"; strings pass through validated."""
    if rerank is True:
        return "exact"
    if rerank is False:
        return "none"
    if rerank in RERANK_MODES:
        return rerank
    raise ValueError(f"rerank must be a bool or one of {RERANK_MODES}, got {rerank!r}")


class RawVectors:
    """``raw_dists`` over an (n, d) float32 table (e.g. the index's data)."""

    def __init__(self, vectors: torch.Tensor):
        self.vectors = vectors.to(torch.float32)

    def raw_dists(self, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """q (Q, d), ids (Q, C) -> (Q, C) exact squared L2."""
        d = self.vectors[ids.long()] - q[:, None, :]
        return (d * d).sum(-1)


class ExactReranker:
    """Exact float32 squared L2 through a ``raw_dists(q, ids)`` source."""

    def __init__(self, source):
        self.source = source

    def dists(self, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return self.source.raw_dists(q, ids)


class ReconstructReranker:
    """Approximate rerank on coder-reconstructed vectors: the candidates'
    codes decoded through ``backend.recon_vectors`` (PQ's and Flash's come
    padded to M·ds and are cut to the query's D), scored by squared L2
    against the raw query. No raw table is kept; the result is bounded by
    the coder's reconstruction error."""

    def __init__(self, backend):
        self.backend = backend

    def dists(self, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        v = self.backend.recon_vectors(ids)
        d = v[..., : q.shape[-1]] - q[:, None, :]
        return (d * d).sum(-1)


def make_reranker(mode: str, backend=None, raw_vectors=None):
    """The reranker for ``mode`` (None for "none"). "exact" prefers the
    backend's retained raw vectors, else ``raw_vectors``; "reconstruct"
    decodes through ``backend``."""
    if mode == "none":
        return None
    if mode == "exact":
        if backend is not None and getattr(backend, "has_raw", False):
            return ExactReranker(backend)
        if raw_vectors is not None:
            return ExactReranker(RawVectors(raw_vectors))
        raise ValueError(
            "exact rerank needs retained raw vectors: build the backend "
            "with keep_raw=True or pass raw_vectors"
        )
    if mode == "reconstruct":
        if backend is None:
            raise ValueError("reconstruct rerank needs the index backend")
        return ReconstructReranker(backend)
    raise ValueError(f"unknown rerank mode {mode!r}; valid: {RERANK_MODES}")


def rerank_topk(reranker, q, cand_ids, cand_dists, k: int):
    """Re-score each query's candidates and take the true top-k.

    q (Q, d); cand_ids (Q, C) int32, −1 padded; cand_dists (Q, C) scan
    distances (the key only when ``reranker`` is None).
    Returns (ids (Q, k), dists (Q, k), n_rerank (Q,) int64).
    """
    valid = cand_ids >= 0
    if reranker is None:
        scored = torch.where(valid, cand_dists, INF)
        n_rerank = torch.zeros(cand_ids.shape[0], dtype=torch.int64, device=cand_ids.device)
    else:
        scored = torch.where(valid, reranker.dists(q, cand_ids.clamp_min(0)), INF)
        n_rerank = valid.sum(1)
    vals, idx = stable_smallest(scored, k)
    return cand_ids.gather(1, idx), vals, n_rerank


def merge_rerank_topk(reranker, queries, cand_ids, cand_dists, k: int):
    """Cross-source merge: dedup by id, re-score once, global top-k.

    queries (Q, d); cand_ids (Q, C) global ids, −1 padded; cand_dists (Q, C)
    the carried scan distances (the key only when ``reranker`` is None).
    A repeated id keeps its first slot only (stable sort by id, followers
    struck), so nothing is scored or returned twice. Ties in the top-k go
    to the lower slot. Returns (ids (Q, k), dists (Q, k), n_rerank int);
    slots past the available candidates are −1 / +inf. Queries run in
    blocks that bound the gathered (Q_b, C, d) rerank rows.
    """
    q, c = cand_ids.shape
    _, order = torch.sort(cand_ids, dim=-1, stable=True)
    sorted_ids = cand_ids.gather(1, order)
    adj_dup = torch.zeros_like(sorted_ids, dtype=torch.bool)
    adj_dup[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
    dup = torch.empty_like(adj_dup).scatter_(1, order, adj_dup)  # undo the sort
    valid = (cand_ids >= 0) & ~dup
    if reranker is None:
        scored = torch.where(valid, cand_dists.to(torch.float32), INF)
        n_rerank = 0
    else:
        block = max(1, _MERGE_BUDGET // max(1, c * queries.shape[1]))
        safe = cand_ids.clamp_min(0)
        scored = torch.cat([
            reranker.dists(queries[s:s + block], safe[s:s + block])
            for s in range(0, q, block)
        ])
        scored = torch.where(valid, scored, INF)
        n_rerank = int(valid.sum())
    dists, idx = stable_smallest(scored, k)
    ids = cand_ids.gather(1, idx)
    ids = torch.where(torch.isinf(dists), -1, ids)
    return ids, dists, n_rerank
