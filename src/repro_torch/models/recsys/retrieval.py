"""Candidate retrieval for BERT4Rec: the paper's technique as a serving
feature. The reference's ``models/recsys/retrieval.py`` in PyTorch.

Three scorers of (B, D) query vectors against an (N, D) catalog:

* ``score_dense``  — exact: one (B, D) × (D, N) product and a top-k.
* ``score_flash``  — the Flash compact scan: per query, one ``flash_scan``
  launch over the candidates' (N, M) codes with the query's quantized ADT,
  the ``k · rerank`` smallest int32 sums kept, then an exact inner-product
  rerank on the originals.
* ``search_index`` — graph search through the ``AnnIndex`` facade (or a
  bare ``HNSWIndex``, reranked on ``item_embed``).

Every top-k follows ``jax.lax.top_k`` (:func:`repro_torch.utils.topk_first`):
the int32 scan sums tie often, and at the ``k · rerank`` cut the lower
index is kept, as in the reference. Each scorer runs where its catalog
tensors lie; queries are moved there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import flash as fl
from repro_torch.graph.hnsw import HNSWIndex, search_hnsw
from repro_torch.graph.rerank import ExactReranker, RawVectors, SearchSpec
from repro_torch.kernels import ops
from repro_torch.utils import topk_first

#: queries whose (N,) scan sums are held at once in ``score_flash``
_FLASH_BLOCK = 64


class RetrievalResult(NamedTuple):
    ids: torch.Tensor  # (B, k) int32
    scores: torch.Tensor  # (B, k): inner product or −distance, higher is better


def score_dense(query: torch.Tensor, item_embed: torch.Tensor, *, k: int) -> RetrievalResult:
    """query (B, D), item_embed (N, D) -> the exact top-k by inner product."""
    query = query.to(item_embed.device)
    top, idx = topk_first(query @ item_embed.T, k)
    return RetrievalResult(ids=idx.to(torch.int32), scores=top)


def score_flash(
    query: torch.Tensor,
    coder: fl.FlashCoder,
    codes: torch.Tensor,
    item_embed: torch.Tensor,
    *,
    k: int,
    rerank: int = 4,
) -> RetrievalResult:
    """Compact-code scan + exact rerank.

    query (B, D); codes (N, M) int32 Flash codes of the candidates;
    item_embed (N, D) their originals. Flash codes order by L2 distance (for
    normalized embeddings the inner-product order); the rerank restores
    exact inner-product scores. One ``flash_scan`` launch per query.
    """
    query = query.to(item_embed.device)
    kk = min(k * rerank, codes.shape[0])
    adt = fl.query_ctx(coder, query).adt_q  # (B, M, K) int32 levels
    ids, scores = [], []
    for s in range(0, query.shape[0], _FLASH_BLOCK):
        q = query[s:s + _FLASH_BLOCK]
        d = torch.stack([ops.flash_scan(codes, a) for a in adt[s:s + _FLASH_BLOCK]])  # (b, N)
        _, idx = topk_first(-d, kk)  # the kk smallest sums, lower index first on ties
        cand = item_embed[idx]  # (b, kk, D)
        sc = (cand @ q[:, :, None])[..., 0]
        top, j = topk_first(sc, k)
        ids.append(idx.gather(1, j).to(torch.int32))
        scores.append(top)
    return RetrievalResult(ids=torch.cat(ids), scores=torch.cat(scores))


def search_index(
    query: torch.Tensor,
    index,
    item_embed: torch.Tensor,
    *,
    k: int,
    ef_search: int = 128,
    max_layers: int | None = None,
) -> RetrievalResult:
    """Graph search (sub-linear) + exact rerank; distances become −scores.

    ``index`` is an ``AnnIndex`` (reranks on its stored vectors and honours
    tombstones); a bare ``HNSWIndex`` is still taken, as the reference's
    legacy call sites do, and reranks on ``item_embed``.
    """
    if isinstance(index, HNSWIndex):
        spec = SearchSpec(k=k, ef=ef_search, width=1, rerank="exact")
        res = search_hnsw(
            index, query.to(item_embed.device), spec=spec,
            reranker=ExactReranker(RawVectors(item_embed)), max_layers=max_layers,
        )
    else:
        if max_layers is not None:
            raise ValueError(
                "max_layers only applies to a bare HNSWIndex; the AnnIndex facade "
                "always searches the depth it was built with"
            )
        res = index.search(query, k, ef=ef_search, rerank=True)
    return RetrievalResult(ids=res.ids, scores=-res.dists)


def retrieval_recall(found: RetrievalResult, exact: RetrievalResult, k: int) -> float:
    """Mean over queries of |found top-k ∩ exact top-k| / k."""
    hits = found.ids[:, :k, None].long() == exact.ids[:, None, :k].long().to(found.ids.device)
    return float(hits.any(-1).sum(-1).to(torch.float64).mean() / k)
