"""A second witness for a graph search's recall: an exhaustive scan of the
same codes.

:func:`code_scan_recall` scores EVERY row with the backend's own query
distance (``query_dists``: the ADT sums of the Flash and PQ codes, the SQ
and PCA distances), keeps the best ``c``, reranks them exactly and returns
recall@10. It shares the coder with a graph search of ``c`` candidates and
not the graph, so it is what the codes allow such a search at best: a
graph search far below it points at the graph, one near it at the coder.
"""

from __future__ import annotations

import torch


def recall_at(ids: torch.Tensor, gt: torch.Tensor) -> float:
    """Mean share of each row of ``gt`` found in the same row of ``ids``."""
    hit = (ids[:, :, None].long() == gt[:, None, :].long()).any(2).sum(1)
    return float(hit.to(torch.float64).mean() / gt.shape[1])


def code_scan_recall(backend, data: torch.Tensor, queries: torch.Tensor, gt: torch.Tensor, c: int,
                     chunk: int = 4096) -> float:
    """recall@10 against ``gt`` of the scan over all ``backend.n`` rows
    keeping ``c``, reranked on ``data``; ``chunk`` rows per step."""
    ctx = backend.prepare_query(queries)
    q, dev = queries.shape[0], queries.device
    best_d = torch.full((q, c), float("inf"), device=dev)
    best_i = torch.zeros((q, c), dtype=torch.int64, device=dev)
    for s in range(0, backend.n, chunk):
        ids = torch.arange(s, min(backend.n, s + chunk), device=dev).expand(q, -1)
        d = backend.query_dists(ctx, ids.to(torch.int32)).to(torch.float32)
        best_d, pos = torch.topk(torch.cat([best_d, d], 1), c, dim=1, largest=False)
        best_i = torch.cat([best_i, ids], 1).gather(1, pos)
    exact = ((data[best_i] - queries[:, None, :]) ** 2).sum(-1)
    top = best_i.gather(1, torch.topk(exact, 10, dim=1, largest=False).indices)
    return recall_at(top, gt)
