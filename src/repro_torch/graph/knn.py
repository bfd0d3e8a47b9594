"""Exact brute-force k-NN (ground truth for recall, paper §4.1.1), in
PyTorch (reference: repro.graph.knn).

Chunked over the database: each chunk's (Q, chunk) distance tile is one
``l2_batch`` launch (kernel ``csrc/l2_batch.cu`` on the card), merged into
the running top-k. The merge is an ascending stable sort of [running best,
new chunk], which is ``lax.top_k(-cat_d, k)``'s order: on equal distances
the earlier slot, so the running best and then the lower id, wins.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.beam import stable_smallest
from repro_torch.kernels import ops


def exact_knn(
    queries: torch.Tensor, data: torch.Tensor, *, k: int, chunk: int = 8192
) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, D), data (N, D) float32 on one device -> (ids (Q, k)
    int32, squared dists (Q, k) float32), ascending; −1 / +inf past N."""
    q = queries.shape[0]
    dev = queries.device
    best_d = torch.full((q, k), float("inf"), device=dev)
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, data.shape[0], chunk):
        tile = data[start:start + chunk]
        d = ops.l2_batch(queries, tile)  # (Q, m)
        ids = torch.arange(start, start + tile.shape[0], dtype=torch.int32, device=dev)
        cat_d = torch.cat([best_d, d], 1)
        cat_i = torch.cat([best_i, ids.expand(q, -1)], 1)
        best_d, idx = stable_smallest(cat_d, k)
        best_i = cat_i.gather(1, idx)
    return best_i, best_d


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def recall_at_k(found_ids, true_ids, k: int) -> float:
    """Mean |found ∩ truth| / k over queries (the paper's Recall)."""
    found = _as_tensor(found_ids).long()
    true = _as_tensor(true_ids).to(found.device).long()
    hits = (found[:, :k, None] == true[:, None, :k]) & (true[:, None, :k] >= 0)
    return float((hits.any(-1).sum(-1).to(torch.float64) / k).mean())


def average_distance_ratio(found_d, true_d, k: int) -> float:
    """ADR (paper §4.1.4): mean over queries and ranks of δ_found / δ_true,
    from squared distances (exact ones for the found ids)."""
    found = _as_tensor(found_d).to(torch.float64)
    true = _as_tensor(true_d).to(found.device, torch.float64)
    num = torch.sqrt(found[:, :k].clamp_min(0.0))
    den = torch.sqrt(true[:, :k].clamp_min(1e-12))
    return float((num / den).mean())
