"""Batched k-means for subspace codebooks (paper §3.3.3, Eq. 8), and the
single-space fit of the segment routing table (``kmeans_fit``).

All ``M`` subspace codebooks are fitted at once over a leading batch axis:
k-means++ seeding drawn with ``torch.multinomial`` on an explicit
``torch.Generator``, then a fixed number of Lloyd iterations. Empty clusters
are re-seeded from the point farthest from its centroid (one per iteration),
as in the reference. The draws differ from ``jax.random``'s, so the port's
fit is held to the reference on quality, not bits.
"""

from __future__ import annotations

import torch

from repro_torch.utils import first_argmax, first_argmin


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared L2 between rows: x (M, n, d), c (M, k, d) -> (M, n, k)."""
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (c * c).sum(-1)
    xc = torch.bmm(x, c.transpose(1, 2))
    return torch.clamp_min(x2 + c2[:, None, :] - 2.0 * xc, 0.0)


def _kmeanspp_init(gen: torch.Generator, x: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding for every subspace: x (M, n, d) -> (M, k, d)."""
    m, n, d = x.shape
    ar = torch.arange(m, device=x.device)
    first = torch.randint(0, n, (m,), generator=gen, device=x.device)
    centroids = torch.zeros((m, k, d), dtype=x.dtype, device=x.device)
    c0 = x[ar, first]
    centroids[:, 0] = c0
    mind = _sq_dists(x, c0[:, None, :])[:, :, 0]
    for i in range(1, k):
        total = mind.sum(-1, keepdim=True)
        # all points on their centroids already: draw uniformly instead
        probs = torch.where(total > 0, mind / total.clamp_min(1e-30), 1.0)
        idx = torch.multinomial(probs, 1, generator=gen)[:, 0]
        c_new = x[ar, idx]
        centroids[:, i] = c_new
        mind = torch.minimum(mind, ((x - c_new[:, None, :]) ** 2).sum(-1))
    return centroids


def _lloyd_step(x: torch.Tensor, centroids: torch.Tensor):
    """One Lloyd iteration for every subspace -> (new_centroids, inertia (M,))."""
    m, n, _ = x.shape
    k = centroids.shape[1]
    d2 = _sq_dists(x, centroids)
    assign = first_argmin(d2, -1)  # (M, n)
    mins = d2.gather(-1, assign[..., None])[..., 0]
    inertia = mins.sum(-1)
    one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype)  # (M, n, k)
    counts = one_hot.sum(1)  # (M, k)
    sums = torch.bmm(one_hot.transpose(1, 2), x)  # (M, k, d)
    new = sums / torch.clamp_min(counts[..., None], 1.0)
    empty = counts < 0.5
    new = torch.where(empty[..., None], centroids, new)
    # re-seed at most one empty cluster per iteration (cheap and sufficient)
    far = first_argmax(mins, -1)  # (M,)
    first_empty = first_argmax(empty.to(torch.int32), -1)
    any_empty = empty.any(-1)
    ar = torch.arange(m, device=x.device)
    reseed = torch.where(any_empty[:, None], x[ar, far], new[ar, first_empty])
    new[ar, first_empty] = reseed
    return new, inertia


def kmeans_fit_batched(
    gen: torch.Generator, xs: torch.Tensor, *, k: int, iters: int = 25
):
    """Batched k-means: xs (M, n, ds) -> centroids (M, k, ds), inertias (M,)."""
    centroids = _kmeanspp_init(gen, xs, k)
    for _ in range(iters):
        centroids, _ = _lloyd_step(xs, centroids)
    _, inertia = _lloyd_step(xs, centroids)
    return centroids, inertia


def kmeans_fit(gen: torch.Generator, x: torch.Tensor, *, k: int, iters: int = 25):
    """k-means over one space: x (n, d) -> centroids (k, d), inertia ()
    (the batched fit with a batch of one)."""
    centroids, inertia = kmeans_fit_batched(gen, x[None], k=k, iters=iters)
    return centroids[0], inertia[0]


def assign_codes_batched(xs: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid codes (Eq. 8): xs (M, n, ds), centroids (M, k, ds)
    -> (M, n) int32, first index on ties."""
    return first_argmin(_sq_dists(xs, centroids), -1).to(torch.int32)
