"""Deterministic synthetic vectors (numpy), the same generator the reference
package uses so both packages see identical data from one seed."""

from __future__ import annotations

import numpy as np


def vector_dataset(
    seed: int, *, n: int, d: int, n_clusters: int = 64, sep: float = 1.0
) -> np.ndarray:
    """Embedding-like GMM with anisotropic (PCA-spectrum-like) noise."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * sep
    scales = np.linspace(1.0, 0.2, d).astype(np.float32)
    x = centers[rng.integers(0, n_clusters, n)]
    x += rng.normal(size=(n, d)).astype(np.float32) * scales
    return x
