"""Principal component extraction (paper §3.3.2).

The decomposition is a float64 covariance ``eigh`` on the host, exactly as
the reference does it, so the PCA half of a Flash coder fitted on the same
rows is bit-equal between the two packages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PCAModel(NamedTuple):
    """Orthogonal rotation fitted to data.

    mean:        (D,)   data mean (float32).
    components:  (D, D) columns are unit eigenvectors, descending eigenvalue.
    eigenvalues: (D,)   descending, >= 0.
    """

    mean: np.ndarray
    components: np.ndarray
    eigenvalues: np.ndarray

    @property
    def dim(self) -> int:
        return self.mean.shape[0]


def fit_pca(x, *, max_sample: int = 65536) -> PCAModel:
    """Fit a full-rank PCA rotation on (a stride sample of) ``x`` ((n, D)).

    Returns float32 numpy arrays; the caller moves them to its device.
    The stride subsample is taken before the float64 copy (the reference
    copies first and subsamples after: the same rows, less host memory).
    """
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if x.ndim != 2:
        raise ValueError(f"expected (n, D), got {x.shape}")
    n = x.shape[0]
    if n > max_sample:
        step = n // max_sample
        x = x[::step][:max_sample]
    x = np.asarray(x, dtype=np.float64)
    mean = x.mean(axis=0)
    xc = x - mean
    cov = (xc.T @ xc) / max(x.shape[0] - 1, 1)
    eigval, eigvec = np.linalg.eigh(cov)  # ascending
    order = np.argsort(eigval)[::-1]
    eigval = np.clip(eigval[order], 0.0, None)
    eigvec = eigvec[:, order]
    return PCAModel(
        mean=mean.astype(np.float32),
        components=eigvec.astype(np.float32),
        eigenvalues=eigval.astype(np.float32),
    )
