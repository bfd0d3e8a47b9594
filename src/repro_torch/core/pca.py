"""Principal component extraction (paper §3.3.2).

The decomposition is a float64 covariance ``eigh`` on the host, exactly as
the reference does it, so the PCA half of a Flash coder fitted on the same
rows is bit-equal between the two packages. The model's arrays stay numpy;
``transform`` and its inverse move them to the input's device.
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


def variance_dim(model: PCAModel, alpha: float) -> int:
    """Smallest d with cumulative explained variance >= alpha (paper f(d))."""
    ev = np.asarray(model.eigenvalues, dtype=np.float64)
    total = ev.sum()
    if total <= 0:
        return model.dim
    frac = np.cumsum(ev) / total
    return int(np.searchsorted(frac, alpha) + 1)


def _on(arr, like: torch.Tensor) -> torch.Tensor:
    """A model array (numpy or tensor) as a tensor on ``like``'s device."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr))
    return t.to(like.device)


def transform(model: PCAModel, x: torch.Tensor, d: int | None = None) -> torch.Tensor:
    """Project ``x`` (…, D) onto the first ``d`` principal components."""
    d = model.dim if d is None else d
    return (x - _on(model.mean, x)) @ _on(model.components, x)[:, :d]


def inverse_transform(model: PCAModel, z: torch.Tensor) -> torch.Tensor:
    """Lift ``z`` (…, d) back to the original space (the tail zero-padded):
    the reconstruction of Theorem 1's error vector E_u = u − inverse(transform(u))."""
    d = z.shape[-1]
    return z @ _on(model.components, z)[:, :d].T + _on(model.mean, z)


def reconstruction_error(model: PCAModel, x: torch.Tensor, d: int) -> torch.Tensor:
    """Per-row L2 reconstruction error when keeping ``d`` components."""
    xr = inverse_transform(model, transform(model, x, d))
    return torch.linalg.vector_norm(x - xr, dim=-1)
