"""The paper's three baseline coders for graph construction (§3.2), in
PyTorch (reference: repro.core.baselines).

* :class:`PQCoder`  — product quantization: float ADC tables for the
  acquisition stage, SDC (inter-centroid) tables for selection (§3.2.1).
  Default L_PQ = 8 (K = 256 centroids per subspace).
* :class:`SQCoder`  — per-dimension scalar quantization with the
  quantized-domain ("no-decode") distance (§3.2.2).
* :class:`PCACoder` — dimensionality reduction: full-precision L2 on the
  first d_PCA principal components (§3.2.3).

The formulas and their op order are the reference's. The PQ fit's k-means
draws from a ``torch.Generator`` where the reference draws from
``jax.random``, so a fitted PQ coder is held to the reference on quality,
not on bits; with the reference's codebooks carried across, codes and
tables agree (``tests/test_torch_baselines.py``). Query-side functions take
a leading batch axis (the reference ``vmap``s them).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import kmeans as km
from repro_torch.core import pca as pca_mod
from repro_torch.core import quantize as qz
from repro_torch.core.flash import _partial_dists, _split_subspaces
from repro_torch.utils import resolve_device

#: (M · rows · K) distance elements one PQ encode block may hold
_PQ_ENCODE_ELEMS = 1 << 26


def _as_f32(x, dev: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
    return t.to(device=dev, dtype=torch.float32)


# ---------------------------------------------------------------------------
# PQ
# ---------------------------------------------------------------------------


class PQCoder(NamedTuple):
    """Product quantizer state.

    codebooks: (M, K, ds) centroids on the raw dims (no rotation, unlike
               Flash); D is zero-padded up to M·ds.
    sdc:       (M, K, K)  float inter-centroid squared partial distances.
    """

    codebooks: torch.Tensor
    sdc: torch.Tensor

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def k(self) -> int:
        return self.codebooks.shape[1]

    @property
    def ds(self) -> int:
        return self.codebooks.shape[2]

    @property
    def code_bytes(self) -> float:
        return self.m * math.log2(self.k) / 8.0


def fit_pq(
    sample,
    *,
    m: int,
    l_pq: int = 8,
    kmeans_iters: int = 25,
    max_fit_sample: int = 32768,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> PQCoder:
    """Fit M subspace codebooks of K = 2^l_pq words on the first
    ``max_fit_sample`` rows of ``sample`` (n, D); ``seed`` seeds the
    k-means generator on ``device``."""
    dev = resolve_device(device)
    x = _as_f32(sample, dev)[:max_fit_sample]
    k = 1 << l_pq
    ds = -(-x.shape[1] // m)
    subs = _split_subspaces(x, m, ds).contiguous()  # (M, n, ds)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    codebooks, _ = km.kmeans_fit_batched(gen, subs, k=k, iters=kmeans_iters)
    diff = codebooks[:, :, None, :] - codebooks[:, None, :, :]
    return PQCoder(codebooks=codebooks, sdc=(diff * diff).sum(-1))


def pq_encode(coder: PQCoder, x: torch.Tensor) -> torch.Tensor:
    """(n, D) -> (n, M) int32 codes (nearest centroid, first on ties)."""
    out = torch.empty((x.shape[0], coder.m), dtype=torch.int32, device=x.device)
    block = max(1, _PQ_ENCODE_ELEMS // (coder.m * coder.k))
    for s in range(0, x.shape[0], block):
        subs = _split_subspaces(x[s:s + block], coder.m, coder.ds).contiguous()
        out[s:s + block] = km.assign_codes_batched(subs, coder.codebooks).T
    return out


def pq_adc_table(coder: PQCoder, q: torch.Tensor) -> torch.Tensor:
    """Asymmetric distance tables for queries (Q, D) -> (Q, M, K) float32."""
    subs = _split_subspaces(q, coder.m, coder.ds).contiguous()  # (M, Q, ds)
    return _partial_dists(subs, coder.codebooks).permute(1, 0, 2).contiguous()


def pq_decode(coder: PQCoder, codes: torch.Tensor) -> torch.Tensor:
    """Codes (…, M) -> the concatenated centroids (…, M·ds), still padded
    (callers cut to D)."""
    m_idx = torch.arange(coder.m, device=codes.device)
    gathered = coder.codebooks[m_idx, codes.long()]  # (…, M, ds)
    return gathered.reshape(*gathered.shape[:-2], -1)


def pq_reconstruct(coder: PQCoder, x: torch.Tensor) -> torch.Tensor:
    """decode(encode(x)) cut to D: (n, D) -> (n, D)."""
    return pq_decode(coder, pq_encode(coder, x))[:, : x.shape[1]]


def pq_sdc_lookup(coder: PQCoder, codes_a: torch.Tensor, codes_b: torch.Tensor) -> torch.Tensor:
    """Symmetric distance between coded vectors: Σ_m sdc[m, a_m, b_m] for
    broadcastable (…, M) codes -> (…,) float32."""
    codes_a, codes_b = torch.broadcast_tensors(codes_a, codes_b)
    m_idx = torch.arange(coder.m, device=codes_a.device)
    return coder.sdc[m_idx, codes_a.long(), codes_b.long()].sum(-1)


# ---------------------------------------------------------------------------
# SQ
# ---------------------------------------------------------------------------


class SQCoder(NamedTuple):
    """Scalar quantizer state (per-dimension affine, L_SQ bits)."""

    params: qz.SQParams
    s2: torch.Tensor  # (D,) per-dim squared scale for quantized-domain L2

    @property
    def code_bytes(self) -> float:
        return self.params.lo.shape[0] * int(self.params.bits) / 8.0


def fit_sq(sample, *, bits: int = 8, device: str | torch.device = "cuda") -> SQCoder:
    params = qz.sq_fit(_as_f32(sample, resolve_device(device)), bits=bits)
    return SQCoder(params=params, s2=qz.sq_dim_scales(params))


def sq_encode(coder: SQCoder, x: torch.Tensor) -> torch.Tensor:
    return qz.sq_encode(coder.params, x)


def sq_reconstruct(coder: SQCoder, x: torch.Tensor) -> torch.Tensor:
    return qz.sq_decode(coder.params, qz.sq_encode(coder.params, x))


def sq_dist(coder: SQCoder, qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Quantized-domain squared L2 Σ_d s2_d (qa_d − qb_d)² of broadcastable
    (…, D) int32 codes: an integer subtraction, then one float
    scale-accumulate (no decode; ``ops.sq_l2`` is the contiguous-table
    kernel of the same sum)."""
    diff = (qa - qb).to(torch.float32)
    return (coder.s2 * diff * diff).sum(-1)


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------


class PCACoder(NamedTuple):
    """Dimensionality-reduction coder: keep d principal components."""

    mean: torch.Tensor  # (D,)
    rot: torch.Tensor  # (D, d)

    @property
    def d(self) -> int:
        return self.rot.shape[1]

    @property
    def code_bytes(self) -> float:
        return self.d * 4.0


def fit_pca_coder(
    sample, *, d: int | None = None, alpha: float = 0.9, device: str | torch.device = "cuda"
) -> PCACoder:
    """Fit; if ``d`` is None keep the smallest d with cumulative variance
    >= alpha (the paper sets d_PCA at 90%)."""
    dev = resolve_device(device)
    model = pca_mod.fit_pca(sample)
    if d is None:
        d = pca_mod.variance_dim(model, alpha)
    return PCACoder(
        mean=torch.from_numpy(model.mean).to(dev),
        rot=torch.from_numpy(np.ascontiguousarray(model.components[:, :d])).to(dev),
    )


def pca_encode(coder: PCACoder, x: torch.Tensor) -> torch.Tensor:
    return (x - coder.mean) @ coder.rot


def pca_reconstruct(coder: PCACoder, x: torch.Tensor) -> torch.Tensor:
    return pca_encode(coder, x) @ coder.rot.T + coder.mean


def pca_dist(za: torch.Tensor, zb: torch.Tensor) -> torch.Tensor:
    """Squared L2 in the reduced space (a rotation keeps norms: comparable)."""
    diff = za - zb
    return (diff * diff).sum(-1)
