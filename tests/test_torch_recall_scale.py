"""Recall at scale is bound by the Flash coder, in the reference as in the port.

On ``vector_dataset(seed=0, d=128, n_clusters=64)`` the main path's coder
(d_f = 64, M = 16, 4-bit codes, H = 8) ranks the true neighbours lower and
lower as n grows: the clusters are Gaussian blobs in 128 dims, so the true
10-NN sit barely closer than thousands of other rows, and the 4-bit codes
cannot tell them apart. Whatever graph searches those codes, it cannot beat
an exhaustive scan of them.

This file measures that ceiling with each package's own coder, fitted on
the same rows: every base row is scored by its ADT sum, the best ``C`` are
reranked exactly, and recall@10 is taken against exact k-NN. The
reference's side is ``repro.core.flash`` (JAX on the CPU) alone, so it is a
witness that does not use the port. Holds:

* at each n the port's scan recall is within 0.03 of the reference's (the
  two k-means fits draw differently);
* the reference's scan recall at 100k is below 0.5 and below its recall at
  10k: the fall comes from the coder and the data, not from the port.

The measured recalls are in the assertion messages and printed (``-s``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flash as jflash
from repro.data.synthetic import vector_dataset
from repro_torch.core import flash as tflash

CODER_KW = dict(d_f=64, m_f=16, l_f=4, h=8)  # the main path's coder
SIZES = (10_000, 100_000)
QUERIES = 1000  # held-out rows after the base rows, as the card's smoke run takes them
C = 256  # candidates kept for the exact rerank: a search at ef = 256
K_NN = 10
_QCHUNK = 100


def _exact_knn(data: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    x = data.astype(np.float64)
    x2 = (x * x).sum(1)
    out = []
    for s in range(0, len(queries), _QCHUNK):
        q = queries[s:s + _QCHUNK].astype(np.float64)
        d = x2[None, :] - 2.0 * q @ x.T
        out.append(np.argsort(d, axis=1, kind="stable")[:, :k])
    return np.concatenate(out)


def _scan_recall(adt: np.ndarray, codes: np.ndarray, data: np.ndarray,
                 queries: np.ndarray, gt: np.ndarray) -> float:
    """recall@10 of scoring every row by Σ_m adt[q, m, codes[i, m]], keeping
    the best C and reranking them by exact L2."""
    hits = 0
    for s in range(0, len(queries), _QCHUNK):
        a = adt[s:s + _QCHUNK].astype(np.int32)
        sums = np.zeros((len(a), len(codes)), np.int32)
        for m in range(codes.shape[1]):
            sums += a[:, m, :][:, codes[:, m]]
        cand = np.argpartition(sums, C, axis=1)[:, :C]
        q = queries[s:s + _QCHUNK]
        exact = ((data[cand] - q[:, None, :]) ** 2).sum(-1)
        top = np.take_along_axis(cand, np.argsort(exact, axis=1)[:, :K_NN], 1)
        hits += sum(len(set(t) & set(g)) for t, g in zip(top, gt[s:s + _QCHUNK]))
    return hits / (len(queries) * K_NN)


@pytest.fixture(scope="module")
def scan_recalls() -> dict[int, tuple[float, float]]:
    """n -> (reference scan recall, port scan recall)."""
    out = {}
    for n in SIZES:
        allx = vector_dataset(0, n=n + QUERIES, d=128, n_clusters=64)
        data, queries = allx[:n], allx[n:]
        gt = _exact_knn(data, queries, K_NN)

        jcoder = jflash.fit_flash(jax.random.PRNGKey(0), jnp.asarray(data), **CODER_KW)
        jcodes = np.asarray(jflash.encode(jcoder, jnp.asarray(data)))
        jadt = np.asarray(jax.vmap(lambda v: jflash.query_ctx(jcoder, v).adt_q)(jnp.asarray(queries)))
        ref = _scan_recall(jadt, jcodes, data, queries, gt)

        tcoder = tflash.fit_flash(data, seed=0, device="cpu", **CODER_KW)
        tcodes = tflash.encode(tcoder, torch.from_numpy(data)).numpy()
        tadt = tflash.query_ctx(tcoder, torch.from_numpy(queries)).adt_q.numpy()
        port = _scan_recall(tadt, tcodes, data, queries, gt)
        print(f"n={n}: exhaustive scan (C={C}) recall@10 reference {ref:.4f}, port {port:.4f}")
        out[n] = (ref, port)
    return out


@pytest.mark.parametrize("n", SIZES)
def test_port_scan_recall_matches_reference(scan_recalls, n):
    ref, port = scan_recalls[n]
    assert abs(port - ref) <= 0.03, f"n={n}: port {port:.4f} vs reference {ref:.4f}"


def test_reference_scan_recall_falls_with_scale(scan_recalls):
    small, large = scan_recalls[SIZES[0]][0], scan_recalls[SIZES[1]][0]
    assert large < 0.5, f"reference scan recall@10 at n={SIZES[1]} is {large:.4f}"
    assert large < small, f"reference scan recall@10: {small:.4f} at n={SIZES[0]}, {large:.4f} at n={SIZES[1]}"
