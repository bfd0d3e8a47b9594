"""The port's exact k-NN oracle (``graph/knn.py``) against the reference's,
on the CPU.

``exact_knn`` runs with a chunk that does not divide n, so the last tile is
ragged (the reference pads it; the port slices it). Ids must be equal —
both merge the running best before the new chunk and break ties at the
lower slot — and distances allclose with rtol 1e-5 and atol 1e-5 times
the largest ‖q‖² + ‖x‖² (the float32 products sum in another order; the
seeded set has no k-th-neighbour near tie, which the test measures).
``recall_at_k`` and ``average_distance_ratio`` agree with the reference's
to 1e-6 (the reference averages in float32).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.knn import average_distance_ratio as j_adr
from repro.graph.knn import exact_knn as j_knn
from repro.graph.knn import recall_at_k as j_recall
from repro_torch.graph.knn import average_distance_ratio, exact_knn, recall_at_k
from conftest import make_clustered


@pytest.fixture(scope="module")
def sets():
    x = make_clustered(1530, 24, seed=21)
    return x[:1500], x[1500:]


@pytest.mark.parametrize("k,chunk", [(10, 256), (7, 1000), (10, 4096)])
def test_exact_knn_matches_reference(sets, k, chunk):
    data, queries = sets
    ids, d = exact_knn(torch.from_numpy(queries), torch.from_numpy(data), k=k, chunk=chunk)
    jids, jd = j_knn(jnp.asarray(queries), jnp.asarray(data), k=k, chunk=chunk)
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (queries.shape[0], k)
    full = ((queries[:, None, :].astype(np.float64) - data[None]) ** 2).sum(-1)
    kth = np.sort(full, 1)[:, k - 1 : k + 1]
    assert float((kth[:, 1] - kth[:, 0]).min()) > 1e-3  # no k-th-place near tie
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    scale = float((queries ** 2).sum(1).max() + (data ** 2).sum(1).max())
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_array_equal(ids.numpy(), np.argsort(full, 1, kind="stable")[:, :k])


def test_exact_knn_fewer_rows_than_k_pads_like_the_reference():
    rng = np.random.default_rng(2)
    data = rng.normal(size=(4, 8)).astype(np.float32)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    ids, d = exact_knn(torch.from_numpy(q), torch.from_numpy(data), k=6, chunk=3)
    jids, jd = j_knn(jnp.asarray(q), jnp.asarray(data), k=6, chunk=3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert (ids[:, 4:] == -1).all() and torch.isinf(d[:, 4:]).all()


def test_recall_and_adr_match_reference(sets):
    data, queries = sets
    gt, gd = exact_knn(torch.from_numpy(queries), torch.from_numpy(data), k=10)
    rng = np.random.default_rng(0)
    found = gt.numpy().copy()
    found[rng.random(found.shape) < 0.3] = rng.integers(0, 1500)  # misses
    found[:, -1] = -1
    truth = gt.numpy().copy()
    truth[0, :3] = -1  # padded truth never counts as a hit
    got = recall_at_k(torch.from_numpy(found), torch.from_numpy(truth), 10)
    want = j_recall(jnp.asarray(found), jnp.asarray(truth), 10)
    assert got == pytest.approx(want, abs=1e-6) and 0 < got < 1
    found_d = gd.numpy() * rng.uniform(1.0, 1.5, gd.shape).astype(np.float32)
    got = average_distance_ratio(torch.from_numpy(found_d), gd, 10)
    want = j_adr(jnp.asarray(found_d), jnp.asarray(gd.numpy()), 10)
    assert got == pytest.approx(want, abs=1e-6) and got > 1.0
