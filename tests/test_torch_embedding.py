"""The port's sparse embedding ops against the reference's
(``repro.models.recsys.embedding``) on the same numpy inputs, on the CPU.

* ``embedding_bag`` (sum / mean / max), with and without a mask, bags with
  no valid slot included: max equal; sum and mean allclose at rtol 1e-6,
  atol 1e-6 (XLA's reduction sums the L rows in another order).
* ``embedding_bag_ragged`` (sum / mean / max), with empty bags (max gives
  −inf there, as ``jax.ops.segment_max``) and bag ids outside [0, n_bags)
  (dropped by both): allclose at rtol 1e-6, atol 1e-6 (the scatter sums in
  another order); max equal.
* ``hash_embedding`` with 1–4 hashes: rows equal for ids that are negative,
  ≥ 2³¹ and near 2³² (the reference wraps them to uint32; the port takes
  them mod 2³² in int64 without overflow), and the result equal.
* ``qr_embedding`` with negative ids (floor division and modulo as
  Python's): equal.
* ``embedding_bag_oracle`` (sum / mean) with out-of-range ids as zero
  rows: allclose at rtol 1e-5, atol 1e-6 (a one-hot product).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.recsys import embedding as jemb
from repro_torch.models.recsys import embedding as temb

V, D, B, L = 97, 8, 6, 5


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    mask = rng.random((B, L)) < 0.6
    mask[0] = False  # a bag with no valid slot
    mask[1] = True
    return table, idx, mask


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("masked", [True, False])
def test_embedding_bag(inputs, reduce, masked):
    table, idx, mask = inputs
    m = mask if masked else None
    want = np.asarray(jemb.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                         None if m is None else jnp.asarray(m), reduce=reduce))
    got = temb.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                             None if m is None else torch.from_numpy(m), reduce=reduce).numpy()
    assert got.shape == want.shape == (B, D)
    if reduce == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_embedding_bag_unknown_reduce(inputs):
    table, idx, _ = inputs
    with pytest.raises(ValueError):
        temb.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx), reduce="min")


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_embedding_bag_ragged(inputs, reduce):
    table = inputs[0]
    rng = np.random.default_rng(1)
    n_bags = 7
    flat = rng.integers(0, V, 40).astype(np.int32)
    seg = rng.integers(0, n_bags, 40).astype(np.int32)
    seg[seg == 3] = 4  # bag 3 is empty
    seg[:2] = [n_bags, -1]  # outside [0, n_bags): dropped by both
    want = np.asarray(jemb.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat), jnp.asarray(seg),
                                                n_bags, reduce=reduce))
    got = temb.embedding_bag_ragged(torch.from_numpy(table), torch.from_numpy(flat), torch.from_numpy(seg),
                                    n_bags, reduce=reduce).numpy()
    assert got.shape == want.shape == (n_bags, D)
    if reduce == "max":
        assert np.all(np.isneginf(got[3]))
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(got[3] == 0)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_hashes", [1, 2, 3, 4])
def test_hash_embedding_wraps_like_uint32(inputs, n_hashes):
    table = inputs[0]
    ids = np.array([0, 1, 7, -1, -2, -(2 ** 31), 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 5, 2 ** 32 - 1,
                    123456789, -987654321], dtype=np.int64)
    # the reference takes int32 (x64 off): ≥ 2³¹ as its two's complement
    j_ids = jnp.asarray(ids.astype(np.uint32).view(np.int32))
    want = np.asarray(jemb.hash_embedding(jnp.asarray(table), j_ids, n_hashes=n_hashes))
    got = temb.hash_embedding(torch.from_numpy(table), torch.from_numpy(ids), n_hashes=n_hashes).numpy()
    for pr in temb._PRIMES[:n_hashes]:  # every id lands on the reference's row
        want_rows = (ids.astype(np.uint64) % 2 ** 32 * pr % 2 ** 32) % V
        np.testing.assert_array_equal(temb._hash_rows(torch.from_numpy(ids), pr, V).numpy(), want_rows)
    np.testing.assert_array_equal(got, want)


def test_qr_embedding(inputs):
    rng = np.random.default_rng(2)
    q_table = rng.normal(size=(11, D)).astype(np.float32)
    r_table = rng.normal(size=(9, D)).astype(np.float32)
    ids = np.concatenate([rng.integers(0, 99, 20), [-1, -10, -100]]).astype(np.int32)
    want = np.asarray(jemb.qr_embedding(jnp.asarray(q_table), jnp.asarray(r_table), jnp.asarray(ids)))
    got = temb.qr_embedding(torch.from_numpy(q_table), torch.from_numpy(r_table), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_embedding_bag_oracle(inputs, reduce):
    table, idx, mask = inputs
    idx = idx.copy()
    idx[2, 0] = V + 3  # out of range: a zero row in both
    want = np.asarray(jemb.embedding_bag_oracle(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(mask),
                                                reduce=reduce))
    got = temb.embedding_bag_oracle(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(mask),
                                    reduce=reduce).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        temb.embedding_bag_oracle(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(mask),
                                  reduce="max")
