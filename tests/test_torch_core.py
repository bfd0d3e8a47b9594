"""The port's Flash coder against the reference package's.

Two holds, as the port's contract sets them:

1. On the reference's fitted coder carried over by ``from_state``, the
   port's ``encode``/``query_ctx`` give the same codewords and ADT levels up
   to float summation order: codeword mismatch rate ≤ 1e-3, and ADT levels
   differ by at most 1 on ≤ 1e-3 of entries (the measured rates are in
   the assertion messages).
2. The port's own ``fit_flash`` (its own k-means draws) reaches a mean
   reconstruction error within 5% of the reference fit's on the same data.

The PCA half is float64 numpy on the host in both packages: bit-equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flash as jflash
from repro.core import pca as jpca
from repro.core import quantize as jqz
from repro.graph import backends as jbk
from repro_torch.core import flash as tflash
from repro_torch.core import pca as tpca
from repro_torch.core import quantize as tqz
from repro_torch.graph import backends as tbk
from conftest import make_clustered

FLASH_KW = dict(d_f=32, m_f=16, l_f=4, h=8, kmeans_iters=8)


@pytest.fixture(scope="module")
def dataset():
    x = make_clustered(2256, 48, seed=3)
    return x[:2000], x[2000:]


@pytest.fixture(scope="module")
def coders(dataset):
    """(reference FlashBlockedBackend, the same state restored in the port)."""
    data, _ = dataset
    jbe = jbk.make_backend("flash_blocked", jnp.asarray(data), jax.random.PRNGKey(0),
                           r_for_blocked=16, **FLASH_KW)
    tbe = tbk.FlashBlockedBackend.from_state(
        {k: np.asarray(v) for k, v in jbe.state_dict().items()}, device="cpu"
    )
    return jbe, tbe


def _recon_error(state: dict, data: np.ndarray, codes: np.ndarray) -> float:
    """Mean L2 error of decode(codes) lifted back to the input space — the
    same numpy formula for both packages' coders."""
    cb = np.asarray(state["coder.codebooks"], np.float64)  # (M, K, ds)
    m = cb.shape[0]
    z_hat = cb[np.arange(m)[None, :], codes].reshape(len(codes), -1)
    rot = np.asarray(state["coder.rot"], np.float64)
    xr = z_hat @ rot.T + np.asarray(state["coder.mean"], np.float64)
    return float(np.linalg.norm(data - xr, axis=1).mean())


def test_pca_is_bit_equal(dataset):
    data, _ = dataset
    ref = jpca.fit_pca(jnp.asarray(data), max_sample=1024)
    got = tpca.fit_pca(data, max_sample=1024)
    np.testing.assert_array_equal(got.mean, np.asarray(ref.mean))
    np.testing.assert_array_equal(got.components, np.asarray(ref.components))
    np.testing.assert_array_equal(got.eigenvalues, np.asarray(ref.eigenvalues))


def test_quantize_table_is_bit_equal_on_equal_inputs():
    rng = np.random.default_rng(0)
    table = (rng.random((64, 16, 16)) * 40).astype(np.float32)
    lo, hi = table.min(axis=(1, 2)), table.max(axis=(1, 2))
    ref = jqz.fit_table_quant(jnp.asarray(lo[:16]), jnp.asarray(hi[:16]), h=8)
    tq = tqz.TableQuant(
        torch.tensor(np.asarray(ref.dist_min)), torch.tensor(np.asarray(ref.delta)),
        torch.tensor(8, dtype=torch.int32),
    )
    got = tqz.quantize_table(tq, torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jqz.quantize_table(ref, jnp.asarray(table))))
    deq = tqz.dequantize_table(tq, torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(deq, np.asarray(jqz.dequantize_table(ref, jnp.asarray(got))), rtol=1e-6)


def test_encode_matches_reference_coder(coders, dataset):
    jbe, tbe = coders
    data, _ = dataset
    got = tflash.encode(tbe.coder, torch.from_numpy(data)).numpy()
    ref = np.asarray(jflash.encode(jbe.coder, jnp.asarray(data)))
    rate = float((got != ref).mean())
    assert rate <= 1e-3, f"codeword mismatch rate {rate:.2e}"
    np.testing.assert_array_equal(tbe.codes.numpy(), np.asarray(jbe.codes))


def test_query_ctx_matches_reference_coder(coders, dataset):
    jbe, tbe = coders
    data, queries = dataset
    x = np.concatenate([data[:500], queries])
    ref = jax.vmap(lambda v: jflash.query_ctx(jbe.coder, v))(jnp.asarray(x))
    got = tflash.query_ctx(tbe.coder, torch.from_numpy(x))
    diff = np.abs(got.adt_q.numpy().astype(np.int64) - np.asarray(ref.adt_q))
    assert diff.max() <= 1, f"an ADT level moved by {diff.max()}"
    level_rate = float((diff > 0).mean())
    assert level_rate <= 1e-3, f"ADT level mismatch rate {level_rate:.2e}"
    code_rate = float((got.codes.numpy() != np.asarray(ref.codes)).mean())
    assert code_rate <= 1e-3, f"codeword mismatch rate {code_rate:.2e}"
    np.testing.assert_allclose(got.adt_f.numpy(), np.asarray(ref.adt_f), rtol=1e-4, atol=1e-4)


def test_adc_sdc_lookups_are_bit_equal(coders):
    jbe, tbe = coders
    rng = np.random.default_rng(1)
    a = rng.integers(0, 16, (7, 5, 16)).astype(np.int32)
    b = rng.integers(0, 16, (7, 5, 16)).astype(np.int32)
    ref = np.asarray(jflash.sdc_lookup(jbe.coder, jnp.asarray(a), jnp.asarray(b)))
    got = tflash.sdc_lookup(tbe.coder, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, ref)
    mat = tflash.sdc_matrix(tbe.coder, torch.from_numpy(a)).numpy()
    want = np.asarray(jflash.sdc_lookup(jbe.coder, jnp.asarray(a)[:, :, None], jnp.asarray(a)[:, None, :]))
    np.testing.assert_array_equal(mat, want.astype(np.float32))
    adt = rng.integers(0, 256, (7, 16, 16)).astype(np.int32)
    got = tflash.adc_lookup(torch.from_numpy(adt), torch.from_numpy(a)).numpy()
    ref = np.stack([np.asarray(jflash.adc_lookup(jnp.asarray(adt[i]), jnp.asarray(a[i]))) for i in range(7)])
    np.testing.assert_array_equal(got, ref)


def test_own_fit_reaches_reference_quality(coders, dataset):
    jbe, _ = coders
    data, _ = dataset
    own = tbk.make_backend("flash_blocked", data, seed=0, r_for_blocked=16, device="cpu", **FLASH_KW)
    err_ref = _recon_error(
        {k: np.asarray(v) for k, v in jbe.state_dict().items()}, data, np.asarray(jbe.codes)
    )
    err_own = _recon_error(own.state_dict(), data, own.codes.numpy())
    assert err_own <= 1.05 * err_ref, f"port {err_own:.4f} vs reference {err_ref:.4f}"
    # the tables the port fitted are a valid Eq. 9 quantization
    sdt = own.coder.sdt_q.numpy()
    assert sdt.min() >= 0 and sdt.max() <= 255
    assert own.nbr_codes.dtype == torch.uint8 and tuple(own.nbr_codes.shape) == (2000, 16, 8)


def test_state_dict_round_trips_reference_keys_and_dtypes(coders):
    jbe, tbe = coders
    ref = jbe.state_dict()
    got = tbe.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
    back = jbk.FlashBlockedBackend.from_state(got)
    np.testing.assert_array_equal(np.asarray(back.codes), np.asarray(jbe.codes))
