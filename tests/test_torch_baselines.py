"""The port's baseline coders (SQ, PCA, PQ), the Flash helpers the rerank
and calibration use, and the Theorem-1 margin functions, against the
reference's on the same numpy inputs, on the CPU.

Tolerances:
* SQ fit, decode and reconstruct, PCA transforms and coders: allclose at
  rtol 1e-6 (atol 1e-6 where values cross zero). SQ codes are equal except
  where ``(x − lo) / scale · levels`` lies within float32 noise of a .5
  boundary; those cases are counted and bounded (at most 1 in 10,000).
* PQ: the port fits its own k-means (a ``torch.Generator``), so the fit is
  held on quality: its quantization MSE within 5% of the reference's on the
  same sample. With the reference's codebooks carried across, codes are
  equal except at near ties (at most 1 in 1,000), and the ADC and SDC tables
  allclose at rtol 1e-5.
* Margin functions: allclose at rtol 1e-5, atol 1e-4; signs equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbl
from repro.core import flash as jflash
from repro.core import margin as jmargin
from repro.core import pca as jpca
from repro.core import quantize as jqz
from repro_torch.core import baselines as tbl
from repro_torch.core import flash as tflash
from repro_torch.core import margin as tmargin
from repro_torch.core import pca as tpca
from repro_torch.core import quantize as tqz
from conftest import make_clustered


@pytest.fixture(scope="module")
def dataset():
    return make_clustered(2000, 32, seed=4)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- SQ -------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8])
def test_sq_params_and_codes(dataset, bits):
    jp = jqz.sq_fit(jnp.asarray(dataset), bits=bits)
    tp = tqz.sq_fit(_t(dataset), bits=bits)
    np.testing.assert_allclose(_n(tp.lo), np.asarray(jp.lo), rtol=1e-6)
    np.testing.assert_allclose(_n(tp.scale), np.asarray(jp.scale), rtol=1e-6)
    assert tp.bits.dtype == torch.int32 and tp.bits.dim() == 0 and int(tp.bits) == bits
    assert tqz.sq_levels(bits) == jqz.sq_levels(bits) == (1 << bits) - 1
    assert int(tqz.sq_levels(tp.bits)) == (1 << bits) - 1
    np.testing.assert_allclose(_n(tqz.sq_dim_scales(tp)), np.asarray(jqz.sq_dim_scales(jp)), rtol=1e-6)
    # encode on the reference's parameters: equal codes except at .5 ties
    params = tqz.SQParams(*(_t(np.asarray(v)) for v in jp))
    got = _n(tqz.sq_encode(params, _t(dataset)))
    want = np.asarray(jqz.sq_encode(jp, jnp.asarray(dataset)))
    diff = got != want
    frac = (dataset - np.asarray(jp.lo)) / np.asarray(jp.scale) * ((1 << bits) - 1)
    near_half = np.abs(frac - np.floor(frac) - 0.5) < 1e-4
    assert not (diff & ~near_half).any(), "a code differs away from a .5 boundary"
    assert diff.sum() <= dataset.size // 10_000
    assert np.abs(got.astype(np.int64) - want).max(initial=0) <= 1
    np.testing.assert_allclose(_n(tqz.sq_decode(params, _t(want))),
                               np.asarray(jqz.sq_decode(jp, jnp.asarray(want))), rtol=1e-6, atol=1e-6)


def test_sq_coder_and_distance(dataset):
    jc = jbl.fit_sq(jnp.asarray(dataset), bits=8)
    tc = tbl.fit_sq(dataset, bits=8, device="cpu")
    np.testing.assert_allclose(_n(tc.s2), np.asarray(jc.s2), rtol=1e-6)
    assert tc.code_bytes == jc.code_bytes == 32.0
    np.testing.assert_allclose(_n(tbl.sq_reconstruct(tc, _t(dataset))),
                               np.asarray(jbl.sq_reconstruct(jc, jnp.asarray(dataset))),
                               rtol=1e-6, atol=1e-5)
    codes = np.asarray(jbl.sq_encode(jc, jnp.asarray(dataset)))
    got = _n(tbl.sq_dist(tc, _t(codes[:100, None]), _t(codes[None, :300])))
    want = np.asarray(jbl.sq_dist(jc, jnp.asarray(codes[:100, None]), jnp.asarray(codes[None, :300])))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---- PCA ------------------------------------------------------------------


def test_pca_transforms(dataset):
    jm, tm = jpca.fit_pca(dataset), tpca.fit_pca(dataset)
    for alpha in (0.5, 0.9, 0.99, 1.0):
        assert tpca.variance_dim(tm, alpha) == jpca.variance_dim(jm, alpha)
    x = dataset[:500]
    for d in (4, 17, 32):
        z_t, z_j = tpca.transform(tm, _t(x), d), jpca.transform(jm, jnp.asarray(x), d)
        np.testing.assert_allclose(_n(z_t), np.asarray(z_j), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(_n(tpca.inverse_transform(tm, z_t)),
                                   np.asarray(jpca.inverse_transform(jm, z_j)), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(_n(tpca.reconstruction_error(tm, _t(x), d)),
                                   np.asarray(jpca.reconstruction_error(jm, jnp.asarray(x), d)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(alpha=0.9), dict(d=12)])
def test_pca_coder(dataset, kw):
    jc = jbl.fit_pca_coder(jnp.asarray(dataset), **kw)
    tc = tbl.fit_pca_coder(dataset, device="cpu", **kw)
    assert tc.d == jc.d and tc.code_bytes == jc.code_bytes
    np.testing.assert_array_equal(_n(tc.mean), np.asarray(jc.mean))
    np.testing.assert_array_equal(_n(tc.rot), np.asarray(jc.rot))
    x = dataset[:300]
    z_t = tbl.pca_encode(tc, _t(x))
    np.testing.assert_allclose(_n(z_t), np.asarray(jbl.pca_encode(jc, jnp.asarray(x))), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(_n(tbl.pca_reconstruct(tc, _t(x))),
                               np.asarray(jbl.pca_reconstruct(jc, jnp.asarray(x))), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(_n(tbl.pca_dist(z_t[:50, None], z_t[None])),
                               np.asarray(jbl.pca_dist(jnp.asarray(_n(z_t)[:50, None]), jnp.asarray(_n(z_t)[None]))),
                               rtol=1e-5, atol=1e-4)


# ---- PQ -------------------------------------------------------------------


@pytest.fixture(scope="module")
def pq_pair(dataset):
    jc = jbl.fit_pq(jax.random.PRNGKey(0), jnp.asarray(dataset), m=8, l_pq=6, kmeans_iters=10)
    return jc, tbl.PQCoder(*(_t(np.asarray(v)) for v in jc))


def _pq_mse(recon: np.ndarray, x: np.ndarray) -> float:
    return float(((recon - x) ** 2).sum(1).mean())


def test_pq_fit_quality(dataset, pq_pair):
    jc, _ = pq_pair
    tc = tbl.fit_pq(dataset, m=8, l_pq=6, kmeans_iters=10, seed=0, device="cpu")
    assert (tc.m, tc.k, tc.ds) == (jc.m, jc.k, jc.ds) and tc.code_bytes == jc.code_bytes
    mse_t = _pq_mse(_n(tbl.pq_reconstruct(tc, _t(dataset))), dataset)
    mse_j = _pq_mse(np.asarray(jbl.pq_reconstruct(jc, jnp.asarray(dataset))), dataset)
    assert mse_t <= 1.05 * mse_j, (mse_t, mse_j)
    # the SDC tables follow the fitted codebooks exactly as the reference's do
    diff = tc.codebooks[:, :, None, :] - tc.codebooks[:, None, :, :]
    assert torch.equal(tc.sdc, (diff * diff).sum(-1))


@pytest.mark.parametrize("d", [32, 30])  # 30: the last subspace zero-padded
def test_pq_codes_and_tables_on_reference_codebooks(dataset, pq_pair, d):
    jc, tc = pq_pair
    if d != 32:
        jc = jbl.fit_pq(jax.random.PRNGKey(1), jnp.asarray(dataset[:, :d]), m=8, l_pq=6, kmeans_iters=5)
        tc = tbl.PQCoder(*(_t(np.asarray(v)) for v in jc))
    x = dataset[:, :d]
    got = _n(tbl.pq_encode(tc, _t(x)))
    want = np.asarray(jbl.pq_encode(jc, jnp.asarray(x)))
    assert (got != want).any(1).sum() <= len(x) // 1000
    q = x[:40]
    adc_t = _n(tbl.pq_adc_table(tc, _t(q)))
    adc_j = np.stack([np.asarray(jbl.pq_adc_table(jc, jnp.asarray(v))) for v in q])
    np.testing.assert_allclose(adc_t, adc_j, rtol=1e-5, atol=1e-4)
    codes = _t(want)
    np.testing.assert_allclose(_n(tbl.pq_sdc_lookup(tc, codes[:60, None], codes[None, :200])),
                               np.asarray(jbl.pq_sdc_lookup(jc, jnp.asarray(want[:60, None]),
                                                            jnp.asarray(want[None, :200]))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_n(tbl.pq_reconstruct(tc, _t(x[:200]))),
                               np.asarray(jbl.pq_reconstruct(jc, jnp.asarray(x[:200]))), rtol=1e-6, atol=1e-6)


# ---- Flash helpers ----------------------------------------------------------


@pytest.fixture(scope="module")
def flash_pair(dataset):
    jc = jflash.fit_flash(jax.random.PRNGKey(0), jnp.asarray(dataset), d_f=24, m_f=8, l_f=4, h=8,
                          kmeans_iters=8)
    return jc, tflash.FlashCoder(*(_t(np.asarray(v)) for v in jc))


def test_flash_reconstruct_and_estimate(dataset, flash_pair):
    jc, tc = flash_pair
    x = dataset[:300]
    np.testing.assert_allclose(_n(tflash.reconstruct(tc, _t(x))),
                               np.asarray(jflash.reconstruct(jc, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    sums = np.arange(0, 4000, 37, dtype=np.int32)
    np.testing.assert_allclose(_n(tflash.estimate_distance(tc, _t(sums))),
                               np.asarray(jflash.estimate_distance(jc, jnp.asarray(sums))), rtol=1e-6)


def test_neighbor_blocks_round_trip():
    codes = np.random.default_rng(0).integers(0, 16, (32, 8)).astype(np.int32)
    for b in (4, 8, 32):
        got = tflash.to_neighbor_blocks(_t(codes), b)
        np.testing.assert_array_equal(_n(got), np.asarray(jflash.to_neighbor_blocks(jnp.asarray(codes), b)))
        np.testing.assert_array_equal(_n(tflash.from_neighbor_blocks(got)), codes)
    with pytest.raises(ValueError, match="multiple"):
        tflash.to_neighbor_blocks(_t(codes), 5)


# ---- margin (Theorem 1) ---------------------------------------------------


def test_margin_functions(dataset):
    rng = np.random.default_rng(2)
    u, v, w = (dataset[rng.integers(0, 2000, 400)] for _ in range(3))
    eu, ev, ew = (rng.normal(size=u.shape).astype(np.float32) * 0.1 for _ in range(3))
    j = [jnp.asarray(a) for a in (u, v, w, eu, ev, ew)]
    t = [_t(a) for a in (u, v, w, eu, ev, ew)]
    m_t, m_j = _n(tmargin.hyperplane_margin(*t[:3])), np.asarray(jmargin.hyperplane_margin(*j[:3]))
    np.testing.assert_allclose(m_t, m_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_n(tmargin.error_term(*t)), np.asarray(jmargin.error_term(*j)),
                               rtol=1e-5, atol=1e-4)
    s_t = _n(tmargin.comparison_sign(*t[:3]))
    np.testing.assert_array_equal(s_t, np.asarray(jmargin.comparison_sign(*j[:3])))
    np.testing.assert_array_equal(s_t, tmargin.np_ground_truth_sign(u, v, w))
    # Lemma 1: δ(u,v) − δ(u,w) = 2(e·u − b), so the signs agree
    ok = np.abs(m_t) > 1e-3
    np.testing.assert_array_equal(np.sign(m_t[ok]), s_t[ok])


def test_triples_pick_the_reference_neighbours(dataset):
    """Given the reference's sampled rows, the port picks the same nearest
    and second-nearest pool rows (``lax.top_k``'s order). One difference is
    the reference's own: a sampled row that also lies in the pool should be
    struck as its own neighbour (d² < 1e-9), but ‖q‖² + ‖p‖² − 2q·p of a
    row with itself is float32 rounding noise, often above 1e-9, and the
    noise differs between XLA's product and torch's. So where the row is in
    the pool, the nearest pool row other than itself is compared."""
    key = jax.random.PRNGKey(5)
    jt = jmargin.sample_triples(key, jnp.asarray(dataset), n_triples=200, pool=1500)
    kq, kp = jax.random.split(key)
    q_idx = np.asarray(jax.random.choice(kq, 2000, shape=(200,), replace=False))
    p_idx = np.asarray(jax.random.choice(kp, 2000, shape=(1500,), replace=False))
    tt = tmargin.triples_from(_t(dataset), q_idx, p_idx)
    np.testing.assert_array_equal(_n(tt.u), np.asarray(jt.u))
    in_pool = np.isin(q_idx, p_idx)
    assert 0 < in_pool.sum() < len(q_idx)
    for a, b in ((tt.v, jt.v), (tt.w, jt.w)):
        np.testing.assert_array_equal(_n(a)[~in_pool], np.asarray(b)[~in_pool])

    def first_other(t):
        u, v, w = (np.asarray(_n(a)) for a in t)
        return np.where((v == u).all(1, keepdims=True), w, v)

    np.testing.assert_array_equal(first_other(tt)[in_pool], first_other(jt)[in_pool])
    gen = torch.Generator().manual_seed(0)
    own = tmargin.sample_triples(gen, _t(dataset), n_triples=64, pool=500)
    assert all(t.shape == (64, 32) for t in own)
    assert not (own.v == own.w).all(1).any()  # two distinct pool rows


def test_satisfaction_rate_and_calibrate(dataset, flash_pair):
    jc, tc = flash_pair
    key = jax.random.PRNGKey(5)
    jt = jmargin.sample_triples(key, jnp.asarray(dataset), n_triples=200, pool=1500)
    tt = tmargin.TripleSet(*(_t(np.asarray(a)) for a in jt))
    got = tmargin.margin_satisfaction_rate(tt, lambda x: tflash.reconstruct(tc, x))
    want = jmargin.margin_satisfaction_rate(jt, lambda x: jflash.reconstruct(jc, x))
    for a, b in zip(got, want):  # rates over 200 triples: a flip moves 0.005
        assert abs(float(a) - float(b)) <= 0.01
    sq = {bits: tbl.fit_sq(dataset, bits=bits, device="cpu") for bits in (2, 4, 8)}
    best = tmargin.calibrate(
        torch.Generator().manual_seed(1), _t(dataset),
        lambda bits: (lambda x: tbl.sq_reconstruct(sq[bits], x), sq[bits].code_bytes),
        [dict(bits=b) for b in (2, 4, 8)], target_rate=0.9, n_triples=256,
    )
    assert len(best["all_results"]) == 3 and best["bits"] in (2, 4, 8)
    rates = {r["bits"]: r["sign_rate"] for r in best["all_results"]}
    assert rates[8] >= rates[2]
