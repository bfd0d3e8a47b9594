"""The port's kernels against the reference package's kernels.

On the CPU each wrapper in ``repro_torch.kernels.ops`` runs its plain
PyTorch version; these tests hold that version against the reference's
jnp oracle (``repro.kernels.ref``) and its Pallas kernel in interpret mode
(``repro.kernels.ops.*(impl="interpret")``), on the same numpy inputs, over
both mirror layouts and both table dtypes. Integer tables must be equal;
float32 tables allclose with rtol 1e-5 and atol 1e-5·M·max|table| (the
sums run in another order). ``l2_batch`` is held with rtol 1e-5 and
atol 1e-5·max(‖x‖² + ‖y‖²) (the float32 products sum in another order and
x2 + y2 − 2xy cancels), and its routes (``nearest_centroid``) must be
equal. ``flash_scan`` is held the same way at K ∈ {16, 256}: equal for
int32 tables, rtol 1e-6 and atol 1e-6·M·max|table| for float32 (the plain
version adds in m order, the reference in its own). ``sq_l2`` is held with
rtol 1e-5 (a sum of D non-negative float32 terms in another order). The
CUDA kernels themselves are held against the same plain versions on the
card by ``test_torch_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flash as jflash
from repro.core import quantize as jqz
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import flash as tflash
from repro_torch.core import quantize as tqz
from repro_torch.kernels import ops as tops
from repro_torch.utils import resolve_device

K = 16


def _table(rng, shape, dtype):
    if dtype == "int32":
        return rng.integers(0, 256, shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32) * 3.0


def _check(got, want, table: np.ndarray, m: int):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if table.dtype == np.int32:
        np.testing.assert_array_equal(got, want)
    else:
        atol = 1e-5 * m * float(np.abs(table).max())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("b,c,m", [(5, 40, 16), (3, 17, 7)])
def test_flash_round_matches_reference(dtype, b, c, m):
    rng = np.random.default_rng(b * 31 + c + m)
    codes = rng.integers(0, K, (b, c, m)).astype(np.int32)
    adts = _table(rng, (b, m, K), dtype)
    got = tops.flash_round(torch.from_numpy(codes), torch.from_numpy(adts))
    assert got.dtype == torch.from_numpy(adts).dtype
    _check(got, jref.flash_round_ref(jnp.asarray(codes), jnp.asarray(adts)), adts, m)
    interp = jops.flash_round(jnp.asarray(codes), jnp.asarray(adts), impl="interpret")
    _check(got, interp, adts, m)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("w,m", [(1, 16), (4, 16), (3, 7)])
def test_flash_expand_matches_reference(dtype, packed, w, m):
    rng = np.random.default_rng(w * 7 + m + packed)
    n, r, q = 60, 32, 3
    nodes = rng.integers(-1, n, (q, w)).astype(np.int32)
    adj = rng.integers(-1, n, (n, r)).astype(np.int32)
    codes = rng.integers(0, K, (n, r, m)).astype(np.int32)
    mirror = np.array(jflash.pack_codes(jnp.asarray(codes))) if packed else codes
    adt = _table(rng, (q, m, K), dtype)
    rows, sums = tops.flash_expand(
        torch.from_numpy(nodes), torch.from_numpy(adj), torch.from_numpy(mirror),
        torch.from_numpy(adt),
    )
    for i in range(q):
        args = (jnp.asarray(nodes[i]), jnp.asarray(adj), jnp.asarray(mirror), jnp.asarray(adt[i]))
        rows_r, sums_r = jref.flash_expand_ref(*args)
        np.testing.assert_array_equal(rows[i].numpy(), np.asarray(rows_r))
        _check(sums[i], sums_r, adt, m)
        rows_i, sums_i = jops.flash_expand(*args, impl="interpret")
        np.testing.assert_array_equal(rows[i].numpy(), np.asarray(rows_i))
        _check(sums[i], sums_i, adt, m)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("g,m,b", [(6, 16, 32), (3, 7, 16)])
def test_flash_scan_blocked_matches_reference(dtype, g, m, b):
    rng = np.random.default_rng(g + m + b)
    blocks = rng.integers(0, K, (g, m, b)).astype(np.int32)
    adt = _table(rng, (m, K), dtype)
    got = tops.flash_scan_blocked(torch.from_numpy(blocks), torch.from_numpy(adt))
    _check(got, jref.flash_scan_blocked_ref(jnp.asarray(blocks), jnp.asarray(adt)), adt, m)
    interp = jops.flash_scan_blocked(jnp.asarray(blocks), jnp.asarray(adt), impl="interpret")
    _check(got, interp, adt, m)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_flash_scan_batch_matches_reference(dtype):
    """Batched (Q, W, R, M) rows: each query equals the reference's
    ``ops.flash_scan_batch`` on its own rows and table."""
    rng = np.random.default_rng(5)
    q, w, r, m = 3, 4, 32, 16
    rows = rng.integers(0, K, (q, w, r, m)).astype(np.int32)
    adt = _table(rng, (q, m, K), dtype)
    got = tops.flash_scan_batch(torch.from_numpy(rows), torch.from_numpy(adt))
    assert tuple(got.shape) == (q, w, r)
    for i in range(q):
        want = jops.flash_scan_batch(jnp.asarray(rows[i]), jnp.asarray(adt[i]), impl="interpret")
        _check(got[i], want, adt, m)


@pytest.mark.parametrize("m", [16, 7])
def test_fused_expand_equals_unfused_scan(m):
    """flash_expand's sums equal unpack + flash_scan_batch on the same rows
    (the port's fused and unfused beam steps are bit-equal)."""
    rng = np.random.default_rng(m)
    n, r, q, w = 50, 32, 4, 4
    codes = torch.from_numpy(rng.integers(0, K, (n, r, m)).astype(np.int32))
    mirror = tflash.pack_codes(codes)
    adj = torch.from_numpy(rng.integers(-1, n, (n, r)).astype(np.int32))
    nodes = torch.from_numpy(rng.integers(-1, n, (q, w)).astype(np.int32))
    adt = torch.from_numpy(rng.integers(0, 256, (q, m, K)).astype(np.int32))
    rows, sums = tops.flash_expand(nodes, adj, mirror, adt)
    unpacked = tflash.unpack_codes(mirror[nodes.clamp_min(0).long()], m)
    assert torch.equal(rows, adj[nodes.clamp_min(0).long()])
    assert torch.equal(sums, tops.flash_scan_batch(unpacked.contiguous(), adt))


@pytest.mark.parametrize("m", [16, 7, 1])
def test_pack_round_trip_and_reference_bytes(m):
    rng = np.random.default_rng(m)
    codes = rng.integers(0, 16, (5, 9, m)).astype(np.int32)
    packed = tflash.pack_codes(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jflash.pack_codes(jnp.asarray(codes))))
    np.testing.assert_array_equal(tflash.unpack_codes(packed, m).numpy(), codes)
    if m % 2 == 0:
        np.testing.assert_array_equal(
            tqz.unpack4(tqz.pack4(torch.from_numpy(codes))).numpy(), codes
        )
        np.testing.assert_array_equal(
            tqz.pack4(torch.from_numpy(codes)).numpy(), np.asarray(jqz.pack4(jnp.asarray(codes)))
        )


def test_cpu_tensors_take_the_plain_version():
    """No launch is counted for CPU tensors: the counters count kernels."""
    tops.reset_launches()
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, K, (2, 8, 16)).astype(np.int32))
    adts = torch.from_numpy(rng.integers(0, 9, (2, 16, K)).astype(np.int32))
    tops.flash_round(codes, adts)
    assert all(v == 0 for v in tops.launches.values())


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


def _l2_atol(x: np.ndarray, y: np.ndarray) -> float:
    return 1e-5 * float((x * x).sum(1).max() + (y * y).sum(1).max())


@pytest.mark.parametrize("n,c,d", [(37, 4, 48), (130, 70, 48), (5, 1, 3)])
def test_l2_batch_matches_reference(n, c, d):
    rng = np.random.default_rng(n + c + d)
    x = rng.normal(size=(n, d)).astype(np.float32) * 2.0
    y = rng.normal(size=(c, d)).astype(np.float32) * 2.0
    y[0] = x[0]  # one exact zero distance: the clamp at 0
    got = tops.l2_batch(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, c)
    atol = _l2_atol(x, y)
    want = np.asarray(jref.l2_batch_ref(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)
    interp = np.asarray(jops.l2_batch(jnp.asarray(x), jnp.asarray(y), impl="interpret"))
    np.testing.assert_allclose(got.numpy(), interp, rtol=1e-5, atol=atol)
    assert float(got.min()) >= 0.0


@pytest.mark.parametrize("with_banned", [False, True])
def test_nearest_centroid_matches_reference(with_banned):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(300, 48)).astype(np.float32)
    cents = rng.normal(size=(70, 48)).astype(np.float32)
    cents[5] = cents[3]  # an exact tie: the first index must win
    banned = np.zeros(70, bool)
    if with_banned:
        banned[[0, 3, 11]] = True
    tb = torch.from_numpy(banned) if with_banned else None
    jb = jnp.asarray(banned) if with_banned else None
    route, d2 = tops.nearest_centroid(torch.from_numpy(x), torch.from_numpy(cents), banned=tb)
    jroute, jd2 = jops.nearest_centroid(jnp.asarray(x), jnp.asarray(cents), banned=jb)
    assert route.dtype == torch.int32
    np.testing.assert_array_equal(route.numpy(), np.asarray(jroute))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5, atol=_l2_atol(x, cents))
    assert not np.isin(route.numpy(), np.nonzero(banned)[0]).any()
    if not with_banned:
        assert not (route.numpy() == 5).any()  # every tie with centroid 3 goes to 3
    # a row sitting on centroids 3 and 5 routes to the first open one
    r, _ = tops.nearest_centroid(torch.from_numpy(cents[3:4]), torch.from_numpy(cents), banned=tb)
    assert int(r[0]) == (5 if with_banned else 3)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("k", [16, 256])
@pytest.mark.parametrize("n,m", [(4096, 16), (1000, 7)])
def test_flash_scan_matches_reference(dtype, k, n, m):
    rng = np.random.default_rng(n + m + k)
    codes = rng.integers(0, k, (n, m)).astype(np.int32)
    adt = _table(rng, (m, k), dtype)
    got = tops.flash_scan(torch.from_numpy(codes), torch.from_numpy(adt))
    assert got.dtype == torch.from_numpy(adt).dtype and tuple(got.shape) == (n,)
    for want in (jref.flash_scan_ref(jnp.asarray(codes), jnp.asarray(adt)),
                 jops.flash_scan(jnp.asarray(codes), jnp.asarray(adt), impl="interpret")):
        want = np.asarray(want)
        if dtype == "int32":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * m * float(np.abs(adt).max()))


@pytest.mark.parametrize("n,d", [(1000, 128), (77, 30)])
def test_sq_l2_matches_reference(n, d):
    rng = np.random.default_rng(n + d)
    q = rng.integers(0, 256, d).astype(np.int32)
    db = rng.integers(0, 256, (n, d)).astype(np.int32)
    db[0] = q  # one exact zero
    s2 = rng.uniform(1e-4, 1e-2, d).astype(np.float32)
    got = tops.sq_l2(torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(s2))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,) and float(got[0]) == 0.0
    for want in (jref.sq_l2_ref(jnp.asarray(q), jnp.asarray(db), jnp.asarray(s2)),
                 jops.sq_l2(jnp.asarray(q), jnp.asarray(db), jnp.asarray(s2), impl="interpret")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_flash_scan_and_sq_l2_count_no_launch_on_the_cpu():
    tops.reset_launches()
    rng = np.random.default_rng(1)
    tops.flash_scan(torch.from_numpy(rng.integers(0, K, (50, 16)).astype(np.int32)),
                    torch.from_numpy(rng.integers(0, 9, (16, K)).astype(np.int32)))
    tops.sq_l2(torch.zeros(8, dtype=torch.int32), torch.ones((5, 8), dtype=torch.int32), torch.ones(8))
    assert tops.launches["flash_scan"] == 0 and tops.launches["sq_l2"] == 0
