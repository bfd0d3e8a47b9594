"""The port's Flash kernels against the reference package's kernels.

On the CPU each wrapper in ``repro_torch.kernels.ops`` runs its plain
PyTorch version; these tests hold that version against the reference's
jnp oracle (``repro.kernels.ref``) and its Pallas kernel in interpret mode
(``repro.kernels.ops.*(impl="interpret")``), on the same numpy inputs, over
both mirror layouts and both table dtypes. Integer tables must be equal;
float32 tables allclose with rtol 1e-5 and atol 1e-5·M·max|table| (the
sums run in another order). The CUDA kernels themselves are held
against the same plain versions on the card by ``test_torch_cuda.py``.
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
