"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with ``nvcc`` (the kernels are built at
first use); they carry the ``cuda`` marker and skip without one. They
import no JAX, so they run on the card's machine (``--noconftest``: the
suite's conftest imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Int32 tables must give equal sums; float32 tables allclose with rtol 1e-5
and atol 1e-5·M·max|table| (the kernel sums in another order).
``l2_batch`` is allclose with rtol 1e-5 and atol 1e-5·max(‖x‖² + ‖y‖²)
against the plain version with TF32 off, and ``nearest_centroid``'s
routes are equal except where the two nearest centroids are within that
atol of each other (a near tie, counted and bounded). ``flash_scan`` adds
in m order like its plain version, so both table kinds must be equal;
``sq_l2`` is allclose with rtol 1e-5 (non-negative terms in another order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import flash as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_cuda_flash_round(cuda_device, dtype):
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(0, K, (300, 128, 16)).astype(np.int32)).to(cuda_device)
    adts_np = _table(rng, (300, 16, K), dtype)
    adts = torch.from_numpy(adts_np).to(cuda_device)
    before = tops.launches["flash_round"]
    got = tops.flash_round(codes, adts)
    torch.cuda.synchronize()
    assert tops.launches["flash_round"] == before + 1
    _check(got.cpu(), tref.flash_round(codes, adts).cpu(), adts_np, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_cuda_flash_expand_and_scan(cuda_device, packed, dtype):
    rng = np.random.default_rng(2)
    n, r, m, q, w = 5000, 32, 16, 64, 4
    codes = torch.from_numpy(rng.integers(0, K, (n, r, m)).astype(np.int32))
    mirror = (tflash.pack_codes(codes) if packed else codes).to(cuda_device)
    adj = torch.from_numpy(rng.integers(-1, n, (n, r)).astype(np.int32)).to(cuda_device)
    nodes = torch.from_numpy(rng.integers(-1, n, (q, w)).astype(np.int32)).to(cuda_device)
    adt_np = _table(rng, (q, m, K), dtype)
    adt = torch.from_numpy(adt_np).to(cuda_device)
    rows, sums = tops.flash_expand(nodes, adj, mirror, adt)
    rows_p, sums_p = tref.flash_expand(nodes, adj, mirror, adt)
    torch.cuda.synchronize()
    assert torch.equal(rows.cpu(), rows_p.cpu())
    _check(sums.cpu(), sums_p.cpu(), adt_np, m)
    blocks = codes[: q * w].reshape(q, w, r, m).transpose(-1, -2).contiguous().to(cuda_device)
    got = tops.flash_scan_blocked(blocks, adt)
    _check(got.cpu(), tref.flash_scan_blocked(blocks, adt).cpu(), adt_np, m)


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    codes = torch.zeros((4, 8, 16), dtype=torch.int64, device=cuda_device)
    adts = torch.zeros((4, 16, K), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        tops.flash_round(codes, adts)
    with pytest.raises(ValueError):
        tops.flash_round(codes.to(torch.int32)[:, ::2], adts)
    # a packed mirror with M = 8 (4 bytes per row) is not read as 8-byte words
    nodes = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    adj = torch.zeros((4, 32), dtype=torch.int32, device=cuda_device)
    mirror = torch.zeros((4, 32, 4), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        tops.flash_expand(nodes, adj, mirror, torch.zeros((2, 8, K), dtype=torch.int32, device=cuda_device))
    before = tops.launches["flash_scan_batch"]
    tops.flash_scan_batch(torch.zeros((2, 0, 32, 16), dtype=torch.int32, device=cuda_device), adts[:2])
    assert tops.launches["flash_scan_batch"] == before  # nothing to launch on an empty batch


def _l2_atol(x: torch.Tensor, y: torch.Tensor) -> float:
    return 1e-5 * float((x * x).sum(1).max() + (y * y).sum(1).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,d", [(1000, 8192, 128), (65536, 64, 128), (37, 70, 48), (5, 1, 3)])
def test_cuda_l2_batch(cuda_device, n, c, d):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(n + c + d)
    x = torch.randn((n, d), generator=g, device=cuda_device) * 3.0
    y = torch.randn((c, d), generator=g, device=cuda_device) * 3.0
    y[0] = x[0]
    before = tops.launches["l2_batch"]
    got = tops.l2_batch(x, y)
    torch.cuda.synchronize()
    assert tops.launches["l2_batch"] == before + 1
    want = tref.l2_batch(x, y)
    assert torch.allclose(got, want, rtol=1e-5, atol=_l2_atol(x, y))
    assert float(got.min()) >= 0.0


@pytest.mark.cuda
def test_cuda_nearest_centroid(cuda_device):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(3)
    x = torch.randn((2000, 128), generator=g, device=cuda_device)
    cents = torch.randn((64, 128), generator=g, device=cuda_device)
    banned = torch.zeros(64, dtype=torch.bool, device=cuda_device)
    banned[[1, 7]] = True
    route, d2 = tops.nearest_centroid(x, cents, banned=banned)
    plain = tref.l2_batch(x, cents).masked_fill(banned[None], float("inf"))
    atol = _l2_atol(x, cents)
    two = plain.topk(2, 1, largest=False).values
    near_tie = (two[:, 1] - two[:, 0]) <= 2 * atol
    want = plain.argmin(1).to(torch.int32)
    diff = route != want
    assert not bool((diff & ~near_tie).any()), "a route differs away from a near tie"
    assert int(diff.sum()) <= max(1, int(near_tie.sum()))
    assert not bool(banned[route.long()].any())
    assert torch.allclose(d2, plain.gather(1, route[:, None].long())[:, 0], rtol=1e-5, atol=atol)


@pytest.mark.cuda
def test_cuda_l2_batch_raises_on_what_it_does_not_take(cuda_device):
    x = torch.zeros((4, 8), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        tops.l2_batch(x, x)
    with pytest.raises(ValueError):
        tops.l2_batch(x.float(), torch.zeros((4, 7), device=cuda_device))
    with pytest.raises(ValueError):
        tops.l2_batch(x.float()[:, ::2], x.float()[:, ::2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("n,m,k,offset", [(1_048_575, 16, 16, 0), (5000, 16, 256, 1), (3001, 7, 16, 0)])
def test_cuda_flash_scan(cuda_device, dtype, n, m, k, offset):
    """The catalog's shape, a K = 256 table read element by element (a code
    table that starts 4 bytes past a 16-byte line), and M = 7."""
    rng = np.random.default_rng(n + m + k)
    flat = torch.from_numpy(rng.integers(0, k, (n * m + offset,)).astype(np.int32)).to(cuda_device)
    codes = flat[offset:].view(n, m)
    adt = torch.from_numpy(_table(rng, (m, k), dtype)).to(cuda_device)
    before = tops.launches["flash_scan"]
    got = tops.flash_scan(codes, adt)
    torch.cuda.synchronize()
    assert tops.launches["flash_scan"] == before + 1
    assert torch.equal(got, tref.flash_scan(codes, adt))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1_048_576, 128), (999, 30), (64, 4096)])
def test_cuda_sq_l2(cuda_device, n, d):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(n + d)
    q = torch.randint(0, 256, (d,), generator=g, device=cuda_device, dtype=torch.int32)
    db = torch.randint(0, 256, (n, d), generator=g, device=cuda_device, dtype=torch.int32)
    s2 = torch.rand((d,), generator=g, device=cuda_device) * 1e-2 + 1e-4
    before = tops.launches["sq_l2"]
    got = tops.sq_l2(q, db, s2)
    torch.cuda.synchronize()
    assert tops.launches["sq_l2"] == before + 1
    assert torch.allclose(got, tref.sq_l2(q, db, s2), rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_cuda_flash_scan_and_sq_l2_raise_on_what_they_do_not_take(cuda_device):
    codes = torch.zeros((8, 16), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):  # a 64 KiB table
        tops.flash_scan(codes, torch.zeros((16, 1024), dtype=torch.int32, device=cuda_device))
    with pytest.raises(TypeError):
        tops.flash_scan(codes.long(), torch.zeros((16, K), dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        tops.flash_scan(codes, torch.zeros((8, K), dtype=torch.int32, device=cuda_device))
    q = torch.zeros(5000, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="4096"):
        tops.sq_l2(q, torch.zeros((2, 5000), dtype=torch.int32, device=cuda_device),
                   torch.ones(5000, device=cuda_device))
    with pytest.raises(TypeError):
        tops.sq_l2(q[:8], torch.zeros((2, 8), dtype=torch.int32, device=cuda_device),
                   torch.ones(8, dtype=torch.float64, device=cuda_device))
