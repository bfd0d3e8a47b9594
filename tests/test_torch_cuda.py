"""The CUDA Flash kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with ``nvcc`` (the kernels are built at
first use); they carry the ``cuda`` marker and skip without one. They
import no JAX, so they run on the card's machine (``--noconftest``: the
suite's conftest imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Int32 tables must give equal sums; float32 tables allclose with rtol 1e-5
and atol 1e-5·M·max|table| (the kernel sums in another order).
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
        pytest.skip("needs a CUDA card: the Flash kernels are CUDA C++ for sm_90a")
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
