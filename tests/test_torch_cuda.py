"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with ``nvcc`` (the kernels are built at
first use); they carry the ``cuda`` marker and skip without one. They
import no JAX, so they run on the card's machine (``--noconftest``: the
suite's conftest imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Int32 tables must give equal sums; float32 tables allclose with rtol 1e-5
and atol 1e-5·M·max|table| (the kernel sums in another order).
``l2_batch`` (3xTF32 on the tensor cores) is allclose with rtol 1e-5 and
atol 1e-5·max(‖x‖² + ‖y‖²) against the plain version with TF32 off, and
``nearest_centroid``'s routes are equal except where the two nearest centroids are within that
atol of each other (a near tie, counted and bounded). ``flash_scan`` adds
in m order like its plain version, so both table kinds must be equal;
``sq_l2`` is allclose with rtol 1e-5 (non-negative terms in another order).
``flash_beam`` (int32 tables only) must equal the loop of ``flash_expand``
launches it replaces bit for bit: ids, dists and both counts; on a packed
mirror of any M (the byte-wise layout) both equal their plain versions.
The incremental build on the card, and the flat Vamana and NSG builds
over ``flash_blocked``, equal the CPU path's from one coder's state where
the two devices' query tables agree, and a snapshot of a card
index loads back on the card searching identically. The BERT4Rec train
step on the card agrees with the CPU's (the tolerance is in its test), and
so do the LM family's prefill and decode at each reduced config (float32,
atol 1e-4), ``lm_loss`` with its gradients at two and the GNN family's
train step at each reduced config (the tolerances are in the tests).
``l2_batch`` at the flash-ann width (D = 768) holds the same tolerance; the
flash-ann segment build (``graph.segmented.build_segment``) equals the
CPU's where the query tables agree; ``launch/steps``'s ``serve_bulk`` gives
the CPU's top-100 ids except at near ties. The segment layer's mesh
programs on two ranks sharing the card equal the single-process programs;
``flash_scan`` on a rank's row shard of the candidate codes equals its
plain version; BERT4Rec's cells and the GNN steps on four ranks sharing
the card (``launch/steps`` under a mesh) equal the one-process cells (the
tolerances are in the tests), and so do the LM prefill and decode cells of
four reduced GQA configs (the MoE one expert-parallel).
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
    # a packed mirror whose last dim is not ⌈M/2⌉
    nodes = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    adj = torch.zeros((4, 32), dtype=torch.int32, device=cuda_device)
    mirror = torch.zeros((4, 32, 5), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        tops.flash_expand(nodes, adj, mirror, torch.zeros((2, 8, K), dtype=torch.int32, device=cuda_device))
    before = tops.launches["flash_scan_batch"]
    tops.flash_scan_batch(torch.zeros((2, 0, 32, 16), dtype=torch.int32, device=cuda_device), adts[:2])
    assert tops.launches["flash_scan_batch"] == before  # nothing to launch on an empty batch


def _l2_atol(x: torch.Tensor, y: torch.Tensor) -> float:
    return 1e-5 * float((x * x).sum(1).max() + (y * y).sum(1).max())


def _l2_call(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One ``l2_batch`` call, held to one kernel launch plus one pad copy
    per operand the plan copies, and to its plain version."""
    plan = tops._l2_plan(x.shape[0], y.shape[0], x.shape[1], x.data_ptr(), y.data_ptr())
    before = dict(tops.launches)
    got = tops.l2_batch(x, y)
    torch.cuda.synchronize()
    assert tops.launches["l2_batch"] == before["l2_batch"] + 1
    assert tops.launches["l2_batch_pad"] == before["l2_batch_pad"] + plan.pad_x + plan.pad_y
    want = tref.l2_batch(x, y)
    assert torch.allclose(got, want, rtol=1e-5, atol=_l2_atol(x, y))
    assert float(got.min()) >= 0.0
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,d", [(1000, 8192, 128), (65536, 64, 128), (37, 70, 48), (5, 1, 3),
                                   (1, 8191, 25), (300, 288, 100), (77, 1, 960), (1, 64, 960),
                                   (129, 8191, 100), (2000, 64, 25)])
def test_cuda_l2_batch(cuda_device, n, c, d):
    """The paths' shapes, and odd ones: D ∈ {3, 25, 100, 960} (a padded
    copy where D % 4 ≠ 0), C ∈ {1, 64, 70, 288, 8191, 8192} (the narrow
    resident shape at C ≤ 64, ragged edges), N = 1 and N one past a tile."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(n + c + d)
    x = torch.randn((n, d), generator=g, device=cuda_device) * 3.0
    y = torch.randn((c, d), generator=g, device=cuda_device) * 3.0
    y[0] = x[0]
    _l2_call(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 128])
def test_cuda_l2_batch_misaligned_view(cuda_device, d):
    """x = a view one row (D = 3) or one float (D = 128) past its storage's
    start, off TMA's 16-byte alignment: the plan copies it first."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(d)
    if d == 3:
        x = (torch.randn((301, d), generator=g, device=cuda_device) * 3.0)[1:]
    else:
        x = (torch.randn((300 * d + 1,), generator=g, device=cuda_device) * 3.0)[1:].view(300, d)
    y = torch.randn((70, d), generator=g, device=cuda_device) * 3.0
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert tops._l2_plan(300, 70, d, x.data_ptr(), y.data_ptr()).pad_x
    _l2_call(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 8192])
def test_cuda_l2_batch_cancellation(cuda_device, c):
    """SIFT-like rows: uint8-range values around one common vector, near
    duplicates and an exact-zero row; ‖x‖² + ‖y‖² − 2·x·y cancels to a
    small share of the norms."""
    rng = np.random.default_rng(c)
    base = rng.integers(0, 256, 128)
    x = (base + rng.integers(-4, 5, (1000, 128))).astype(np.float32)
    y = (base + rng.integers(-4, 5, (c, 128))).astype(np.float32)
    y[1] = x[1] + rng.normal(size=128).astype(np.float32) * 1e-3
    x[0] = 0.0
    _l2_call(torch.from_numpy(x).to(cuda_device), torch.from_numpy(y).to(cuda_device))


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
    with pytest.raises(ValueError, match="shared memory"):  # a 256 KiB table: above 227 KB
        tops.flash_scan(codes, torch.zeros((16, 4096), dtype=torch.int32, device=cuda_device))
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


def _beam_inputs(rng, dev, *, n, r, q, ef, levels, packed, e=2, m=16):
    """A random n-vertex graph with −1 holes and repeated vertices, its
    mirror, (Q, M, K) int32 tables of ``levels`` levels and the sorted
    initial beam from E entries (one of them −1)."""
    codes = torch.from_numpy(rng.integers(0, K, (n, m)).astype(np.int32))
    adj = torch.from_numpy(rng.integers(0, n, (n, r)).astype(np.int32))
    adj[torch.from_numpy(rng.random((n, r)) < 0.1)] = -1
    adj[: n // 2, 3] = adj[: n // 2, 0]
    mirror = torch.where(adj[..., None] >= 0, codes[adj.clamp_min(0).long()], 0)
    if packed:
        mirror = tflash.pack_codes(mirror)
    adt = torch.from_numpy(rng.integers(0, levels, (q, m, K)).astype(np.int32))
    entries = torch.from_numpy(rng.integers(0, n, (q, e)).astype(np.int32))
    entries[:, -1] = -1
    d_e = tflash.adc_lookup(adt, codes[entries.clamp_min(0).long()]).to(torch.float32)
    d_e = torch.where(entries >= 0, d_e, float("inf"))
    beam = tref.initial_beam(entries, d_e, ef)
    return [t.to(dev).contiguous() for t in (adt, adj, mirror, *beam, entries)]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("ef,w,levels", [(64, 1, 256), (256, 4, 4), (32, 8, 256)])
def test_cuda_flash_beam_equals_the_step_loop(cuda_device, packed, ef, w, levels):
    """One flash_beam launch against the loop of flash_expand launches it
    replaces, on the same inputs: ids, dists and both counts equal."""
    rng = np.random.default_rng(ef + w)
    adt, adj, mirror, beam_d, beam_ids, beam_exp, entries = _beam_inputs(
        rng, cuda_device, n=20000, r=32, q=300, ef=ef, levels=levels, packed=packed)
    max_iters = -(-(4 * ef + 8) // w)
    before = tops.launches["flash_beam"]
    got = tops.flash_beam(adt, adj, mirror, beam_d, beam_ids, beam_exp, entries, width=w,
                          max_iters=max_iters)
    torch.cuda.synchronize()
    assert tops.launches["flash_beam"] == before + 1

    def step(nodes):
        rows, sums = tops.flash_expand(nodes, adj, mirror, adt)
        return rows, sums.to(torch.float32)

    want = tref.beam_loop(step, beam_d, beam_ids, beam_exp, entries, adj.shape[0], width=w,
                          max_iters=max_iters)
    for g, x, name in zip(got, want, ("dists", "ids", "n_dists", "n_hops")):
        assert torch.equal(g.cpu(), x.cpu()), name
    assert int(got[3].sum()) > 0


@pytest.mark.cuda
def test_cuda_flash_beam_raises_on_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(0)
    args = _beam_inputs(rng, cuda_device, n=500, r=32, q=4, ef=16, levels=256, packed=True)
    adt, rest = args[0], args[1:]
    with pytest.raises(TypeError, match="int32"):
        tops.flash_beam(adt.to(torch.float32), *rest, width=1, max_iters=8)
    with pytest.raises(ValueError, match="width"):  # more rows than the beam holds
        tops.flash_beam(adt, *rest, width=17, max_iters=8)
    big = _beam_inputs(rng, cuda_device, n=500, r=32, q=2, ef=20000, levels=256, packed=True)
    with pytest.raises(ValueError, match="shared memory"):
        tops.flash_beam(*big, width=1, max_iters=8)


@pytest.mark.cuda
def test_cuda_table_kernels_take_tables_above_48k(cuda_device):
    """An (M, K) = (64, 256) int32 table (64 KiB, above the 48 KB a kernel
    gets without the opt-in) through flash_round, flash_scan,
    flash_scan_blocked and flash_expand: bit-equal to the plain versions."""
    rng = np.random.default_rng(7)
    m, k = 64, 256
    adts = torch.from_numpy(rng.integers(0, 256, (40, m, k)).astype(np.int32)).to(cuda_device)
    codes = torch.from_numpy(rng.integers(0, k, (40, 96, m)).astype(np.int32)).to(cuda_device)
    assert torch.equal(tops.flash_round(codes, adts).cpu(), tref.flash_round(codes, adts).cpu())
    flat = codes.reshape(-1, m).contiguous()
    assert torch.equal(tops.flash_scan(flat, adts[0]).cpu(), tref.flash_scan(flat, adts[0]).cpu())
    blocks = codes.reshape(40, 3, 32, m).transpose(-1, -2).contiguous()
    assert torch.equal(tops.flash_scan_blocked(blocks, adts).cpu(),
                       tref.flash_scan_blocked(blocks, adts).cpu())
    n, r = 500, 32
    mirror = torch.from_numpy(rng.integers(0, k, (n, r, m)).astype(np.int32)).to(cuda_device)
    adj = torch.from_numpy(rng.integers(-1, n, (n, r)).astype(np.int32)).to(cuda_device)
    nodes = torch.from_numpy(rng.integers(-1, n, (40, 4)).astype(np.int32)).to(cuda_device)
    got, want = tops.flash_expand(nodes, adj, mirror, adts), tref.flash_expand(nodes, adj, mirror, adts)
    assert all(torch.equal(g.cpu(), x.cpu()) for g, x in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("ef", [64, 256])
def test_cuda_flash_beam_more_slots_than_threads(cuda_device, ef):
    """W = 16 rows of R = 96 slots (W·R = 1,536 > 1,024 threads: two slots a
    thread) equal the loop of flash_expand launches and the plain version
    bit for bit: ids, dists and both counts."""
    rng = np.random.default_rng(ef)
    args = _beam_inputs(rng, cuda_device, n=20000, r=96, q=100, ef=ef, levels=256, packed=True)
    adt, adj, mirror = args[:3]
    max_iters = -(-(4 * ef + 8) // 16)
    got = tops.flash_beam(*args, width=16, max_iters=max_iters)

    def step(nodes):
        rows, sums = tops.flash_expand(nodes, adj, mirror, adt)
        return rows, sums.to(torch.float32)

    loop = tref.beam_loop(step, *args[3:6], args[6], adj.shape[0], width=16, max_iters=max_iters)
    plain = tref.flash_beam(*(t.cpu() for t in args), width=16, max_iters=max_iters)
    for g, x, y, name in zip(got, loop, plain, ("dists", "ids", "n_dists", "n_hops")):
        assert torch.equal(g.cpu(), x.cpu()) and torch.equal(g.cpu(), y), name
    assert int(got[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("m,skew", [(5, 0), (6, 0), (7, 0), (8, 0), (12, 0), (24, 0), (16, 1), (16, 4)])
def test_cuda_packed_mirror_of_any_m(cuda_device, m, skew):
    """flash_beam and flash_expand on a packed mirror whose rows are not
    whole 8-byte words (⌈M/2⌉ % 8 ≠ 0), or one that starts off an 8-byte
    boundary (``skew`` bytes into its storage), take the byte-wise layout
    and equal their plain versions bit for bit: ids, sums and both counts.
    An odd M's padding nibble is set to 15, so a kernel that added it would
    read past the query's table (M = 5 through the byte loop, M = 7 and the
    4-byte skew through the 4-byte words)."""
    rng = np.random.default_rng(m + skew)
    adt, adj, mirror, beam_d, beam_ids, beam_exp, entries = _beam_inputs(
        rng, cuda_device, n=5000, r=32, q=200, ef=64, levels=256, packed=True, m=m)
    if m % 2:
        mirror[..., -1] |= 0xF0
    if skew:
        flat = torch.zeros(mirror.numel() + skew, dtype=torch.uint8, device=cuda_device)
        flat[skew:] = mirror.reshape(-1)
        mirror = flat[skew:].view(mirror.shape)
    assert tops.mirror_layout(mirror) == "bytes"
    before = dict(tops.launches)
    for w in (1, 4):
        args = (adt, adj, mirror, beam_d, beam_ids, beam_exp, entries)
        got = tops.flash_beam(*args, width=w, max_iters=64)
        want = tref.flash_beam(*(t.cpu() for t in args), width=w, max_iters=64)
        for g, x, name in zip(got, want, ("dists", "ids", "n_dists", "n_hops")):
            assert torch.equal(g.cpu(), x), (w, name)
        assert int(got[3].sum()) > 0
        nodes = beam_ids[:, :w].contiguous()
        rows, sums = tops.flash_expand(nodes, adj, mirror, adt)
        rows_p, sums_p = tref.flash_expand(nodes.cpu(), adj.cpu(), mirror.cpu(), adt.cpu())
        assert torch.equal(rows.cpu(), rows_p) and torch.equal(sums.cpu(), sums_p)
    assert tops.launches["mirror_bytes"] == before["mirror_bytes"] + 4
    assert tops.launches["mirror_words"] == before["mirror_words"]


def _clustered(n: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(16, d)) * 2.0
    return (centers[rng.integers(0, 16, n)] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("m_f", [8, 16])
def test_cuda_incremental_build_equals_the_cpu_build(cuda_device, m_f):
    """One coder's state, the incremental build on both devices: with equal
    query tables the graphs, the mirror and the per-phase counts are equal
    (m_f = 8 reads the mirror byte-wise, m_f = 16 as 8-byte words)."""
    from repro_torch.graph import backends as tbk
    from repro_torch.graph.engine import BuildParams
    from repro_torch.graph.hnsw import build_hnsw

    x = torch.from_numpy(_clustered(2000, 48, seed=m_f))
    be = tbk.make_backend("flash_blocked", x, seed=0, r_for_blocked=16, device="cpu",
                          d_f=32, m_f=m_f, l_f=4, h=8, kmeans_iters=8)
    card = tbk.FlashBlockedBackend.from_state(be.state_dict(), device=cuda_device)
    params = BuildParams(r_upper=8, r_base=16, ef=32, batch=16, max_layers=3)
    layout = "bytes" if m_f == 8 else "words"
    before = tops.launches[f"mirror_{layout}"]
    g_gpu, s_gpu = build_hnsw(x.to(cuda_device), card, params=params, seed=0, strategy="incremental")
    torch.cuda.synchronize()
    assert tops.launches[f"mirror_{layout}"] - before == -(-2000 // 16) - 1  # one per insert batch
    g_cpu, s_cpu = build_hnsw(x, be, params=params, seed=0, strategy="incremental")
    mismatch = int((card.prepare_query(x.to(cuda_device)).adt_q.cpu() != be.prepare_query(x).adt_q).sum())
    assert mismatch == 0, f"{mismatch} query-table levels differ between the devices"
    for a, b in ((g_gpu.adj0, g_cpu.adj0), (g_gpu.adj_up, g_cpu.adj_up),
                 (g_gpu.backend.nbr_codes, g_cpu.backend.nbr_codes)):
        assert torch.equal(a.cpu(), b)
    assert list(s_gpu.phases) == list(s_cpu.phases) and g_gpu.entry == g_cpu.entry


@pytest.mark.cuda
def test_cuda_snapshot_round_trip(cuda_device, tmp_path):
    """A card index saved and loaded back on the card searches identically;
    loaded on the CPU it holds the same graph and mirror."""
    from repro_torch.graph.engine import BuildParams
    from repro_torch.index import AnnIndex
    from repro_torch.serve import snapshot as snap

    x = _clustered(3064, 48, seed=1)
    data, queries = x[:3000], torch.from_numpy(x[3000:]).to(cuda_device)
    idx = AnnIndex.build(data, params=BuildParams(r_upper=8, r_base=16, ef=32, batch=16, max_layers=2),
                         backend_kwargs=dict(d_f=32, m_f=8, l_f=4, h=8, kmeans_iters=8),
                         strategy="incremental", device=cuda_device)
    idx.delete([3, 7])
    path = snap.save_index(str(tmp_path / "snap"), idx)
    back = snap.load_index(path)
    assert back.device.type == "cuda" and back.build_strategy == "incremental"
    for width in (1, 4):
        a, b = idx.search(queries, k=10, ef=64, width=width), back.search(queries, k=10, ef=64, width=width)
        assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
    cpu = snap.load_index(path, device="cpu")
    assert torch.equal(cpu.graph.adj0, idx.graph.adj0.cpu())
    assert torch.equal(cpu.backend.nbr_codes, idx.backend.nbr_codes.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("algo,strategy", [("vamana", "bulk"), ("vamana", "incremental"), ("nsg", "bulk"),
                                           ("nsg", "incremental")])
def test_cuda_flat_flash_builds_equal_the_cpu_builds(cuda_device, algo, strategy):
    """Flat Vamana and NSG (``knn_k`` = r_base: the incremental NSG beam
    reads the mirror) over ``flash_blocked`` at r_base = 24, W = 4, from one
    coder's state (the incremental NSG from one k-NN graph, the CPU's:
    ``l2_batch`` may order a near tie otherwise, and one swapped neighbour
    changes the graph): with equal query tables the graphs, n_dists and a search
    at ef 128, W = 4 are equal on both devices (the ids, and the Flash
    distances without rerank; the exact rerank's float32 distances sum in
    another order, so they are allclose at rtol 1e-5), and the card's
    build and search launch ``flash_beam``."""
    from repro_torch.graph import backends as tbk
    from repro_torch.graph.engine import BuildParams
    from repro_torch.graph.nsg import build_nsg_stats
    from repro_torch.index import AnnIndex, exact_knn

    x = torch.from_numpy(_clustered(2000, 48, seed=7))
    be = tbk.make_backend("flash_blocked", x, seed=0, r_for_blocked=24, device="cpu",
                          d_f=32, m_f=16, l_f=4, h=8, kmeans_iters=8)
    card = tbk.FlashBlockedBackend.from_state(be.state_dict(), device=cuda_device)
    mismatch = int((card.prepare_query(x.to(cuda_device)).adt_q.cpu() != be.prepare_query(x).adt_q).sum())
    assert mismatch == 0, f"{mismatch} query-table levels differ between the devices"
    params = BuildParams(r_upper=8, r_base=24, ef=64, batch=32, max_layers=3, width=4, alpha=1.2)
    kw = dict(knn_k=24) if algo == "nsg" else {}
    knn = exact_knn(x, x, k=25)[0][:, 1:]

    def build(b):
        if (algo, strategy) != ("nsg", "incremental"):
            return AnnIndex.build(x, algo=algo, backend=b, params=params, strategy=strategy, device=b.device, **kw)
        xd = x.to(b.device)
        graph, _, st = build_nsg_stats(xd, b, params=params, strategy=strategy, knn_adj=knn, **kw)
        return AnnIndex.from_graph(graph, xd, algo=algo, params=params, backend_kind="flash_blocked", stats=st,
                                   strategy=strategy, device=b.device)

    before = tops.launches["flash_beam"]
    idx = {w: build(b) for w, b in (("card", card), ("cpu", be))}
    q = x[:64] + 0.25
    res = {(w, rr): i.search(q.to(i.data.device), k=10, ef=128, width=4, rerank=rr)
           for w, i in idx.items() for rr in (False, True)}
    torch.cuda.synchronize()
    assert tops.launches["flash_beam"] > before
    st = {w: i.export_state()[1] for w, i in idx.items()}
    for key, arr in st["cpu"].items():
        np.testing.assert_array_equal(st["card"][key], arr, err_msg=f"{algo}/{strategy}: {key}")
    assert idx["card"].last_stats.n_dists == idx["cpu"].last_stats.n_dists
    for rr in (False, True):
        assert torch.equal(res["card", rr].ids.cpu(), res["cpu", rr].ids)
    assert torch.equal(res["card", False].dists.cpu(), res["cpu", False].dists)  # Flash sums: integers
    torch.testing.assert_close(res["card", True].dists.cpu(), res["cpu", True].dists, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp32", "pq", "sq", "pca"])
def test_cuda_baseline_builds_equal_the_cpu_builds(cuda_device, kind):
    """HNSW, Vamana and NSG, bulk and incremental, over a baseline backend
    with a hand-made coder on 800 integer rows: graphs, distances, entries
    and n_dists equal on the card and on the CPU, and no Flash kernel runs."""
    from repro_torch.graph.engine import BuildParams
    from repro_torch.index import AnnIndex
    from repro_torch.testing.exact import exact_backends

    x = torch.from_numpy(np.random.default_rng(5).integers(-8, 9, (800, 32)).astype(np.float32))
    be = {"card": exact_backends(x, cuda_device)[kind], "cpu": exact_backends(x, "cpu")[kind]}
    before = dict(tops.launches)
    for algo in ("hnsw", "vamana", "nsg"):
        params = BuildParams(r_upper=8, r_base=16, ef=32, batch=64, max_layers=2,
                             alpha=1.2 if algo == "vamana" else 1.0)
        for strategy in ("bulk", "incremental"):
            idx = {w: AnnIndex.build(x, algo=algo, backend=b, params=params, strategy=strategy,
                                     device=b.device) for w, b in be.items()}
            st = {w: i.export_state()[1] for w, i in idx.items()}
            for key, arr in st["cpu"].items():
                np.testing.assert_array_equal(st["card"][key], arr, err_msg=f"{algo}/{strategy}: {key}")
            assert idx["card"].last_stats.n_dists == idx["cpu"].last_stats.n_dists
            q = x[:16] + 1
            assert torch.equal(idx["card"].search(q, k=8, ef=32).ids.cpu(), idx["cpu"].search(q, k=8, ef=32).ids)
    for name in ("flash_round", "flash_beam", "flash_scan_blocked"):
        assert tops.launches[name] == before[name], name


def _serving_pair(cuda_device):
    """A flash_blocked index over integer rows (exact rerank distances) built
    on the CPU and restored on the card, its queries, and its fresh rows."""
    from repro_torch.graph.engine import BuildParams
    from repro_torch.index import AnnIndex

    x = np.random.default_rng(8).integers(-8, 9, (2128, 32)).astype(np.float32)
    cpu = AnnIndex.build(x[:2000], params=BuildParams(r_upper=8, r_base=16, ef=32, batch=16, max_layers=3),
                         backend_kwargs=dict(d_f=32, m_f=16, l_f=4, h=8, kmeans_iters=8),
                         strategy="incremental", device="cpu")
    card = AnnIndex.restore(*cpu.export_state(), device=cuda_device)
    queries, extra = x[2000:2064], x[2064:]
    mismatch = int((card.backend.prepare_query(torch.from_numpy(queries).to(cuda_device)).adt_q.cpu()
                    != cpu.backend.prepare_query(torch.from_numpy(queries)).adt_q).sum())
    assert mismatch == 0, f"{mismatch} query-table levels differ between the devices"
    return cpu, card, queries, extra


@pytest.mark.cuda
def test_cuda_engine_and_runtime_equal_the_cpu(cuda_device):
    """The engine on the card returns the CPU engine's ids, distances and
    counts (one flash_beam launch per padded dispatch); a Runtime on the
    card serves the same rows from client threads, and its add / delete
    flips publish the CPU handle's states."""
    import threading

    from repro_torch import serve

    cpu, card, queries, extra = _serving_pair(cuda_device)
    e_cpu = serve.SearchEngine(cpu, k=10, ef=64).warmup()
    e_card = serve.SearchEngine(card, k=10, ef=64).warmup()
    assert e_card.n_compiles == e_cpu.n_compiles == 3
    off = 0
    for b in (1, 3, 8, 17, 32, 45):
        before = tops.launches["flash_beam"]
        got, want = e_card.search(queries[off:off + b]), e_cpu.search(queries[off:off + b])
        assert tops.launches["flash_beam"] - before == (2 if b > 32 else 1)
        assert torch.equal(got.ids.cpu(), want.ids) and torch.equal(got.dists.cpu(), want.dists)
        assert (got.n_dists, got.n_scan, got.n_rerank) == (want.n_dists, want.n_scan, want.n_rerank)
        off = (off + b) % 16
    assert e_card.n_compiles == 3
    direct = e_cpu.search(queries[:32], record=False).ids.numpy()
    handle = serve.IndexHandle(cpu)
    with serve.Runtime(card, k=10, ef=64, max_wait_ms=2.0) as rt:
        rt.warmup()
        out = [None] * 32

        def client(rows):
            for i in rows:
                out[i] = rt.submit(queries[i]).result(timeout=60).ids

        threads = [threading.Thread(target=client, args=(range(t, 32, 4),)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        np.testing.assert_array_equal(np.stack(out), direct)
        rt.add(extra).result(timeout=120)
        handle.add(extra)
        rt.delete(np.arange(0, 2000, 7)).result(timeout=120)
        handle.delete(np.arange(0, 2000, 7))
        st_card, st_cpu = rt.handle.current.index.export_state()[1], handle.current.index.export_state()[1]
        for key, arr in st_cpu.items():
            np.testing.assert_array_equal(st_card[key], arr, err_msg=key)
        res = rt.search(queries[5], 60)
        assert not np.isin(res.ids, np.arange(0, 2000, 7)).any()
        stats = rt.stats()
    assert stats["cold_dispatches"] == 0 and stats["thread_restarts"] == 0


@pytest.mark.cuda
def test_cuda_recover_equals_the_cpu_recover(cuda_device, tmp_path):
    """One durable root (a WAL add and delete over a snapshot) recovered on
    the card and on the CPU: the same graph, mirror, tombstones and ids."""
    from repro_torch.serve import recovery

    cpu, _, queries, extra = _serving_pair(cuda_device)
    root = recovery.init(str(tmp_path / "root"), cpu)
    handle, _, _ = recovery.attach(root, background=False, fsync="batch", device="cpu")
    try:
        handle.add(extra)
        handle.delete(np.arange(3, 2000, 11))
    finally:
        handle.wal.close()
    on_card, on_cpu = recovery.recover(root, device=cuda_device), recovery.recover(root, device="cpu")
    assert on_card.index.device.type == "cuda" and on_card.replayed == on_cpu.replayed == 2
    st_card, st_cpu = on_card.index.export_state()[1], on_cpu.index.export_state()[1]
    for key, arr in st_cpu.items():
        np.testing.assert_array_equal(st_card[key], arr, err_msg=key)
    a = on_card.index.search(queries, k=10, ef=64)
    b = on_cpu.index.search(queries, k=10, ef=64)
    assert torch.equal(a.ids.cpu(), b.ids) and torch.equal(a.dists.cpu(), b.dists)


@pytest.mark.cuda
@pytest.mark.parametrize("compression", ["none", "bf16", "int8_ef"])
def test_cuda_train_step_equals_the_cpu(cuda_device, compression):
    """``make_train_step`` (2 microbatches) at the reduced BERT4Rec config
    on the card and on the CPU from one set of parameters and the same 3
    batches: loss and lr at rtol 1e-5, grad_norm at rtol 1e-4, every
    parameter, moment and residual within atol/rtol 1e-4 except at most 1
    in 10,000 elements, each within 2·steps·lr (a gradient that is float
    noise moves its parameter by ±lr, whichever sign the noise has)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.recsys import bert4rec as b4r
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    from repro_torch.utils import tree_leaves, tree_map

    cfg = get_arch("bert4rec").make_reduced()
    params_np = b4r.params_to_jax(b4r.Bert4Rec(cfg, torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(3):
        mask = rng.random((8, cfg.seq_len)) < cfg.mask_prob
        mask[:, -1] = True
        batches.append({"items": rng.integers(0, cfg.n_items, (2, 4, cfg.seq_len)).astype(np.int32),
                        "mask_positions": mask.reshape(2, 4, -1)})
    lr = 3e-3
    tc = tl.TrainConfig(opt=opt.AdamWConfig(lr=lr, warmup_steps=0, schedule="constant"), microbatches=2,
                        compression=compression)

    def loss_fn(p, batch):
        return b4r.bert4rec_loss(p, cfg, batch["items"], batch["mask_positions"]), {}

    step = tl.make_train_step(loss_fn, tc)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        tree = tl.init_train_state(tree_map(lambda a, d=dev: torch.from_numpy(a).to(d), params_np), tc).tree()
        metrics = []
        for b in batches:
            tree, m = step(tree, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        out[dev.type] = (tree, metrics)
    for mc, mp in zip(out["cuda"][1], out["cpu"][1]):
        for k in mp:
            np.testing.assert_allclose(mc[k], mp[k], rtol=1e-4 if k == "grad_norm" else 1e-5, err_msg=k)
    off = total = 0
    for a, b in zip(tree_leaves(out["cuda"][0]), tree_leaves(out["cpu"][0])):
        a, b = a.double().cpu(), b.double()
        assert float((a - b).abs().max()) <= 2 * 3 * lr + 1e-4
        off += int(((a - b).abs() > 1e-4 + 1e-4 * b.abs()).sum())
        total += b.numel()
    assert off <= total // 10_000, f"{off} of {total} elements differ"


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-72b", "qwen1.5-0.5b", "llama3.2-3b", "deepseek-v3-671b",
                                  "moonshot-v1-16b-a3b"])
def test_cuda_lm_prefill_and_decode_equal_the_cpu(cuda_device, arch):
    """One set of float32 weights (the reduced config) on the card and the
    CPU, TF32 off: the prefill logits and caches and 3 decode steps of fixed
    tokens allclose at atol 1e-4 (float32 sums in another order; the
    measured largest difference is below 1e-5)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.utils import tree_map

    cfg = get_arch(arch).make_reduced()
    cpu = tfm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 15)))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, want = {}, {}
        for params, dev, out in ((card, cuda_device, got), (cpu, torch.device("cpu"), want)):
            logits, caches = tfm.lm_prefill(params, cfg, toks[:, :12].to(dev), s_max=15)
            out["prefill"] = logits.cpu()
            for i in range(3):
                logits, caches = tfm.lm_decode_step(params, cfg, caches, toks[:, 12 + i].to(dev), 12 + i)
                out[f"decode{i}"] = logits.cpu()
            out.update({k: v.cpu() for k, v in caches.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v3-671b"])
def test_cuda_lm_loss_and_grads_equal_the_cpu(cuda_device, arch):
    """``lm_loss`` (deepseek: MLA, MoE, MTP, bfloat16 storage) and its
    gradients at the reduced config on the card and the CPU from one set of
    weights and tokens, TF32 off: loss and metrics at rtol 1e-5, each
    float32 gradient leaf within 1e-4 of its largest magnitude, each
    bfloat16 leaf within 2⁻⁷ of it (one bfloat16 step; float32 sums in
    another order)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import lm_loss_fn
    from repro_torch.models import transformer as tfm
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.utils import tree_map, tree_paths

    cfg = get_arch(arch).make_reduced()
    cpu = tfm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        params = tree_map(lambda t, d=dev: t.to(d), cpu)
        out[dev.type] = value_and_grad(lm_loss_fn(cfg), params, {k: v.to(dev) for k, v in batch.items()})
    (lc, mc, gc), (lp, mp, gp) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(float(lc), float(lp), rtol=1e-5)
    assert sorted(mc) == sorted(mp)
    for k in mp:
        np.testing.assert_allclose(float(mc[k]), float(mp[k]), rtol=1e-5, err_msg=k)
    for (path, a), (_, b) in zip(tree_paths(gc), tree_paths(gp)):
        assert a.dtype == b.dtype, path
        rtol = 2.0 ** -7 if b.dtype == torch.bfloat16 else 1e-4
        a, b = a.cpu().double(), b.double()
        assert float((a - b).abs().max()) <= rtol * float(b.abs().max()), path


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gatedgcn", "egnn", "nequip", "equiformer-v2"])
def test_cuda_gnn_train_step_equals_the_cpu(cuda_device, arch):
    """One float32 ``gnn_train_step`` (``AdamWConfig()``) at the reduced
    config on a padded ``molecule``-like batch of 16 graphs, card against
    CPU from one set of weights, TF32 off: the loss, grad_norm and every
    moment leaf within 1e-4 of the tensor's largest magnitude, every
    parameter within that plus 2·lr (the card's ``index_add`` sums with
    atomics, in no fixed order). Equiformer's last attention bias, whose
    gradient is float noise (the softmax cancels it), is held against its
    tree's largest magnitude. The batch holds a receiver whose incoming
    edges are all masked; its gradients stay finite on the card."""
    import dataclasses

    from repro_torch.configs.registry import GNN_SHAPES, get_arch
    from repro_torch.launch import steps as st
    from repro_torch.train.train_loop import TrainConfig, init_train_state
    from repro_torch.utils import tree_map, tree_paths

    shape = next(s for s in GNN_SHAPES if s.name == "molecule")
    shape = dataclasses.replace(shape, dims={**shape.dims, "n_nodes": 30 * 16, "n_edges": 64 * 16, "n_graphs": 16})
    cfg = st.gnn_adapt_config(get_arch(arch).make_reduced(), shape)
    gen = torch.Generator().manual_seed(0)
    batch = st.gnn_batch(cfg, shape, gen, device="cpu")
    g = batch["graph"]
    n_real = shape.dims["n_edges"]  # the last real node receives only self-loops
    last = shape.dims["n_nodes"] - 1
    rcv = torch.where(g.receivers == last, last - 1, g.receivers)
    rcv[n_real - 3:n_real] = last
    snd = g.senders.clone()
    snd[n_real - 3:n_real] = last
    batch["graph"] = g._replace(senders=snd, receivers=rcv)
    params = st.gnn_init(cfg, gen, device="cpu")
    step = st.gnn_train_step(cfg)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        p = tree_map(lambda t, d=dev: t.to(d), params)
        b = {"graph": batch["graph"].to(dev), "labels": batch["labels"].to(dev)}
        tree, metrics = step(init_train_state(p, TrainConfig()).tree(), b)
        out.append((metrics, tree))
    (mc, card), (mp, cpu) = out
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mc[k]), float(mp[k]), rtol=1e-4)
    lr = float(mp["lr"])
    for got_tree, want_tree, atol in ((card["params"], cpu["params"], 2 * lr), (card["opt_state"].mu, cpu["opt_state"].mu, 0.0),
                                      (card["opt_state"].nu, cpu["opt_state"].nu, 0.0)):
        want = tree_paths(want_tree)
        largest = max(float(b.abs().max()) for _, b in want)
        for (path, a), (_, b) in zip(tree_paths(got_tree), want):
            a = a.cpu().double()
            assert bool(torch.isfinite(a).all()), path
            scale = largest if path == "['layers']/['attn']/['b1']" else float(b.abs().max())
            assert float((a - b.double()).abs().max()) <= 1e-4 * scale + atol, path


@pytest.mark.cuda
def test_cuda_l2_batch_at_flash_ann_width(cuda_device):
    """``l2_batch`` at the flash-ann width (D = 768, 24 K-slices a tile: the
    wide shape) against its plain version, 1,024 queries x 20,000 rows, with
    the stated atol; the plan at C = 64 is the wide one too."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((1024, 768), generator=gen, device=cuda_device)
    y = torch.randn((20_000, 768), generator=gen, device=cuda_device)
    assert not tops._l2_plan(65536, 64, 768, x.data_ptr(), y.data_ptr()).narrow
    got, want = tops.l2_batch(x, y), tref.l2_batch(x, y)
    atol = 1e-5 * float((x * x).sum(1).max() + (y * y).sum(1).max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


@pytest.mark.cuda
def test_cuda_build_segment_equals_the_cpu(cuda_device):
    """``graph.segmented.build_segment`` (the unblocked Flash backend's
    incremental build) on the card against the CPU from one shared coder,
    1,000 rows at D = 64: codes, adjacency, levels and entry equal where the
    two devices' query tables agree, else at least 99% of adjacency rows."""
    from repro_torch.core import flash as fl
    from repro_torch.data.synthetic import vector_dataset
    from repro_torch.graph import segmented as seg
    from repro_torch.graph.engine import BuildParams, prefix_entries, sample_levels

    params = BuildParams(r_upper=8, r_base=16, ef=48, batch=32, max_layers=3)
    rows = torch.from_numpy(vector_dataset(0, n=1000, d=64))
    coder = seg.fit_shared_coder(0, rows, d_f=32, m_f=16, kmeans_iters=8, device="cpu")
    levels = sample_levels(0, 1000, r_upper=8, max_layers=3)
    entries = prefix_entries(levels, params.batch)
    cpu = seg.build_segment(rows, coder, levels, entries, params=params)
    card = seg.build_segment(rows.to(cuda_device), fl.FlashCoder(*(t.to(cuda_device) for t in coder)), levels,
                             entries, params=params)
    agree = int((fl.query_ctx(coder, rows).adt_q != fl.query_ctx(
        fl.FlashCoder(*(t.to(cuda_device) for t in coder)), rows.to(cuda_device)).adt_q.cpu()).sum()) == 0
    assert torch.equal(card.backend.codes.cpu(), cpu.backend.codes)
    if agree:
        for f in ("adj0", "adj0_d", "adj_up", "levels"):
            assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
        assert card.entry == cpu.entry
    else:
        assert float((card.adj0.cpu() == cpu.adj0).all(1).double().mean()) >= 0.99


@pytest.mark.cuda
def test_cuda_mesh_programs_on_two_ranks_equal_one_process(cuda_device, tmp_path):
    """``graph.segmented``'s mesh programs on two ranks sharing the card
    (``run_ranks``, ``gloo``) against the single-process programs on the
    card, from one coder and plan at the reference test's sizes (2 x 300 x
    32): every stacked tensor equal on both ranks, the search's ids and
    dists equal."""
    import _mesh_ranks as mr
    from repro_torch.graph import segmented as seg
    from repro_torch.graph.backends import FlashBackend
    from repro_torch.graph.engine import BuildParams, prefix_entries, sample_levels
    from repro_torch.launch.mesh import run_ranks

    rng = np.random.default_rng(0)
    data = rng.normal(size=(mr.S * mr.NS, mr.D)).astype(np.float32)
    queries = rng.normal(size=(mr.Q, mr.D)).astype(np.float32)
    params = BuildParams(**mr.PARAMS)
    levels = np.stack([sample_levels(s, mr.NS, r_upper=params.r_upper, max_layers=params.max_layers)
                       for s in range(mr.S)])
    entries = np.stack([prefix_entries(levels[s], params.batch) for s in range(mr.S)])
    segs = torch.from_numpy(data.reshape(mr.S, mr.NS, mr.D)).to(cuda_device)
    coder = seg.fit_shared_coder(0, data, device=cuda_device, **mr.CODER_KW)
    built = seg.build_segments_vmapped(segs, coder, levels, entries, params=params)
    ids, dists = seg.search_segments_local(built, torch.from_numpy(queries).to(cuda_device), np.full(mr.S, mr.NS),
                                           k=mr.K, ef_search=mr.EF, seg_vectors=segs)
    state = FlashBackend(coder, built.index.backend.codes[0]).state_dict()
    npz = str(tmp_path / "inputs.npz")
    np.savez(npz, data=data, queries=queries, plan_levels=levels, plan_entries=entries,
             offsets=np.array([0, mr.NS], np.int32), **{f"coder_state.{k}": v for k, v in state.items()})
    want = mr.graph_arrays(built.index)
    for r, out in enumerate(run_ranks(mr.segment_programs, 2, npz, device="cuda", timeout=300)):
        assert out["device"].startswith("cuda") and out["coords"] == {"data": r}
        for f, v in want.items():
            np.testing.assert_array_equal(out["build"][f], v, err_msg=f"rank {r}: {f}")
        np.testing.assert_array_equal(out["ids"], ids.cpu().numpy())
        np.testing.assert_array_equal(out["dists"], dists.cpu().numpy())


@pytest.mark.cuda
def test_cuda_serve_bulk_equals_the_cpu(cuda_device):
    """``launch/steps``'s ``serve_bulk`` step at the reduced config with a
    70,000-row table (two 65,536-row chunks), 64 sessions in blocks of 16 on
    the card against one block on the CPU from one set of weights: top-100
    ids equal, except where the CPU's scores of the differing ids lie within
    1e-5 of the 100th; scores within atol 1e-4."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import steps as st
    from repro_torch.models.recsys import bert4rec as b4r
    from repro_torch.utils import tree_map

    cfg = dataclasses.replace(get_arch("bert4rec").make_reduced(), n_items=70_000)
    params = b4r.params_tree(b4r.Bert4Rec(cfg, torch.Generator().manual_seed(0), device="cpu"))
    items = torch.randint(0, cfg.n_items, (64, cfg.seq_len), generator=torch.Generator().manual_seed(1),
                          dtype=torch.int32)
    items[:, -1] = cfg.mask_id
    fn = st.build_bundle("bert4rec", "serve_bulk", reduced=True, cfg_override={"n_items": 70_000},
                         device=cuda_device).fn
    ids_c, s_c = fn(tree_map(lambda t: t.to(cuda_device), params), items.to(cuda_device), block=16)
    ids_p, s_p = fn(params, items)
    logits = b4r.bert4rec_score_all(params, cfg, items)
    for r in range(items.shape[0]):
        extra = ids_c[r].cpu().long()[~torch.isin(ids_c[r].cpu(), ids_p[r])]
        assert bool(((logits[r, extra] - s_p[r, -1]).abs() <= 1e-5).all()), r
    torch.testing.assert_close(s_c.cpu(), s_p, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks,m", [(2, 16), (4, 16), (4, 5)])
def test_cuda_flash_scan_on_a_rank_shard(cuda_device, ranks, m):
    """``retrieval_cand`` across ranks scans each rank's contiguous row
    shard of the candidate codes: every rank's shard (a view at its row
    offset of 1,000,000 rows, M = 16; and M = 5, whose rows start off a
    16-byte line) equals the plain version and the whole table's scan at
    those rows."""
    n, k = 1_000_000, 16
    rng = np.random.default_rng(ranks + m)
    codes = torch.from_numpy(rng.integers(0, k, (n, m)).astype(np.int32)).to(cuda_device)
    adt = torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.int32)).to(cuda_device)
    whole = tops.flash_scan(codes, adt)
    rows = n // ranks
    for r in range(ranks):
        shard = codes.narrow(0, r * rows, rows)
        before = tops.launches["flash_scan"]
        got = tops.flash_scan(shard, adt)
        torch.cuda.synchronize()
        assert tops.launches["flash_scan"] == before + 1
        assert torch.equal(got, tref.flash_scan(shard, adt)) and torch.equal(got, whole[r * rows:(r + 1) * rows])


def _card_inputs(tmp_path, make) -> str:
    import pickle

    path = str(tmp_path / "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(make(), f)
    return path


@pytest.mark.cuda
def test_cuda_recsys_cells_across_ranks_equal_one_process(cuda_device, tmp_path):
    """BERT4Rec's four cells (``launch/steps``, reduced config, a 4,096-row
    table, 3,000 candidates) on four ranks sharing the card over ``gloo``,
    on (2, 2), (1, 2) and (2, 1) meshes, against the one-process cells on
    the card from one set of weights: top-k ids equal but at near ties
    (scores within 1e-5 of the k-th), scores and logits within atol 1e-4,
    one train step's loss within rtol 1e-5, grad_norm within 1e-4 and every
    leaf within 1e-4 of its largest magnitude (parameters 2·lr more)."""
    import _mesh_steps_ranks as msr
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.recsys import bert4rec as b4r
    from repro_torch.utils import tree_paths

    def make():
        cfg = msr.recsys_config()
        rng = np.random.default_rng(1)
        items = rng.integers(0, cfg.n_items, (msr.B, cfg.seq_len)).astype(np.int32)
        serve = items.copy()
        serve[:, -1] = cfg.mask_id
        mask = rng.random(items.shape) < cfg.mask_prob
        mask[:, -1] = True
        return {"params": b4r.params_to_jax(b4r.Bert4Rec(cfg, torch.Generator().manual_seed(0), device="cpu")),
                "items": items, "serve_items": serve, "mask": mask,
                "codes": rng.integers(0, 16, (msr.N_CAND, 16)).astype(np.int32),
                "adt": rng.integers(0, 256, (16, 16)).astype(np.int32)}

    out = run_ranks(msr.recsys_cells, 4, _card_inputs(tmp_path, make), device="cuda", timeout=300)
    one = out[0]["one_process"]
    for rank in out:
        for name, cells in rank["meshes"].items():
            label = f"rank {rank['rank']} {name}"
            np.testing.assert_allclose(cells["serve_p99"], one["serve_p99"], rtol=0, atol=1e-4, err_msg=label)
            for (gi, gs), (wi, ws) in ((cells["serve_bulk"], one["serve_bulk"]),
                                       (cells["retrieval_cand"][:2], one["retrieval_cand"][:2]),
                                       (cells["retrieval_cand"][2:], one["retrieval_cand"][2:])):
                gi, gs, wi, ws = (np.atleast_2d(x) for x in (gi, gs, wi, ws))
                for r in range(gi.shape[0]):
                    extra = gs[r][~np.isin(gi[r], wi[r])]
                    assert (np.abs(extra - ws[r, -1]) <= 1e-5 * max(1.0, abs(ws[r, -1]))).all(), (label, r)
                np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4, err_msg=label)
            got, want = cells["train_batch"], one["train_batch"]
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=label)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4, err_msg=label)
            for tree, extra in (("params", 2 * want["lr"]), ("mu", 0.0), ("nu", 0.0)):
                wanted = dict(tree_paths(want[tree]))
                for path, a in tree_paths(got[tree]):
                    w = np.asarray(wanted[path], np.float64)
                    assert float(np.abs(a - w).max()) <= 1e-4 * float(np.abs(w).max()) + extra, (label, tree, path)


@pytest.mark.cuda
def test_cuda_gnn_steps_across_ranks_equal_one_process(cuda_device, tmp_path):
    """One train step of each GNN arch (reduced configs, 512 nodes, 2,048
    edges, a receiver whose edges are all masked) on four ranks sharing the
    card, edges sharded over (2, 2), (1, 2) and (2, 1) meshes, against the
    one-process step on the card: the loss, grad_norm and every leaf within
    1e-3 of its largest magnitude (parameters 2·lr more; index_add adds
    with atomics on the card and GatedGCN's ReLUs flip under float32
    noise, as in the card-against-CPU check)."""
    import _mesh_steps_ranks as msr
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.gnn import common as gcm
    from repro_torch.utils import tree_paths

    def make():
        out = {}
        for i, arch in enumerate(msr.GNN_ARCHS):
            cfg = msr.gnn_config(arch)
            gen = torch.Generator().manual_seed(i)
            g = gcm.random_graph_batch(gen, n_nodes=msr.GNN_NODES, n_edges=msr.GNN_EDGES, d_feat=8,
                                       with_positions=arch != "gatedgcn", n_graphs=msr.GNN_GRAPHS, device="cpu")
            g = gcm.pad_graph(g, msr.GNN_NODES, msr.GNN_EDGE_PAD)
            nodes = g.nodes.clone()
            nodes[:, 0] = nodes[:, 0].abs() * 3
            graph = {"nodes": nodes.numpy(), "positions": None if g.positions is None else (g.positions * 0.3).numpy(),
                     "edges": None, "senders": g.senders.numpy(), "receivers": g.receivers.numpy(),
                     "node_mask": g.node_mask.numpy(), "edge_mask": (g.edge_mask & (g.receivers != 0)).numpy(),
                     "graph_id": g.graph_id.numpy()}
            labels = st._labels(cfg, msr.GNN_NODES, msr.GNN_GRAPHS, gen, torch.device("cpu")).numpy()
            out[arch] = {"params": gcm.params_to_jax(st.gnn_init(cfg, gen, device="cpu")), "graph": graph,
                         "labels": labels}
        return out

    out = run_ranks(msr.gnn_cells, 4, _card_inputs(tmp_path, make), device="cuda", timeout=300)
    for arch in msr.GNN_ARCHS:
        want = out[0]["one_process"][arch]
        for rank in out:
            for name, cells in rank["meshes"].items():
                got, label = cells[arch], f"{arch} rank {rank['rank']} {name}"
                for key in ("loss", "grad_norm"):
                    np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=label)
                for tree, extra in (("params", 2 * want["lr"]), ("mu", 0.0), ("nu", 0.0)):
                    wanted = dict(tree_paths(want[tree]))
                    largest = max(float(np.abs(w).max()) for w in wanted.values())
                    for path, a in tree_paths(got[tree]):
                        w = np.asarray(wanted[path], np.float64)
                        scale = largest if path == "['layers']/['attn']/['b1']" else float(np.abs(w).max())
                        assert float(np.abs(a - w).max()) <= 1e-3 * scale + extra, (label, tree, path)


@pytest.mark.cuda
def test_cuda_lm_cells_across_ranks_equal_one_process(cuda_device, tmp_path):
    """The LM serving cells (``launch/steps``' prefill and decode bundles
    under a mesh; ``tests/_mesh_lm_ranks.py``: a prefill of B 8 × S 8, a
    batched and a long-context decode from its caches) of the reduced
    moonshot with ``impl="ep"`` at capacity factor 4.0 (no assignment drops,
    so the ep branch computes what one process does), qwen1.5, qwen2 (Kv 1)
    and llama with 6 heads and Kv 3 on four ranks sharing the card, on (2, 2), (1, 2) and (2, 1)
    meshes, against the one-process cells on the card from one set of
    weights: logits within 1e-4 of the largest |logit|, every cache within
    1e-4 of its largest |value|, argmax equal but at near ties (a top-2
    margin below 1e-4)."""
    import _mesh_lm_ranks as mlr
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as tfm

    cases = {"moonshot-ep": ("moonshot-v1-16b-a3b", {"moe": {"impl": "ep", "capacity_factor": 4.0}}),
             "qwen1.5": ("qwen1.5-0.5b", {}), "qwen2-kv1": ("qwen2-72b", {}),
             "llama-kv3": ("llama3.2-3b", {"n_heads": 6, "n_kv_heads": 3})}

    def make():
        out = {}
        for i, (case, (arch, override)) in enumerate(cases.items()):
            cfg = mlr.lm_config(arch, override)
            out[case] = {"arch": arch, "override": override,
                         "params": tfm.params_to_jax(tfm.init_lm(torch.Generator().manual_seed(i), cfg, device="cpu")),
                         "tokens": np.random.default_rng(i).integers(0, cfg.vocab, (mlr.B, mlr.S)).astype(np.int32)}
        return {"cases": out}

    out = run_ranks(mlr.lm_cells, 4, _card_inputs(tmp_path, make), device="cuda", timeout=300)
    for case in cases:
        want = out[0]["one_process"][case]["cells"]
        for rank in out:
            for name, runs in rank["meshes"].items():
                for cell, (logits, caches) in runs[case]["cells"].items():
                    label = f"{case} rank {rank['rank']} {name} {cell}"
                    w_logits, w_caches = want[cell]
                    top2 = np.sort(w_logits, -1)[:, -2:]
                    tie = top2[:, 1] - top2[:, 0] < 1e-4
                    assert float(np.abs(logits - w_logits).max()) <= 1e-4 * float(np.abs(w_logits).max()), label
                    assert not ((logits.argmax(-1) != w_logits.argmax(-1)) & ~tie).any(), label
                    for k, w in w_caches.items():
                        assert float(np.abs(caches[k] - w).max()) <= 1e-4 * float(np.abs(w).max()), (label, k)


@pytest.mark.cuda
def test_cuda_lm_train_across_ranks_equals_one_process(cuda_device, tmp_path):
    """The LM train cell (``launch/steps.lm_train_bundle`` under a mesh;
    ``tests/_mesh_lm_train_ranks.py``: 2 steps of B 8 × S 8) in float32 at
    depth 2 (the reduced qwen1.5, qwen2 with Kv 1 and llama with 6 heads and
    Kv 3) and the reduced moonshot with ``impl="ep"`` at capacity factor 4.0
    (no assignment drops, so the ep branch computes what one process does)
    with remat, on two ranks sharing the card over ``gloo``, on (1, 2) and
    (2, 1) meshes, against the one-process steps on the card from one set of
    weights and batches: every step's loss, ``ce``, the aux losses and
    ``grad_norm`` within 1e-5 relative, every parameter and moment within
    1e-4 of its tensor's largest magnitude (parameters 2·steps·lr more; a
    bfloat16 parameter's within a bfloat16 step, its second moment two)."""
    import _mesh_lm_train_ranks as mtr
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as tfm
    from repro_torch.utils import tree_paths

    cases = {"moonshot-ep": ("moonshot-v1-16b-a3b", {"moe": {"impl": "ep", "capacity_factor": 4.0}, "remat": True}),
             "qwen1.5": ("qwen1.5-0.5b", {}), "qwen2-kv1": ("qwen2-72b", {}),
             "llama-kv3": ("llama3.2-3b", {"n_heads": 6, "n_kv_heads": 3})}

    def make():
        out = {}
        for i, (case, (arch, override)) in enumerate(cases.items()):
            cfg = mtr.lm_config(arch, override)
            rng = np.random.default_rng(i)
            out[case] = {"arch": arch, "override": override,
                         "params": tfm.params_to_jax(tfm.init_lm(torch.Generator().manual_seed(i), cfg, device="cpu")),
                         "batches": [tuple(rng.integers(0, cfg.vocab, (mtr.B, mtr.S)).astype(np.int32)
                                           for _ in range(2)) for _ in range(mtr.STEPS)]}
        return {"cases": out}

    out = run_ranks(mtr.train_cells, 2, _card_inputs(tmp_path, make), device="cuda", timeout=300)
    for case in cases:
        want = out[0]["one_process"][case]
        lr = max(s["lr"] for s in want["steps"])
        for rank in out:
            for name, runs in rank["meshes"].items():
                got, label = runs[case], f"{case} rank {rank['rank']} {name}"
                for g, w in zip(got["steps"], want["steps"]):
                    for k in ("loss", "ce", "moe/load_balance", "moe/router_z", "grad_norm"):
                        if k in w:
                            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=f"{label}: {k}")
                for tree, extra, n in (("params", 2 * mtr.STEPS * lr, 1), ("mu", 0.0, 1), ("nu", 0.0, 2)):
                    wanted = dict(tree_paths(want[tree]))
                    for path, a in tree_paths(got[tree]):
                        w = np.asarray(wanted[path], np.float64)
                        rel = n * 2.0 ** -7 if case == "qwen2-kv1" else 1e-4  # the reduced qwen2 stores bfloat16
                        assert float(np.abs(a - w).max()) <= rel * float(np.abs(w).max()) + extra, (label, tree, path)
