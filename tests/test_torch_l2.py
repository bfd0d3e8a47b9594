"""``l2_batch``'s arithmetic and host-side plan against the reference package.

The CUDA kernel (``kernels/csrc/l2_batch.cu``) runs only on the card. Its
arithmetic is 3xTF32: each float32 operand split into TF32 parts hi =
rna(v) and lo = rna(v − hi), the three products hi·hi + hi·lo + lo·hi
summed in one float32 accumulator, the norms float32 sums of the unsplit
squares. ``kernels/ref.py::l2_batch_split_tf32`` emulates that arithmetic
(no path calls it). These tests hold the emulation against the reference's
jnp oracle (``repro.kernels.ref.l2_batch_ref``) and its Pallas kernel in
interpret mode, on the same numpy inputs, at the tolerance the port states
for ``l2_batch``: rtol 1e-5 and atol 1e-5·max(‖x‖² + ‖y‖²). The inputs are
chosen to be hard: a large common offset (SIFT's 0–255 range, so that
‖x‖² + ‖y‖² − 2·x·y cancels), near duplicates, exact duplicates and an
exact-zero row, at D ∈ {3, 25, 128, 960}. A single TF32 product misses
that tolerance on the offset inputs. Routes (the first argmin) may differ
from the reference's only at near ties (the two distances within 2·atol).
The plan (``ops._l2_plan``: tile shape, padded D, copies, ring stages,
grid; the shared memory they take) is checked on the paths' shapes, ragged N and C, and
views off TMA's 16-byte alignment. The kernel itself is held against the
plain version on the card by ``test_torch_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.utils import first_argmin


def _atol(x: np.ndarray, y: np.ndarray) -> float:
    return 1e-5 * float((x * x).sum(1).max() + (y * y).sum(1).max())


def _inputs(kind: str, n: int, c: int, d: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(x (n, d), y (c, d)) float32 of one kind, with an exact-zero x row and
    an exact duplicate."""
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        x = rng.normal(size=(n, d)) * 2.0
        y = rng.normal(size=(c, d)) * 2.0
    elif kind == "offset":  # rows scattered around one point of SIFT's 0–255 range
        base = rng.uniform(0.0, 255.0, d)
        x = base + rng.normal(0.0, 3.0, (n, d))
        y = base + rng.normal(0.0, 3.0, (c, d))
    else:  # near duplicates: y's rows are x's, moved by 1e-3
        x = rng.uniform(0.0, 255.0, (n, d))
        y = x[rng.integers(0, n, c)] + rng.normal(0.0, 1e-3, (c, d))
    x, y = x.astype(np.float32), y.astype(np.float32)
    x[0] = 0.0
    y[1] = x[1]
    return x, y


def test_tf32_rna_rounds_to_nearest_ties_away():
    """``tf32_rna`` keeps 10 mantissa bits: the low 13 bits are zero, the
    error is at most half a TF32 unit, and a value exactly halfway rounds
    away from zero, for both signs."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=4096) * 10.0 ** rng.integers(-20, 20, 4096)
    v = torch.from_numpy(v.astype(np.float32))
    h = tref.tf32_rna(v)
    assert int((h.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool(((h - v).abs() <= v.abs() * 2.0 ** -11).all())
    # 1 + 2⁻¹¹ and 1 + 3·2⁻¹¹, halfway between TF32 neighbours
    half = torch.tensor([0x3F801000, 0x3F803000], dtype=torch.int32).view(torch.float32)
    up = torch.tensor([0x3F802000, 0x3F804000], dtype=torch.int32).view(torch.float32)
    assert torch.equal(tref.tf32_rna(half), up)
    assert torch.equal(tref.tf32_rna(-half), -up)


@pytest.mark.parametrize("d", [3, 25, 128, 960])
@pytest.mark.parametrize("kind", ["gauss", "offset", "near_dup"])
def test_split_tf32_matches_reference(kind, d):
    """The kernel's arithmetic holds the reference's oracle and its Pallas
    kernel (interpret mode) at the stated tolerance."""
    x, y = _inputs(kind, 40, 70, d, seed=d)
    got = tref.l2_batch_split_tf32(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and tuple(got.shape) == (40, 70)
    assert float(got.min()) >= 0.0
    atol = _atol(x, y)
    for want in (jref.l2_batch_ref(jnp.asarray(x), jnp.asarray(y)),
                 jops.l2_batch(jnp.asarray(x), jnp.asarray(y), impl="interpret")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=atol)
    assert float(got[1, 1]) <= atol  # the exact duplicate


@pytest.mark.parametrize("d", [25, 128, 960])
def test_one_tf32_product_misses_the_tolerance(d):
    """Why three products: hi·hi alone is off by more than atol on rows
    with a common offset, where the split keeps well inside it."""
    x, y = _inputs("offset", 40, 70, d, seed=d)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want = np.asarray(jref.l2_batch_ref(jnp.asarray(x), jnp.asarray(y)))
    xy = tref.tf32_rna(tx) @ tref.tf32_rna(ty).T
    one = (tx * tx).sum(1)[:, None] + (ty * ty).sum(1)[None] - 2.0 * xy
    atol = _atol(x, y)
    assert float(np.abs(one.numpy() - want).max()) > atol
    assert float(np.abs(tref.l2_batch_split_tf32(tx, ty).numpy() - want).max()) < 0.5 * atol


@pytest.mark.parametrize("d", [25, 128])
def test_split_tf32_routes_match_reference_except_near_ties(d):
    """First-argmin routes of the emulation against the reference's
    ``nearest_centroid`` over 64 centroids close to each other: equal except
    where the reference's two distances lie within 2·atol."""
    x, cents = _inputs("offset", 2000, 64, d, seed=7 + d)
    got = first_argmin(tref.l2_batch_split_tf32(torch.from_numpy(x), torch.from_numpy(cents)), 1).numpy()
    want, _ = jops.nearest_centroid(jnp.asarray(x), jnp.asarray(cents))
    want = np.asarray(want)
    plain = np.asarray(jref.l2_batch_ref(jnp.asarray(x), jnp.asarray(cents)))
    rows = np.arange(x.shape[0])
    atol = _atol(x, cents)
    gap = np.abs(plain[rows, got] - plain[rows, want])
    differ = got != want
    assert not (differ & (gap > 2 * atol)).any()
    two = np.sort(plain, 1)[:, :2]
    assert differ.sum() <= ((two[:, 1] - two[:, 0]) <= 2 * atol).sum()


# (N, C, D, x and y address offsets, SMs) -> (narrow, BN, padded D, copy x,
# copy y, tiles, grid)
PLANS = [
    # the ground-truth tile: wide, 8 x 64 tiles over 132 SMs
    ((1000, 8192, 128, 0, 0, 132), (False, 128, 128, False, False, 512, 132)),
    # the assignment chunk: narrow, y resident
    ((65536, 64, 128, 0, 0, 132), (True, 64, 128, False, False, 512, 132)),
    # D % 4 != 0: both copied; C = 8191 ragged
    ((1, 8191, 25, 0, 0, 132), (False, 128, 28, True, True, 64, 64)),
    ((5, 1, 3, 0, 0, 132), (True, 64, 4, True, True, 1, 1)),
    # C <= 64, but y's 30 slices do not fit beside a ring: wide
    ((77, 1, 960, 0, 0, 132), (False, 128, 960, False, False, 1, 1)),
    # ragged N and C
    ((129, 70, 48, 0, 0, 132), (False, 128, 48, False, False, 2, 2)),
    ((2000, 64, 100, 0, 0, 132), (True, 64, 100, False, False, 16, 16)),
    # a view off a 16-byte line: only that operand is copied
    ((300, 70, 128, 4, 0, 132), (False, 128, 128, True, False, 3, 3)),
    ((300, 64, 128, 0, 8, 132), (True, 64, 128, False, True, 3, 3)),
    # fewer SMs than tiles
    ((1000, 8192, 128, 0, 0, 10), (False, 128, 128, False, False, 512, 10)),
]


@pytest.mark.parametrize("args,want", PLANS)
def test_l2_plan(args, want):
    n, c, d, x_off, y_off, sms = args
    plan = tops._l2_plan(n, c, d, 1 << 20 | x_off, 1 << 21 | y_off, sms)
    assert (plan.narrow, plan.bn, plan.d_pad, plan.pad_x, plan.pad_y, plan.tiles, plan.grid) == want
    nk = -(-plan.d_pad // 32)
    assert tops._l2_smem(plan.bn, plan.narrow, nk, plan.stages) <= tops._MAX_BLOCK_SMEM
    # the deepest ring that fits, up to 8 stages
    assert plan.stages == 8 or tops._l2_smem(plan.bn, plan.narrow, nk, plan.stages + 1) > tops._MAX_BLOCK_SMEM
    assert plan.stages >= 2


def test_l2_batch_on_the_cpu_takes_the_plain_version_of_a_misaligned_view():
    """CPU tensors take ``ref.l2_batch`` whatever their layout: a view off
    16-byte alignment at D = 3 gives the reference's distances and counts
    neither a launch nor a pad copy."""
    rng = np.random.default_rng(3)
    flat = rng.normal(size=(301 * 3,)).astype(np.float32)
    y = rng.normal(size=(70, 3)).astype(np.float32)
    x = torch.from_numpy(flat).view(301, 3)[1:]
    assert x.data_ptr() % 16 != 0
    tops.reset_launches()
    got = tops.l2_batch(x, torch.from_numpy(y))
    want = np.asarray(jref.l2_batch_ref(jnp.asarray(x.numpy()), jnp.asarray(y)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=_atol(x.numpy(), y))
    assert tops.launches["l2_batch"] == 0 and tops.launches["l2_batch_pad"] == 0
