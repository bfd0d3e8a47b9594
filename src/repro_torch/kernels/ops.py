"""Wrappers of the port's CUDA kernels: the five Flash kernels, ``l2_batch``
and ``sq_l2``.

Dispatch is by where the tensors lie: CPU tensors take the plain PyTorch
version in ``ref.py`` (the CPU tests' path); CUDA tensors launch the
hand-written kernel from ``csrc/`` or raise on a dtype, shape or layout the
kernel does not take — there is no fallback. Each wrapper adds one to
``launches[<kernel>]`` where it launches (:func:`count_launch`, under one
lock: the segmented search calls the wrappers from ``fanout_map``'s
threads), and nowhere else, so a run can show that its main path went
through the kernels.

Kernel notes (each source in ``csrc/`` carries the full note):

* ``flash_round`` replaces ``repro/kernels/flash_round.py::flash_round_pallas``.
  Bound by bytes: the gathered (B, C, M) int32 codes (8.2 GB per bulk pass at
  n = 1M, C = 128, M = 16). One block per row, table in shared memory.
* ``flash_expand`` replaces ``repro/kernels/flash_expand.py::flash_expand_pallas``.
  Bound by the random adjacency and packed code rows (384 B per frontier
  vertex at R = 32, M = 16). One block per (query, vertex group), one
  8-byte code load per neighbor, nibbles unpacked in registers; packed
  rows that are not whole 8-byte words (⌈M/2⌉ % 8 ≠ 0) are read byte-wise
  (:func:`mirror_layout`; ``launches["mirror_*"]`` count each layout).
* ``flash_beam`` replaces the same TPU kernel together with the beam loop
  that launched it once per iteration: one launch runs the whole base-layer
  beam search of Q queries. Bound by latency (dependent loads and
  in-block merges), not bytes. One block per query, the beam, table and
  candidate block in shared memory, visited as one bit per vertex.
* ``flash_scan_blocked`` replaces
  ``repro/kernels/flash_scan.py::flash_scan_blocked_pallas``. Bound by the
  (G, M, B) code bytes; warps read one subspace's B codes as one line.
* ``l2_batch`` replaces ``repro/kernels/l2_batch.py::l2_batch_pallas``.
  The product runs on the tensor cores at float32 accuracy: 3xTF32 (each
  operand split into TF32 hi and lo parts, hi·hi + hi·lo + lo·hi into one
  float32 wgmma accumulator), operands brought in by TMA through a ring of
  shared-memory stages, norms summed in-kernel in float32. Bound by
  operations at the ground-truth tile, by bytes at the assignment chunk.
  :func:`_l2_plan` picks the tile shape (C ≤ 64: y resident per block), the
  ring, the persistent grid and whether an operand is first copied into a
  zero-padded (·, ⌈D/4⌉·4) layout TMA can read (``launches["l2_batch_pad"]``).
* ``flash_scan`` replaces ``repro/kernels/flash_scan.py::flash_scan_pallas``.
  Bound by the (N, M) int32 codes (67.1 MB per query at the 1M-item
  catalog). Table in shared memory, one row per thread, 16-byte code loads.
* ``sq_l2`` replaces ``repro/kernels/sq_l2.py::sq_l2_pallas``. Bound by the
  (N, D) int32 codes. q and s2 in shared memory, one row per warp, one float
  multiply-add per dimension, a warp shuffle reduction.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.utils import first_argmin

#: launches of each CUDA kernel since the last reset (plain int counters)
launches: dict[str, int] = {
    "flash_round": 0,
    "flash_expand": 0,
    "flash_beam": 0,
    "flash_scan_blocked": 0,
    "flash_scan_batch": 0,
    "l2_batch": 0,
    "l2_batch_pad": 0,
    "flash_scan": 0,
    "sq_l2": 0,
    # the mirror layout each flash_expand / flash_beam launch read
    "mirror_words": 0,
    "mirror_bytes": 0,
    "mirror_unpacked": 0,
}

#: csrc/flash_common.cuh::MirrorLayout codes, by name
MIRROR_LAYOUTS = {"unpacked": 0, "words": 1, "bytes": 2}

_LAUNCH_LOCK = threading.Lock()

#: largest per-block table the kernels stage (static shared memory limit)
_MAX_TABLE_BYTES = 48 * 1024

#: dynamic shared memory one block may have on sm_90 (227 KB)
_MAX_BLOCK_SMEM = 232448

#: widest sq_l2 query the kernel stages (q and s2: 32 KiB of shared memory)
_MAX_SQ_DIM = 4096


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for k in launches:
            launches[k] = 0


def count_launch(*names: str) -> None:
    """Add one launch to each named counter, atomically (the read-modify-
    write of ``+= 1`` is not atomic across threads)."""
    with _LAUNCH_LOCK:
        for name in names:
            launches[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, device: torch.device, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _table_kind(name: str, table: torch.Tensor) -> int:
    """1 for a float32 table, 0 for int32 levels; raises otherwise."""
    if table.dtype == torch.float32:
        return 1
    if table.dtype == torch.int32:
        return 0
    raise TypeError(f"{name}: table must be int32 or float32, got {table.dtype}")


def _check_table_size(name: str, m: int, k: int) -> None:
    if m * k * 4 > _MAX_TABLE_BYTES:
        raise ValueError(f"{name}: an (M={m}, K={k}) table exceeds {_MAX_TABLE_BYTES} B of shared memory")


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def mirror_layout(mirror: torch.Tensor) -> str:
    """How the kernels read a mirror (``MIRROR_LAYOUTS``): an int32 one
    unpacked; a packed one as 8-byte words where its rows are whole words
    (⌈M/2⌉ % 8 == 0) from an 8-byte aligned start, else byte-wise."""
    if mirror.dtype != torch.uint8:
        return "unpacked"
    return "words" if mirror.shape[-1] % 8 == 0 and mirror.data_ptr() % 8 == 0 else "bytes"


def flash_scan(codes: torch.Tensor, adt: torch.Tensor) -> torch.Tensor:
    """Flat ADT scan over a code table: codes (N, M) int32 in [0, K), adt
    (M, K) -> (N,) in adt's dtype, Σ_m adt[m, codes[n, m]]."""
    if codes.device.type == "cpu":
        return ref.flash_scan(codes, adt)
    if codes.dim() != 2 or adt.dim() != 2 or codes.shape[1] != adt.shape[0]:
        raise ValueError(
            f"flash_scan: codes {tuple(codes.shape)} / adt {tuple(adt.shape)} must be (N, M) / (M, K)"
        )
    if codes.dtype != torch.int32:
        raise TypeError(f"flash_scan: codes must be int32, got {codes.dtype}")
    n, m = codes.shape
    k = adt.shape[1]
    is_float = _table_kind("flash_scan", adt)
    _check_cuda("flash_scan", codes.device, codes=codes, adt=adt)
    _check_table_size("flash_scan", m, k)
    out = torch.empty(n, dtype=adt.dtype, device=codes.device)
    if n == 0:
        return out
    vec4 = int(m % 4 == 0 and codes.data_ptr() % 16 == 0)
    err = build.kernel("flash_scan")(
        codes.data_ptr(), adt.data_ptr(), out.data_ptr(), n, m, k, is_float, vec4,
        _stream(codes),
    )
    _raise_on("flash_scan", err)
    count_launch("flash_scan")
    return out


def flash_round(codes: torch.Tensor, adts: torch.Tensor) -> torch.Tensor:
    """Bulk refinement-round scan: codes (B, C, M) int32, adts (B, M, K)
    -> (B, C) in adts' dtype."""
    if codes.device.type == "cpu":
        return ref.flash_round(codes, adts)
    b, c, m = codes.shape
    b2, m2, k = adts.shape
    if (b, m) != (b2, m2):
        raise ValueError(f"flash_round: codes (B={b}, M={m}) != adts (B={b2}, M={m2})")
    if codes.dtype != torch.int32:
        raise TypeError(f"flash_round: codes must be int32, got {codes.dtype}")
    is_float = _table_kind("flash_round", adts)
    _check_cuda("flash_round", codes.device, codes=codes, adts=adts)
    _check_table_size("flash_round", m, k)
    out = torch.empty((b, c), dtype=adts.dtype, device=codes.device)
    if b == 0 or c == 0:
        return out
    vec4 = int(m % 4 == 0 and codes.data_ptr() % 16 == 0)
    err = build.kernel("flash_round")(
        codes.data_ptr(), adts.data_ptr(), out.data_ptr(), b, c, m, k,
        is_float, vec4, _stream(codes),
    )
    _raise_on("flash_round", err)
    count_launch("flash_round")
    return out


def flash_expand(
    nodes: torch.Tensor,
    adjacency: torch.Tensor,
    mirror: torch.Tensor,
    adt: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused beam-expansion step: nodes (Q, W) int32, adjacency (n, R) int32,
    mirror (n, R, ⌈M/2⌉) uint8 or (n, R, M) int32, adt (Q, M, K)
    -> (rows (Q, W, R) int32, sums (Q, W, R) adt.dtype)."""
    if nodes.device.type == "cpu":
        return ref.flash_expand(nodes, adjacency, mirror, adt)
    q, w = nodes.shape
    n, r = adjacency.shape
    q2, m, k = adt.shape
    packed = mirror.dtype == torch.uint8
    mp = mirror.shape[-1]
    expect = (m + 1) // 2 if packed else m
    if q2 != q or mirror.shape[:2] != (n, r) or mp != expect:
        raise ValueError(
            f"flash_expand: nodes {tuple(nodes.shape)}, adjacency {tuple(adjacency.shape)}, "
            f"mirror {tuple(mirror.shape)} {mirror.dtype}, adt {tuple(adt.shape)} do not fit "
            f"(expected mirror last dim {expect})"
        )
    if nodes.dtype != torch.int32 or adjacency.dtype != torch.int32:
        raise TypeError("flash_expand: nodes and adjacency must be int32")
    if not packed and mirror.dtype != torch.int32:
        raise TypeError(f"flash_expand: mirror must be uint8 or int32, got {mirror.dtype}")
    is_float = _table_kind("flash_expand", adt)
    _check_cuda("flash_expand", nodes.device, nodes=nodes, adjacency=adjacency, mirror=mirror, adt=adt)
    _check_table_size("flash_expand", m, k)
    rows = torch.empty((q, w, r), dtype=torch.int32, device=nodes.device)
    sums = torch.empty((q, w, r), dtype=adt.dtype, device=nodes.device)
    if q == 0 or w == 0 or r == 0:
        return rows, sums
    layout = mirror_layout(mirror)
    err = build.kernel("flash_expand")(
        nodes.data_ptr(), adjacency.data_ptr(), mirror.data_ptr(), adt.data_ptr(),
        rows.data_ptr(), sums.data_ptr(), q, w, r, mp, m, k, MIRROR_LAYOUTS[layout], is_float,
        _stream(nodes),
    )
    _raise_on("flash_expand", err)
    count_launch("flash_expand", f"mirror_{layout}")
    return rows, sums


def _beam_smem_bytes(ef: int, w: int, r: int, m: int, k: int) -> int:
    """flash_beam's dynamic shared memory per block, the layout
    ``csrc/flash_beam.cu`` carves (passed to its entry point): table, 2
    control words, two beam buffers of (d, id), the W·R slot ids and new and
    kept distances, W nodes, two flag buffers."""
    return 4 * (m * k + 2 + 4 * ef + 3 * w * r + w) + 2 * ef


def flash_beam(
    adt: torch.Tensor,
    adjacency: torch.Tensor,
    mirror: torch.Tensor,
    beam_d: torch.Tensor,
    beam_ids: torch.Tensor,
    beam_exp: torch.Tensor,
    entry_ids: torch.Tensor,
    *,
    width: int,
    max_iters: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole base-layer beam search of Q queries: adt (Q, M, K) int32,
    adjacency (n, R) int32, mirror (n, R, ⌈M/2⌉) uint8 or (n, R, M) int32,
    the sorted initial beam (Q, ef) float32 d / int32 ids / bool expanded,
    entry_ids (Q, E) int32 -> (beam_d (Q, ef), beam_ids (Q, ef), n_dists
    (Q,) int64, n_hops (Q,) int64), the counts of the loop alone.

    Entry and beam ids lie in [−1, n), as for the step loop: ``beam_search``
    scores the entries by indexing the codes with them before this call."""
    if adjacency.device.type == "cpu":
        return ref.flash_beam(adt, adjacency, mirror, beam_d, beam_ids, beam_exp, entry_ids,
                              width=width, max_iters=max_iters)
    q, m, k = adt.shape
    n, r = adjacency.shape
    ef = beam_d.shape[1]
    e = entry_ids.shape[1]
    packed = mirror.dtype == torch.uint8
    mp = mirror.shape[-1]
    expect = (m + 1) // 2 if packed else m
    if (mirror.shape[:2] != (n, r) or mp != expect or beam_d.shape != (q, ef)
            or beam_ids.shape != (q, ef) or beam_exp.shape != (q, ef) or entry_ids.shape[0] != q):
        raise ValueError(
            f"flash_beam: adt {tuple(adt.shape)}, adjacency {tuple(adjacency.shape)}, mirror "
            f"{tuple(mirror.shape)} {mirror.dtype}, beam {tuple(beam_d.shape)}/{tuple(beam_ids.shape)}/"
            f"{tuple(beam_exp.shape)}, entries {tuple(entry_ids.shape)} do not fit "
            f"(expected mirror last dim {expect})"
        )
    if adt.dtype != torch.int32:
        raise TypeError(f"flash_beam: the kernel takes int32 level tables, got {adt.dtype}")
    if (adjacency.dtype, beam_ids.dtype, entry_ids.dtype) != (torch.int32,) * 3:
        raise TypeError("flash_beam: adjacency, beam ids and entries must be int32")
    if beam_d.dtype != torch.float32 or beam_exp.dtype != torch.bool:
        raise TypeError("flash_beam: the beam's d must be float32 and its flags bool")
    if not packed and mirror.dtype != torch.int32:
        raise TypeError(f"flash_beam: mirror must be uint8 or int32, got {mirror.dtype}")
    if not 1 <= width * r <= 1024:
        raise ValueError(f"flash_beam: W·R = {width}·{r} must lie in [1, 1024] (one thread per slot)")
    if not 1 <= width <= ef:
        raise ValueError(f"flash_beam: width {width} must lie in [1, ef={ef}]")
    smem = _beam_smem_bytes(ef, width, r, m, k)
    if smem > _MAX_BLOCK_SMEM:
        raise ValueError(
            f"flash_beam: ef={ef}, W={width}, R={r}, (M, K)=({m}, {k}) need {smem} B of shared "
            f"memory per block, above the {_MAX_BLOCK_SMEM} B a block may have"
        )
    _check_cuda("flash_beam", adjacency.device, adt=adt, adjacency=adjacency, mirror=mirror,
                beam_d=beam_d, beam_ids=beam_ids, beam_exp=beam_exp, entry_ids=entry_ids)
    dev = adjacency.device
    out_d = torch.empty((q, ef), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, ef), dtype=torch.int32, device=dev)
    nd = torch.zeros(q, dtype=torch.int64, device=dev)
    nh = torch.zeros(q, dtype=torch.int64, device=dev)
    if q == 0:
        return out_d, out_i, nd, nh
    visited = torch.empty((q, (n + 31) // 32), dtype=torch.int32, device=dev)
    layout = mirror_layout(mirror)
    err = build.kernel("flash_beam")(
        adt.data_ptr(), adjacency.data_ptr(), mirror.data_ptr(), beam_d.data_ptr(),
        beam_ids.data_ptr(), beam_exp.data_ptr(), entry_ids.data_ptr(), visited.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), nd.data_ptr(), nh.data_ptr(),
        q, n, r, mp, m, k, e, ef, width, max_iters, smem, MIRROR_LAYOUTS[layout], _stream(adjacency),
    )
    _raise_on("flash_beam", err)
    count_launch("flash_beam", f"mirror_{layout}")
    return out_d, out_i, nd, nh


def flash_scan_blocked(blocks: torch.Tensor, adt: torch.Tensor) -> torch.Tensor:
    """Blocked-layout ADT scan: blocks (G, M, B) with adt (M, K) -> (G, B),
    or batched blocks (Q, G, M, B) with adt (Q, M, K) -> (Q, G, B)."""
    out, launched = _flash_scan_blocked(blocks, adt)
    if launched:
        count_launch("flash_scan_blocked")
    return out


def _flash_scan_blocked(blocks: torch.Tensor, adt: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """``flash_scan_blocked``'s work: (result, whether the kernel launched)."""
    if blocks.device.type == "cpu":
        return ref.flash_scan_blocked(blocks, adt), False
    if blocks.dim() == 3 and adt.dim() == 2:
        out, launched = _flash_scan_blocked(blocks[None], adt[None])
        return out[0], launched
    if blocks.dim() != 4 or adt.dim() != 3:
        raise ValueError(
            f"flash_scan_blocked: blocks {tuple(blocks.shape)} / adt {tuple(adt.shape)} "
            "must be (G, M, B) / (M, K) or (Q, G, M, B) / (Q, M, K)"
        )
    q, g, m, b = blocks.shape
    q2, m2, k = adt.shape
    if (q, m) != (q2, m2):
        raise ValueError(f"flash_scan_blocked: blocks (Q={q}, M={m}) != adt (Q={q2}, M={m2})")
    if blocks.dtype != torch.int32:
        raise TypeError(f"flash_scan_blocked: blocks must be int32, got {blocks.dtype}")
    is_float = _table_kind("flash_scan_blocked", adt)
    _check_cuda("flash_scan_blocked", blocks.device, blocks=blocks, adt=adt)
    _check_table_size("flash_scan_blocked", m, k)
    out = torch.empty((q, g, b), dtype=adt.dtype, device=blocks.device)
    if q == 0 or g == 0 or b == 0:
        return out, False
    err = build.kernel("flash_scan_blocked")(
        blocks.data_ptr(), adt.data_ptr(), out.data_ptr(), q, g, m, b, k,
        is_float, _stream(blocks),
    )
    _raise_on("flash_scan_blocked", err)
    return out, True


def flash_scan_batch(rows: torch.Tensor, adt: torch.Tensor) -> torch.Tensor:
    """Neighbor-row batch scan: rows (Q, W, R, M) int32, adt (Q, M, K)
    -> (Q, W, R). The transpose to (Q, W, M, R) groups each block's codes
    by subspace (the reference's ``ops.flash_scan_batch``), then one
    ``flash_scan_blocked`` launch scores all Q·W rows."""
    if rows.shape[-1] != adt.shape[-2]:
        raise ValueError(f"rows M={rows.shape[-1]} != adt M={adt.shape[-2]}")
    blocks = rows.transpose(-1, -2).contiguous()
    out, launched = _flash_scan_blocked(blocks, adt)
    if launched:
        count_launch("flash_scan_blocked", "flash_scan_batch")
    return out


#: l2_batch's tiles (csrc/l2_batch.cu): x rows per tile, D columns per
#: slice, y rows per tile in the wide and the narrow (y resident) shape
_L2_BM, _L2_BK, _L2_BN_WIDE, _L2_BN_NARROW = 128, 32, 128, 64
#: ring stages l2_batch takes at most
_L2_MAX_STAGES = 8


class L2Plan(NamedTuple):
    """How ``l2_batch`` launches its kernel for one call."""

    narrow: bool  # y resident per block (BN = 64), else BN = 128
    bn: int  # y rows per output tile
    d_pad: int  # the row length the kernel reads: ⌈D/4⌉·4
    pad_x: bool  # copy x into a zero-padded (N, d_pad) tensor first
    pad_y: bool  # the same for y
    stages: int  # the TMA ring's depth
    tiles: int  # output tiles
    grid: int  # persistent blocks: min(tiles, SMs)


def _l2_smem(bn: int, resident: bool, nk: int, stages: int) -> int:
    """csrc/l2_batch.cu::smem_bytes: 1 KB of alignment slack, the ring of
    copied slices (x, and y unless resident), the split y slices (hi and lo:
    two buffers, or all nk when resident), the output tile, y's norms and the
    barriers."""
    x_tile = _L2_BM * _L2_BK * 4
    y_tile = bn * _L2_BK * 4
    return (1024 + stages * (x_tile + (0 if resident else y_tile))
            + (nk if resident else 2) * 2 * y_tile + _L2_BM * bn * 4 + 4 * bn + 8 * (2 * stages + 1))


@functools.lru_cache(maxsize=None)
def _l2_stages(bn: int, resident: bool, nk: int) -> int:
    """The deepest ring (≤ 8 stages) that fits a block's shared memory; 0 if
    not even 2 do."""
    fits = [s for s in range(2, _L2_MAX_STAGES + 1) if _l2_smem(bn, resident, nk, s) <= _MAX_BLOCK_SMEM]
    return fits[-1] if fits else 0


def _l2_plan(n: int, c: int, d: int, x_ptr: int, y_ptr: int, sms: int = 132) -> L2Plan:
    """The host side of one ``l2_batch`` launch on ``sms`` SMs for x (n, d) at
    address ``x_ptr`` and y (c, d) at ``y_ptr``, both row-major. TMA reads rows
    whose stride is a multiple of 16 bytes from a 16-byte aligned base, so an
    operand is copied into a zero-padded (·, ⌈d/4⌉·4) tensor where D % 4 ≠ 0
    or its base is misaligned (zeros change neither products nor norms). C ≤ 64
    takes the narrow shape (y split once per block and kept resident) when y's
    slices fit beside a ring of at least 2 stages; everything else the wide one."""
    d_pad = -(-d // 4) * 4
    pad_x = d % 4 != 0 or x_ptr % 16 != 0
    pad_y = d % 4 != 0 or y_ptr % 16 != 0
    nk = -(-d_pad // _L2_BK)
    m_tiles = -(-n // _L2_BM)
    narrow_stages = _l2_stages(_L2_BN_NARROW, True, nk)
    if c <= _L2_BN_NARROW and narrow_stages:
        bn, stages, tiles = _L2_BN_NARROW, narrow_stages, m_tiles
    else:
        bn, stages = _L2_BN_WIDE, _l2_stages(_L2_BN_WIDE, False, nk)
        tiles = m_tiles * -(-c // bn)
    return L2Plan(bn == _L2_BN_NARROW, bn, d_pad, pad_x, pad_y, stages, tiles, min(tiles, sms))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _pad_cols(t: torch.Tensor, d_pad: int) -> torch.Tensor:
    """t (rows, D) copied into a fresh zero-padded (rows, d_pad) tensor."""
    out = torch.zeros((t.shape[0], d_pad), dtype=t.dtype, device=t.device)
    out[:, : t.shape[1]] = t
    count_launch("l2_batch_pad")
    return out


def l2_batch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2: x (N, D), y (C, D) float32 -> (N, C) float32,
    ``max(‖x‖² + ‖y‖² − 2·x·yᵀ, 0)``."""
    if x.device.type == "cpu":
        return ref.l2_batch(x, y)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"l2_batch: x {tuple(x.shape)} and y {tuple(y.shape)} must be (N, D) and (C, D)")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"l2_batch: x and y must be float32, got {x.dtype} and {y.dtype}")
    _check_cuda("l2_batch", x.device, x=x, y=y)
    n, d = x.shape
    c = y.shape[0]
    if n >= 2 ** 31 or c >= 2 ** 31:
        raise ValueError(f"l2_batch: (N={n}, C={c}) exceeds the kernel's 32-bit row coordinates")
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if n == 0 or c == 0:
        return out
    if d == 0:
        return out.zero_()
    plan = _l2_plan(n, c, d, x.data_ptr(), y.data_ptr(), _sm_count(x.device))
    if plan.pad_x:
        x = _pad_cols(x, plan.d_pad)
    if plan.pad_y:
        y = _pad_cols(y, plan.d_pad)
    err = build.kernel("l2_batch")(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), n, c, plan.d_pad, int(plan.narrow),
        plan.stages, plan.grid, _stream(x),
    )
    _raise_on("l2_batch", err)
    count_launch("l2_batch")
    return out


def nearest_centroid(
    x: torch.Tensor, centroids: torch.Tensor, *, banned: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid routing: x (N, D), centroids (S, D) -> (route (N,)
    int32, d2 (N,) float32). The distance matrix is one ``l2_batch``; the
    optional (S,) bool ``banned`` mask (quarantined segments) sets its
    columns to +inf, and the argmin takes the FIRST minimum (``jnp.argmin``'s
    rule), as the reference does outside its Pallas kernel."""
    d2 = l2_batch(x, centroids)
    if banned is not None:
        d2 = torch.where(banned.to(d2.device)[None, :], float("inf"), d2)
    route = first_argmin(d2, 1)
    return route.to(torch.int32), d2.gather(1, route[:, None])[:, 0]


def sq_l2(q: torch.Tensor, db: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """SQ quantized-domain distance: q (D,) int32 codes, db (N, D) int32
    codes, s2 (D,) float32 -> (N,) float32, Σ_d s2_d (db[n, d] − q_d)²."""
    if db.device.type == "cpu":
        return ref.sq_l2(q, db, s2)
    if db.dim() != 2 or q.shape != (db.shape[1],) or s2.shape != (db.shape[1],):
        raise ValueError(
            f"sq_l2: q {tuple(q.shape)}, db {tuple(db.shape)}, s2 {tuple(s2.shape)} "
            "must be (D,), (N, D), (D,)"
        )
    if q.dtype != torch.int32 or db.dtype != torch.int32 or s2.dtype != torch.float32:
        raise TypeError(
            f"sq_l2: q and db must be int32 and s2 float32, got {q.dtype}, {db.dtype}, {s2.dtype}"
        )
    n, d = db.shape
    if d > _MAX_SQ_DIM:
        raise ValueError(f"sq_l2: D={d} exceeds the {_MAX_SQ_DIM} dimensions the kernel stages")
    _check_cuda("sq_l2", db.device, q=q, db=db, s2=s2)
    out = torch.empty(n, dtype=torch.float32, device=db.device)
    if n == 0 or d == 0:
        return out.zero_()
    vec4 = int(d % 4 == 0 and db.data_ptr() % 16 == 0)
    err = build.kernel("sq_l2")(
        q.data_ptr(), db.data_ptr(), s2.data_ptr(), out.data_ptr(), n, d, vec4, _stream(db),
    )
    _raise_on("sq_l2", err)
    count_launch("sq_l2")
    return out
