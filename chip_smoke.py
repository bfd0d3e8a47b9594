#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py              # the full run: 500k x 128 vectors, 64 segments
    python3 chip_smoke.py --n 100000   # quick

Phases, each printing one JSON line (any failure raises, so the exit is
non-zero and no result line is printed):

1. device   the card's name and power limit; nvcc builds the seven kernels
            from ``src/repro_torch/kernels/csrc`` in parallel (seconds).
2. kernels  each kernel on the card at the paths' shapes, held against its
            plain PyTorch version (int32 tables bit-equal, float32 tables
            and ``l2_batch``/``sq_l2`` allclose, routes equal), timed
            beside its bound, the plain version and (``l2_batch``)
            ``torch.cdist``; ``flash_beam`` (1,000 queries over the
            phase's n-vertex graph, ef ∈ {64, 256}, W ∈ {1, 4}, and the
            build's 32-query insert batch) is also held bit-equal to, and
            timed beside, the loop of ``flash_expand`` launches it
            replaces; ``l2_batch`` is timed with L2 cold over a rotation of
            chunks (and warm), against its 3xTF32 and float32-FMA bounds,
            and held at the card tests' odd shapes too. ``torch.profiler``
            gives the device time of ``flash_expand``,
            ``flash_scan_blocked``, ``flash_beam`` and ``l2_batch`` beside
            the events'. Packed mirrors of M ∈ {5, 6, 7, 8, 12, 24} (rows
            that are not whole 8-byte words; an odd M's padding nibble set)
            take the byte-wise layout, bit-equal to the plain versions; M = 8
            is timed beside the M = 16 word row, and so is the M = 16 mirror
            read byte-wise (a copy off an 8-byte boundary). The shapes that
            raised before the limits were repaired: an (M, K) = (64, 256)
            int32 table (64 KiB) through ``flash_round``, ``flash_scan``,
            ``flash_scan_blocked`` and ``flash_expand``, and ``flash_beam``
            at W = 16, R = 96 (1,536 slots on 1,024 threads), ef ∈ {64,
            256}, against its plain version and the ``flash_expand`` loop:
            bit-equal. The flat graphs' shapes (``generality``): bulk
            rounds' (B, C) ∈ {16,384, 848} × {32, 48, 112} through
            ``flash_round``, ``flash_beam`` at W = 4, R = 24 with a quarter
            of the slots empty (ef 128, Q 1,000; ef 64, Q 32): bit-equal.
3. build    ``AnnIndex.build(algo="hnsw", backend="flash_blocked",
            strategy="bulk")`` over the ``--n`` base rows of one
            ``vector_dataset(seed=0, n=--n + 1,000, d=128, n_clusters=64)``
            draw (SIFT1M's shape): seconds and n_dists per phase.
4. search   1,000 held-out queries, k = 10, exact rerank, ef ∈ {64, 256},
            width ∈ {1, 4}: QPS, recall@10 and ``flash_beam`` launches
            against the port's ``exact_knn`` (kernel ``l2_batch``), itself
            cross-checked on all 1,000 queries against a plain loop (ids
            may differ only at near ties; they are counted), and its time
            split into ``l2_batch`` device time and the rest; the unfused
            step loop must return the fused beam's ids; a profiler window
            over one search (ef = 64, W = 1) each way gives the device busy
            share and the top five kernels by device time.
5. check    on small inputs the card's path equals the plain CPU path: beam
            search on the built index with the same query tables, a whole
            20k-vector build from the same coder, and an 8k-row
            ``SegmentedAnnIndex`` (4 segments) built on the card, restored
            on the CPU, then grown, pruned, compacted and searched on both;
            and HNSW, Vamana and NSG, bulk and incremental, over fp32 and
            hand-made PQ (integer codebooks), SQ (s2 = 1) and PCA (zero
            mean, identity columns) backends on 2,000 integer rows in
            [−8, 8] at D = 32 (every distance an exact float32 integer):
            graphs, distances, entries and n_dists equal on card and CPU;
            and flat Vamana and NSG over ``flash_blocked`` at r_base 24,
            W 4 (bulk over 20,000 rows, incremental over 4,000, the NSG
            from one k-NN graph) from one coder fitted on the card: graphs,
            n_dists and a search at ef 128 equal where the query tables
            agree.
6. incremental  the paper's build, ``AnnIndex.build(strategy="incremental")``
            with ``BuildParams()`` and the main path's coder over the first
            ``--n-inc`` rows of the same draw: seconds (bootstrap, insert
            batches), n_dists by phase (bootstrap, beam_upper and beam_base
            must be non-zero), insert batches and ``flash_beam`` launches
            (one per batch), recall@10 at ef ∈ {64, 256}, W ∈ {1, 4}
            against ``exact_knn`` over those rows, a profiler window over 5
            insert batches (busy share, top five kernels, host and card ms
            per batch); beside it the bulk build of the same rows (counted
            apart, as ``incremental_bulk``); and a
            4,000-row incremental build with an M = 8 coder (the byte-wise
            mirror layout) on the card and on the CPU from one coder's
            state, bit-equal where the query tables agree.
7. snapshot the main index saved with ``serve.snapshot.save_index`` and
            loaded back on the card (save and load seconds, bytes): the
            1,000 queries at ef = 64, W = 1 must return the live ids and
            distances. Then ``ShardedBuilder(workers=2, snapshot_path=…,
            attach=True)`` over the first 32,768 rows in 8 segments (a spawn
            pool sharing the card) must attach segments bit-equal to the
            inline build of the same plan; both walls and
            ``model_parallel_wall`` of the inline walls.
7d. serving  the serving runtime (``repro_torch.serve``) over the main
            path's live index, k = 10, ef = 64, W = 1, exact rerank:
            ``SearchEngine`` (buckets 1/8/32) serves the 1,000 queries in
            blocks cycling through 1, 3, 8, 17, 32, 45 (45 chunked): no
            cold key after ``warmup``, ids equal ``index.search``'s,
            distances within rtol 1e-5, one ``flash_beam`` launch per
            padded dispatch; QPS and p50/p99 per block size, the device
            busy share of 100 one-query dispatches. ``Runtime`` (8
            closed-loop client threads, deadline 50 ms, max_wait 2 ms,
            max_queue 256), three waves of single-query requests: 1,000
            with no mutation; as many as arrive while ``add`` of 256 new
            rows of the main draw's distribution then ``delete`` of 10,000
            ids run, and 1,000 more (no request submitted after the delete
            resolved returns a deleted id, 0 cold dispatches); 1,000 after
            both (ids equal a direct search of the
            current generation); QPS, p50/p99, mean packed batch,
            admission counts and each flip's clone/apply/warm seconds.
            Durability: ``init_durable`` → ``attach`` → a Runtime adds
            256 rows and deletes 5,000 → ``recover`` on the card:
            graph, levels, entry, tombstones bit-equal, same ids; WAL
            bytes, fsyncs, replay seconds, ``verify_root``. The snapshot
            phase's 8-segment pool manifest adopted by
            ``init_from_manifest``, one WAL ``add`` of 256 rows replayed
            by ``recover`` (routed by ``l2_batch``): equal to a live
            ``add``. A future that raises (other than the admission
            policy's shed or reject, which are counted) or a supervisor
            restart fails the run.
7b. baselines  the paper's build-speed comparison: bulk HNSW with
            ``BuildParams()`` over the first ``--n-base`` (50,000) rows of the main
            draw for fp32, pq (m = 16, l_pq = 8, 10 k-means iterations), sq
            (8 bits), pca (α = 0.9) and ``flash_blocked`` (the main path's
            coder) (``benchmarks/bench_indexing.py:212-215``): coder fit and
            build seconds by phase, n_dists, index bytes, recall@10 and QPS
            at ef ∈ {64, 256}, W = 1, exact rerank (and reconstruct rerank
            at ef = 256 for the coded backends), each build's seconds over
            fp32's. The four baseline builds launch no Flash kernel. Each
            coded backend's recall at ef = 256 must reach half that of a
            scan of all its codes keeping 256.
7c. generality  Vamana and NSG (knn_k = 24), bulk, over fp32 and
            ``flash_blocked`` on the same rows with
            ``benchmarks/bench_generality.py:24-26``'s parameters (r_upper
            8, r_base 24, ef 64, batch 32, W 4, α 1.2): build seconds,
            n_dists, recall@10 and QPS at ef = 128 (Flash: at least half
            that of a scan of its codes keeping 128); every
            ``flash_blocked`` build launches ``flash_round`` and
            ``flash_beam``, every search ``flash_beam``.
8. sharded  the scale-out path: ``ShardedBuilder`` streams the first
            ``--n`` − 2,000 rows into 64 balanced segments (inline,
            each a bulk Flash-HNSW build): assignment
            seconds (bootstrap, streaming pass), segment sizes, the sum and
            the largest of the per-segment build seconds, n_dists; the
            rows whose segment differs when the same capacity-capped
            routing runs on the plain version's distances (on the card,
            and on the CPU against the card), counted.
9. segmented_search  the held-out queries, k = 10, exact rerank, ef ∈ {64,
            256}, W = 4, the default fan-out (one card: the loop over
            segments): QPS, recall@10 against phase 4's ground truth,
            n_scan, n_rerank, ``flash_beam`` launches (one per segment
            and search); the fan-out threads must return the same ids.
10. maintenance  ``add`` the last 2,000 rows (routed by ``nearest_centroid``),
            search, ``delete`` 10,000 ids, search (ef = 256, W = 4): no
            deleted id may come back; recall
            against an exact k-NN of the live rows.
10b. serving_router  ``SegmentRouter`` over phase 10's collection, 256
            queries, k = 10, ef = 64, W = 4: at n_probe = 64 the ids equal
            ``SegmentedAnnIndex.search``'s, the fan-out threads equal the
            loop; QPS and recall@10 (against the live rows' exact k-NN) at
            n_probe ∈ {1, 4, 64}.
11. retrieval  BERT4Rec next-item retrieval at the model's full config
            (1,048,575 items, D = 64, 2 blocks, 2 heads, S = 200): rows
            [0, n) of the item table hold a normalized
            ``vector_dataset(0, d=64, n_clusters=256)``; 64 sessions (and
            one) go through ``serve``; a Flash coder (d_f = 48, M = 16) codes
            the table; ``score_dense``, ``score_flash`` (k = 10, rerank 8;
            k = 100, rerank 4) are timed at B = 64 and B = 1, with recall@10
            against dense for the encoder queries and 64 near-item queries.
            Then ``retrieval_graph``: an ``AnnIndex`` over the whole table
            on the scan's coder and codes, ``search_index`` at ef = 96
            and 512 (build seconds, QPS, recall@10; on the near-item
            queries at ef = 512 it must reach ½ of ``score_flash``'s).
            ``flash_scan`` must equal its plain version
            over the catalog, and the card's ``score_flash`` ids the CPU
            path's on 8 queries whose query tables agree.

Launch counts are zeroed just before each path (the main path: phases 3–4;
the incremental path and the bulk build beside it: phase 6, each counted
apart, the profiler window in neither; the snapshot path: phase 7; the
serving path: phases 7d and 10b, each counted, then summed; the
baselines and generality paths: phases 7b and 7c; the scale-out path:
phases 8–10; the retrieval path: phase 11) and read just after it;
the script fails if a kernel of a path never launched there. The main
path's M = 16 coder must read its mirror as 8-byte words on every launch
(``launches["mirror_*"]``). ``sq_l2`` and ``flash_expand`` are on no path:
phase 2 alone runs them (and ``flash_expand`` the loop that ``flash_beam``
is held against). Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

QUERIES = 1000  # held-out search queries, the search batch
SEGMENTS = 64  # the scale-out path's segments (benchmarks/bench_scalability.py:60-61)
ADD_ROWS = 2000  # rows the scale-out path adds through routed growth
REQUESTS = 64  # the retrieval path's request batch (examples/retrieval_serving.py:49)
GRAPH_EF = (96, 512)  # the example's ef_search (examples/retrieval_serving.py:72), and a wider beam
DELETE_ROWS = 10000  # ids the scale-out path deletes
N_INC = 10000  # rows of the incremental build (phase 6; PERF.md §4 gives the cut)
N_BASE = 50_000  # rows of the baselines and generality phases (7b, 7c; PERF.md §4 gives the cut)
POOL_ROWS = 32768  # rows of the snapshot phase's pool and inline builds (PERF.md §4 gives the cut)
PROFILED_BATCHES = 5  # insert batches of the incremental path's profiler window (PERF.md §4)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
CUDA_CORE_OPS_PER_S = 67e12  # float32 outside the tensor cores; int32 adds counted at it
TF32_TENSOR_OPS_PER_S = 495e12  # dense TF32 on the tensor cores, NVIDIA data sheet
L2_COLD_BYTES = 64 << 20  # operands rotated per l2_batch timing: above the 50 MB L2

REPLACES = {
    "flash_round": "src/repro/kernels/flash_round.py:49",
    "flash_expand": "src/repro/kernels/flash_expand.py:81",
    "flash_beam": "src/repro/kernels/flash_expand.py:81",
    "flash_scan_blocked": "src/repro/kernels/flash_scan.py:94",
    "l2_batch": "src/repro/kernels/l2_batch.py:43",
    "flash_scan": "src/repro/kernels/flash_scan.py:50",
    "sq_l2": "src/repro/kernels/sq_l2.py:34",
}
SOURCES = {
    "flash_round": "src/repro_torch/kernels/csrc/flash_round.cu",
    "flash_expand": "src/repro_torch/kernels/csrc/flash_expand.cu",
    "flash_beam": "src/repro_torch/kernels/csrc/flash_beam.cu",
    "flash_scan_blocked": "src/repro_torch/kernels/csrc/flash_scan_blocked.cu",
    "l2_batch": "src/repro_torch/kernels/csrc/l2_batch.cu",
    "flash_scan": "src/repro_torch/kernels/csrc/flash_scan.cu",
    "sq_l2": "src/repro_torch/kernels/csrc/sq_l2.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, *, reps: int = 5, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    from CUDA events (one warm-up call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def device_events(prof) -> list:
    """The kernel events (device time) of a ``torch.profiler`` run."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA]


def profiled(fn, reps: int = 1, cpu: bool = True):
    """Run ``fn`` ``reps`` times under ``torch.profiler`` (CUDA activity, and
    CPU activity unless ``cpu`` is False) between two synchronizations:
    (profile, host ms of the window), or (None, the error) where the profiler
    cannot start here. An error raised by ``fn`` itself propagates."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with contextlib.ExitStack() as stack:
        try:  # the profiler is an observation, not the path
            prof = stack.enter_context(profile(activities=activities))
        except Exception as exc:
            return None, repr(exc)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return prof, wall


def profiler_kernel_ms(fn, kernel: str, reps: int = 5):
    """Device ms per call of ``fn`` spent in kernels whose name holds
    ``kernel``, from ``torch.profiler``; a string where it records none."""
    prof, wall = profiled(fn, reps)
    if prof is None:
        return f"profiler failed: {wall}"
    us = sum(e.time_range.elapsed_us() for e in device_events(prof) if kernel in e.name)
    return us / reps / 1e3 if us > 0 else "no device time recorded"


def device_window(fn, cpu: bool = True) -> dict:
    """One call of ``fn`` under the profiler: the window's host ms, the
    device busy share (kernel time over the window) and the top five
    kernels by device time. ``cpu=False`` records the CUDA activity alone
    (a window of ~10⁵ launches takes minutes to parse with the CPU ops)."""
    prof, wall = profiled(fn, cpu=cpu)
    if prof is None:
        return {"error": wall}
    by_name: dict = {}
    for e in device_events(prof):
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"window_ms": wall, "device_ms": busy, "busy_share": busy / wall if wall else None,
            "device_ops": sum(c for _, c in by_name.values()),
            "top5": [{"name": k[:120], "ms": ms, "count": c} for k, (ms, c) in top]}


def bound_ms(nbytes: float, ops: float, ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def embedding_bag_ms(idx, table, want) -> dict:
    """The one PyTorch call that computes a table kernel's function:
    ``F.embedding_bag(idx, table.view(-1, 1), mode="sum")`` over a float32
    copy of the tables, with ``idx`` the codes offset by m·K (and by the
    row's table). Exact while every sum stays below 2²⁴ (M·255 here): held
    equal to the kernel's int32 result ``want``, then timed alone (the
    offset indices and the float32 copy are made outside the timed call)."""
    import torch
    import torch.nn.functional as F

    t32 = table.reshape(-1, 1).to(torch.float32)
    got = F.embedding_bag(idx, t32, mode="sum")[:, 0]
    if not torch.equal(got, want.reshape(-1).to(torch.float32)):
        raise AssertionError("embedding_bag disagrees with the kernel it stands beside")
    return {"library_ms": time_ms(lambda: F.embedding_bag(idx, t32, mode="sum")),
            "library_call": "F.embedding_bag(codes + m*K, table.view(-1, 1), mode='sum')"}


def check_kernels(dev, n: int) -> dict:
    """Phase 2: every kernel vs its plain version at the main path's shapes."""
    import torch

    from repro_torch.core import flash as fl
    from repro_torch.graph import engine
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    m, k, r = 16, 16, 32
    out = {}
    layouts0 = {key: ops.launches[f"mirror_{key}"] for key in ops.MIRROR_LAYOUTS}

    def ints(shape, hi, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=g, device=dev, dtype=dtype)

    def compare(name, got, want, table):
        err = float((got.to(torch.float64) - want.to(torch.float64)).abs().max())
        if table.dtype == torch.int32:
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: int32 table result differs from the plain version")
        else:
            atol = 1e-5 * m * float(table.abs().max())
            if not torch.allclose(got, want, rtol=1e-5, atol=atol):
                raise AssertionError(f"{name}: float32 result off by {err} (atol {atol})")
        return err

    # flash_round: one round_dists launch of the bulk build
    b, c = min(engine._BULK_CHUNK, n), 64 + 8 * 8
    codes = ints((b, c, m), k)
    errs = {}
    for dt in (torch.int32, torch.float32):
        adts = ints((b, m, k), 256) if dt == torch.int32 else torch.randn((b, m, k), generator=g, device=dev) * 50
        errs[dt] = compare("flash_round", ops.flash_round(codes, adts), ref.flash_round(codes, adts), adts)
    adts = ints((b, m, k), 256)
    nbytes = codes.numel() * 4 + adts.numel() * 4 + b * c * 4
    bnd, by = bound_ms(nbytes, b * c * m)
    mk = torch.arange(m, device=dev) * k
    idx = (codes.long() + mk + (torch.arange(b, device=dev) * m * k)[:, None, None]).reshape(b * c, m)
    out["flash_round"] = dict(
        shape=[b, c, m], max_abs_err=errs[torch.int32], max_abs_err_f32=errs[torch.float32],
        ms=time_ms(lambda: ops.flash_round(codes, adts)),
        device_ms=profiler_kernel_ms(lambda: ops.flash_round(codes, adts), "flash_round_kernel"),
        plain_ms=time_ms(lambda: ref.flash_round(codes, adts), reps=3, inner=2),
        bound_ms=bnd, bound_by=by, **embedding_bag_ms(idx, adts, ops.flash_round(codes, adts)),
    )
    del idx

    # flash_expand / flash_scan_blocked: one base-layer beam step of a
    # 1000-query search on an n-vertex graph
    q = QUERIES
    adjacency = ints((n, r), n)
    mirror = ints((n, r, m // 2), 256, torch.uint8)
    mirror_i32 = fl.unpack_codes(mirror, m).contiguous()
    for w in (1, 4):
        nodes = ints((q, w), n)
        if w > 1:
            nodes[:, 0] = -1  # an inactive slot, as a beam step has
        errs = {}
        for dt in (torch.int32, torch.float32):
            adt = ints((q, m, k), 256) if dt == torch.int32 else torch.randn((q, m, k), generator=g, device=dev) * 50
            for mir in (mirror, mirror_i32):
                rows, sums = ops.flash_expand(nodes, adjacency, mir, adt)
                rows_p, sums_p = ref.flash_expand(nodes, adjacency, mir, adt)
                if not torch.equal(rows, rows_p):
                    raise AssertionError("flash_expand: gathered rows differ from the plain version")
                errs[dt] = max(errs.get(dt, 0.0), compare("flash_expand", sums, sums_p, adt))
            blocks = fl.unpack_codes(mirror[nodes.clamp_min(0).long()], m).transpose(-1, -2).contiguous()
            got = ops.flash_scan_blocked(blocks, adt)
            errs[("scan", dt)] = compare("flash_scan_blocked", got, ref.flash_scan_blocked(blocks, adt), adt)
            if dt == torch.int32 and not torch.equal(got, sums):
                raise AssertionError("flash_scan_blocked and flash_expand disagree on the same rows")
        adt = ints((q, m, k), 256)
        slots = q * w * r
        nbytes = q * w * 4 + slots * (4 + m // 2) + adt.numel() * 4 + slots * 8
        bnd, by = bound_ms(nbytes, slots * m)
        out[f"flash_expand_w{w}"] = dict(
            shape=[q, w, r, m], n=n, max_abs_err=errs[torch.int32], max_abs_err_f32=errs[torch.float32],
            ms=time_ms(lambda: ops.flash_expand(nodes, adjacency, mirror, adt)),
            device_ms=profiler_kernel_ms(lambda: ops.flash_expand(nodes, adjacency, mirror, adt),
                                         "flash_expand_kernel"),
            plain_ms=time_ms(lambda: ref.flash_expand(nodes, adjacency, mirror, adt), reps=3, inner=2),
            bound_ms=bnd, bound_by=by, library_ms=None,
        )
        blocks = fl.unpack_codes(mirror[nodes.clamp_min(0).long()], m).transpose(-1, -2).contiguous()
        nbytes = blocks.numel() * 4 + adt.numel() * 4 + slots * 4
        bnd, by = bound_ms(nbytes, slots * m)
        mk = (torch.arange(m, device=dev) * k)[None, None, :, None]
        idx = (blocks.long() + mk + (torch.arange(q, device=dev) * m * k)[:, None, None, None])
        idx = idx.transpose(-1, -2).reshape(-1, m).contiguous()
        out[f"flash_scan_blocked_w{w}"] = dict(
            shape=list(blocks.shape), max_abs_err=errs[("scan", torch.int32)],
            max_abs_err_f32=errs[("scan", torch.float32)],
            ms=time_ms(lambda: ops.flash_scan_blocked(blocks, adt)),
            device_ms=profiler_kernel_ms(lambda: ops.flash_scan_blocked(blocks, adt),
                                         "flash_scan_blocked_kernel"),
            plain_ms=time_ms(lambda: ref.flash_scan_blocked(blocks, adt), reps=3, inner=2),
            bound_ms=bnd, bound_by=by,
            **embedding_bag_ms(idx, adt, ops.flash_scan_blocked(blocks, adt)),
        )
        del idx
    del mirror_i32
    out.update(check_flash_beam(ints, adjacency, n, m, k, r))
    out.update(check_any_m(ints, adjacency, n, k, r))
    # the layout each flash_expand / flash_beam launch of this phase read
    out["mirror_layout_launches"] = {key: ops.launches[f"mirror_{key}"] - v for key, v in layouts0.items()}

    out["limits"] = check_repaired_limits(dev, g)
    out["flat_shapes"] = check_flat_shapes(dev, g)
    out.update(check_l2_batch(dev, g, q))
    # nearest_centroid: routed growth's shape, with a banned mask
    x = torch.randn((2000, 128), generator=g, device=dev) * 10
    cents = torch.randn((64, 128), generator=g, device=dev) * 10
    banned = torch.zeros(64, dtype=torch.bool, device=dev)
    banned[[5, 17]] = True
    route, d2 = ops.nearest_centroid(x, cents, banned=banned)
    plain = ref.l2_batch(x, cents).masked_fill(banned[None], float("inf"))
    flips, near = route_flips(route, plain, l2_atol(x, cents))
    if flips > near or bool(banned[route.long()].any()):
        raise AssertionError(f"nearest_centroid: {flips} routes differ, {near} of them at near ties")
    out["nearest_centroid"] = dict(shape=[2000, 64, 128], route_flips=flips, near_tie_flips=near)

    # flash_scan: one query's scan of the BERT4Rec catalog's codes
    from repro_torch.configs.registry import get_arch

    nc = get_arch("bert4rec").make_full().n_items
    codes = ints((nc, m), k)
    errs = {}
    for dt in (torch.int32, torch.float32):
        adt = ints((m, k), 256) if dt == torch.int32 else torch.randn((m, k), generator=g, device=dev) * 50
        errs[dt] = compare("flash_scan", ops.flash_scan(codes, adt), ref.flash_scan(codes, adt), adt)
    adt = ints((m, k), 256)
    bnd, by = bound_ms(codes.numel() * 4 + adt.numel() * 4 + nc * 4, nc * m)
    idx = codes.long() + torch.arange(m, device=dev) * k
    out["flash_scan"] = dict(
        shape=[nc, m, k], max_abs_err=errs[torch.int32], max_abs_err_f32=errs[torch.float32],
        ms=time_ms(lambda: ops.flash_scan(codes, adt)),
        device_ms=profiler_kernel_ms(lambda: ops.flash_scan(codes, adt), "flash_scan_kernel"),
        plain_ms=time_ms(lambda: ref.flash_scan(codes, adt), reps=3, inner=2),
        bound_ms=bnd, bound_by=by, **embedding_bag_ms(idx, adt, ops.flash_scan(codes, adt)),
    )
    del codes, idx

    # sq_l2: a 1M-row scan of 8-bit SQ codes at D = 128, positive scales
    ns, ds = 1 << 20, 128
    qc, db = ints((ds,), 256), ints((ns, ds), 256)
    s2 = torch.rand((ds,), generator=g, device=dev) * 1e-2 + 1e-4
    got, want = ops.sq_l2(qc, db, s2), ref.sq_l2(qc, db, s2)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
        raise AssertionError(f"sq_l2: off by {err} (rtol 1e-5)")
    bnd, by = bound_ms(db.numel() * 4 + 2 * ds * 4 + ns * 4, 3 * ns * ds)
    out["sq_l2"] = dict(
        shape=[ns, ds], max_abs_err=err, rtol=1e-5,
        ms=time_ms(lambda: ops.sq_l2(qc, db, s2)),
        device_ms=profiler_kernel_ms(lambda: ops.sq_l2(qc, db, s2), "sq_l2_kernel"),
        plain_ms=time_ms(lambda: ref.sq_l2(qc, db, s2), reps=3, inner=2),
        bound_ms=bnd, bound_by=by, library_ms=None,
    )
    del db
    torch.cuda.synchronize()
    return out


def check_l2_batch(dev, g, q: int) -> dict:
    """Phase 2's l2_batch rows: a ground-truth tile (exact_knn: the 1,000
    queries x one 8,192-row chunk) and an assignment chunk (65,536 rows x 64
    centroids), each held to its plain version and timed two ways: ``ms``
    as the path sees it, with L2 cold (a rotation of distinct chunks, more
    than 50 MB in all: data chunks for the ground truth, row chunks for the
    assignment), and ``ms_warm`` on the same inputs again (the method of
    the kernel table's earlier rows); ``device_ms`` is the profiler's kernel
    time over the cold rotation. ``bound_ms`` is the 3xTF32 bound (3 ·
    2·N·C·D at TF32's rate), the float32-FMA bound beside it. Then the card
    tests' odd shapes, compared only."""
    import itertools

    import torch

    from repro_torch.kernels import ops, ref

    out = {}
    d = 128
    for key, (nn, cc) in (("l2_batch_gt", (q, 8192)), ("l2_batch_assign", (65536, 64))):
        rotate = "y" if key == "l2_batch_gt" else "x"
        per = 4 * d * (cc if rotate == "y" else nn)
        reps = max(2, -(-L2_COLD_BYTES // per))
        xs = [torch.randn((nn, d), generator=g, device=dev) * 10 for _ in range(1 if rotate == "y" else reps)]
        ys = [torch.randn((cc, d), generator=g, device=dev) * 10 for _ in range(reps if rotate == "y" else 1)]
        pairs = [(xs[i % len(xs)], ys[i % len(ys)]) for i in range(reps)]
        err, atol = 0.0, 0.0
        for x, y in pairs[:2]:
            got, want = ops.l2_batch(x, y), ref.l2_batch(x, y)
            a = l2_atol(x, y)
            e = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=1e-5, atol=a):
                raise AssertionError(f"l2_batch {nn}x{cc}: off by {e} (atol {a})")
            err, atol = max(err, e), max(atol, a)
        del got, want
        cycle = itertools.cycle(pairs)

        def cold(cycle=cycle):
            return ops.l2_batch(*next(cycle))

        x, y = pairs[0]
        nbytes = 4 * (nn * d + cc * d + nn * cc)
        bnd, by = bound_ms(nbytes, 3 * 2 * nn * cc * d, TF32_TENSOR_OPS_PER_S)
        bnd_fma, by_fma = bound_ms(nbytes, 2 * nn * cc * d)
        out[key] = dict(
            shape=[nn, cc, d], max_abs_err=err, atol=atol, cold_rotation=reps,
            ms=time_ms(cold, reps=5, inner=max(10, 2 * reps)),
            ms_warm=time_ms(lambda: ops.l2_batch(x, y)),
            device_ms=profiler_kernel_ms(cold, "l2_batch_kernel", reps=2 * reps),
            plain_ms=time_ms(lambda: ref.l2_batch(x, y)),
            bound_ms=bnd, bound_by=by, bound_fp32_fma_ms=bnd_fma, bound_fp32_fma_by=by_fma,
            library_ms=time_ms(lambda: torch.cdist(x, y, compute_mode="use_mm_for_euclid_dist")),
        )
        del xs, ys, pairs, cycle
    # the card tests' odd shapes (compare only): D % 4 ≠ 0 (a padded copy),
    # ragged C and N, a view off TMA's 16-byte alignment
    odd = []
    for nn, cc, dd, skew in ((1, 8191, 25, 0), (300, 288, 100, 0), (77, 1, 960, 0), (1, 64, 960, 0),
                             (129, 8191, 100, 0), (2000, 64, 25, 0), (5, 1, 3, 0), (300, 70, 3, 1),
                             (300, 70, 128, 1)):
        x = (torch.randn((nn * dd + skew,), generator=g, device=dev) * 3.0)[skew:].view(nn, dd)
        y = torch.randn((cc, dd), generator=g, device=dev) * 3.0
        before = ops.launches["l2_batch_pad"]
        got, want = ops.l2_batch(x, y), ref.l2_batch(x, y)
        a = l2_atol(x, y)
        e = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5, atol=a):
            raise AssertionError(f"l2_batch {nn}x{cc}x{dd} (skew {skew}): off by {e} (atol {a})")
        odd.append({"shape": [nn, cc, dd], "skew_floats": skew, "max_abs_err": e, "atol": a,
                    "pad_copies": ops.launches["l2_batch_pad"] - before})
    out["l2_batch_odd_shapes"] = odd
    return out


def check_flash_beam(ints, adjacency, n: int, m: int, k: int, r: int) -> dict:
    """Phase 2's flash_beam rows: the base-layer search of the 1,000-query
    batch over the phase's random n-vertex graph (a code per vertex, the
    mirror built from them, one random entry per query), at ef ∈ {64, 256}
    and W ∈ {1, 4}. Each launch must equal, bit for bit (ids, dists,
    n_dists, n_hops), both its plain version ``ref.flash_beam`` on the same
    inputs and the loop of ``flash_expand`` launches it replaces, and at
    (64, 4) also with the unpacked mirror; it is timed beside that loop
    (``step_loop_ms``), its plain version on the card and its bound. At
    (64, 1) the first 32 queries, one insert batch of the build
    (``BuildParams``: batch 32, ef 64, W 1), are checked and timed too, and
    so is the same search with the mirror read byte-wise (a copy 4 bytes
    off an 8-byte boundary) beside the word layout.

    The bound counts the bytes the search needs: the tables, n_hops · R
    adjacency entries and packed code rows, the beam in and out, the entries
    and the counts. The visited bitmap the kernel zeroes is its own
    workspace, reported apart as ``workspace_bytes``."""
    import torch

    from repro_torch.core import flash as fl
    from repro_torch.kernels import ops, ref

    q = QUERIES
    codes = ints((n, m), k)
    unpacked = codes[adjacency.long()]  # adjacency has no empty slot here
    packed = fl.pack_codes(unpacked)
    entries = ints((q, 1), n)
    words = -(-n // 32)
    out = {}
    for ef in (64, 256):
        for w in (1, 4):
            adt = ints((q, m, k), 256)
            d_e = fl.adc_lookup(adt, codes[entries.long()]).to(torch.float32)
            args = (adt, *ref.initial_beam(entries, d_e, ef), entries)  # adt, beam (3), entries
            max_iters = -(-(4 * ef + 8) // w)

            def kernel(args=args, mir=packed):
                return ops.flash_beam(args[0], adjacency, mir, *args[1:], width=w, max_iters=max_iters)

            def plain(args=args, mir=packed):
                return ref.flash_beam(args[0], adjacency, mir, *args[1:], width=w, max_iters=max_iters)

            def step_loop(args=args):
                a, bd, bi, be, en = args

                def step(nodes):
                    rows, sums = ops.flash_expand(nodes, adjacency, packed, a)
                    return rows, sums.to(torch.float32)
                return ref.beam_loop(step, bd, bi, be, en, n, width=w, max_iters=max_iters)

            def check(got, args=args, mirrors=(packed,), what=""):
                """Hold ``got`` equal to the step loop and, per mirror, to the
                plain version: the largest |kernel − plain| over finite dists."""
                err = 0.0
                wants = [("the flash_expand step loop", step_loop(args))]
                wants += [(f"its plain version ({mir.dtype} mirror)", plain(args, mir)) for mir in mirrors]
                for against, want in wants:
                    for name, x, y in zip(("dists", "ids", "n_dists", "n_hops"), got, want):
                        if not torch.equal(x, y):
                            raise AssertionError(f"flash_beam ({what}) differs from {against} in {name}")
                    fin = torch.isfinite(got[0]) & torch.isfinite(want[0])
                    if bool(fin.any()):
                        err = max(err, float((got[0][fin] - want[0][fin]).abs().max()))
                return err

            mirrors = (unpacked, packed) if (ef, w) == (64, 4) else (packed,)
            err = 0.0
            for mir in mirrors:
                got = kernel(mir=mir)
                err = max(err, check(got, mirrors=mirrors, what=f"ef={ef}, W={w}, {mir.dtype} mirror"))
            hops = int(got[3].sum())
            nbytes = (adt.numel() * 4 + hops * r * (4 + m // 2)
                      + q * ef * 9 + q * ef * 8 + q * 16 + entries.numel() * 4)
            bnd, by = bound_ms(nbytes, hops * r * m)
            row = out[f"flash_beam_ef{ef}_w{w}"] = dict(
                shape=[q, ef, w, r, m], n=n, layout=ops.mirror_layout(packed), max_abs_err=err, n_hops=hops, n_dists=int(got[2].sum()),
                n_hops_max=int(got[3].max()), workspace_bytes=q * words * 4,
                ms=time_ms(kernel, reps=5, inner=3),
                device_ms=profiler_kernel_ms(kernel, "flash_beam_kernel", reps=3),
                step_loop_ms=path_ms(step_loop, reps=3),
                plain_ms=path_ms(plain, reps=3),
                bound_ms=bnd, bound_by=by, library_ms=None,
            )
            if (ef, w) == (64, 1):
                # the same search with the M = 16 mirror read byte-wise: a copy
                # 4 bytes into its storage (off 8-byte words, on 4-byte ones)
                flat = torch.empty(packed.numel() + 4, dtype=torch.uint8, device=packed.device)
                flat[4:] = packed.reshape(-1)
                skewed = flat[4:].view(packed.shape)
                before = ops.launches["mirror_bytes"]
                got = kernel(mir=skewed)
                if ops.launches["mirror_bytes"] != before + 1:
                    raise AssertionError("flash_beam on a skewed M = 16 mirror did not take the byte-wise layout")
                row["bytes_layout_same_inputs"] = dict(
                    layout=ops.mirror_layout(skewed), max_abs_err=check(got, what="M=16, byte-wise"),
                    ms=time_ms(lambda: kernel(mir=skewed), reps=5, inner=3),
                    device_ms=profiler_kernel_ms(lambda: kernel(mir=skewed), "flash_beam_kernel", reps=3),
                )
                del flat, skewed
                batch = tuple(t[:32].contiguous() for t in args)
                got = kernel(batch)
                row["insert_batch_q32"] = dict(
                    max_abs_err=check(got, batch, what="an insert batch of 32 queries"),
                    n_hops_max=int(got[3].max()), ms=time_ms(lambda: kernel(batch), reps=5, inner=3),
                    device_ms=profiler_kernel_ms(lambda: kernel(batch), "flash_beam_kernel", reps=3),
                    step_loop_ms=path_ms(lambda: step_loop(batch), reps=3),
                )
    return out


def check_any_m(ints, adjacency, n: int, k: int, r: int) -> dict:
    """Phase 2's packed mirrors whose rows are not whole 8-byte words: M ∈
    {5, 6, 7, 8, 12, 24} (⌈M/2⌉ = 3, 3, 4, 4, 6, 12 bytes) over the phase's
    random n-vertex graph, 1,000 queries, ef = 64, W ∈ {1, 4}; an odd M's
    padding nibble is set to 15, which a kernel must never add (M = 5 reads
    bytes, M = 7 4-byte words). Every ``flash_beam``
    launch must take the byte-wise layout and equal its plain version
    ``ref.flash_beam`` bit for bit (ids, dists, n_dists, n_hops), and
    ``flash_expand`` on the first W beam entries ``ref.flash_expand``. The
    M = 8 launch at W = 1 is timed beside phase 2's M = 16 word-layout row
    (``flash_beam_ef64_w1``), with its bound counted the same way."""
    import torch

    from repro_torch.core import flash as fl
    from repro_torch.kernels import ops, ref

    q, ef = QUERIES, 64
    out = {}
    for m in (5, 6, 7, 8, 12, 24):
        codes = ints((n, m), k)
        packed = fl.pack_codes(codes[adjacency.long()])
        if m % 2:
            packed[..., -1] |= 0xF0
        entries = ints((q, 1), n)
        adt = ints((q, m, k), 256)
        d_e = fl.adc_lookup(adt, codes[entries.long()]).to(torch.float32)
        args = (adt, adjacency, packed, *ref.initial_beam(entries, d_e, ef), entries)
        del codes
        rows = {}
        for w in (1, 4):
            max_iters = -(-(4 * ef + 8) // w)
            before = ops.launches["mirror_bytes"]
            got = ops.flash_beam(*args, width=w, max_iters=max_iters)
            if ops.launches["mirror_bytes"] != before + 1:
                raise AssertionError(f"flash_beam at M={m} did not take the byte-wise layout")
            want = ref.flash_beam(*args, width=w, max_iters=max_iters)
            for name, x, y in zip(("dists", "ids", "n_dists", "n_hops"), got, want):
                if not torch.equal(x, y):
                    raise AssertionError(f"flash_beam (M={m}, W={w}, bytes) differs from its plain version in {name}")
            nodes = args[4][:, :w].contiguous()
            e_rows, e_sums = ops.flash_expand(nodes, adjacency, packed, adt)
            p_rows, p_sums = ref.flash_expand(nodes, adjacency, packed, adt)
            if not (torch.equal(e_rows, p_rows) and torch.equal(e_sums, p_sums)):
                raise AssertionError(f"flash_expand (M={m}, W={w}, bytes) differs from its plain version")
            rows[f"w{w}"] = {"n_hops": int(got[3].sum()), "n_dists": int(got[2].sum())}
            if (m, w) == (8, 1):
                hops = int(got[3].sum())
                mp = packed.shape[-1]
                nbytes = (adt.numel() * 4 + hops * r * (4 + mp)
                          + q * ef * 9 + q * ef * 8 + q * 16 + entries.numel() * 4)
                bnd, by = bound_ms(nbytes, hops * r * m)

                def kernel(args=args, max_iters=max_iters):
                    return ops.flash_beam(*args, width=1, max_iters=max_iters)
                out["flash_beam_m8_bytes"] = dict(
                    shape=[q, ef, 1, r, m], n=n, layout=ops.mirror_layout(packed), n_hops=hops,
                    ms=time_ms(kernel, reps=5, inner=3),
                    device_ms=profiler_kernel_ms(kernel, "flash_beam_kernel", reps=3),
                    bound_ms=bnd, bound_by=by,
                )
        out[f"packed_m{m}"] = dict(bytes_per_row=int(packed.shape[-1]), layout=ops.mirror_layout(packed),
                                   bit_equal=True, **rows)
        del packed, args, adt
    return out


def l2_atol(x, y) -> float:
    """The stated l2_batch tolerance: 1e-5 · max(‖x‖² + ‖y‖²)."""
    return 1e-5 * float((x * x).sum(1).max() + (y * y).sum(1).max())


def route_flips(route, plain_d2, atol: float) -> tuple[int, int]:
    """(routes that differ from the plain argmin, how many of those are near
    ties: the route's plain distance within 2·atol of the plain minimum)."""
    from repro_torch.utils import first_argmin

    want = first_argmin(plain_d2, 1)
    diff = route.long() != want
    gap = plain_d2.gather(1, route[:, None].long())[:, 0] - plain_d2.gather(1, want[:, None])[:, 0]
    return int(diff.sum()), int((diff & (gap <= 2 * atol)).sum())


def assignment_cross_check(rows_np, plan, dev) -> dict:
    """The streaming assignment's segments (the kernel's distances, then the
    capacity-capped greedy routing ``graph/sharded._route_balanced``)
    against the same routing, chunk by chunk with the same capacity, on the
    plain version's distances on the card and on the CPU (no kernel runs).
    A full segment keeps the rows closest to it, so a difference in the
    last bits of two rows' distances to it moves a row, and each move
    shifts the capacity left for later rows and chunks: the counts measure
    that sensitivity of the routing. ``near`` counts the moved rows whose
    two segments lie within 2·atol by the plain distances."""
    import torch

    from repro_torch.graph.sharded import _route_balanced
    from repro_torch.kernels import ref

    got = plan.locate()[:, 0]
    cents = torch.from_numpy(plan.centroids)
    cap = -(-plan.n // plan.n_segments)
    routes = {}
    d2_card = []
    for where, c in (("card", cents.to(dev)), ("cpu", cents)):
        remaining = np.full(plan.n_segments, cap, np.int64)
        out = np.empty(plan.n, np.int64)
        for s in range(0, plan.n, plan.chunk_size):
            x = torch.from_numpy(np.ascontiguousarray(rows_np[s:s + plan.chunk_size])).to(c.device)
            d2 = ref.l2_batch(x, c).cpu().numpy()
            out[s:s + x.shape[0]] = _route_balanced(d2, remaining)
            if where == "card":
                d2_card.append((d2, l2_atol(x, c)))
        routes[where] = out
    moved = np.nonzero(got != routes["card"])[0]
    near = 0
    for s, (d2, atol) in zip(range(0, plan.n, plan.chunk_size), d2_card):
        rows = moved[(moved >= s) & (moved < s + d2.shape[0])]
        gap = np.abs(d2[rows - s, got[rows]] - d2[rows - s, routes["card"][rows]])
        near += int((gap <= 2 * atol).sum())
    first = int(moved[0] // plan.chunk_size) if moved.size else None
    return {"rows": plan.n, "kernel_vs_plain_card": int(moved.size), "near": near,
            "first_chunk_that_differs": first,
            "plain_card_vs_plain_cpu": int((routes["card"] != routes["cpu"]).sum())}


def plain_knn(data, queries, k: int, chunk: int = 1 << 17):
    """Chunked exact k-NN in plain torch (a cross-check, not the path):
    (ids (Q, k) int64, squared dists (Q, k))."""
    import torch

    q2 = (queries * queries).sum(1, keepdim=True)
    best_d = torch.full((queries.shape[0], k), float("inf"), device=data.device)
    best_i = torch.zeros((queries.shape[0], k), dtype=torch.int64, device=data.device)
    for s in range(0, data.shape[0], chunk):
        x = data[s:s + chunk]
        d = q2 + (x * x).sum(1)[None] - 2.0 * queries @ x.T
        dd = torch.cat([best_d, d], 1)
        ii = torch.cat([best_i, torch.arange(s, s + x.shape[0], device=data.device).expand(queries.shape[0], -1)], 1)
        best_d, pos = torch.topk(dd, k, dim=1, largest=False)
        best_i = ii.gather(1, pos)
    return best_i, best_d


def knn_cross_check(gt_ids, gt_d, data, queries, k: int = 10) -> dict:
    """The port's exact_knn against the plain loop on ``queries``: id sets
    equal except where the plain k-th and (k+1)-th distances are within the
    l2 tolerance (a near tie), sorted distances allclose. Counts the queries
    whose sets differ and the ground-truth ids outside the plain set."""
    import torch

    ids_p, d_p = plain_knn(data, queries, k + 1)
    atol = l2_atol(queries, data)
    got, want = gt_ids.long().cpu(), ids_p[:, :k].cpu()
    gap = (d_p[:, k] - d_p[:, k - 1]).cpu()
    differ = near = flipped = 0
    for i in range(queries.shape[0]):
        extra = len(set(got[i].tolist()) - set(want[i].tolist()))
        if extra:
            differ += 1
            flipped += extra
            near += int(float(gap[i]) <= 2 * atol)
    if differ > near or not torch.allclose(gt_d, d_p[:, :k], rtol=1e-5, atol=atol):
        raise AssertionError(f"exact_knn vs the plain loop: {differ} id sets differ, {near} at near ties")
    return {"queries": int(queries.shape[0]), "id_sets_differ": differ, "near_ties": near,
            "ids_differ": flipped, "max_abs_dist_err": float((gt_d - d_p[:, :k]).abs().max())}


def time_split(fn, kernel: str) -> dict:
    """One call of ``fn`` under the profiler: its host ms to a synchronized
    end, and its device ms in kernels whose name holds ``kernel`` and in the
    others (with their counts)."""
    prof, wall = profiled(fn)
    if prof is None:
        return {"error": wall}
    ev = device_events(prof)
    mine = [e.time_range.elapsed_us() / 1e3 for e in ev if kernel in e.name]
    rest = [e.time_range.elapsed_us() / 1e3 for e in ev if kernel not in e.name]
    return {"window_ms": wall, f"{kernel}_ms": sum(mine), f"{kernel}_count": len(mine),
            "other_device_ms": sum(rest), "other_device_count": len(rest)}


def scan_gate(what: str, recall: float, scan: float) -> None:
    """The sanity floor every graph search here is held to: at least half
    the recall of a scan of all the codes keeping the same ``c``
    (``repro_torch.testing.scan.code_scan_recall``). (The
    codes, not the graph, bound recall at these sizes: an absolute floor
    would test the coder configuration.)"""
    if recall < 0.5 * scan:
        raise AssertionError(f"{what}: recall@10 {recall} is below half the code scan's {scan}")


def recall_at(ids, gt) -> float:
    import torch

    hit = (ids[:, :, None].long() == gt[:, None, :]).any(2).sum(1)
    return float(hit.to(torch.float64).mean() / gt.shape[1])


def small_input_checks(dev, index, queries, knn) -> dict:
    """Phase 5: the card's path against the plain CPU path on small inputs,
    and the 0.5 recall@10 floor (ef=256) on the small build."""
    import torch

    from repro_torch.graph import backends as bk
    from repro_torch.graph.beam import beam_search
    from repro_torch.graph.engine import BuildParams
    from repro_torch.graph.hnsw import build_hnsw

    out = {}
    # (a) beam search on the built index, same query tables on both devices
    be_gpu = index.backend
    be_cpu = bk.FlashBlockedBackend(
        be_gpu.coder._replace(**{f: getattr(be_gpu.coder, f).cpu() for f in be_gpu.coder._fields}),
        be_gpu.codes.cpu(), be_gpu.nbr_codes.cpu(),
    )
    qs = queries[:64]
    ctx = be_gpu.prepare_query(qs)
    ctx_cpu = type(ctx)(*(t.cpu() for t in ctx))
    entries = torch.full((64, 1), index.graph.entry, dtype=torch.int32, device=dev)
    adj_cpu = index.graph.adj0.cpu()
    want = beam_search(be_cpu, ctx_cpu, adj_cpu, entries.cpu(), ef=64, width=4)
    for fused in (True, False):
        got = beam_search(be_gpu, ctx, index.graph.adj0, entries, ef=64, width=4, fused=fused)
        for f in ("ids", "dists", "n_dists", "n_hops"):
            if not torch.equal(getattr(got, f).cpu(), getattr(want, f)):
                raise AssertionError(f"beam search on the card (fused={fused}) differs from the CPU path in {f}")
    out["beam_card_equals_cpu"] = True

    # (b) a whole small build from one coder: card kernels vs CPU plain path
    data = index.data[:20000]
    be = bk.make_backend("flash_blocked", data, seed=0, r_for_blocked=16, device=dev,
                         d_f=64, m_f=16, l_f=4, h=8, kmeans_iters=8)
    state = be.state_dict()
    params = BuildParams(r_upper=8, r_base=16, ef=32, batch=16, max_layers=2)
    g_gpu, s_gpu = build_hnsw(data, be, params=params, seed=0)
    be_c = bk.FlashBlockedBackend.from_state(state, device="cpu")
    g_cpu, s_cpu = build_hnsw(data.cpu(), be_c, params=params, seed=0)
    lv_gpu = be.prepare_query(data).adt_q.cpu()
    lv_cpu = be_c.prepare_query(data.cpu()).adt_q
    mismatch = int((lv_gpu != lv_cpu).sum())
    same = float((g_gpu.adj0.cpu() == g_cpu.adj0).all(1).double().mean())
    out.update(small_build_n=int(data.shape[0]), adt_level_mismatch=mismatch,
               adj0_rows_equal=same, phases_gpu=s_gpu.phases, phases_cpu=s_cpu.phases)
    if mismatch == 0 and same != 1.0:
        raise AssertionError(f"equal query tables, yet only {same} of adjacency rows equal the CPU build")
    if same < 0.99:
        raise AssertionError(f"only {same} of adjacency rows equal the CPU build ({mismatch} level mismatches)")
    from repro_torch.graph.hnsw import search_hnsw
    from repro_torch.graph.rerank import SearchSpec, make_reranker

    res = search_hnsw(g_gpu, queries, spec=SearchSpec(k=10, ef=256, width=4),
                      reranker=make_reranker("exact", raw_vectors=data))
    out["small_build_recall@10_ef256"] = rec = recall_at(res.ids, knn(data, queries, 10)[0])
    if rec < 0.5:
        raise AssertionError(f"small build: recall@10 at ef=256 is {rec}, below 0.5")
    return out


def segmented_check(data_np, q_np, workdir: str, device: str = "cuda") -> dict:
    """Phase 5's scale-out check: an 8k-row collection in 4 segments built on
    the card and restored on the CPU; both sides add 500 rows, delete 100
    ids, compact and search, and must return equal ids."""
    import torch

    from repro_torch.graph.engine import BuildParams
    from repro_torch.index import SegmentedAnnIndex

    params = BuildParams(r_upper=8, r_base=16, ef=32, batch=16, max_layers=2)
    card = SegmentedAnnIndex.build_streaming(
        data_np[:8000], n_segments=4, params=params, workdir=workdir, device=device,
        backend_kwargs=dict(d_f=64, m_f=16, l_f=4, h=8, kmeans_iters=8),
    )
    cpu = SegmentedAnnIndex.restore(*card.export_state(), device="cpu")
    dead = np.random.default_rng(1).choice(8500, 100, replace=False)
    ids = {}
    for name, coll in (("card", card), ("cpu", cpu)):
        coll.add(data_np[8000:8500])
        coll.delete(dead)
        coll.compact()
        ids[name] = coll.search(q_np[:200], k=10, ef=64, width=4).ids.cpu()
        if np.isin(ids[name].numpy(), dead).any():
            raise AssertionError(f"segmented check ({name}): a deleted id came back")
    same_route = bool((card._locate == cpu._locate).all())
    adj_rows = [float((a.graph.adj0.cpu() == b.graph.adj0).all(1).double().mean())
                for a, b in zip(card.segments, cpu.segments)]
    if not torch.equal(ids["card"], ids["cpu"]):
        raise AssertionError(
            f"segmented check: card and CPU ids differ (routes equal: {same_route}, "
            f"adj0 rows equal per segment: {adj_rows})"
        )
    return {"segmented_check_n": card.n, "segmented_card_equals_cpu": True,
            "segmented_routes_equal": same_route, "segmented_adj0_rows_equal": adj_rows}


def incremental_path(dev, base_np, queries, n_inc: int, t_start: float) -> dict:
    """Phase 6: the paper's build, ``AnnIndex.build(strategy="incremental")``
    with ``BuildParams()`` and the main path's coder over the first ``n_inc``
    rows: seconds (bootstrap, insert batches), n_dists by phase, insert
    batches and ``flash_beam`` launches (one per insert batch: its
    base-layer acquisition), recall@10 at ef ∈ {64, 256}, W ∈ {1, 4} against
    ``exact_knn`` over those rows, the share of rows the base layer reaches
    from the entry, and a profiler window over ``PROFILED_BATCHES`` more
    insert batches (``add`` to a copy: the same program) for the card's
    busy share and the time per insert batch on the host and on the card.
    Beside it the bulk build of the same rows, and the card against the CPU
    path on a 4,000-row incremental build with an M = 8 coder (4 bytes per
    packed row: the byte-wise layout). Returns the path's launches (ground
    truth, the incremental build, its searches), the bulk build's beside it
    (build and searches), counted apart, and ``l2_batch``'s ground-truth
    launches. The profiler window and the card-against-CPU build are not
    counted."""
    import torch

    from repro_torch.graph import backends as bk
    from repro_torch.graph.engine import PHASE_NAMES, BuildParams, bfs_reachable
    from repro_torch.graph.hnsw import build_hnsw
    from repro_torch.index import AnnIndex, exact_knn
    from repro_torch.kernels import ops
    from repro_torch.utils import sync

    params = BuildParams()
    kw = dict(d_f=64, m_f=16, l_f=4, h=8)
    data = torch.from_numpy(base_np[:n_inc]).to(dev)
    ops.reset_launches()
    gt = exact_knn(queries, data, k=10)[0].long()
    gt_l2 = ops.launches["l2_batch"]

    def build(strategy):
        sync(dev)
        t0 = time.perf_counter()
        idx = AnnIndex.build(data, algo="hnsw", backend="flash_blocked", strategy=strategy, params=params,
                             backend_kwargs=kw, device=dev)
        sync(dev)
        return idx, time.perf_counter() - t0

    def recalls(idx):
        out = []
        for ef in (64, 256):
            for width in (1, 4):
                idx.search(queries[:32], k=10, ef=ef, width=width)  # warm-up
                sync(dev)
                t0 = time.perf_counter()
                res = idx.search(queries, k=10, ef=ef, width=width)
                sync(dev)
                dt = time.perf_counter() - t0
                if not bool(torch.isfinite(res.dists).all()) or tuple(res.ids.shape) != (QUERIES, 10):
                    raise AssertionError(f"{idx.build_strategy} search ef={ef} width={width}: malformed result")
                out.append({"ef": ef, "width": width, "qps": QUERIES / dt, "recall@10": recall_at(res.ids, gt)})
        return out

    before = dict(ops.launches)
    index, wall = build("incremental")
    st = index.last_stats
    inc_launches = {k: v - before[k] for k, v in ops.launches.items()}
    phases = dict(zip(PHASE_NAMES, st.phases))
    batches = -(-n_inc // params.batch) - 1
    for name in ("bootstrap", "beam_upper", "beam_base"):
        if not phases[name] > 0:
            raise AssertionError(f"the incremental build left phase {name} at 0 n_dists")
    if inc_launches["flash_beam"] != batches or inc_launches["mirror_words"] != batches:
        raise AssertionError(f"{batches} insert batches, yet {inc_launches['flash_beam']} flash_beam launches "
                             f"({inc_launches['mirror_words']} on the word layout)")
    inc_results = recalls(index)
    sync(dev)
    launches = dict(ops.launches)
    inc_reach = float(bfs_reachable(index.graph.adj0.cpu().numpy(), index.graph.entry).mean())
    # more insert batches under the profiler (not counted: the path's
    # launches were read above)
    extra = torch.from_numpy(base_np[n_inc:n_inc + PROFILED_BATCHES * params.batch]).to(dev)
    copies = iter([index.clone(), index.clone()])
    t0 = time.perf_counter()
    window = device_window(lambda: next(copies).add(extra), cpu=False)
    window["warmup_window_and_parse_s"] = time.perf_counter() - t0
    if "window_ms" in window:
        window["host_ms_per_insert_batch"] = window["window_ms"] / PROFILED_BATCHES
        window["device_ms_per_insert_batch"] = window["device_ms"] / PROFILED_BATCHES
    del index, copies
    # the bulk build of the same rows beside it, counted apart from the path
    ops.reset_launches()
    bulk, bulk_wall = build("bulk")
    bulk_build_launches = dict(ops.launches)
    bulk_results = recalls(bulk)
    bulk_reach = float(bfs_reachable(bulk.graph.adj0.cpu().numpy(), bulk.graph.entry).mean())
    bst = bulk.last_stats
    del bulk
    sync(dev)
    bulk_launches = dict(ops.launches)

    # the card against the CPU path: a 4,000-row incremental build from one
    # M = 8 coder's state (not counted: both counts were read above)
    d4 = data[:4000]
    be = bk.make_backend("flash_blocked", d4, seed=0, r_for_blocked=params.r_base, device=dev,
                         d_f=64, m_f=8, l_f=4, h=8)
    state = be.state_dict()
    layout = ops.mirror_layout(be.nbr_codes)
    t0 = time.perf_counter()
    g_gpu, s_gpu = build_hnsw(d4, be, params=params, seed=0, strategy="incremental")
    sync(dev)
    card_s = time.perf_counter() - t0
    be_c = bk.FlashBlockedBackend.from_state(state, device="cpu")
    t0 = time.perf_counter()
    g_cpu, s_cpu = build_hnsw(d4.cpu(), be_c, params=params, seed=0, strategy="incremental")
    cpu_s = time.perf_counter() - t0
    mismatch = int((be.prepare_query(d4).adt_q.cpu() != be_c.prepare_query(d4.cpu()).adt_q).sum())
    same = {"adj0": torch.equal(g_gpu.adj0.cpu(), g_cpu.adj0), "adj_up": torch.equal(g_gpu.adj_up.cpu(), g_cpu.adj_up),
            "mirror": torch.equal(g_gpu.backend.nbr_codes.cpu(), g_cpu.backend.nbr_codes),
            "n_dists_by_phase": list(s_gpu.phases) == list(s_cpu.phases)}
    rows_equal = float((g_gpu.adj0.cpu() == g_cpu.adj0).all(1).double().mean())
    if mismatch == 0 and not all(same.values()):
        raise AssertionError(f"equal query tables, yet the card's incremental build differs from the CPU's: {same}")
    if rows_equal < 0.99:
        raise AssertionError(f"only {rows_equal} of adjacency rows equal the CPU build ({mismatch} level mismatches)")
    emit({"phase": "incremental", "n": n_inc, "build_s": wall, "seconds": st.seconds,
          "n_dists": st.n_dists, "n_dists_by_phase": phases, "n_hops": st.n_hops,
          "insert_batches": batches, "flash_beam_launches": inc_launches["flash_beam"],
          "s_per_insert_batch": st.seconds["insert_batches"] / max(1, batches),
          "results": inc_results, "reachable_from_entry": inc_reach,
          "profile_insert_batches": {"batches": PROFILED_BATCHES, **window},
          "bulk": {"build_s": bulk_wall, "seconds": bst.seconds, "n_dists": bst.n_dists,
                   "n_dists_by_phase": dict(zip(PHASE_NAMES, bst.phases)),
                   "repair_unreachable": bst.repair_unreachable, "results": bulk_results,
                   "reachable_from_entry": bulk_reach,
                   "flash_beam_launches": bulk_build_launches["flash_beam"], "launches": bulk_launches},
          "card_vs_cpu_m8": {"n": 4000, "layout": layout, "card_s": card_s, "cpu_s": cpu_s,
                             "adt_level_mismatch": mismatch, "equal": same, "adj0_rows_equal": rows_equal},
          "launches": launches, "elapsed_s": time.perf_counter() - t_start})
    return launches, bulk_launches, gt_l2


def snapshot_path(index, base_np, queries, spill: str, t_start: float):
    """Phase 7: the main index through the port's snapshot files and back on
    the card (the live index's search ids and distances must come back), then
    the sharded builder's spawn pool: ``ShardedBuilder(workers=2,
    snapshot_path=…, attach=True)`` over the first ``POOL_ROWS`` rows in 8 segments
    must attach segments bit-equal (adj0, adj_up, mirror) to the inline build
    of the same plan. Returns the path's launches (this process's; the pool's
    workers count their own)."""
    import torch

    from repro_torch.graph.engine import BuildParams
    from repro_torch.graph.sharded import model_parallel_wall
    from repro_torch.index import ShardConfig, ShardedBuilder
    from repro_torch.kernels import ops
    from repro_torch.serve import snapshot as snap
    from repro_torch.utils import sync

    dev = queries.device
    ops.reset_launches()
    path = os.path.join(spill, "snapshot", "main")
    sync(dev)
    t0 = time.perf_counter()
    snap.save_index(path, index)
    save_s = time.perf_counter() - t0
    nbytes = snap.snapshot_bytes(path)
    t0 = time.perf_counter()
    loaded = snap.load_index(path, device=dev)
    sync(dev)
    load_s = time.perf_counter() - t0
    live = index.search(queries, k=10, ef=64, width=1)
    back = loaded.search(queries, k=10, ef=64, width=1)
    if not (torch.equal(live.ids, back.ids) and torch.equal(live.dists, back.dists)):
        raise AssertionError("the loaded snapshot searches otherwise than the live index (ef=64, W=1)")
    del loaded
    shutil.rmtree(path, ignore_errors=True)

    rows = POOL_ROWS
    cfg = ShardConfig(n_segments=8, chunk_size=65536, balanced=True, algo="hnsw", backend="flash_blocked",
                      strategy="bulk", params=BuildParams(), backend_kwargs=dict(d_f=64, m_f=16, l_f=4, h=8))
    inline_builder = ShardedBuilder(cfg, workdir=os.path.join(spill, "pool_inline"), device=dev)
    plan = inline_builder.assign(base_np[:rows])
    inline = inline_builder.build(plan=plan)
    sync(dev)
    launches = dict(ops.launches)
    pooled = ShardedBuilder(cfg, workers=2, workdir=os.path.join(spill, "pool"), device=dev).build(
        plan=plan, snapshot_path=os.path.join(spill, "snapshot", "pool"), attach=True)
    for s, (a, b) in enumerate(zip(pooled.index.segments, inline.index.segments)):
        for name, x, y in (("adj0", a.graph.adj0, b.graph.adj0), ("adj_up", a.graph.adj_up, b.graph.adj_up),
                           ("mirror", a.backend.nbr_codes, b.backend.nbr_codes)):
            if not torch.equal(x, y):
                raise AssertionError(f"pool segment {s} differs from the inline build in {name}")
    walls = [m["wall_s"] for m in inline.segments]
    emit({"phase": "snapshot", "n": int(index.n), "save_s": save_s, "load_s": load_s, "snapshot_bytes": nbytes,
          "search_equal_live": True, "pool_rows": plan.n, "pool_segments": plan.n_segments,
          "inline_build_s": inline.wall_build_s, "pool_build_s": pooled.wall_build_s, "pool_workers": 2,
          "model_parallel_wall_2": model_parallel_wall(walls, 2), "inline_segment_build_s": walls,
          "pool_segment_build_s": [m["wall_s"] for m in pooled.segments],
          "pool_pids": sorted({m["pid"] for m in pooled.segments}), "pool_equals_inline": True,
          "launches": launches, "elapsed_s": time.perf_counter() - t_start})
    return launches


def segment_scan_recall(coll, queries, gt, c: int = 256, block: int = 50) -> float:
    """recall@10 of an exhaustive scan of every segment's own codes with the
    queries' ADTs under that segment's coder, keeping the best ``c`` per
    segment, reranking the union exactly (a check, not part of the path)."""
    import torch

    cands = []
    for s, seg in enumerate(coll.segments):
        be = seg.backend
        adt = be.prepare_query(queries).adt_q
        q, m, k = adt.shape
        onehot = torch.zeros((be.n, m * k), device=queries.device)
        onehot.scatter_(1, be.codes.long() + torch.arange(m, device=queries.device) * k, 1.0)
        d = adt.reshape(q, m * k).to(torch.float32) @ onehot.T
        top = torch.topk(d, min(c, be.n), dim=1, largest=False).indices
        cands.append(torch.from_numpy(coll.global_ids(s)).to(queries.device)[top])
    cands = torch.cat(cands, 1)
    raw = coll.raw_vectors
    best = []
    for i in range(0, queries.shape[0], block):
        cb = cands[i:i + block]
        d = ((raw[cb] - queries[i:i + block, None, :]) ** 2).sum(-1)
        best.append(cb.gather(1, torch.topk(d, 10, dim=1, largest=False).indices))
    return recall_at(torch.cat(best), gt)


def timed_search(coll, queries, **kw):
    import torch

    from repro_torch.utils import sync

    coll.search(queries[:32], **kw)  # warm-up
    sync(queries.device)
    t0 = time.perf_counter()
    res = coll.search(queries, **kw)
    sync(queries.device)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(res.dists).all()) or tuple(res.ids.shape) != (queries.shape[0], 10):
        raise AssertionError(f"segmented search {kw}: malformed result")
    return res, dt


def scale_out_path(base_np, queries, gt, spill: str, t_start: float):
    """Phases 8–10 on the main path's rows: sharded streaming build of all
    but the last ``ADD_ROWS`` rows, segmented fan-out search, routed growth
    of those rows and deletion, scored against the main path's ground
    truth ``gt`` and then an ``exact_knn`` of the live rows. Returns the
    path's kernel launches, its ``l2_batch`` launches by use (assignment,
    add, ground truth), the collection and the live rows' ground truth."""
    import torch

    from repro_torch.graph.engine import BuildParams
    from repro_torch.index import ShardConfig, ShardedBuilder, exact_knn
    from repro_torch.kernels import ops, ref
    from repro_torch.utils import sync

    dev = queries.device
    n = base_np.shape[0]
    ops.reset_launches()

    # ---- 8. sharded streaming build ----------------------------------------
    builder = ShardedBuilder(
        ShardConfig(n_segments=SEGMENTS, chunk_size=65536, balanced=True, algo="hnsw",
                    backend="flash_blocked", strategy="bulk", params=BuildParams(),
                    backend_kwargs=dict(d_f=64, m_f=16, l_f=4, h=8)),
        workdir=os.path.join(spill, "shard"), device=dev,
    )
    before = dict(ops.launches)
    plan = builder.assign(base_np[: n - ADD_ROWS])
    assign_l2 = ops.launches["l2_batch"] - before["l2_batch"]
    if assign_l2 == 0:
        raise AssertionError("the streaming assignment never launched l2_batch")
    assign_check = assignment_cross_check(base_np[: n - ADD_ROWS], plan, dev)
    res = builder.build(plan=plan)
    coll = res.index
    walls = [m["wall_s"] for m in res.segments]
    phase_s = {}
    for m in res.segments:
        for key, v in m["seconds"].items():
            phase_s[key] = phase_s.get(key, 0.0) + v
    unreach = [m["repair_unreachable"] for m in res.segments]
    emit({"phase": "sharded", "n": n - ADD_ROWS, "segments": plan.n_segments,
          "assign_s": builder.assign_seconds, "seg_size_min": min(plan.seg_sizes),
          "seg_size_max": max(plan.seg_sizes), "build_s": res.wall_build_s,
          "segment_build_s_sum": sum(walls), "segment_build_s_max": max(walls),
          "segment_build_s": walls, "phase_s_sum": phase_s, "repair_unreachable": unreach,
          "n_dists": sum(m["n_dists"] for m in res.segments),
          "n_dists_by_phase": {k: sum(m["phases"][k] for m in res.segments) for k in res.segments[0]["phases"]},
          "assign_l2_batch_launches": assign_l2, "assign_cross_check": assign_check,
          "launches": dict(ops.launches),
          "elapsed_s": time.perf_counter() - t_start})
    if sum(plan.seg_sizes) != n - ADD_ROWS:
        raise AssertionError("the segments do not hold every streamed row")

    # ---- 9. segmented fan-out search ---------------------------------------
    # the default fan-out: on one card, the sequential loop over segments
    results, seq_ids = [], None
    for ef in (64, 256):
        before = dict(ops.launches)
        r, dt = timed_search(coll, queries, k=10, ef=ef, width=4)
        results.append({"ef": ef, "width": 4, "qps": QUERIES / dt, "seconds": dt,
                        "recall@10": recall_at(r.ids, gt), "n_scan": r.n_scan, "n_rerank": r.n_rerank,
                        "flash_beam_launches": ops.launches["flash_beam"] - before["flash_beam"]})
        if ef == 64:
            seq_ids = r.ids
    sync(dev)
    t0 = time.perf_counter()
    fan = coll.search(queries, k=10, ef=64, width=4, fanout=True)
    sync(dev)
    fan_s = time.perf_counter() - t0
    if not torch.equal(fan.ids, seq_ids):
        raise AssertionError("fanout=True returned other ids than the sequential loop (ef=64)")
    scan_rec = segment_scan_recall(coll, queries, gt)
    best = results[-1]["recall@10"]
    emit({"phase": "segmented_search", "queries": QUERIES, "k": 10, "results": results,
          "fanout_equals_sequential": True, "threads_ef64_qps": QUERIES / fan_s,
          "segment_scan_256_recall@10": scan_rec,
          "elapsed_s": time.perf_counter() - t_start})
    if best < min(0.5, 0.5 * scan_rec):
        raise AssertionError(f"segmented recall@10 at ef=256 is {best}, below min(0.5, ½·{scan_rec})")

    # ---- 10. maintenance: routed add, delete -------------------------------
    new = torch.from_numpy(base_np[n - ADD_ROWS:]).to(dev)
    before = dict(ops.launches)
    sync(dev)
    t0 = time.perf_counter()
    gids = coll.add(new)
    sync(dev)
    add_s = time.perf_counter() - t0
    add_l2 = ops.launches["l2_batch"] - before["l2_batch"]
    if add_l2 == 0:
        raise AssertionError("add never launched nearest_centroid's l2_batch")
    if not np.array_equal(gids, np.arange(n - ADD_ROWS, n)):
        raise AssertionError("add assigned other global ids than the stream's")
    route = torch.from_numpy(coll._locate[gids, 0].astype(np.int32)).to(dev)
    flips, near = route_flips(route, ref.l2_batch(new, coll.centroids), l2_atol(new, coll.centroids))
    if flips > near:
        raise AssertionError(f"add: {flips} rows left the plain argmin's segment, {near} at near ties")
    r_add, dt_add = timed_search(coll, queries, k=10, ef=256, width=4)
    rng = np.random.default_rng(0)
    dead = rng.choice(n, DELETE_ROWS, replace=False)
    t0 = time.perf_counter()
    n_dead = coll.delete(dead)
    del_s = time.perf_counter() - t0
    r_del, dt_del = timed_search(coll, queries, k=10, ef=256, width=4)
    if np.isin(r_del.ids.cpu().numpy(), dead).any():
        raise AssertionError("a deleted id came back from search")
    live = np.setdiff1d(np.arange(n), dead)
    live_t = torch.from_numpy(live).to(dev)
    before = ops.launches["l2_batch"]
    gt_live = live_t[exact_knn(queries, torch.from_numpy(base_np[live]).to(dev), k=10)[0].long()]
    sync(dev)
    launches = dict(ops.launches)
    l2_uses = {"assignment": assign_l2, "add": add_l2, "ground_truth": launches["l2_batch"] - before}
    emit({"phase": "maintenance", "added": ADD_ROWS, "add_s": add_s, "add_l2_batch_launches": add_l2,
          "route_flips": flips, "near_tie_flips": near, "n_after_add": coll.n,
          "recall@10_after_add_ef256": recall_at(r_add.ids, gt), "qps_after_add": QUERIES / dt_add,
          "deleted": n_dead, "delete_s": del_s, "n_active": coll.n_active,
          "recall@10_after_delete_ef256": recall_at(r_del.ids, gt_live), "qps_after_delete": QUERIES / dt_del,
          "deleted_ids_returned": 0, "launches": launches, "l2_batch_launches_by_use": l2_uses,
          "elapsed_s": time.perf_counter() - t_start})
    for name in ("flash_round", "flash_beam", "l2_batch"):
        if launches[name] == 0:
            raise AssertionError(f"the scale-out path never launched {name}")
    return launches, l2_uses, coll, gt_live


# ---------------------------------------------------------------------------
# The serving path (phase 7d; the router at the end of the scale-out path)
# ---------------------------------------------------------------------------

SERVE_BLOCKS = (1, 3, 8, 17, 32, 45)  # engine block sizes; 45 > the top bucket (chunked)
SERVE_CLIENTS = 8  # closed-loop client threads of the Runtime waves
SERVE_WAVE = 1000  # requests per wave
# rows the second wave adds, then deletes; the durable Runtime's; the
# segmented replay's add (each add cut from 1,000: PERF.md §4)
SERVE_ADD, SERVE_DELETE = 256, 10000
DURABLE_ADD, DURABLE_DELETE = 256, 5000
SEG_ADD = 256
ROUTER_QUERIES = 256
ROUTER_PROBES = (1, 4, 64)


def fresh_rows(m: int, seed: int, d: int = 128, n_clusters: int = 64) -> np.ndarray:
    """``m`` new rows of the main draw's distribution: the centres and scales
    of ``vector_dataset(0, d=128, n_clusters=64)``, the cluster picks and the
    noise from their own stream ``default_rng([0, seed])``."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    scales = np.linspace(1.0, 0.2, d).astype(np.float32)
    own = np.random.default_rng([0, seed])
    x = centers[own.integers(0, n_clusters, m)]
    x += own.normal(size=(m, d)).astype(np.float32) * scales
    return x


def run_wave(rt, q_np, during=None) -> dict:
    """``SERVE_WAVE`` single-query requests from ``SERVE_CLIENTS`` closed-loop
    client threads (query i is ``q_np[i % len]``); with ``during``, the
    clients send requests for as long as ``during()`` runs on this thread
    and ``SERVE_WAVE`` more after it returned. A shed or rejected request
    is the admission policy's decision and is counted; any other
    exception from a future fails the run. Returns the records and the
    runtime's stats."""
    import threading

    from repro_torch import serve

    lock = threading.Lock()
    nxt = [0]
    limit = [SERVE_WAVE if during is None else float("inf")]
    recs, errors = [], []

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
                if i >= limit[0]:
                    return
            t_sub = time.perf_counter()
            try:
                res = rt.submit(q_np[i % len(q_np)]).result(timeout=120)
                recs.append((i, t_sub, res.ids))
            except (serve.DeadlineExceededError, serve.QueueFullError) as exc:
                recs.append((i, t_sub, type(exc).__name__))
            except BaseException as exc:  # noqa: BLE001 — reported, then the run fails
                errors.append(repr(exc))

    rt.reset_stats()
    threads = [threading.Thread(target=client, name=f"client-{c}") for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    info = None
    if during is not None:
        info = during()
        with lock:
            limit[0] = nxt[0] + SERVE_WAVE
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a Runtime client thread is still waiting after 600 s")
    if errors:
        raise AssertionError(f"{len(errors)} Runtime futures raised: {errors[:3]}")
    st = rt.stats()
    if st["thread_restarts"]:
        raise AssertionError(f"the Runtime's supervisor restarted a loop {st['thread_restarts']} times")
    served = [r for r in recs if not isinstance(r[2], str)]
    return {"recs": served, "info": info, "stats": {
        "requests": len(recs), "served": len(served), "seconds": wall, "qps": len(served) / wall,
        "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"], "queue_p99_ms": st["queue_p99_ms"],
        "service_p50_ms": st["service_p50_ms"], "mean_batch": st["mean_batch"], "batches": st["batches"],
        "rejected": st["rejected"], "shed": st["shed"], "missed": st["deadline_misses"],
        "cold_dispatches": st["cold_dispatches"], "generation": st["generation"]}}


def flip_seconds() -> list:
    """Each recorded generation flip's clone / apply / prepare (warm) / log
    seconds, from the ``serve/flip`` spans."""
    from repro_torch import obs

    return [{"gen": sp.attrs.get("gen"), "total_s": sp.dur_s,
             **{c.name.rsplit("/", 1)[-1] + "_s": c.dur_s for c in sp.children}}
            for sp in obs.spans("serve/flip")]


def serving_path(index, base_np, q_np, queries, spill: str, t_start: float) -> dict:
    """Phase 7d, the serving runtime over the main path's live index:
    the engine (block sizes, warm keys, ids against ``index.search``), the
    Runtime's three waves (no mutation; an add and a delete beside the
    traffic; after both), durability (``init_durable`` → ``attach`` →
    Runtime add/delete → ``recover``, bit-equal) and the snapshot phase's
    8-segment pool manifest adopted as a durable root with one WAL ``add``
    replayed (routed by ``l2_batch``), equal to a live add. Returns the
    path's launches."""
    import torch

    from repro_torch import obs, serve
    from repro_torch.kernels import ops
    from repro_torch.serve.recovery import wal_path
    from repro_torch.utils import sync

    dev = queries.device
    out = {}
    ops.reset_launches()
    t_phase = time.perf_counter()

    # ---- the engine ----------------------------------------------------------
    eng = serve.SearchEngine(index, k=10, ef=64, width=1, rerank=True, q_buckets=(1, 8, 32))
    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0
    compiles = eng.n_compiles
    eng.reset_stats()
    lat = {b: [] for b in SERVE_BLOCKS}  # (queries, seconds) per block, by nominal size
    ids, dists = [], []
    beam0, off, j = ops.launches["flash_beam"], 0, 0
    while off < QUERIES:
        b = min(SERVE_BLOCKS[j % len(SERVE_BLOCKS)], QUERIES - off)
        t0 = time.perf_counter()
        res = eng.search(q_np[off:off + b])
        lat[SERVE_BLOCKS[j % len(SERVE_BLOCKS)]].append((b, time.perf_counter() - t0))
        ids.append(res.ids)
        dists.append(res.dists)
        off += b
        j += 1
    beam_launches = ops.launches["flash_beam"] - beam0
    est = eng.stats()
    eng_ids, eng_d = torch.cat(ids), torch.cat(dists)
    direct = index.search(queries, k=10, ef=64, width=1)
    if eng.n_compiles != compiles:
        raise AssertionError(f"the engine met {eng.n_compiles - compiles} cold keys after warmup")
    if not torch.equal(eng_ids, direct.ids):
        raise AssertionError("the engine's ids differ from index.search(queries, ef=64)")
    if not torch.allclose(eng_d, direct.dists, rtol=1e-5, atol=0.0):
        raise AssertionError("the engine's distances are off index.search's by more than rtol 1e-5")
    if beam_launches != est["blocks"]:
        raise AssertionError(f"{beam_launches} flash_beam launches for {est['blocks']} padded dispatches")
    per_block = {}
    for b, v in lat.items():
        qs, secs = np.array([x[0] for x in v]), np.array([x[1] for x in v])
        per_block[str(b)] = {"blocks": len(v), "queries": int(qs.sum()), "qps": float(qs.sum() / secs.sum()),
                             "p50_ms": float(np.percentile(secs, 50) * 1e3),
                             "p99_ms": float(np.percentile(secs, 99) * 1e3)}
    window = device_window(lambda: [eng.search(q_np[i]) for i in range(100)], cpu=False)
    out["engine"] = {"buckets": [1, 8, 32], "warmup_s": warm_s, "compiles_after_warmup": 0,
                     "keys": compiles, "blocks": est["blocks"], "padded_queries": est["padded_queries"],
                     "flash_beam_launches": beam_launches, "qps": est["qps"], "p50_ms": est["p50_ms"],
                     "p99_ms": est["p99_ms"], "per_block_size": per_block,
                     "n_dists_per_query": est["n_dists_per_query"], "ids_equal_index_search": True,
                     "profile_100_single_queries": window}
    eng_np = eng_ids.cpu().numpy()

    # ---- the Runtime: three waves ----------------------------------------------
    new_rows = fresh_rows(SERVE_ADD, 1)
    dead = np.random.default_rng(18).choice(index.n, SERVE_DELETE, replace=False)
    obs.enable()
    obs.clear_spans()
    try:
        with serve.Runtime(index, k=10, ef=64, q_buckets=(1, 8, 32), max_wait_ms=2.0, max_queue=256,
                           default_deadline_ms=50.0) as rt:
            rt.warmup()
            w1 = run_wave(rt, q_np)
            for i, _, got in w1["recs"]:
                if not np.array_equal(got, eng_np[i % QUERIES]):
                    raise AssertionError(f"wave 1: request {i} returned other ids than the engine")

            def mutate():
                stamp = []
                t0 = time.perf_counter()
                rt.add(new_rows).result(timeout=600)
                add_s = time.perf_counter() - t0
                fut = rt.delete(dead)
                fut.add_done_callback(lambda f: stamp.append(time.perf_counter()))
                fut.result(timeout=600)
                return {"add_s": add_s, "delete_s": time.perf_counter() - t0 - add_s, "resolved": stamp[0]}

            w2 = run_wave(rt, q_np, during=mutate)
            resolved = w2["info"].pop("resolved")
            after = [r for r in w2["recs"] if r[1] > resolved]
            if len(after) < SERVE_WAVE // 2:
                raise AssertionError(f"wave 2: only {len(after)} requests followed the delete")
            bad = sum(bool(np.isin(got, dead).any()) for _, _, got in after)
            if bad:
                raise AssertionError(f"wave 2: {bad} requests submitted after the delete resolved returned a deleted id")
            if w2["stats"]["cold_dispatches"]:
                raise AssertionError(f"wave 2: {w2['stats']['cold_dispatches']} cold dispatches")
            flips = flip_seconds()
            w3 = run_wave(rt, q_np)
            now = rt.handle.current.index
            live = now.search(queries, k=10, ef=64, width=1).ids.cpu().numpy()
            for i, _, got in w3["recs"]:
                if not np.array_equal(got, live[i % QUERIES]):
                    raise AssertionError(f"wave 3: request {i} returned other ids than handle.current.index")
            if np.isin(live, dead).any():
                raise AssertionError("a deleted id came back from the current generation")
            health = rt.health()
            del now
    finally:
        obs.disable()
    out["runtime"] = {"clients": SERVE_CLIENTS, "default_deadline_ms": 50.0, "max_wait_ms": 2.0, "max_queue": 256,
                      "wave1": w1["stats"], "wave2": {**w2["stats"], **w2["info"], "added": SERVE_ADD,
                                                       "deleted": SERVE_DELETE,
                                                       "requests_after_delete": len(after)},
                      "wave3": w3["stats"], "flips": flips, "ids_wave1_equal_engine": True,
                      "ids_wave3_equal_current": True, "healthy": health["healthy"]}

    # ---- durability ----------------------------------------------------------------
    root = os.path.join(spill, "durable")
    sync(dev)
    t0 = time.perf_counter()
    serve.init_durable(root, index)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    handle, ckpt, _ = serve.attach(root, fsync="batch", device=dev)
    attach_s = time.perf_counter() - t0
    try:
        obs.enable()
        obs.clear_spans()
        with serve.Runtime(handle, k=10, ef=64, q_buckets=(1, 8, 32)) as rt:
            rt.add(fresh_rows(DURABLE_ADD, 2)).result(timeout=600)
            rt.delete(np.random.default_rng(19).choice(index.n, DURABLE_DELETE, replace=False)).result(timeout=600)
            if rt.stats()["thread_restarts"]:
                raise AssertionError("the durable Runtime's supervisor restarted a loop")
        durable_flips = flip_seconds()
    finally:
        obs.disable()
        ckpt.close()
        wal = handle.wal.stats()
        handle.wal.close()
    live = handle.current.index
    sync(dev)
    t0 = time.perf_counter()
    rec = serve.recover(root, device=dev)
    sync(dev)
    replay_s = time.perf_counter() - t0
    got, want = rec.index.graph, live.graph
    for name in ("adj0", "adj_up", "levels"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"recover: {name} differs from the live handle's index")
    if got.entry != want.entry or not np.array_equal(rec.index.tombstones, live.tombstones):
        raise AssertionError("recover: the entry or the tombstones differ from the live handle's index")
    if not torch.equal(rec.index.search(queries, k=10, ef=64).ids, live.search(queries, k=10, ef=64).ids):
        raise AssertionError("recover: search ids differ from the live handle's index")
    report = serve.verify_root(root, device=dev)
    if not report["ok"] or report["wal"]["replayable"] != 2:
        raise AssertionError(f"verify_root: {report}")
    out["durability"] = {"n": int(live.n), "added": DURABLE_ADD, "deleted": DURABLE_DELETE,
                         "init_s": init_s, "attach_s": attach_s, "wal_bytes": wal["bytes"],
                         "wal_fsyncs": wal["fsyncs"], "wal_appends": wal["appends"], "replayed": rec.replayed,
                         "recover_s": replay_s, "flips": durable_flips, "recovered_bit_equal": True,
                         "verify_root": {k: report[k] for k in ("ok", "checkpoint_lsn", "wal", "snapshot")}}
    del rec, live, handle
    shutil.rmtree(root, ignore_errors=True)

    # ---- the sharded pool's manifest as a durable root -----------------------------
    manifest = os.path.join(spill, "snapshot", "pool")
    root = os.path.join(spill, "durable_seg")
    rows = fresh_rows(SEG_ADD, 3)
    _, adopted = serve.init_from_manifest(root, manifest, device=dev)
    del adopted
    with serve.WalWriter(wal_path(root), fsync="batch") as w:
        w.append("add", {"vectors": rows})
        w.commit()
    l2_0 = ops.launches["l2_batch"]
    t0 = time.perf_counter()
    rec = serve.recover(root, device=dev)
    sync(dev)
    seg_replay_s = time.perf_counter() - t0
    replay_l2 = ops.launches["l2_batch"] - l2_0
    live = serve.load_index(manifest, device=dev)
    live.add(rows)
    for s, (a, b) in enumerate(zip(rec.index.segments, live.segments)):
        if not np.array_equal(rec.index.global_ids(s), live.global_ids(s)):
            raise AssertionError(f"segmented replay: segment {s} routed other rows than a live add")
        for name, x, y in (("adj0", a.graph.adj0, b.graph.adj0), ("adj_up", a.graph.adj_up, b.graph.adj_up),
                           ("mirror", a.backend.nbr_codes, b.backend.nbr_codes)):
            if not torch.equal(x, y):
                raise AssertionError(f"segmented replay: segment {s} differs from a live add in {name}")
    if replay_l2 == 0:
        raise AssertionError("the segmented replay never launched l2_batch")
    out["segmented_recovery"] = {"segments": len(live.segments), "n": int(live.n), "added": SEG_ADD,
                                 "replay_s": seg_replay_s, "replay_l2_batch_launches": replay_l2,
                                 "equals_live_add": True,
                                 "routed": [int(len(rec.index.global_ids(s))) for s in range(len(live.segments))]}
    del rec, live
    shutil.rmtree(root, ignore_errors=True)
    sync(dev)
    launches = dict(ops.launches)
    emit({"phase": "serving", **out, "launches": launches, "phase_s": time.perf_counter() - t_phase,
          "elapsed_s": time.perf_counter() - t_start})
    return launches


def serving_router(coll, queries, gt, t_start: float) -> dict:
    """The router half of the serving path, over the scale-out path's
    64-segment collection as phase 10 left it: at n_probe = 64 the ids must
    equal ``SegmentedAnnIndex.search`` at the same spec, and the fan-out
    threads the loop; QPS and recall@10 at each n_probe. Returns its
    launches."""
    import torch

    from repro_torch import serve
    from repro_torch.kernels import ops
    from repro_torch.utils import sync

    dev = queries.device
    q = queries[:ROUTER_QUERIES]
    q_np = q.cpu().numpy()
    ops.reset_launches()
    t_phase = time.perf_counter()
    rows = []
    # one router, warmed once; its probe count is set per row
    router = serve.SegmentRouter(coll, n_probe=len(coll.segments), k=10, ef=64, width=4,
                                 q_buckets=(1, 8, 32), fanout=False).warmup()
    for n_probe in ROUTER_PROBES:
        router.n_probe = n_probe
        sync(dev)
        t0 = time.perf_counter()
        res = router.search(q_np)
        sync(dev)
        dt = time.perf_counter() - t0
        rows.append({"n_probe": n_probe, "qps": ROUTER_QUERIES / dt, "seconds": dt,
                     "recall@10": recall_at(res.ids, gt[:ROUTER_QUERIES]), "n_scan": res.n_scan,
                     "n_rerank": res.n_rerank})
        if n_probe == len(coll.segments):
            want = coll.search(q, k=10, ef=64, width=4)
            if not torch.equal(res.ids, want.ids):
                raise AssertionError("the router at the full probe returned other ids than SegmentedAnnIndex.search")
            router.fanout = True
            if not torch.equal(router.search(q_np).ids, res.ids):
                raise AssertionError("the router's fan-out threads returned other ids than its loop")
            router.fanout = False
    sync(dev)
    launches = dict(ops.launches)
    emit({"phase": "serving_router", "queries": ROUTER_QUERIES, "segments": len(coll.segments), "k": 10,
          "ef": 64, "width": 4, "results": rows, "full_probe_equals_segmented_search": True,
          "fanout_equals_loop": True, "launches": launches, "phase_s": time.perf_counter() - t_phase,
          "elapsed_s": time.perf_counter() - t_start})
    return launches


def path_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``fn`` to a synchronized end (one warm-up):
    for calls that wait on the card themselves (a top-k's selection)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def retrieval_path(dev, t_start: float) -> dict:
    """Phase 11: BERT4Rec next-item retrieval at the model's full config.
    Returns the path's kernel launches."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import flash as fl
    from repro_torch.data.synthetic import vector_dataset
    from repro_torch.graph.backends import FlashBackend
    from repro_torch.graph.engine import BuildParams
    from repro_torch.index import AnnIndex
    from repro_torch.kernels import ops, ref
    from repro_torch.models.recsys import bert4rec as b4r
    from repro_torch.models.recsys import retrieval as rt
    from repro_torch.utils import sync, topk_first

    cfg = get_arch("bert4rec").make_full()
    n = cfg.n_items
    ops.reset_launches()
    out = {"n_items": n, "embed_dim": cfg.embed_dim, "n_blocks": cfg.n_blocks, "n_heads": cfg.n_heads,
           "seq_len": cfg.seq_len, "requests": REQUESTS}

    # the model, with the repo's stand-in for a trained table in rows [0, n)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = b4r.Bert4Rec(cfg, gen, device=dev)
    table_np = vector_dataset(0, n=n, d=cfg.embed_dim, n_clusters=256)
    table_np /= np.linalg.norm(table_np, axis=1, keepdims=True)
    with torch.no_grad():
        model.item_embed[:n].copy_(torch.from_numpy(table_np))
    table = model.item_embed.detach()[:n]
    sync(dev)
    out["setup_s"] = time.perf_counter() - t0
    out["model_state_gb"] = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9

    # the requests: 64 sessions ending in [MASK], and one (retrieval_cand)
    items, _ = b4r.sample_training_batch(gen, cfg, REQUESTS)
    items[:, -1] = cfg.mask_id
    q = model.serve(items)
    if tuple(q.shape) != (REQUESTS, cfg.embed_dim) or not bool(torch.isfinite(q).all()):
        raise AssertionError("serve: malformed query vectors")
    out["serve_ms"] = {f"B{REQUESTS}": path_ms(lambda: model.serve(items)), "B1": path_ms(lambda: model.serve(items[:1]))}
    noise = torch.randn((REQUESTS, cfg.embed_dim), generator=gen, device=dev)
    near = table[:REQUESTS] + 0.03 * noise

    # the coder
    t0 = time.perf_counter()
    coder = fl.fit_flash(table, d_f=48, m_f=16, kmeans_iters=10, device=dev)
    codes = fl.encode(coder, table)
    sync(dev)
    out["coder_s"] = time.perf_counter() - t0

    # scoring, each way, at B = 64 and B = 1
    def dense(qq):
        return rt.score_dense(qq, table, k=10)

    def flash(qq, k, rerank):
        return rt.score_flash(qq, coder, codes, table, k=k, rerank=rerank)

    scorers = {"dense": dense, "flash_k10_r8": lambda qq: flash(qq, 10, 8),
               "flash_k100_r4": lambda qq: flash(qq, 100, 4)}
    out["score_ms"], per_call = {}, {}
    for name, fn in scorers.items():
        for b in (REQUESTS, 1):
            before = ops.launches["flash_scan"]
            fn(q[:b])
            per_call[f"{name}_B{b}"] = ops.launches["flash_scan"] - before
            out["score_ms"][f"{name}_B{b}"] = path_ms(lambda fn=fn, b=b: fn(q[:b]))
    out["flash_scan_launches_per_call"] = per_call
    # where score_flash's time goes (k = 10, rerank 8): the scan launches,
    # then the selection of the 80 smallest sums; the rest is the query
    # tables and the rerank
    adt_all = fl.query_ctx(coder, q).adt_q
    stages = {}
    for b in (REQUESTS, 1):
        def scan(b=b):
            return torch.stack([ops.flash_scan(codes, a) for a in adt_all[:b]])
        sums = scan()
        stages[f"scan_B{b}"] = path_ms(scan)
        stages[f"select_B{b}"] = path_ms(lambda sums=sums: topk_first(-sums, 80))
    out["flash_k10_r8_stages_ms"] = stages
    recall = {}
    for qname, qq in (("encoder", q), ("near_item", near)):
        exact = dense(qq)
        if tuple(exact.ids.shape) != (REQUESTS, 10) or not bool(torch.isfinite(exact.scores).all()):
            raise AssertionError("score_dense: malformed result")
        for name in ("flash_k10_r8", "flash_k100_r4"):
            res = scorers[name](qq)
            if not bool(torch.isfinite(res.scores).all()) or not bool(((res.ids >= 0) & (res.ids < n)).all()):
                raise AssertionError(f"{name}: malformed result")
            recall[f"{name}_{qname}"] = rt.retrieval_recall(res, exact, 10)
    out["recall@10_vs_dense"] = recall
    emit({"phase": "retrieval", **out, "elapsed_s": time.perf_counter() - t_start})

    # the graph through the AnnIndex facade over the scan's coder and codes
    t0 = time.perf_counter()
    index = AnnIndex.build(table, algo="hnsw", backend=FlashBackend(coder, codes),
                           params=BuildParams(r_upper=8, r_base=16, ef=48, batch=32), device=dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    st = index.last_stats
    graph = {"rows": index.n, "build_s": build_s, "seconds": st.seconds, "n_dists": st.n_dists,
             "repair_unreachable": st.repair_unreachable, "flash_round_launches": ops.launches["flash_round"]}
    for qname, qq in (("encoder", q), ("near_item", near)):
        exact = dense(qq)
        for ef in GRAPH_EF:
            rt.search_index(qq, index, table, k=10, ef_search=ef)  # warm-up
            sync(dev)
            t0 = time.perf_counter()
            res = rt.search_index(qq, index, table, k=10, ef_search=ef)
            sync(dev)
            graph[f"qps_{qname}_ef{ef}"] = REQUESTS / (time.perf_counter() - t0)
            if tuple(res.ids.shape) != (REQUESTS, 10) or not bool(torch.isfinite(res.scores).all()):
                raise AssertionError(f"search_index ef={ef}: malformed result")
            graph[f"recall@10_{qname}_ef{ef}"] = rt.retrieval_recall(res, exact, 10)
    sync(dev)
    launches = dict(ops.launches)
    for name in ("flash_scan", "flash_round"):
        if launches[name] == 0:
            raise AssertionError(f"the retrieval path never launched {name}")

    # checks against the plain versions and the CPU path (their launches
    # are not the path's: the counts were read above)
    adt = fl.query_ctx(coder, q[:1]).adt_q[0]
    if not torch.equal(ops.flash_scan(codes, adt), ref.flash_scan(codes, adt)):
        raise AssertionError("flash_scan differs from its plain version over the catalog")
    cpu_coder = coder._replace(**{f: getattr(coder, f).cpu() for f in coder._fields})
    q8 = q[:8]
    levels_differ = (fl.query_ctx(coder, q8).adt_q.cpu() != fl.query_ctx(cpu_coder, q8.cpu()).adt_q).flatten(1).any(1)
    card_ids = flash(q8, 10, 8).ids.cpu()
    cpu_ids = rt.score_flash(q8.cpu(), cpu_coder, codes.cpu(), table.cpu(), k=10, rerank=8).ids
    same = (card_ids == cpu_ids).all(1)
    if not bool(same[~levels_differ].all()):
        raise AssertionError("score_flash on the card returned other ids than the CPU path with equal ADTs")
    emit({"phase": "retrieval_graph", **graph, "launches": launches, "flash_scan_card_equals_plain": True,
          "card_equals_cpu_queries": int(same.sum()), "adt_level_mismatch_queries": int(levels_differ.sum()),
          "elapsed_s": time.perf_counter() - t_start})
    # The sanity floor: on the near-item queries, the graph at the widest
    # beam must reach half the recall of score_flash at k = 10, rerank 8.
    # At the example's ef = 96 the graph's share of the scan's recall falls
    # with the catalog's size, in the reference as in the port (0.91 at 20k
    # rows, 0.85 at 50k, 0.26 at 1M: PERF.md, PR 13), and the untrained
    # encoder's queries (norm 8 against unit rows) fall faster; both are
    # reported, not held.
    got = graph[f"recall@10_near_item_ef{GRAPH_EF[-1]}"]
    floor = 0.5 * recall["flash_k10_r8_near_item"]
    if got < floor:
        raise AssertionError(f"graph recall@10 (near-item, ef={GRAPH_EF[-1]}) {got} below ½ of score_flash's ({floor})")
    return launches


def check_repaired_limits(dev, g) -> dict:
    """Phase 2's shapes that raised before the limits were repaired, each
    held bit for bit against its plain version: an (M, K) = (64, 256) int32
    table (64 KiB, above the 48 KB a kernel gets without the shared-memory
    opt-in) through the four table kernels, and ``flash_beam`` at W = 16,
    R = 96 (W·R = 1,536 slots on 1,024 threads) against its plain version
    and the loop of ``flash_expand`` launches."""
    import torch

    from repro_torch.kernels import ops, ref

    def ints(shape, hi, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=g, device=dev, dtype=dtype)

    def same(name, got, want):
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"{name}: differs from its plain version at a repaired limit")

    m, k, b = 64, 256, 1024
    adts = ints((b, m, k), 256)
    codes = ints((b, 128, m), k)
    same("flash_round (64 KiB table)", ops.flash_round(codes, adts), ref.flash_round(codes, adts))
    flat = codes.reshape(-1, m)
    same("flash_scan (64 KiB table)", ops.flash_scan(flat, adts[0]), ref.flash_scan(flat, adts[0]))
    blocks = codes.reshape(b, 4, 32, m).transpose(-1, -2).contiguous()
    same("flash_scan_blocked (64 KiB table)", ops.flash_scan_blocked(blocks, adts),
         ref.flash_scan_blocked(blocks, adts))
    n, r = 20000, 32
    mirror = ints((n, r, m), k)
    adj = ints((n, r), n)
    nodes = ints((b, 4), n)
    rows, sums = ops.flash_expand(nodes, adj, mirror, adts)
    rows_p, sums_p = ref.flash_expand(nodes, adj, mirror, adts)
    same("flash_expand rows (64 KiB table)", rows, rows_p)
    same("flash_expand (64 KiB table)", sums, sums_p)
    bnd, by = bound_ms(codes.numel() * 4 + adts.numel() * 4 + b * 128 * 4, b * 128 * m)
    idx = (codes.long() + torch.arange(m, device=dev) * k
           + (torch.arange(b, device=dev) * m * k)[:, None, None]).reshape(b * 128, m)
    lib = embedding_bag_ms(idx, adts, ops.flash_round(codes, adts))
    del idx
    out = {"table_64k": {"shape_mk": [m, k], "shape": [b, 128, m], "table_bytes": m * k * 4, "bit_equal": True,
                         **lib,
                         "flash_round_ms": time_ms(lambda: ops.flash_round(codes, adts)),
                         "flash_round_device_ms": profiler_kernel_ms(lambda: ops.flash_round(codes, adts),
                                                                     "flash_round_kernel"),
                         "flash_round_plain_ms": time_ms(lambda: ref.flash_round(codes, adts), reps=3, inner=2),
                         "bound_ms": bnd, "bound_by": by}}
    del codes, flat, blocks, mirror

    # flash_beam, W = 16 rows of R = 96 slots, over a random 200k-vertex graph
    out["flash_beam_w16_r96"] = beam_bit_equal(ints, n=200_000, r=96, w=16, q=1000, efs=(64, 256))
    return out


def beam_bit_equal(ints, *, n: int, r: int, w: int, q: int, efs, empty: float = 0.0) -> dict:
    """``flash_beam`` over a random n-vertex graph of degree ``r`` (a share
    ``empty`` of its slots −1, as a flat graph's rows hold) with an M = 16,
    4-bit code per vertex, ``q`` queries from one random entry each, beam
    width ``w``: at each ef of ``efs`` held bit for bit (dists, ids, n_dists,
    n_hops) against its plain version and the loop of ``flash_expand``
    launches, and timed."""
    import torch

    from repro_torch.core import flash as fl
    from repro_torch.kernels import ops, ref

    m, k = 16, 16
    codes = ints((n, m), k)
    adj = ints((n, r), n)
    if empty:
        adj[ints((n, r), 1 << 20) < int(empty * (1 << 20))] = -1
    mirror = fl.pack_codes(codes[adj.clamp_min(0).long()])
    out = {}
    for ef in efs:
        adt = ints((q, m, k), 256)
        entries = ints((q, 1), n)
        d_e = fl.adc_lookup(adt, codes[entries.long()]).to(torch.float32)
        beam = ref.initial_beam(entries, d_e, ef)
        max_iters = -(-(4 * ef + 8) // w)
        args = (adt, adj, mirror, *beam, entries)
        got = ops.flash_beam(*args, width=w, max_iters=max_iters)

        def step(nodes, adt=adt):
            rows, sums = ops.flash_expand(nodes, adj, mirror, adt)
            return rows, sums.to(torch.float32)

        loop = ref.beam_loop(step, *beam, entries, n, width=w, max_iters=max_iters)
        plain = ref.flash_beam(*args, width=w, max_iters=max_iters)
        for against, want in (("the flash_expand step loop", loop), ("its plain version", plain)):
            for x, y, name in zip(got, want, ("dists", "ids", "n_dists", "n_hops")):
                if not torch.equal(x.cpu(), y.cpu()):
                    raise AssertionError(f"flash_beam W={w} R={r} ef={ef} Q={q}: {name} differs from {against}")
        hops = int(got[3].sum())
        # the bytes the search needs, as check_flash_beam counts them
        nbytes = adt.numel() * 4 + hops * r * (4 + m // 2) + q * ef * 17 + q * 16 + entries.numel() * 4
        bnd, by = bound_ms(nbytes, hops * r * m)
        out[f"ef{ef}"] = {
            "queries": q, "n": n, "empty_slots": empty, "bit_equal": True, "n_dists": int(got[2].sum()),
            "n_hops": hops,
            "ms": time_ms(lambda: ops.flash_beam(*args, width=w, max_iters=max_iters), reps=3, inner=1),
            "device_ms": profiler_kernel_ms(lambda: ops.flash_beam(*args, width=w, max_iters=max_iters),
                                            "flash_beam_kernel", reps=3),
            "bound_ms": bnd, "bound_by": by}
    torch.cuda.synchronize()
    return out


def check_flat_shapes(dev, g) -> dict:
    """Phase 2's flat-graph shapes (the ``generality`` phase's parameters:
    r_base = 24, W = 4, ef 64 to build, 128 to search), held bit for bit
    against the plain versions: ``flash_round`` at every C a flat bulk
    round scores (S = 32 random, P = 2R = 48 pool, P + E² = 112 refine)
    over a full 16,384-row block and a remainder of 848 rows (50,000 rows
    in blocks), and ``flash_beam`` at W = 4, R = 24 over a random
    ``N_BASE``-vertex graph with a quarter of its slots empty: 1,000 queries
    at ef 128 (the search) and 32 at ef 64 (an insert batch)."""
    import torch

    from repro_torch.graph import engine
    from repro_torch.kernels import ops, ref

    def ints(shape, hi, dtype=torch.int32):
        return torch.randint(0, hi, shape, generator=g, device=dev, dtype=dtype)

    m, k = 16, 16
    out = {"flash_round": {}}
    for b in (engine._BULK_CHUNK, N_BASE % engine._BULK_CHUNK):
        for c in (32, 48, 48 + engine._BULK_EXPAND ** 2):
            codes, adts = ints((b, c, m), k), ints((b, m, k), 256)
            if not torch.equal(ops.flash_round(codes, adts), ref.flash_round(codes, adts)):
                raise AssertionError(f"flash_round at a flat round's (B, C) = ({b}, {c}): differs from plain")
            out["flash_round"][f"b{b}_c{c}"] = "bit_equal"
    del codes, adts
    out["flash_beam_w4_r24_search"] = beam_bit_equal(ints, n=N_BASE, r=24, w=4, q=1000, efs=(128,), empty=0.25)
    out["flash_beam_w4_r24_insert_batch"] = beam_bit_equal(ints, n=N_BASE, r=24, w=4, q=32, efs=(64,), empty=0.25)
    return out


# Builds over integer data with hand-made coders (repro_torch.testing.exact):
# every distance an exact float32 integer, so equal on the card and the CPU.
EXACT_N, EXACT_D = 2000, 32


EXACT_CASES = [(kind, algo, strategy) for kind in ("fp32", "pq", "sq", "pca")
               for algo in ("hnsw", "vamana", "nsg") for strategy in ("bulk", "incremental")]


def exact_builds(device: str, src: str) -> dict:
    """Every case of :data:`EXACT_CASES` built on ``device`` over the
    integer rows: {case: (export_state arrays, n_dists, seconds)}. Module
    level with ``src`` passed in: the CPU side runs in a spawned process."""
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch

    from repro_torch.graph.engine import BuildParams
    from repro_torch.index import AnnIndex
    from repro_torch.testing.exact import exact_backends

    if device == "cpu":  # half the cores: the card's side runs beside it
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    x = torch.from_numpy(np.random.default_rng(5).integers(-8, 9, (EXACT_N, EXACT_D)).astype(np.float32))
    backends = exact_backends(x, device)
    out = {}
    for kind, algo, strategy in EXACT_CASES:
        # batch 128: 16 insert batches a pass (the smoke's time limit)
        params = BuildParams(r_upper=8, r_base=16, ef=32, batch=128, max_layers=2,
                             alpha=1.2 if algo == "vamana" else 1.0)
        t0 = time.perf_counter()
        idx = AnnIndex.build(x, algo=algo, backend=backends[kind], params=params, strategy=strategy,
                             device=device)
        out[f"{kind}/{algo}/{strategy}"] = (idx.export_state()[1], idx.last_stats.n_dists,
                                            time.perf_counter() - t0)
    return out


#: the flat Flash builds phase 5 holds card against CPU: (algo, strategy,
#: rows, algorithm options), at the ``generality`` phase's parameters
FLAT_FLASH_CASES = (("vamana", "bulk", 20000, {}), ("nsg", "bulk", 20000, dict(knn_k=24)),
                    ("vamana", "incremental", 4000, {}), ("nsg", "incremental", 4000, dict(knn_k=24)))
FLAT_PARAMS = dict(r_upper=8, r_base=24, ef=64, batch=32, max_layers=3, width=4, alpha=1.2)


def flat_flash_builds(device: str, src: str, rows, queries, states: dict, knns: dict) -> dict:
    """Every case of :data:`FLAT_FLASH_CASES` built on ``device`` over the
    case's first n rows of ``rows`` (numpy) from the coder ``states[n]`` (a
    ``flash_blocked`` state dict), and searched with ``queries`` at ef 128,
    W = 4: {case: (export_state arrays, n_dists, [(ids, Flash distances)
    without rerank, (ids, distances) with the exact rerank], query-table
    levels, seconds)}. The incremental NSG starts from the k-NN graph
    ``knns[n]``, the same on both devices. Module level with ``src``
    passed in: the CPU side runs in a spawned process."""
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch

    from repro_torch.graph.backends import FlashBlockedBackend
    from repro_torch.graph.engine import BuildParams
    from repro_torch.graph.nsg import build_nsg_stats
    from repro_torch.index import AnnIndex

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    params = BuildParams(**FLAT_PARAMS)
    q = torch.from_numpy(queries).to(device)
    out = {}
    for algo, strategy, n, kw in FLAT_FLASH_CASES:
        x = torch.from_numpy(rows[:n]).to(device)
        be = FlashBlockedBackend.from_state(states[n], device=device)
        t0 = time.perf_counter()
        if (algo, strategy) == ("nsg", "incremental"):
            graph, _, st = build_nsg_stats(x, be, params=params, strategy=strategy,
                                           knn_adj=torch.from_numpy(knns[n]), **kw)
            idx = AnnIndex.from_graph(graph, x, algo=algo, params=params, backend_kind="flash_blocked", stats=st,
                                      strategy=strategy, device=device)
        else:
            idx = AnnIndex.build(x, algo=algo, backend=be, params=params, strategy=strategy, device=device, **kw)
        res = [idx.search(q, k=10, ef=128, width=4, rerank=rr) for rr in (False, True)]
        out[f"{algo}/{strategy}/{n}"] = (idx.export_state()[1], idx.last_stats.n_dists,
                                         [(r.ids.cpu().numpy(), r.dists.cpu().numpy()) for r in res],
                                         be.prepare_query(x).adt_q.cpu().numpy(), time.perf_counter() - t0)
    return out


def card_against_cpu_builds(dev, data) -> dict:
    """Phase 5's build checks, each built on the card and, at the same
    time in a spawned process, on the CPU:

    * every algorithm (HNSW, Vamana, NSG), bulk and incremental, over every
      baseline backend with hand-made coders on 2,000 integer rows in
      [−8, 8] at D = 32: the graphs, their distances, the entry and n_dists
      must be equal;
    * flat Vamana and NSG over ``flash_blocked`` (:data:`FLAT_FLASH_CASES`,
      the generality phase's r_base = 24 and W = 4) on the first rows of
      ``data``, from one coder fitted on the card (the incremental NSG
      from one k-NN graph, the CPU's; the card's own is held to it up to
      near ties): Flash distances are
      integer sums, so where the two devices' query tables agree the
      graphs, n_dists and a 200-query search at ef 128 must be equal (ids
      and Flash distances); with the exact rerank the float32 distances
      sum in another order, so they must be allclose at rtol 1e-5 and the
      ids, which may swap at a near tie, are reported. Where the tables
      disagree, 99% of the adjacency rows must be equal, as in the HNSW
      check above."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.graph import backends as bk
    from repro_torch.index import exact_knn

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    rows = data[:max(c[2] for c in FLAT_FLASH_CASES)].cpu().numpy()
    queries = (data[-200:].cpu().numpy() + 0.5).astype(np.float32)
    states = {}
    for n in sorted({c[2] for c in FLAT_FLASH_CASES}):
        be = bk.make_backend("flash_blocked", data[:n], seed=0, r_for_blocked=FLAT_PARAMS["r_base"], device=dev,
                             d_f=64, m_f=16, l_f=4, h=8, kmeans_iters=8)
        states[n] = {key: v.cpu() if hasattr(v, "cpu") else v for key, v in be.state_dict().items()}
    # The incremental NSG's k-NN graph: l2_batch on the card may order a
    # near tie otherwise than the CPU's plain product, and one swapped
    # neighbour changes the graph. Both builds start from the CPU's; the
    # card's is held to it up to near ties (knn_cross_check).
    knns, knn_check = {}, {}
    for _, strategy, n, kw in FLAT_FLASH_CASES:
        if "knn_k" in kw and strategy == "incremental":
            k = kw["knn_k"] + 1
            cpu_ids = exact_knn(data[:n].cpu(), data[:n].cpu(), k=k)[0]
            card_ids, card_d = exact_knn(data[:n], data[:n], k=k)
            knns[n] = cpu_ids[:, 1:].numpy()
            knn_check[n] = dict(knn_cross_check(card_ids, card_d, data[:n], data[:n], k=k),
                                rows_differ_from_cpu=int((card_ids.cpu() != cpu_ids).any(1).sum()))
    with ProcessPoolExecutor(max_workers=1, mp_context=mp.get_context("spawn")) as ex:
        cpu_exact = ex.submit(exact_builds, "cpu", src)
        cpu_flat = ex.submit(flat_flash_builds, "cpu", src, rows, queries, states, knns)
        card = exact_builds(str(dev), src)
        card_flat = flat_flash_builds(str(dev), src, rows, queries, states, knns)
        cpu = cpu_exact.result()
        cpu_flat = cpu_flat.result()
    out = {}
    for case, (arrays, nd, secs) in card.items():
        cpu_arrays, cpu_nd, cpu_secs = cpu[case]
        for key, arr in cpu_arrays.items():
            if not np.array_equal(arrays[key], arr):
                raise AssertionError(f"{case}: the card's {key} differs from the CPU's")
        if nd != cpu_nd:
            raise AssertionError(f"{case}: n_dists {nd} on the card, {cpu_nd} on the CPU")
        out[case] = {"n_dists": nd, "card_s": secs, "cpu_s": cpu_secs}
    flat = {}
    for case, (arrays, nd, res, levels, secs) in card_flat.items():
        c_arrays, c_nd, c_res, c_levels, c_secs = cpu_flat[case]
        mismatch = int((levels != c_levels).sum())
        rows_equal = float((arrays["adj"] == c_arrays["adj"]).all(1).mean())
        (ids, d), (rr_ids, rr_d) = res
        (c_ids, c_d), (c_rr_ids, c_rr_d) = c_res
        same = {"graph": all(np.array_equal(arrays[key], arr) for key, arr in c_arrays.items()),
                "n_dists": nd == c_nd, "search_ids": np.array_equal(ids, c_ids),
                "search_flash_dists": np.array_equal(d, c_d),
                "rerank_dists_rtol_1e-5": bool(np.allclose(rr_d, c_rr_d, rtol=1e-5, atol=0.0))}
        flat[case] = {"adt_level_mismatch": mismatch, "adj_rows_equal": rows_equal, "equal": same,
                      "rerank_ids_equal": float((rr_ids == c_rr_ids).mean()),
                      "n_dists": nd, "card_s": secs, "cpu_s": c_secs}
        if mismatch == 0 and not all(same.values()):
            raise AssertionError(f"flat flash_blocked {case}: equal query tables, yet the card differs from the "
                                 f"CPU: {same} ({rows_equal} of adjacency rows equal)")
        if rows_equal < 0.99:
            raise AssertionError(f"flat flash_blocked {case}: only {rows_equal} of adjacency rows equal the CPU's "
                                 f"({mismatch} level mismatches)")
    return {"exact_builds_n": EXACT_N, "exact_builds_card_equals_cpu": out,
            "flat_flash_blocked_card_equals_cpu": flat, "flat_nsg_knn_card_vs_cpu": knn_check}


def index_bytes(index) -> int:
    """Adjacency plus the per-node payload the backend stores, the paper's
    index size, counted as ``benchmarks/bench_indexing.py:38-56`` counts it
    (SQ levels and PQ codes at one byte each)."""
    g, be, kind = index.graph, index.backend, index.backend_kind
    adj = (g.adj0.numel() + g.adj_up.numel()) * 4 if index.layered else g.adj.numel() * 4
    n = index.n
    if kind == "fp32":
        payload = n * index.data.shape[1] * 4
    elif kind == "pca":
        payload = be.z.numel() * 4
    elif kind == "sq":
        payload = be.codes.numel()
    elif kind == "pq":
        payload = be.codes.shape[0] * be.coder.m
    else:
        payload = int(be.codes.shape[0] * be.coder.m_f * np.log2(be.coder.k) / 8)
        if hasattr(be, "nbr_codes"):
            payload += be.nbr_codes.numel() * be.nbr_codes.element_size()
    return int(adj + payload)


def timed_build(data, dev, **kw):
    """``AnnIndex.build`` on the card: (index, wall seconds)."""
    import torch

    from repro_torch.index import AnnIndex

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = AnnIndex.build(data, device=dev, **kw)
    torch.cuda.synchronize()
    return idx, time.perf_counter() - t0


def timed_searches(idx, queries, gt, settings) -> list:
    """QPS and recall@10 of ``idx.search`` for each (ef, width, rerank)."""
    import torch

    rows = []
    for ef, width, rerank in settings:
        idx.search(queries[:32], k=10, ef=ef, width=width, rerank=rerank)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = idx.search(queries, k=10, ef=ef, width=width, rerank=rerank)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not bool(torch.isfinite(res.dists).all()) or tuple(res.ids.shape) != (queries.shape[0], 10):
            raise AssertionError(f"{idx.algo}/{idx.backend_kind} search ef={ef}: malformed result")
        rows.append({"ef": ef, "width": width, "rerank": rerank, "qps": queries.shape[0] / dt,
                     "seconds": dt, "recall@10": recall_at(res.ids, gt), "n_scan": res.n_scan,
                     "n_rerank": res.n_rerank})
    return rows


#: the baseline backends and their settings (benchmarks/bench_indexing.py:212-215),
#: beside the main path's blocked Flash coder
BASELINES = (("fp32", {}), ("pq", dict(m=16, l_pq=8, kmeans_iters=10)), ("sq", dict(bits=8)),
             ("pca", dict(alpha=0.9)), ("flash_blocked", dict(d_f=64, m_f=16, l_f=4, h=8)))


def baselines_path(dev, base_np, queries, n_rows: int, t_start: float) -> tuple[dict, dict]:
    """Phase ``baselines``: the paper's build-speed comparison. The first
    ``n_rows`` rows, bulk HNSW with ``BuildParams()`` over every backend:
    coder fit and build seconds by phase, n_dists, index bytes, recall@10
    and QPS at ef ∈ {64, 256}, W = 1 with exact rerank (and reconstruct
    rerank at ef = 256 for the coded backends), each build's seconds over
    fp32's. Each coded backend's recall at ef = 256 must reach half that
    of a scan of all its codes keeping 256 (``scan_gate``). The four
    baseline builds must launch no Flash kernel; the Flash build must
    launch ``flash_round`` and ``flash_beam``. Returns the
    path's launches (every build and search) and the ground truth's
    ``l2_batch`` launches."""
    import torch

    from repro_torch.graph.engine import PHASE_NAMES, BuildParams
    from repro_torch.index import exact_knn
    from repro_torch.kernels import ops
    from repro_torch.testing.scan import code_scan_recall

    data = torch.from_numpy(base_np[:n_rows]).to(dev)
    gt_l2 = ops.launches["l2_batch"]
    gt = exact_knn(queries, data, k=10)[0].long()
    gt_l2 = ops.launches["l2_batch"] - gt_l2
    rows = {}
    for kind, kw in BASELINES:
        before = dict(ops.launches)
        idx, wall = timed_build(data, dev, algo="hnsw", backend=kind, strategy="bulk", params=BuildParams(),
                                backend_kwargs=kw)
        built = {key: ops.launches[key] - before[key] for key in ("flash_round", "flash_beam")}
        settings = [(64, 1, True), (256, 1, True)] + ([(256, 1, "reconstruct")] if kind != "fp32" else [])
        st = idx.last_stats
        rows[kind] = {"settings": kw, "build_s": wall, "seconds": st.seconds, "n_dists": st.n_dists,
                      "n_dists_by_phase": dict(zip(PHASE_NAMES, st.phases)),
                      "repair_unreachable": st.repair_unreachable, "index_bytes": index_bytes(idx),
                      "build_launches": built, "search": timed_searches(idx, queries, gt, settings)}
        if kind != "fp32":  # fp32's scan is the ground truth itself
            scan = code_scan_recall(idx.backend, idx.data, queries, gt, 256)
            rows[kind]["code_scan_256_recall@10"] = scan
            best = max(r["recall@10"] for r in rows[kind]["search"] if r["ef"] == 256 and r["rerank"] is True)
            scan_gate(f"baselines {kind} at ef=256", best, scan)
        flash = kind.startswith("flash")
        if flash and not (built["flash_round"] and built["flash_beam"]):
            raise AssertionError(f"the {kind} build launched flash_round {built['flash_round']} and "
                                 f"flash_beam {built['flash_beam']} times")
        if not flash and any(built.values()):
            raise AssertionError(f"the {kind} build launched a Flash kernel: {built}")
        del idx
    for row in rows.values():
        row["build_s_over_fp32"] = row["build_s"] / rows["fp32"]["build_s"]
    launches = dict(ops.launches)
    emit({"phase": "baselines", "n": n_rows, "queries": int(queries.shape[0]), "k": 10, "backends": rows,
          "ground_truth_l2_batch_launches": gt_l2, "launches": launches,
          "elapsed_s": time.perf_counter() - t_start})
    return launches, gt_l2


def generality_path(dev, base_np, queries, n_rows: int, t_start: float) -> dict:
    """Phase ``generality`` (``benchmarks/bench_generality.py:24-26`` over
    ``benchmarks/common.py:36-38``): Vamana and NSG (``knn_k`` = 24), bulk,
    over fp32 and ``flash_blocked`` on the first ``n_rows`` rows: build
    seconds, n_dists, recall@10 and QPS at ef = 128, W = 4, exact rerank,
    held to half the recall of a scan of the codes keeping 128
    (``scan_gate``). Every ``flash_blocked`` build and search must launch ``flash_beam``,
    every flat bulk Flash build ``flash_round``. Returns the path's
    launches."""
    import torch

    from repro_torch.graph.engine import BuildParams
    from repro_torch.index import exact_knn
    from repro_torch.kernels import ops
    from repro_torch.testing.scan import code_scan_recall

    data = torch.from_numpy(base_np[:n_rows]).to(dev)
    gt = exact_knn(queries, data, k=10)[0].long()
    params = BuildParams(r_upper=8, r_base=24, ef=64, batch=32, max_layers=3, width=4, alpha=1.2)
    rows = {}
    for algo, akw in (("vamana", {}), ("nsg", dict(knn_k=24))):
        for kind, kw in (("fp32", {}), ("flash_blocked", dict(d_f=64, m_f=16, l_f=4, h=8))):
            before = dict(ops.launches)
            idx, wall = timed_build(data, dev, algo=algo, backend=kind, strategy="bulk", params=params,
                                    backend_kwargs=kw, **akw)
            built = {key: ops.launches[key] - before[key] for key in ("flash_round", "flash_beam")}
            mid = dict(ops.launches)
            search = timed_searches(idx, queries, gt, [(128, 4, True)])
            searched = ops.launches["flash_beam"] - mid["flash_beam"]
            st = idx.last_stats
            rows[f"{algo}/{kind}"] = {"build_s": wall, "seconds": st.seconds, "n_dists": st.n_dists,
                                      "repair_unreachable": st.repair_unreachable,
                                      "index_bytes": index_bytes(idx), "build_launches": built,
                                      "search_flash_beam_launches": searched, "search": search}
            if kind != "fp32":
                scan = code_scan_recall(idx.backend, idx.data, queries, gt, 128)
                rows[f"{algo}/{kind}"]["code_scan_128_recall@10"] = scan
                scan_gate(f"generality {algo}/{kind} at ef=128", search[0]["recall@10"], scan)
            if kind == "flash_blocked" and not (built["flash_round"] and built["flash_beam"] and searched):
                raise AssertionError(f"{algo}/{kind}: build launches {built}, search flash_beam {searched}")
            if kind == "fp32" and (any(built.values()) or searched):
                raise AssertionError(f"{algo}/fp32 launched a Flash kernel")
            del idx
        rows[f"{algo}/build_s_fp32_over_flash_blocked"] = (
            rows[f"{algo}/fp32"]["build_s"] / rows[f"{algo}/flash_blocked"]["build_s"])
    launches = dict(ops.launches)
    emit({"phase": "generality", "n": n_rows, "params": dataclasses.asdict(params), "knn_k": 24,
          "results": rows, "launches": launches, "elapsed_s": time.perf_counter() - t_start})
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # The repo's scalability setting is 1M vectors in 64 segments. Both paths
    # at 1M ran 1,119 s and 1,151 s of the 1,200 s limit on the H100, so the
    # rows are cut to 500k and the 64 segments kept (PERF.md records it).
    ap.add_argument("--n", type=int, default=500_000,
                    help="base rows of both paths (the scalability setting: 1M)")
    ap.add_argument("--n-inc", type=int, default=N_INC,
                    help="rows of the incremental build (phase 6)")
    ap.add_argument("--n-base", type=int, default=N_BASE,
                    help="rows of the baselines and generality phases (7b, 7c)")
    args = ap.parse_args()
    n = args.n

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.data.synthetic import vector_dataset
    from repro_torch.graph.engine import PHASE_NAMES, BuildParams
    from repro_torch.index import AnnIndex, exact_knn
    from repro_torch.kernels import build, ops
    from repro_torch.testing.scan import code_scan_recall

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device + kernel build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build_s = build.build_all()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in build.PTXAS_LOG.items()
    }
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas})

    # ---- 2. kernels vs plain at the path's shapes ---------------------------
    kern = check_kernels(dev, n)
    emit({"phase": "kernels", **kern})

    # ---- 3. build ----------------------------------------------------------
    t0 = time.perf_counter()
    allx = vector_dataset(0, n=n + QUERIES, d=128, n_clusters=64)
    base_np, q_np = allx[:n], allx[n:]
    data = torch.from_numpy(base_np).to(dev)
    queries = torch.from_numpy(q_np).to(dev)
    data_s = time.perf_counter() - t0
    params = BuildParams()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = AnnIndex.build(
        data, algo="hnsw", backend="flash_blocked", strategy="bulk", params=params,
        backend_kwargs=dict(d_f=64, m_f=16, l_f=4, h=8), device="cuda",
    )
    torch.cuda.synchronize()
    build_wall = time.perf_counter() - t0
    st = index.last_stats
    build_launches = dict(ops.launches)
    emit({"phase": "build", "n": n, "d": 128, "data_gen_s": data_s, "build_s": build_wall,
          "seconds": st.seconds, "n_dists": st.n_dists, "n_dists_by_phase": dict(zip(PHASE_NAMES, st.phases)),
          "n_hops": st.n_hops, "repair_unreachable": st.repair_unreachable, "launches": build_launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for name in ("flash_round", "flash_beam"):  # flash_beam: the repair's inserts
        if build_launches[name] == 0:
            raise AssertionError(f"the build never launched {name}")
    adj0 = index.graph.adj0
    if not bool(((adj0 >= -1) & (adj0 < n)).all()):
        raise AssertionError("adjacency ids out of range")

    # ---- 4. search ---------------------------------------------------------
    t0 = time.perf_counter()
    gt_i32, gt_d = exact_knn(queries, data, k=10)
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0
    gt_l2 = ops.launches["l2_batch"] - build_launches["l2_batch"]
    gt = gt_i32.long()
    gt_check = knn_cross_check(gt, gt_d, data, queries)
    results = []
    fused_ids = {}
    for ef in (64, 256):
        for width in (1, 4):
            before = dict(ops.launches)
            index.search(queries[:32], k=10, ef=ef, width=width)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = index.search(queries, k=10, ef=ef, width=width)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if not bool(torch.isfinite(res.dists).all()) or tuple(res.ids.shape) != (QUERIES, 10):
                raise AssertionError(f"search ef={ef} width={width}: malformed result")
            rec = recall_at(res.ids, gt)
            results.append({"ef": ef, "width": width, "qps": QUERIES / dt, "seconds": dt,
                            "recall@10": rec, "n_scan": res.n_scan, "n_rerank": res.n_rerank,
                            "flash_beam_launches": ops.launches["flash_beam"] - before["flash_beam"]})
            fused_ids[(ef, width)] = res.ids
    for width in (1, 4):
        res_u = index.search(queries, k=10, ef=64, width=width, fused=False)
        if not torch.equal(res_u.ids, fused_ids[(64, width)]):
            raise AssertionError(f"unfused search (ef=64, width={width}) returned other ids than the fused one")
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    for name in ("flash_round", "flash_beam", "flash_scan_blocked", "l2_batch"):
        if launches[name] == 0:
            raise AssertionError(f"the main path never launched {name}")
    if launches["mirror_bytes"] or launches["mirror_words"] != launches["flash_beam"]:
        raise AssertionError("the main path's coder (M = 16) left the 8-byte word layout")
    # where the device time goes in one search and in the ground truth
    # (after the counts were read)
    gt_split = time_split(lambda: exact_knn(queries, data, k=10), "l2_batch_kernel")
    windows = {
        "flash_beam": device_window(lambda: index.search(queries, k=10, ef=64, width=1)),
        "step_loop": device_window(lambda: index.search(queries, k=10, ef=64, width=1, fused=False)),
    }
    # the sanity floor (scan_gate): the search at ef=256 against a scan of
    # the same codes keeping 256 candidates
    scan_rec = code_scan_recall(index.backend, index.data, queries, gt, 256)
    best = max(r["recall@10"] for r in results if r["ef"] == 256)
    emit({"phase": "search", "queries": QUERIES, "k": 10, "results": results,
          "exhaustive_scan_256_recall@10": scan_rec, "unfused_equals_fused": True,
          "ground_truth_s": gt_s, "ground_truth_cross_check": gt_check, "ground_truth_split": gt_split,
          "profile_ef64_w1": windows, "launches": launches, "elapsed_s": time.perf_counter() - t_start})
    scan_gate("the main path's search at ef=256", best, scan_rec)

    spill = os.path.join(root, "build", "chip_smoke_spill")
    shutil.rmtree(spill, ignore_errors=True)
    try:
        # ---- 5. small-input checks against the CPU path ---------------------
        check = small_input_checks(dev, index, queries, plain_knn)
        check.update(segmented_check(base_np, q_np, os.path.join(spill, "check")))
        check.update(card_against_cpu_builds(dev, index.data))
        emit({"phase": "check", **check, "elapsed_s": time.perf_counter() - t_start})

        # ---- 6. the incremental build ---------------------------------------
        inc_launches, bulk_launches, inc_gt_l2 = incremental_path(dev, base_np, queries, args.n_inc, t_start)
        for name in ("flash_beam", "l2_batch"):
            if inc_launches[name] == 0:
                raise AssertionError(f"the incremental path never launched {name}")
        for name in ("flash_beam", "flash_round"):
            if bulk_launches[name] == 0:
                raise AssertionError(f"the bulk build beside the incremental path never launched {name}")

        # ---- 7. snapshot files and the sharded pool -------------------------
        snap_launches = snapshot_path(index, base_np, queries, spill, t_start)
        for name in ("flash_beam", "flash_round", "l2_batch"):
            if snap_launches[name] == 0:
                raise AssertionError(f"the snapshot path never launched {name}")

        # ---- 7d. the serving runtime over the live index --------------------
        serve_launches = serving_path(index, base_np, q_np, queries, spill, t_start)
        del index, data

        # ---- 7b. the baseline backends, 7c. the flat graphs -----------------
        ops.reset_launches()
        base_launches, base_gt_l2 = baselines_path(dev, base_np, queries, args.n_base, t_start)
        ops.reset_launches()
        gen_launches = generality_path(dev, base_np, queries, args.n_base, t_start)

        # ---- 8.–10. the scale-out path --------------------------------------
        scale_launches, l2_uses, coll, gt_live = scale_out_path(base_np, queries, gt, spill, t_start)
        # ---- 10b. the serving router over the scale-out collection ----------
        router_launches = serving_router(coll, queries, gt_live, t_start)
        del coll
        serve_launches = {k: serve_launches[k] + router_launches[k] for k in serve_launches}
        for name in ("flash_beam", "l2_batch"):
            if serve_launches[name] == 0:
                raise AssertionError(f"the serving path never launched {name}")
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    # l2_batch's launches, split by what called it: the assignments (the
    # scale-out path's and the pool's plan), routed add, and the ground
    # truths that score the main, scale-out and incremental paths
    l2_uses["ground_truth"] += gt_l2 + inc_gt_l2 + base_gt_l2 + gen_launches["l2_batch"]
    l2_uses["assignment"] += snap_launches["l2_batch"]
    l2_uses["serving"] = serve_launches["l2_batch"]

    # ---- 11. the retrieval path ------------------------------------------------
    retrieval_launches = retrieval_path(dev, t_start)

    rows = []
    for name, key in (("flash_round", "flash_round"), ("flash_expand", "flash_expand_w4"),
                      ("flash_beam", "flash_beam_ef64_w1"),
                      ("flash_scan_blocked", "flash_scan_blocked_w4"), ("l2_batch", "l2_batch_gt"),
                      ("flash_scan", "flash_scan"), ("sq_l2", "sq_l2")):
        kr = kern[key]
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
                     "launches": (launches[name] + inc_launches[name] + bulk_launches[name] + snap_launches[name]
                                  + scale_launches[name] + retrieval_launches[name] + base_launches[name]
                                  + gen_launches[name] + serve_launches[name]),
                     "max_abs_err": kr["max_abs_err"], "ms": kr["ms"],
                     "plain_ms": kr["plain_ms"], "bound_ms": kr["bound_ms"], "bound_by": kr["bound_by"],
                     "library_ms": kr["library_ms"], "shape": kr["shape"]})
        rows[-1].update({f: kr[f] for f in ("device_ms", "step_loop_ms", "workspace_bytes", "ms_warm",
                                            "bound_fp32_fma_ms", "library_call") if f in kr})
        if isinstance(kr.get("device_ms"), float):  # events minus device: the wrapper's host cost
            rows[-1]["host_us_per_call"] = (kr["ms"] - kr["device_ms"]) * 1e3
        if name == "l2_batch":
            rows[-1]["launches_by_use"] = l2_uses
            rows[-1]["assignment_shape"] = {f: kern["l2_batch_assign"][f] for f in (
                "shape", "max_abs_err", "ms", "ms_warm", "device_ms", "plain_ms", "bound_ms",
                "bound_fp32_fma_ms", "library_ms")}
        if name == "flash_beam":
            rows[-1]["launches_by_use"] = {"main_build": build_launches[name],
                                           "main_search": launches[name] - build_launches[name],
                                           "incremental": inc_launches[name],
                                           "incremental_bulk": bulk_launches[name], "snapshot": snap_launches[name],
                                           "scale_out": scale_launches[name], "baselines": base_launches[name],
                                           "generality": gen_launches[name], "serving": serve_launches[name]}
            rows[-1]["w16_r96"] = kern["limits"]["flash_beam_w16_r96"]
            rows[-1]["flat_w4_r24"] = {key: kern["flat_shapes"][key] for key in (
                "flash_beam_w4_r24_search", "flash_beam_w4_r24_insert_batch")}
            rows[-1]["byte_layout_m8"] = kern["flash_beam_m8_bytes"]
            rows[-1]["byte_layout_m16"] = kern["flash_beam_ef64_w1"]["bytes_layout_same_inputs"]
        if name == "flash_round":
            rows[-1]["launches_by_use"] = {"main": launches[name], "incremental": inc_launches[name],
                                           "incremental_bulk": bulk_launches[name], "snapshot": snap_launches[name], "scale_out": scale_launches[name],
                                           "retrieval_graph": retrieval_launches[name],
                                           "baselines": base_launches[name], "generality": gen_launches[name],
                                           "serving": serve_launches[name]}
            rows[-1]["table_64k"] = kern["limits"]["table_64k"]
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
