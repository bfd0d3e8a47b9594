#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py              # the full run: 1M x 128 vectors
    python3 chip_smoke.py --n 100000   # a smaller base set (the cut rule)

Phases, each printing one JSON line (any failure raises, so the exit is
non-zero and no result line is printed):

1. device   the card's name and power limit; nvcc builds the three Flash
            kernels from ``src/repro_torch/kernels/csrc`` (seconds printed).
2. kernels  each kernel on the card at the main path's shapes, held against
            its plain PyTorch version (int32 tables bit-equal, float32
            tables allclose), timed beside its bound and the plain version.
3. build    ``AnnIndex.build(algo="hnsw", backend="flash_blocked",
            strategy="bulk")`` over ``vector_dataset(seed=0, d=128,
            n_clusters=64)`` (SIFT1M's shape): seconds and n_dists per phase.
4. search   1,000 held-out queries, k = 10, exact rerank, ef ∈ {64, 256},
            width ∈ {1, 4}: QPS and recall@10 against a chunked exact k-NN;
            the unfused step must return the fused step's ids.
5. check    on small inputs the card's path equals the plain CPU path: beam
            search on the built index with the same query tables, and a
            whole 20k-vector build from the same coder.

Launch counts are zeroed just before the build and read just after the
last search; the script fails if a kernel of the path never launched.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

QUERIES = 1000  # held-out search queries, the search batch
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
CUDA_CORE_OPS_PER_S = 67e12  # float32 outside the tensor cores; int32 adds counted at it

REPLACES = {
    "flash_round": "src/repro/kernels/flash_round.py:49",
    "flash_expand": "src/repro/kernels/flash_expand.py:81",
    "flash_scan_blocked": "src/repro/kernels/flash_scan.py:94",
}
SOURCES = {
    "flash_round": "src/repro_torch/kernels/csrc/flash_round.cu",
    "flash_expand": "src/repro_torch/kernels/csrc/flash_expand.cu",
    "flash_scan_blocked": "src/repro_torch/kernels/csrc/flash_scan_blocked.cu",
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


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    out["flash_round"] = dict(
        shape=[b, c, m], max_abs_err=errs[torch.int32], max_abs_err_f32=errs[torch.float32],
        ms=time_ms(lambda: ops.flash_round(codes, adts)),
        plain_ms=time_ms(lambda: ref.flash_round(codes, adts), reps=3, inner=2),
        bound_ms=bnd, bound_by=by, library_ms=None,
    )

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
            plain_ms=time_ms(lambda: ref.flash_expand(nodes, adjacency, mirror, adt), reps=3, inner=2),
            bound_ms=bnd, bound_by=by, library_ms=None,
        )
        blocks = fl.unpack_codes(mirror[nodes.clamp_min(0).long()], m).transpose(-1, -2).contiguous()
        nbytes = blocks.numel() * 4 + adt.numel() * 4 + slots * 4
        bnd, by = bound_ms(nbytes, slots * m)
        out[f"flash_scan_blocked_w{w}"] = dict(
            shape=list(blocks.shape), max_abs_err=errs[("scan", torch.int32)],
            max_abs_err_f32=errs[("scan", torch.float32)],
            ms=time_ms(lambda: ops.flash_scan_blocked(blocks, adt)),
            plain_ms=time_ms(lambda: ref.flash_scan_blocked(blocks, adt), reps=3, inner=2),
            bound_ms=bnd, bound_by=by, library_ms=None,
        )
    torch.cuda.synchronize()
    return out


def exact_knn(data, queries, k: int, chunk: int = 1 << 17):
    """Chunked exact k-NN on the card (ground truth; not part of the path)."""
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
    return best_i


def exhaustive_scan_recall(index, queries, gt, c: int, chunk: int = 1 << 16) -> float:
    """recall@10 of scanning EVERY code with the queries' ADTs, keeping the
    best ``c`` and reranking them exactly: what the compact codes allow a
    search of ``c`` candidates at best (a check, not part of the path). The
    ADT sums are one-hot products of integer levels, exact in float32."""
    import torch

    be = index.backend
    ctx = be.prepare_query(queries)
    q, m, k = ctx.adt_q.shape
    adt = ctx.adt_q.reshape(q, m * k).to(torch.float32)
    offs = torch.arange(m, device=queries.device) * k
    best_d = torch.full((q, c), float("inf"), device=queries.device)
    best_i = torch.zeros((q, c), dtype=torch.int64, device=queries.device)
    for s in range(0, be.n, chunk):
        codes = be.codes[s:s + chunk].long() + offs
        onehot = torch.zeros((codes.shape[0], m * k), device=queries.device)
        onehot.scatter_(1, codes, 1.0)
        d = adt @ onehot.T
        ids = torch.arange(s, s + codes.shape[0], device=queries.device).expand(q, -1)
        best_d, pos = torch.topk(torch.cat([best_d, d], 1), c, dim=1, largest=False)
        best_i = torch.cat([best_i, ids], 1).gather(1, pos)
    exact = ((index.data[best_i] - queries[:, None, :]) ** 2).sum(-1)
    top = best_i.gather(1, torch.topk(exact, 10, dim=1, largest=False).indices)
    return recall_at(top, gt)


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
    out["small_build_recall@10_ef256"] = rec = recall_at(res.ids, knn(data, queries, 10))
    if rec < 0.5:
        raise AssertionError(f"small build: recall@10 at ef=256 is {rec}, below 0.5")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="base vectors (cut rule: 1M, 500k, 250k)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.data.synthetic import vector_dataset
    from repro_torch.graph.engine import PHASE_NAMES, BuildParams
    from repro_torch.index import AnnIndex
    from repro_torch.kernels import build, ops

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
    kern = check_kernels(dev, args.n)
    emit({"phase": "kernels", **kern})

    # ---- 3. build ----------------------------------------------------------
    t0 = time.perf_counter()
    allx = vector_dataset(0, n=args.n + QUERIES, d=128, n_clusters=64)
    data_np, q_np = allx[: args.n], allx[args.n:]
    data = torch.from_numpy(data_np).to(dev)
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
    emit({"phase": "build", "n": args.n, "d": 128, "data_gen_s": data_s, "build_s": build_wall,
          "seconds": st.seconds, "n_dists": st.n_dists, "n_dists_by_phase": dict(zip(PHASE_NAMES, st.phases)),
          "n_hops": st.n_hops, "repair_unreachable": st.repair_unreachable, "launches": build_launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if build_launches["flash_round"] == 0:
        raise AssertionError("the build never launched flash_round")
    adj0 = index.graph.adj0
    if not bool(((adj0 >= -1) & (adj0 < args.n)).all()):
        raise AssertionError("adjacency ids out of range")

    # ---- 4. search ---------------------------------------------------------
    gt = exact_knn(data, queries, 10)
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
                            "flash_expand_launches": ops.launches["flash_expand"] - before["flash_expand"]})
            fused_ids[(ef, width)] = res.ids
    for width in (1, 4):
        res_u = index.search(queries, k=10, ef=64, width=width, fused=False)
        if not torch.equal(res_u.ids, fused_ids[(64, width)]):
            raise AssertionError(f"unfused search (ef=64, width={width}) returned other ids than the fused one")
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    for name in ("flash_round", "flash_expand", "flash_scan_blocked"):
        if launches[name] == 0:
            raise AssertionError(f"the main path never launched {name}")
    # The sanity floor: the graph search at ef=256 must reach at least half
    # the recall of an exhaustive scan of the same codes keeping 256
    # candidates. (At this scale the 4-bit codes, not the graph, bound
    # recall: an absolute floor would test the coder configuration.)
    scan_rec = exhaustive_scan_recall(index, queries, gt, 256)
    best = max(r["recall@10"] for r in results if r["ef"] == 256)
    emit({"phase": "search", "queries": QUERIES, "k": 10, "results": results,
          "exhaustive_scan_256_recall@10": scan_rec, "unfused_equals_fused": True,
          "launches": launches})
    if best < 0.5 * scan_rec:
        raise AssertionError(
            f"recall@10 at ef=256 is {best}, below half the exhaustive scan's {scan_rec}"
        )

    # ---- 5. small-input checks against the CPU path -------------------------
    emit({"phase": "check", **small_input_checks(dev, index, queries, exact_knn)})

    rows = []
    for name, key in (("flash_round", "flash_round"), ("flash_expand", "flash_expand_w4"),
                      ("flash_scan_blocked", "flash_scan_blocked_w4")):
        kr = kern[key]
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
                     "launches": launches[name], "max_abs_err": kr["max_abs_err"], "ms": kr["ms"],
                     "plain_ms": kr["plain_ms"], "bound_ms": kr["bound_ms"], "bound_by": kr["bound_by"],
                     "library_ms": kr["library_ms"], "shape": kr["shape"]})
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
