"""Segment-parallel index build and fan-out search in the PyTorch port —
the paper's distributed deployment (§2.1.4/§4.4), on one card or across
ranks (the counterpart of ``examples/distributed_build.py``, at its sizes).

    PYTHONPATH=src python examples/torch_distributed_build.py
    PYTHONPATH=src python examples/torch_distributed_build.py --ranks 2
    PYTHONPATH=src python examples/torch_distributed_build.py --device cpu --workers 2 --seg-size 500
    PYTHONPATH=src python examples/torch_distributed_build.py --device cpu --ranks 2 --seg-size 500

One shared Flash coder (an offline job), one per-segment build program,
then queries fan out to every segment and merge through exact-reranked
top-k (the coordinator). On one process the program is
``build_segments_vmapped`` (the segments build one after another) and
``search_segments_local``. With ``--ranks N`` the rows are cut into N
segments, one a rank, and ``launch.mesh.run_ranks`` starts N processes
(``gloo`` when they share a card or run on the CPU, ``nccl`` with a card
each): ``make_segmented_build_fn`` builds each rank's segment on its own
device and gathers the stack, ``make_segmented_search_fn`` searches each
rank's segment and merges on every rank. Then the serving form
(``SegmentedAnnIndex``: per-segment facades with routed growth, in this
process), and the streaming form: the same rows through ``ShardedBuilder``
(nearest-centroid routing, per-segment builds inline, in a ``--workers``
process pool, or with ``--ranks`` across the ranks' mesh, a published
manifest). Keep the call under ``if __name__ == "__main__"``: pool workers
and ranks re-import the main module.
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.data.synthetic import vector_dataset
from repro_torch.graph import segmented as seg
from repro_torch.graph.engine import BuildParams, prefix_entries, sample_levels
from repro_torch.index import ShardConfig, ShardedBuilder, exact_knn, recall_at_k
from repro_torch.kernels import ops
from repro_torch.launch.mesh import run_ranks
from repro_torch.utils import resolve_device, sync

PARAMS = dict(r_upper=8, r_base=16, ef=48, batch=32, max_layers=3)


def mesh_acts(mesh, segs, queries, coder, levels, entries, workdir: str) -> dict:
    """What every rank runs with ``--ranks``: the two stacked programs, then
    the streaming build across the mesh. Returns the ids, the seconds and
    the kernel launches of all ranks."""
    dev = mesh.device
    params = BuildParams(**PARAMS)
    segs = segs.to(dev)
    sync(dev)
    t0 = time.perf_counter()
    built = seg.make_segmented_build_fn(mesh, params=params)(segs, coder, levels, entries)
    sync(dev)
    build_s = time.perf_counter() - t0
    n_seg, seg_size = segs.shape[:2]
    offsets = np.arange(n_seg) * seg_size
    ids, _ = seg.make_segmented_search_fn(mesh, k=10, ef_search=96)(built, queries, offsets, segs)
    builder = ShardedBuilder(
        ShardConfig(n_segments=n_seg, chunk_size=1024, algo="hnsw", params=params, sample_size=2048),
        mesh=mesh, workdir=workdir, device=dev,
    )
    res = builder.build(segs.reshape(n_seg * seg_size, -1).cpu().numpy())
    out = {"build_s": build_s, "ids": ids, "mode": res.mode, "assign_s": res.wall_assign_s,
           "sharded_build_s": res.wall_build_s, "seg_sizes": list(res.plan.seg_sizes),
           "sharded_ids": res.index.search(queries, k=10, ef=96).ids}
    every = [None] * mesh.size
    torch.distributed.all_gather_object(every, dict(ops.launches))
    out["launches"] = {k: sum(e[k] for e in every) for k in every[0]}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="shared-coder segment builds, fan-out search, sharded streaming build")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--workers", type=int, default=None, help="process pool for the streaming build (default inline)")
    ap.add_argument("--seg-size", type=int, default=2000, help="rows a segment (the reference example's 2,000)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="run the stacked programs and the streaming build on this many ranks, one segment each")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n, d = 4 * args.seg_size, 64
    n_segments = args.ranks or 4
    if n % n_segments:
        raise ValueError(f"{n} rows do not cut into {n_segments} equal segments")
    seg_size = n // n_segments
    data = torch.from_numpy(vector_dataset(0, n=n + 64, d=d, n_clusters=64)).to(dev)
    data, queries = data[:n], data[n:]
    segs = data.reshape(n_segments, seg_size, d)
    params = BuildParams(**PARAMS)
    out = {}

    where = f"{args.ranks} ranks" if args.ranks else str(dev)
    print(f"{n} vectors -> {n_segments} segments of {seg_size} on {where}")
    t0 = time.perf_counter()
    coder = seg.fit_shared_coder(0, data, d_f=32, m_f=16, kmeans_iters=12, device=dev)
    print(f"shared coder fitted in {time.perf_counter() - t0:.1f}s ({coder.code_bytes:.0f} B/vector)")

    levels = np.stack([sample_levels(s, seg_size, r_upper=8, max_layers=3) for s in range(n_segments)])
    entries = np.stack([prefix_entries(levels[s], params.batch) for s in range(n_segments)])
    tids, _ = exact_knn(queries, data, k=10)
    if args.ranks:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            mesh_out = run_ranks(mesh_acts, args.ranks, segs.cpu(), queries.cpu(), [t.cpu() for t in coder],
                                 levels, entries, tmp, device=dev)
        out["ranks_s"] = time.perf_counter() - t0
        out["rank_launches"] = mesh_out["launches"]
        print(f"all segments built in {mesh_out['build_s']:.1f}s (one a rank, {args.ranks} ranks; "
              f"{out['ranks_s']:.1f}s with the ranks' start-up and the streaming build)")
        gids = mesh_out["ids"]
    else:
        sync(dev)
        t0 = time.perf_counter()
        built = seg.build_segments_vmapped(segs, coder, levels, entries, params=params)
        sync(dev)
        dt = time.perf_counter() - t0
        print(f"all segments built in {dt:.1f}s ({dt / n_segments:.1f}s a segment, one after another on one card)")
        gids, _ = seg.search_segments_local(built, queries, np.full(n_segments, seg_size), k=10, ef_search=96,
                                            seg_vectors=segs)
    out["fanout_recall@10"] = recall_at_k(gids.to(dev), tids, 10)
    print(f"fan-out search recall@10 = {out['fanout_recall@10']:.3f}")

    # ---- the serving form: per-segment facades + routed growth ----------
    seg_idx = seg.SegmentedAnnIndex.build(
        segs, algo="hnsw", backend="flash", params=params,
        backend_kwargs=dict(d_f=32, m_f=16, kmeans_iters=12), device=dev,
    )
    res = seg_idx.search(queries, k=10, ef=96)
    out["facade_recall@10"] = recall_at_k(res.ids, tids, 10)
    print(f"facade fan-out recall@10 = {out['facade_recall@10']:.3f}")

    gen = torch.Generator(device=dev).manual_seed(0)
    new_vecs = data[:128] + 0.01 * torch.randn((128, d), generator=gen, device=dev)
    new_gids = seg_idx.add(new_vecs)
    hits = seg_idx.search(new_vecs, k=1, ef=96).ids[:, 0].cpu().numpy() == new_gids
    out["self_hit@1"] = float(hits.mean())
    print(f"routed add of 128 vectors: self-hit@1 = {out['self_hit@1']:.3f} "
          f"(collection now {seg_idx.n_active} vectors)")

    # ---- the streaming form: ShardedBuilder over a chunked source -------
    if args.ranks:
        out["sharded_mode"] = mesh_out["mode"]
        print(f"sharded streaming build ({mesh_out['mode']}): assign {mesh_out['assign_s']:.1f}s, "
              f"build {mesh_out['sharded_build_s']:.1f}s, segments {mesh_out['seg_sizes']}")
        out["sharded_recall@10"] = recall_at_k(mesh_out["sharded_ids"].to(dev), tids, 10)
        print(f"sharded fan-out recall@10 = {out['sharded_recall@10']:.3f}")
        return out
    arr = data.cpu().numpy()

    def chunks():  # zero-arg callable -> a fresh iterator each pass
        for i in range(0, n, 1024):
            yield arr[i:i + 1024]

    with tempfile.TemporaryDirectory() as tmp:
        builder = ShardedBuilder(
            ShardConfig(n_segments=n_segments, chunk_size=1024, algo="hnsw", backend="fp32", params=params,
                        sample_size=2048),
            workers=args.workers, workdir=tmp, device=dev,
        )
        t0 = time.perf_counter()
        plan = builder.assign(chunks)
        t1 = time.perf_counter()
        res = builder.build(plan=plan)
        t2 = time.perf_counter()
        print(f"sharded streaming build ({res.mode}): assign {t1 - t0:.1f}s, build {t2 - t1:.1f}s, "
              f"segments {list(plan.seg_sizes)}")
        out["sharded_recall@10"] = recall_at_k(res.index.search(queries, k=10, ef=96).ids, tids, 10)
        out["sharded_mode"] = res.mode
        print(f"sharded fan-out recall@10 = {out['sharded_recall@10']:.3f}")
    return out


if __name__ == "__main__":
    main()
