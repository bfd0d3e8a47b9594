"""Serving scenario in the PyTorch port: BERT4Rec next-item retrieval behind
the ``repro_torch.serve`` runtime (the counterpart of
``examples/retrieval_serving.py``, at its sizes):

  1. score a request batch three ways (exact dense scan, Flash compact scan
     and rerank, HNSW-Flash graph search) to pick the serving index,
  2. snapshot the index (build once) and load it back (serve forever),
  3. a ``SearchEngine`` pinned to a reranked ``SearchSpec`` and a
     ``Runtime`` (continuous batching with per-request deadlines):
     batched against unbatched QPS and the scan/rerank cost split,
  4. keep serving while the catalog changes: ``Runtime.add()`` lands new
     items as a copy-on-write generation flip,
  5. survive a kill: the same mutations through a durable root (a WAL under
     the handle), a crash at the worst instant (logged, never acked) and a
     boot-time ``recover()`` that replays the tail and serves on.

    PYTHONPATH=src python examples/torch_retrieval_serving.py
    PYTHONPATH=src python examples/torch_retrieval_serving.py --device cpu

The weights are random, as in the reference example: the Flash codes
order items by L2 distance and the dense scan by inner product, and on an
untrained table the two orders share almost nothing, so the two Flash
recall lines read near 0 in both packages.
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch import serve
from repro_torch.core import flash as fl
from repro_torch.graph.backends import FlashBackend
from repro_torch.graph.engine import BuildParams
from repro_torch.index import AnnIndex, SearchSpec
from repro_torch.models.recsys import bert4rec as b4r
from repro_torch.models.recsys import retrieval
from repro_torch.testing import faults
from repro_torch.utils import resolve_device, sync


def _bench(fn, dev, repeats: int = 3) -> float:
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) / repeats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="BERT4Rec retrieval behind the serving runtime")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = b4r.Bert4RecConfig(n_items=50_000, embed_dim=64, n_blocks=2, n_heads=2, seq_len=50)
    model = b4r.Bert4Rec(cfg, gen, device=dev)
    print(f"bert4rec: {cfg.n_items} items, d={cfg.embed_dim}, on {dev}")
    out = {}

    # batched requests: 64 user sessions ending in [MASK]
    items, _ = b4r.sample_training_batch(gen, cfg, 64)
    items[:, -1] = cfg.mask_id
    q = model.serve(items)  # (64, D) query embeddings
    table = model.item_embed.detach()[:cfg.n_items]

    exact = retrieval.score_dense(q, table, k=10)
    t = _bench(lambda: retrieval.score_dense(q, table, k=10), dev)
    print(f"dense scan     : {t * 1e3 / 64:7.3f} ms/req  recall 1.000 "
          f"({cfg.n_items * cfg.embed_dim * 4 / 1e6:.0f} MB scanned)")

    coder = fl.fit_flash(table, d_f=48, m_f=16, kmeans_iters=10, device=dev)
    codes = fl.encode(coder, table)
    fla = retrieval.score_flash(q, coder, codes, table, k=10, rerank=8)
    t = _bench(lambda: retrieval.score_flash(q, coder, codes, table, k=10, rerank=8), dev)
    out["flash_scan_recall@10"] = retrieval.retrieval_recall(fla, exact, 10)
    print(f"flash scan     : {t * 1e3 / 64:7.3f} ms/req  recall {out['flash_scan_recall@10']:.3f} "
          f"({cfg.n_items * coder.code_bytes / 1e6:.0f} MB scanned)")

    # the scan's coder and codes as a prebuilt backend for the facade
    index = AnnIndex.build(table, algo="hnsw", backend=FlashBackend(coder, codes),
                           params=BuildParams(r_upper=8, r_base=16, ef=48, batch=32), device=dev)
    gr = retrieval.search_index(q, index, table, k=10, ef_search=96)
    t = _bench(lambda: retrieval.search_index(q, index, table, k=10, ef_search=96), dev)
    out["hnsw_flash_recall@10"] = retrieval.retrieval_recall(gr, exact, 10)
    print(f"hnsw-flash     : {t * 1e3 / 64:7.3f} ms/req  recall {out['hnsw_flash_recall@10']:.3f} (sub-linear)")

    # ---- build once, serve forever: snapshot + reload -------------------
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "item_index")
        t0 = time.perf_counter()
        serve.save_index(path, index)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        index = serve.load_index(path, device=dev)
        t_load = time.perf_counter() - t0
        print(f"snapshot       : save {t_save:.2f}s, load {t_load:.2f}s, "
              f"{serve.snapshot_bytes(path) / 1e6:.1f} MB on disk (bit-exact restore)")

    # ---- the serving runtime: engine + micro-batching scheduler ---------
    # a quantized scan keeps the best k·4 candidates, an exact rerank on the
    # raw item embeddings restores full-precision order
    spec = SearchSpec(k=10, ef=96, width=4, rerank="exact", rerank_mult=4)
    engine = serve.SearchEngine(index, spec=spec, q_buckets=(1, 8, 32)).warmup()
    n_req = 32
    engine.search(q[:n_req])  # warm the block bucket
    sync(dev)
    t0 = time.perf_counter()
    for i in range(n_req):
        engine.search(q[i])
    sync(dev)
    t_seq = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.search(q[:n_req])
    sync(dev)
    t_block = time.perf_counter() - t0
    print(f"serving        : unbatched {n_req / t_seq:6.0f} qps | batched Q={n_req} {n_req / t_block:6.0f} qps "
          f"({t_seq / t_block:.1f}x)")

    q_np = q.cpu().numpy()
    new_items = table[:256] + 0.01 * torch.randn((256, cfg.embed_dim), generator=gen, device=dev)
    with serve.Runtime(engine=engine, max_wait_ms=2.0) as rt:
        futs = [rt.submit(q_np[i], deadline_ms=500.0) for i in range(n_req)]
        for f in futs:
            f.result(timeout=60)
        st = rt.stats()
        print(f"runtime        : {st['served']} requests -> {st['batches']} dense blocks "
              f"(mean batch {st['mean_batch']:.0f}, deadline 500 ms, shed {st['shed']}, "
              f"e2e p99 {st['p99_ms']:.1f} ms)")
        # the catalog changes while serving: a copy-on-write generation flip
        rt.add(new_items.cpu().numpy()).result(timeout=600)
        final = rt.stats()
        out["cold_dispatches"] = final["cold_dispatches"]
        print(f"cow flip       : generation {final['generation']}, index now {rt.engine.index.n_active} active "
              f"(no rebuild, no coder refit, cold dispatches {final['cold_dispatches']})")

    # ---- kill -> recover -> serve: the durability loop ------------------
    with tempfile.TemporaryDirectory() as td:
        root = os.path.join(td, "durable_index")
        serve.init_durable(root, index)  # checkpoint at LSN 0
        handle, _, _ = serve.attach(root, fsync="batch", checkpoint_every=64, background=False, device=dev)
        with serve.Runtime(handle, engine=engine, max_wait_ms=2.0) as rt:
            rt.add(new_items.cpu().numpy()).result(timeout=600)
            rt.delete([7, 11]).result(timeout=600)
            h = rt.health()
            print(f"durable serve  : {h['wal']['appends']} mutations logged at lsn {handle.last_lsn}, "
                  f"{h['wal']['fsyncs']} fsyncs (group commit: one per flip)")

        # the worst crash instant: a third mutation is logged and fsynced but
        # the process dies before its flip publishes; the caller was never acked
        faults.arm("handle/before_flip")
        try:
            handle.add(new_items[:16].cpu().numpy())
        except faults.FaultInjected:
            pass
        finally:
            faults.disarm()
        handle.wal.close()  # this process's serving state is gone

        result = serve.recover(root, device=dev)  # the next boot
        rec = result.index.search(q[:1], k=10, ef=96)
        out["recovered_active"] = result.index.n_active
        print(f"recovery       : replayed {result.replayed} WAL records over the lsn-{result.checkpoint_lsn} "
              f"checkpoint -> {result.index.n_active} active and serving (top id {int(rec.ids[0, 0])}); the "
              f"unacked in-flight add was replayed too: at-least-once, never a lost ack")

    stats = engine.stats()
    print(f"engine         : p50 {stats['p50_ms']:.1f} ms, p99 {stats['p99_ms']:.1f} ms, "
          f"dispatch keys={stats['compiles']}")
    print(f"pipeline       : rerank={spec.rerank} mult={spec.rerank_mult} -> {stats['n_scan_per_query']:.0f} "
          f"quantized scan + {stats['n_rerank_per_query']:.0f} exact rerank dists/query")
    return out


if __name__ == "__main__":
    main()
