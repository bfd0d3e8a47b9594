"""Quickstart for the PyTorch port: the ``repro_torch.index`` facade —
build, search and grow an ANN index (the counterpart of
``examples/quickstart.py``, at its sizes).

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Builds the same HNSW graph with full-precision distances and with Flash
compact codes (the paper's core trade), then grows it: ``add()`` inserts
into the frozen graph at a fraction of a rebuild's distance evaluations,
``delete()`` tombstones without disconnecting anything.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.data.synthetic import vector_dataset
from repro_torch.graph.engine import BuildParams
from repro_torch.index import AnnIndex, exact_knn, recall_at_k
from repro_torch.utils import resolve_device, sync


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="HNSW over fp32 and Flash codes: build, search, add, delete")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n, m, d = 6000, 1500, 96  # base build + a 25% growth batch
    data = torch.from_numpy(vector_dataset(0, n=n + m + 100, d=d, n_clusters=64)).to(dev)
    base, extra, queries = data[:n], data[n:n + m], data[n + m:]
    params = BuildParams(r_upper=8, r_base=16, ef=48, batch=32, max_layers=3)

    print(f"dataset: {n} x {d} float32 (+{m} to add later) on {dev}")
    tids, _ = exact_knn(queries, base, k=10)
    out = {}
    for kind, kw in [("fp32", {}), ("flash_blocked", dict(d_f=48, m_f=16, l_f=4, h=8, kmeans_iters=12))]:
        sync(dev)
        t0 = time.perf_counter()
        index = AnnIndex.build(base, algo="hnsw", backend=kind, params=params, backend_kwargs=kw, device=dev)
        sync(dev)
        t_build = time.perf_counter() - t0
        res = index.search(queries, k=10, ef=96, rerank=(kind != "fp32"))
        rec = recall_at_k(res.ids, tids, 10)
        nd_build = float(index.last_stats.n_dists)
        print(f"{kind:14s} build {t_build:6.1f}s ({nd_build:.2e} dists)  recall@10 {rec:.3f}")
        out[f"{kind}_recall@10"] = rec

    # ---- dynamic maintenance on the Flash-blocked index -----------------
    sync(dev)
    t0 = time.perf_counter()
    add_stats = index.add(extra)  # no rebuild, no coder refit
    sync(dev)
    t_add = time.perf_counter() - t0
    tids_all, _ = exact_knn(queries, data[:n + m], k=10)
    rec_add = recall_at_k(index.search(queries, k=10, ef=96).ids, tids_all, 10)
    print(f"add {m} vectors  {t_add:6.1f}s ({float(add_stats.n_dists):.2e} dists, "
          f"{float(add_stats.n_dists) / nd_build:.0%} of the base build)  recall@10 {rec_add:.3f}")

    victims = tids_all[:, 0].cpu().numpy()  # every query's true top-1
    index.delete(victims)
    res = index.search(queries, k=10, ef=96)
    leaked = int(np.isin(res.ids.cpu().numpy(), victims).sum())
    print(f"delete {len(np.unique(victims))} vectors: tombstones returned = {leaked} "
          f"(active {index.n_active}/{index.n})")
    out.update({"add_recall@10": rec_add, "tombstones_returned": leaked})
    return out


if __name__ == "__main__":
    main()
