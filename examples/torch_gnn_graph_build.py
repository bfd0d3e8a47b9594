"""Molecular kNN-graph construction through the Flash index, feeding a
GNN, in the PyTorch port (the counterpart of
``examples/gnn_graph_build.py``).

Geometric GNNs (NequIP, EGNN, Equiformer) consume radius or kNN graphs
over atom environments, and building that graph is an ANN problem: the
environment descriptors (stand-ins for SOAP features) are indexed with
HNSW-Flash, searched for their own k + 1 neighbours, and the kNN graph
feeds an EGNN energy model.

    PYTHONPATH=src python examples/torch_gnn_graph_build.py
    PYTHONPATH=src python examples/torch_gnn_graph_build.py --device cpu --atoms 500
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.graph.engine import BuildParams
from repro_torch.index import AnnIndex, exact_knn
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.models.gnn.egnn import EGNNConfig, egnn_forward, init_egnn
from repro_torch.utils import resolve_device, sync

EGNN_CFG = EGNNConfig(n_layers=2, d_hidden=16, d_in=8)


def knn_graph_energy(n_atoms: int = 4000, d_desc: int = 48, k: int = 8, *, seed: int = 0,
                     device: str | torch.device = "cuda") -> dict:
    """Build the kNN graph over ``n_atoms`` random descriptors with
    HNSW-Flash, score its edges against exact kNN and run EGNN on it.
    Returns the index, the descriptors, the graph, the EGNN weights and
    energy, the edge agreement and the ANN seconds."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    positions = torch.from_numpy((rng.normal(size=(n_atoms, 3)) * 5).astype(np.float32)).to(dev)
    desc = torch.from_numpy(rng.normal(size=(n_atoms, d_desc)).astype(np.float32)).to(dev)

    sync(dev)
    t0 = time.perf_counter()
    index = AnnIndex.build(desc, algo="hnsw", backend="flash",
                           params=BuildParams(r_upper=8, r_base=16, ef=48, batch=32),
                           backend_kwargs=dict(d_f=32, m_f=16, kmeans_iters=10), device=dev)
    res = index.search(desc, k=k + 1, ef=64, rerank=True)
    sync(dev)
    t_ann = time.perf_counter() - t0
    nbrs = res.ids[:, 1:].long()  # drop self

    tids, _ = exact_knn(desc, desc, k=k + 1)
    overlap = float((nbrs[:, :, None] == tids[:, None, 1:].long()).any(-1).to(torch.float64).mean())

    senders = nbrs.reshape(-1)
    g = GraphBatch(nodes=desc[:, :8], positions=positions, edges=None, senders=senders.to(torch.int32),
                   receivers=torch.arange(n_atoms, device=dev).repeat_interleave(k).to(torch.int32),
                   node_mask=torch.ones((n_atoms,), dtype=torch.bool, device=dev), edge_mask=senders >= 0,
                   graph_id=torch.zeros((n_atoms,), dtype=torch.int32, device=dev), n_graphs=1)
    params = init_egnn(torch.Generator(device=dev).manual_seed(seed), EGNN_CFG, device=dev)
    with torch.no_grad():
        energy, _ = egnn_forward(params, g, EGNN_CFG)
    return {"index": index, "desc": desc, "exact_ids": tids, "graph": g, "params": params, "energy": energy,
            "overlap": overlap, "ann_s": t_ann}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="HNSW-Flash kNN graph feeding EGNN")
    ap.add_argument("--atoms", type=int, default=4000)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = knn_graph_energy(args.atoms, device=args.device)
    print(f"kNN graph via HNSW-Flash: {out['ann_s']:.1f}s, "
          f"edge agreement with exact kNN = {out['overlap']:.3f}")
    energy = out["energy"]
    print(f"EGNN on the built graph -> energy {float(energy[0, 0]):+.4f} "
          f"(finite: {bool(torch.isfinite(energy).all())})")
    return out


if __name__ == "__main__":
    main()
