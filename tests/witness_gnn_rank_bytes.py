"""What one rank of the edge-sharded GNN step holds, reckoned from the
code's tensor shapes (no run at the cells' sizes): the cells one 80 GB
card cannot hold.

    PYTHONPATH=src python tests/witness_gnn_rank_bytes.py

For GatedGCN on ``ogb_products`` and Equiformer-v2 on ``minibatch_lg`` at
its 1,024 seeds, both at their full configs: one loss forward on a small
graph at full width (257 nodes, 769 edges: sizes no weight dimension
shares) under ``torch.autograd.graph.saved_tensors_hooks`` records every
tensor autograd keeps for the backward, each storage once, and sorts the
bytes by the tensor's leading dimension: an edge's, a node's, or other
(weights). Per edge and per node they scale to the cell's padded sizes
(``launch/steps.gnn_padded_sizes``): a rank holds its 1/r of the edges'
bytes and all of the nodes' (nodes are replicated), plus the weights four
times (parameters, gradients, two AdamW moments), the graph's inputs and
the cell's node features. The saved bytes are a floor of the step's peak
(the backward's own temporaries come on top). Prints one JSON line per
cell with the per-rank GB at 1, 2, 4 and 8 ranks.
"""

from __future__ import annotations

import json
import sys

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.launch import steps as st
from repro_torch.models.gnn.common import random_graph_batch
from repro_torch.utils import tree_bytes

SMALL_NODES, SMALL_EDGES = 257, 769
CELLS = (("gatedgcn", "ogb_products", None), ("equiformer-v2", "minibatch_lg", 1024))
RANKS = (1, 2, 4, 8)


def saved_bytes(arch: str, shape) -> dict:
    """Bytes autograd saves for one loss forward on the small graph, per
    edge, per node and other."""
    cfg = st.gnn_adapt_config(get_arch(arch).make_full(), shape)
    gen = torch.Generator().manual_seed(0)
    g = random_graph_batch(gen, n_nodes=SMALL_NODES, n_edges=SMALL_EDGES, d_feat=shape.dims["d_feat"],
                           with_positions=arch != "gatedgcn", device="cpu")
    params = st.gnn_init(cfg, gen, device="cpu")
    params = {k: v for k, v in params.items()}
    leaves = [p.requires_grad_(True) for p in _leaves(params)]
    labels = st._labels(cfg, SMALL_NODES, 1, gen, torch.device("cpu"))
    seen: dict = {}

    def pack(t):
        key = (t.untyped_storage().data_ptr(), t.untyped_storage().nbytes())
        if key not in seen:
            lead = t.shape[0] if t.dim() else 0
            seen[key] = ("edge" if lead == SMALL_EDGES else "node" if lead == SMALL_NODES else "other",
                         t.untyped_storage().nbytes())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = st.gnn_loss_fn(cfg)(params, {"graph": g, "labels": labels})
    assert loss.requires_grad and leaves
    by = {"edge": 0, "node": 0, "other": 0}
    for kind, nbytes in seen.values():
        by[kind] += nbytes
    return {"cfg": cfg, "per_edge": by["edge"] / SMALL_EDGES, "per_node": by["node"] / SMALL_NODES,
            "params_bytes": tree_bytes(params)}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def main() -> int:
    for arch, cell, seeds in CELLS:
        shape = next(s for s in get_arch(arch).shapes if s.name == cell)
        d = shape.dims
        n_nodes, n_edges = d["n_nodes"], d["n_edges"]
        if seeds is not None:  # minibatch_lg's sampled subgraph at this many seeds (fanout 15-10)
            n_nodes, n_edges = seeds * (1 + 15 + 150), seeds * (15 + 150)
        n_pad, e_pad = st.gnn_padded_sizes(n_nodes, n_edges)
        s = saved_bytes(arch, shape)
        geometric = arch != "gatedgcn"
        node_inputs = n_pad * (4 * d["d_feat"] + (12 if geometric else 0) + 1 + 4)  # features, positions, mask, id
        edge_inputs = e_pad * (4 + 4 + 1)  # senders, receivers, mask
        per_rank = {}
        for r in RANKS:
            edges = s["per_edge"] * e_pad / r
            nodes = s["per_node"] * n_pad
            total = edges + nodes + 4 * s["params_bytes"] + node_inputs + edge_inputs / r
            per_rank[r] = {"edge_activations_gb": edges / 1e9, "node_activations_gb": nodes / 1e9,
                           "total_gb": total / 1e9}
        print(json.dumps({"arch": arch, "cell": cell, "seeds": seeds, "nodes_padded": n_pad, "edges_padded": e_pad,
                          "layers": s["cfg"].n_layers, "saved_bytes_per_edge": s["per_edge"],
                          "saved_bytes_per_node": s["per_node"], "params_gb": s["params_bytes"] / 1e9,
                          "per_rank": per_rank}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
