"""Neighbour sampler for sampled-subgraph GNN training (``minibatch_lg``),
reference: ``repro.data.sampler``.

GraphSAGE-style fanout sampling over a host-side CSR graph, in numpy: the
part of a GNN system that never runs on the card. Output is a padded
edge-list subgraph of static shape.

Layout (fanouts = [f1, f2], B seeds):
  layer-0 nodes: the B seeds
  layer-1:       ≤ B·f1 sampled neighbours
  layer-2:       ≤ B·f1·f2
  edges point sampled neighbour → parent (messages flow to the seeds).

The draws are the reference's (one ``rng.choice`` per parent with
neighbours, in order), so both packages give equal arrays from one
generator; the bookkeeping around them is vectorised.
"""

from __future__ import annotations

import numpy as np


def sample_subgraph(indptr: np.ndarray, indices: np.ndarray, seeds: np.ndarray, *, fanouts: list[int],
                    rng: np.random.Generator) -> dict:
    """Padded arrays: node_ids (N_max,) int64 (−1 past the sampled nodes),
    senders, receivers (E_max,) int32, node_mask, edge_mask, and n_seeds.
    N_max / E_max are the worst-case sizes of the fanout spec."""
    seeds = np.asarray(seeds, np.int64)
    nodes = [seeds]
    send_l, recv_l = [], []
    n_all = len(seeds)
    parents, local_of_parent = seeds, np.arange(len(seeds))
    for f in fanouts:
        takes, owners = [], []
        for pi, p in enumerate(parents):
            nbrs = indices[indptr[p]:indptr[p + 1]]
            if len(nbrs) == 0:
                continue
            takes.append(rng.choice(nbrs, size=min(f, len(nbrs)), replace=False))
            owners.append(np.full(len(takes[-1]), local_of_parent[pi], np.int64))
        new = np.concatenate(takes).astype(np.int64) if takes else np.zeros(0, np.int64)
        send_l.append(n_all + np.arange(len(new)))
        recv_l.append(np.concatenate(owners) if owners else np.zeros(0, np.int64))
        nodes.append(new)
        parents, local_of_parent = new, n_all + np.arange(len(new))
        n_all += len(new)

    b = len(seeds)
    n_max, e_max, width = b, 0, b
    for f in fanouts:
        width *= f
        n_max += width
        e_max += width
    all_nodes = np.concatenate(nodes)
    send, recv = np.concatenate(send_l), np.concatenate(recv_l)
    node_ids = np.full(n_max, -1, np.int64)
    node_ids[:n_all] = all_nodes
    senders = np.zeros(e_max, np.int32)
    receivers = np.zeros(e_max, np.int32)
    senders[:len(send)] = send
    receivers[:len(recv)] = recv
    edge_mask = np.zeros(e_max, bool)
    edge_mask[:len(send)] = True
    return {"node_ids": node_ids, "senders": senders, "receivers": receivers, "node_mask": node_ids >= 0,
            "edge_mask": edge_mask, "n_seeds": b}


def minibatch_stream(indptr, indices, features, labels, *, batch_nodes: int, fanouts: list[int], seed: int = 0):
    """Infinite deterministic generator of padded subgraph batches: step s
    draws from ``default_rng((seed, s))``. ``features`` and ``labels`` are
    indexed with numpy's rules (a numpy array, or anything that takes a
    numpy index array)."""
    n = len(indptr) - 1
    step = 0
    while True:
        rng = np.random.default_rng((seed, step))
        seeds = rng.choice(n, size=batch_nodes, replace=False)
        sub = sample_subgraph(indptr, indices, seeds, fanouts=fanouts, rng=rng)
        safe = np.where(sub["node_ids"] >= 0, sub["node_ids"], 0)
        yield {**sub, "features": features[safe], "labels": labels[seeds]}
        step += 1
