"""Shared GNN substrate: padded graph batches and segment message passing
(reference: ``repro.models.gnn.common``).

Message passing is an edge list (senders, receivers): gathers are
``index_select`` (whose backward is an ``index_add``; ``t[idx]``'s is a
sort-based kernel that took 75% of GatedGCN's device time on the H100)
and scatters into the nodes ``index_add`` for sums (out of place, so no
tensor autograd saved is written) and ``scatter_reduce("amax")`` for
maxima. On the card ``index_add`` adds with atomics, so its float sums are
not in a fixed order there; the CPU path is deterministic.

Graphs are padded to static (n_node_max, n_edge_max); masks carry
validity.

Across ranks (``launch/steps.py``'s GNN cell under a mesh) a batch holds
this rank's slice of the edges and every node (``GraphBatch.edge_axes``:
the ``distributed.collectives.MeshAxes`` the edges are sharded over). The
models then pass node state entering the edges through :func:`to_edges`
(its gradient all-reduced in the backward) and every edge → node
reduction takes ``over=edge_axes`` (partial sums all-reduced; a maximum
across ranks carries no gradient). Node → graph sums stay local: nodes are
replicated. With ``edge_axes`` None (or one rank wide) every function here
is the one-process one. The reference's ``graph_input_specs`` (XLA dry-run stand-ins)
waits for the port's ``launch/dryrun.py`` (ROADMAP queue 1, item 9d).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.utils import resolve_device, to_numpy, tree_leaves, tree_map, tree_paths, tree_unflatten

Params = dict[str, Any]


@dataclasses.dataclass
class GraphBatch:
    """Padded graph (single graph or a batch flattened into one).

    nodes:     (N, F) node features.
    positions: (N, 3) or None — for geometric models.
    edges:     (E, Fe) edge features or None.
    senders:   (E,) int source node of each edge.
    receivers: (E,) int destination node.
    node_mask: (N,) bool.
    edge_mask: (E,) bool.
    graph_id:  (N,) int — sub-graph id per node (batched-molecule readout).
    n_graphs:  int, the number of sub-graphs (a Python int, as the
               reference's static pytree aux data).
    edge_axes: the mesh axes a rank's slice of the edges is one shard of
               (``collectives.MeshAxes``), or None: every edge is here.
    """

    nodes: torch.Tensor
    positions: torch.Tensor | None
    edges: torch.Tensor | None
    senders: torch.Tensor
    receivers: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    graph_id: torch.Tensor
    n_graphs: int
    edge_axes: Any = None

    def _replace(self, **kw) -> "GraphBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "GraphBatch":
        """The same batch with every tensor on ``device``."""
        return self._replace(**{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
                                if isinstance(getattr(self, f.name), torch.Tensor)})


def to_edges(x: torch.Tensor, over=None) -> torch.Tensor:
    """Node state about to be gathered onto this rank's edges: the identity,
    whose gradient is all-reduced over the edge shards ``over``."""
    return x if over is None else over.copy_to(x)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, over=None) -> torch.Tensor:
    """``jax.ops.segment_sum``: (E, …) -> (num_segments, …); ids in range.
    ``over``: the edge shards whose partial sums complete it."""
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype, device=data.device)
    out = out.index_add(0, segment_ids.long(), data)
    return out if over is None else over.reduce_from(out)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, over=None) -> torch.Tensor:
    """``jax.ops.segment_max``: an empty segment gives −inf (the identity
    of max), so the output starts −inf and the reduction leaves it out.
    Across the edge shards ``over`` the maximum carries no gradient."""
    out = torch.full((num_segments, *data.shape[1:]), -math.inf, dtype=data.dtype, device=data.device)
    idx = segment_ids.long().view(-1, *([1] * (data.dim() - 1))).expand_as(data)
    out = out.scatter_reduce(0, idx, data, "amax", include_self=False)
    return out if over is None else over.max(out)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, over=None) -> torch.Tensor:
    """Sum over count, both completed over the edge shards before the divide."""
    s = segment_sum(data, segment_ids, num_segments, over)
    c = segment_sum(torch.ones(data.shape[:1], dtype=torch.float32, device=data.device), segment_ids, num_segments,
                    over)
    return s / torch.clamp_min(c, 1.0).view(-1, *([1] * (data.dim() - 1)))


def scatter_edges_to_nodes(messages: torch.Tensor, receivers: torch.Tensor, n_nodes: int, *,
                           reduce: str = "sum", over=None) -> torch.Tensor:
    """(E, …) messages -> (N, …) aggregated by receiver (over every edge
    shard of ``over``)."""
    if reduce == "sum":
        return segment_sum(messages, receivers, n_nodes, over)
    if reduce == "mean":
        return segment_mean(messages, receivers, n_nodes, over)
    if reduce == "max":
        return segment_max(messages, receivers, n_nodes, over)
    raise ValueError(reduce)


def degree(receivers: torch.Tensor, edge_mask: torch.Tensor, n_nodes: int, over=None) -> torch.Tensor:
    return segment_sum(edge_mask.to(torch.float32), receivers, n_nodes, over)


def edge_param_leaves(params: Params, edge_params: tuple[str, ...]) -> list[bool]:
    """Per leaf of ``params`` (``tree_leaves`` order): whether it acts on
    edges (its path, as ``layers/B``, is or lies under one of
    ``edge_params``), so that its gradient on one rank's edge slice is a
    partial sum over the edge shards. The other leaves act on the
    replicated nodes, and their gradients are whole on every rank."""
    out = []
    for path, _ in tree_paths(params):
        plain = path.replace("['", "").replace("']", "")
        out.append(any(plain == e or plain.startswith(e + "/") for e in edge_params))
    return out


def normal(gen: torch.Generator, shape, device, scale: float = 1.0) -> torch.Tensor:
    """float32 N(0, scale²) drawn from ``gen`` on ``device``."""
    return torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32) * scale


def mlp_init(gen: torch.Generator, sizes, *, device) -> Params:
    """``w{i}`` (sizes[i], sizes[i+1]) N(0, 1/sizes[i]), ``b{i}`` zeros."""
    out = {f"w{i}": normal(gen, (sizes[i], sizes[i + 1]), device, 1.0 / np.sqrt(sizes[i]))
           for i in range(len(sizes) - 1)}
    out.update({f"b{i}": torch.zeros((sizes[i + 1],), dtype=torch.float32, device=device)
                for i in range(len(sizes) - 1)})
    return out


def mlp_apply(p: Params, x: torch.Tensor, *, act=F.silu, final_act: bool = False) -> torch.Tensor:
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def radial_basis(r: torch.Tensor, *, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Bessel-style radial basis with a smooth cutoff (NequIP's embedding):
    √(2/c)·sin(nπr/c)/max(r, 1e-6) times the p = 6 polynomial envelope."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    scale = torch.sqrt(torch.tensor(2.0 / cutoff, dtype=torch.float32))  # jnp.sqrt of a float32
    rb = scale.to(r.device) * torch.sin(n * np.pi * r[..., None] / cutoff) / torch.clamp_min(r[..., None], 1e-6)
    u = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1 - 28 * u**6 + 48 * u**7 - 21 * u**8
    return rb * env[..., None]


def random_graph_batch(gen: torch.Generator, *, n_nodes: int, n_edges: int, d_feat: int,
                       with_positions: bool = False, d_edge: int = 0, n_graphs: int = 1,
                       device: str | torch.device = "cuda") -> GraphBatch:
    """Synthetic padded graph batch drawn from ``gen`` (on ``device``): the
    reference's distributions (node features N(0, 1), uniform endpoints,
    positions N(0, 2²)), not its bits."""
    dev = resolve_device(device)
    nodes = normal(gen, (n_nodes, d_feat), dev)
    senders = torch.randint(0, n_nodes, (n_edges,), generator=gen, device=dev, dtype=torch.int32)
    receivers = torch.randint(0, n_nodes, (n_edges,), generator=gen, device=dev, dtype=torch.int32)
    positions = normal(gen, (n_nodes, 3), dev, 2.0) if with_positions else None
    edges = normal(gen, (n_edges, d_edge), dev) if d_edge else None
    per = n_nodes // n_graphs
    graph_id = torch.clamp_max(torch.arange(n_nodes, device=dev) // max(per, 1), n_graphs - 1)
    return GraphBatch(
        nodes=nodes, positions=positions, edges=edges, senders=senders, receivers=receivers,
        node_mask=torch.ones((n_nodes,), dtype=torch.bool, device=dev),
        edge_mask=torch.ones((n_edges,), dtype=torch.bool, device=dev),
        graph_id=graph_id.to(torch.int32), n_graphs=n_graphs,
    )


def pad_graph(g: GraphBatch, n_nodes: int, n_edges: int) -> GraphBatch:
    """``g`` padded to (n_nodes, n_edges): padding nodes are zero, masked
    and in the last sub-graph; padding edges run 0 → 0 and are masked."""
    dn, de = n_nodes - g.nodes.shape[0], n_edges - g.senders.shape[0]
    if dn < 0 or de < 0:
        raise ValueError(f"cannot pad a ({g.nodes.shape[0]}, {g.senders.shape[0]}) graph to ({n_nodes}, {n_edges})")

    def grow(t, extra, value=0):
        if t is None:
            return None
        return torch.cat([t, torch.full((extra, *t.shape[1:]), value, dtype=t.dtype, device=t.device)])

    return g._replace(nodes=grow(g.nodes, dn), positions=grow(g.positions, dn), edges=grow(g.edges, de),
                      senders=grow(g.senders, de), receivers=grow(g.receivers, de),
                      node_mask=grow(g.node_mask, dn, False), edge_mask=grow(g.edge_mask, de, False),
                      graph_id=grow(g.graph_id, dn, g.n_graphs - 1))


# ---------------------------------------------------------------------------
# Weight carry-over
# ---------------------------------------------------------------------------


def params_from_jax(tree_np: Params, device: str | torch.device = "cuda") -> Params:
    """A reference ``init_*`` tree (numpy or JAX float32 arrays; Equiformer's
    ``w_mr`` a list) as tensors on ``device``, bit for bit, the structure
    kept."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree_np)


def params_to_jax(params: Params) -> Params:
    """The inverse of :func:`params_from_jax`: numpy arrays, bit for bit."""
    return tree_map(to_numpy, params)


def stack_layers(layers: list[Params]) -> Params:
    """Per-layer trees stacked on a leading axis (``tree_map(jnp.stack)``)."""
    per = [tree_leaves(lp) for lp in layers]
    return tree_unflatten(layers[0], [torch.stack(xs) for xs in zip(*per)])


def unstack_layers(stacked: Params):
    """The layers of a stacked tree, in order: each leaf ``unbind``-ed once
    (the backward of one ``stack``, not a zero tensor the size of the
    stacked leaf per layer)."""
    per_leaf = [torch.unbind(t, 0) for t in tree_leaves(stacked)]
    for i in range(len(per_leaf[0])):
        yield tree_unflatten(stacked, [views[i] for views in per_leaf])
