"""Step construction per (architecture × input shape): the reference's
``repro.launch.steps`` on one card.

``build_bundle(arch, shape)`` gives every cell of
``registry.assigned_cells()`` its ``StepBundle``: the step ``fn`` (an LM
train, prefill or decode step, a GNN train step, or one of BERT4Rec's
train, ``serve_p99``, ``serve_bulk`` and ``retrieval_cand`` steps), its
``args`` as meta tensors of the reference's shapes and dtypes (nothing is
allocated), the positions it updates in place and the reference's model
FLOPs. ``flash-ann``'s cells are not steps (``graph/segmented.py`` runs
them).

Under a mesh (``build_bundle(..., mesh=...)``, a ``launch.mesh.Mesh`` of
``torch.distributed`` ranks) a bundle also states its shardings, the
reference's, as ``in_specs`` / ``out_specs`` in the form
``train.elastic.reshard_for_mesh`` takes, and ``fn`` runs on every rank
over that rank's shards, computing what the unsharded step computes: the
collectives GSPMD inserts into the reference's programs are written out
(``distributed.collectives``). BERT4Rec is tensor-parallel over
``"model"`` (the item table by rows, attention by heads, the MLP by hidden
columns) with sessions over the batch axes; ``retrieval_cand`` runs one
``flash_scan`` per rank over its rows of the candidate codes. A GNN step
shards the edges over the batch axes and ``"model"`` and replicates the
nodes (``shard_graph``). The LM cells of the GQA models are tensor- and
expert-parallel over ``"model"`` with the batch over the batch axes, as
``transformer.LMShards`` runs them: the train cell with both Adam moments
sharded as the parameters (:func:`lm_state_specs`), the prefill and decode
cells with the caches' sequence over ``"model"`` (decode below a batch of
8: over every axis); an MLA model's cells are ROADMAP queue 1, item 7.8.

The FLOPs are the reference's analytic counts: 6·N_active per trained
token, 2·N_active per prefilled token, a decode step's 2·N_active per
row plus attention against the whole cache, a GNN step's
6·edges·d_h²·layers, and BERT4Rec's encoder and table products.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.registry import ShapeSpec, get_arch
from repro_torch.distributed.collectives import MeshAxes
from repro_torch.kernels import ops
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import egnn, equiformer_v2, gatedgcn, nequip
from repro_torch.models.gnn.common import GraphBatch, edge_param_leaves, pad_graph, random_graph_batch
from repro_torch.models.gnn.egnn import EGNNConfig, egnn_loss, init_egnn
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config, equiformer_v2_loss, init_equiformer_v2
from repro_torch.models.gnn.gatedgcn import GatedGCNConfig, gatedgcn_loss, init_gatedgcn
from repro_torch.models.gnn.nequip import NequIPConfig, init_nequip, nequip_loss
from repro_torch.models.recsys import bert4rec as b4r
from repro_torch.train.elastic import reshard_for_mesh
from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw_init
from repro_torch.train.train_loop import TrainConfig, make_train_step
from repro_torch.utils import resolve_device, round_up, topk_first, tree_leaves, tree_unflatten


@dataclass
class StepBundle:
    """One cell's program. ``args`` are meta tensors (PyTorch's
    ``ShapeDtypeStruct``) of the reference's shapes and dtypes, in ``fn``'s
    argument order; ``donate`` the positions ``fn`` updates in place;
    ``model_flops`` the reference's analytic count. ``fn`` runs where its
    inputs lie.

    Under a mesh, ``in_specs`` holds each argument's spec tree and
    ``out_specs`` each output's (per leaf a ``PartitionSpec``-like tuple;
    a prefix of the tree, as ``train.elastic.map_with_specs`` takes; a
    graph batch's a dict of its fields, which ``shard_graph`` places);
    ``fn`` runs on every rank over the shards
    ``reshard_for_mesh(arg, spec, mesh)`` gives it, and
    ``train.elastic.gather_from_mesh`` puts its outputs back together.
    Both are None without a mesh."""

    name: str
    fn: Callable
    args: tuple
    donate: tuple = ()
    model_flops: float = 0.0
    in_specs: tuple | None = None
    out_specs: tuple | None = None


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _init_meta(init, cfg):
    """``init(gen, cfg, device="meta")``'s tree: shapes and dtypes alone."""
    return init(torch.Generator(), cfg, device="meta")


def _train_fn(loss_fn, opt: AdamWConfig, keys: tuple, *, microbatches: int = 1, **mesh_kw):
    """fn(params, opt_state, *batch) -> (params, opt_state, metrics): the
    donated ``make_train_step`` over a batch whose leaves are named
    ``keys``, as the reference's bundles lay out a train step; with
    ``microbatches`` > 1 the batch's leading axis is split into that many
    microbatches. ``mesh_kw``: ``make_train_step``'s ``sync``, ``mesh`` and
    ``specs`` for a step on one rank of a mesh."""
    step = make_train_step(loss_fn, TrainConfig(opt=opt, microbatches=microbatches), donate=True, **mesh_kw)

    def train_step(params, opt_state, *batch):
        if microbatches > 1:
            batch = [x.reshape(microbatches, -1, *x.shape[1:]) for x in batch]
        state, metrics = step({"params": params, "opt_state": opt_state}, dict(zip(keys, batch)))
        return state["params"], state["opt_state"], metrics

    return train_step


def _sum_leaves(axes: MeshAxes, grads, picked: list[bool]):
    """``grads`` with the picked leaves summed over ``axes`` (one all-reduce)."""
    leaves = tree_leaves(grads)
    summed = iter(axes.sum_leaves([g for g, p in zip(leaves, picked) if p]))
    return tree_unflatten(grads, [next(summed) if p else g for g, p in zip(leaves, picked)])


def lm_opt_cfg(cfg: tfm.TransformerConfig) -> AdamWConfig:
    """AdamW with bfloat16 moments above 5e10 parameters, else float32
    (``_lm_opt_cfg``, ``launch/steps.py:81-83``)."""
    return AdamWConfig(state_dtype="bf16" if cfg.param_count() > 5e10 else "f32")


def lm_loss_fn(cfg: tfm.TransformerConfig, shards: tfm.LMShards | None = None):
    """(params, batch) -> (loss, metrics): ``lm_loss`` over a batch's
    ``tokens`` and ``labels`` (on one rank of a mesh with ``shards``)."""
    return lambda params, batch: tfm.lm_loss(params, cfg, batch["tokens"], batch["labels"], shards=shards)


def lm_train_step(cfg: tfm.TransformerConfig, tc: TrainConfig, *, donate: bool = False):
    """step(state_tree, batch) -> (state_tree, metrics): ``make_train_step``
    over ``lm_loss`` (``lm_train_bundle``'s step, ``launch/steps.py:103-137``)."""
    return make_train_step(lm_loss_fn(cfg), tc, donate=donate)


def lm_train_flops(cfg: tfm.TransformerConfig, batch: int, seq: int) -> float:
    """6·N_active·tokens, MoE counting its activated experts alone
    (``launch/steps.py:132``)."""
    return 6.0 * cfg.active_param_count() * batch * seq


def lm_prefill_flops(cfg: tfm.TransformerConfig, batch: int, seq: int) -> float:
    """The forward alone, 2·N_active·tokens (``launch/steps.py:162``)."""
    return 2.0 * cfg.active_param_count() * batch * seq


def lm_decode_flops(cfg: tfm.TransformerConfig, batch: int, s_max: int) -> float:
    """One token per row: 2·N_active per row plus attention against the
    whole cache (``launch/steps.py:219-226``)."""
    if cfg.attn == "mla":
        attn = 2.0 * batch * s_max * cfg.n_heads * (cfg.kv_lora_rank * 2 + cfg.qk_rope_dim) * cfg.n_layers
    else:
        attn = 4.0 * batch * s_max * cfg.n_heads * cfg.head_dim * cfg.n_layers
    return 2.0 * cfg.active_param_count() * batch + attn


def lm_state_specs(cfg: tfm.TransformerConfig) -> tuple:
    """(parameter specs, optimizer-state specs): ``lm_param_specs`` and both
    Adam moments sharded as the parameters, the step replicated
    (``_lm_state_specs``, ``launch/steps.py:97-100``). The moments' dtype
    is ``lm_opt_cfg``'s (bfloat16 for qwen2-72b)."""
    pspecs = tfm.lm_param_specs(cfg)
    return pspecs, AdamWState(step=(), mu=pspecs, nu=pspecs)


def lm_train_bundle(cfg: tfm.TransformerConfig, shape: ShapeSpec, mesh=None) -> StepBundle:
    """``lm_train_bundle`` (``launch/steps.py:103-137``): (params,
    opt_state, tokens, labels), ``lm_opt_cfg``'s moments. Under ``mesh``
    (GQA models): parameters and moments by :func:`lm_state_specs`, tokens
    and labels by rows over the batch axes (the reference's shardings,
    ``:117-127``); each rank's loss and gradients, its part of the global
    batch's (``transformer.lm_loss``), are summed over the batch axes, and
    the clipping norm is global."""
    b, s = shape.dims["global_batch"], shape.dims["seq_len"]
    opt = lm_opt_cfg(cfg)
    params = _init_meta(tfm.init_lm, cfg)
    tok = _meta((b, s), torch.int32)
    args = (params, adamw_init(params, state_dtype=opt.state_dtype), tok, tok)
    keys = ("tokens", "labels")
    if mesh is None:
        return StepBundle(f"{cfg.name}:train", _train_fn(lm_loss_fn(cfg), opt, keys), args, donate=(0, 1),
                          model_flops=lm_train_flops(cfg, b, s))
    tfm.require_gqa(cfg, shape.name)
    ba = batch_axes(mesh)
    shards = tfm.LMShards(mesh)
    pspecs, ospecs = lm_state_specs(cfg)
    rows = shards.rows
    fn = _train_fn(lm_loss_fn(cfg, shards), opt, keys, mesh=mesh, specs=pspecs,
                   sync=lambda loss, g: (rows.sum(loss), _sum_leaves(rows, g, [True] * len(tree_leaves(g)))))
    return StepBundle(f"{cfg.name}:train", fn, args, donate=(0, 1), model_flops=lm_train_flops(cfg, b, s),
                      in_specs=(pspecs, ospecs, (ba, None), (ba, None)), out_specs=(pspecs, ospecs, None))


def fix_axes(spec: tuple, mesh) -> tuple:
    """``spec`` without the axes ``mesh`` lacks (one pod: no ``"pod"``); a
    tuple of names keeps the names it has, or becomes None
    (``_fix_axes``, ``launch/steps.py:169-181``)."""
    fixed = []
    for entry in spec:
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in mesh.axis_names)
            fixed.append(kept or None)
        else:
            fixed.append(entry if entry is None or entry in mesh.axis_names else None)
    return tuple(fixed)


def _lm_cache_specs(caches: dict, lead: tuple) -> dict:
    """Every cache (L, B, S, …) by ``lead`` over its first three dims."""
    return {k: lead + (None,) * (v.ndim - 3) for k, v in caches.items()}


def lm_prefill_bundle(cfg: tfm.TransformerConfig, shape: ShapeSpec, mesh=None) -> StepBundle:
    """(params, tokens) -> (last logits, caches) (``launch/steps.py:140-165``).
    Under ``mesh``: parameters by ``lm_param_specs``, tokens by rows over
    the batch axes, the logits whole on every rank and the caches (L, B,
    S, …) with the batch over the batch axes and the sequence over
    ``"model"``."""
    b, s = shape.dims["global_batch"], shape.dims["seq_len"]
    args = (_init_meta(tfm.init_lm, cfg), _meta((b, s), torch.int32))
    if mesh is None:
        return StepBundle(f"{cfg.name}:prefill", lambda params, tokens: tfm.lm_prefill(params, cfg, tokens), args,
                          model_flops=lm_prefill_flops(cfg, b, s))
    tfm.require_gqa(cfg, shape.name)
    ba = batch_axes(mesh)
    shards = tfm.LMShards(mesh)
    caches = tfm.make_caches(cfg, b, s, device="meta")
    return StepBundle(
        f"{cfg.name}:prefill", lambda params, tokens: tfm.lm_prefill(params, cfg, tokens, shards=shards), args,
        model_flops=lm_prefill_flops(cfg, b, s), in_specs=(tfm.lm_param_specs(cfg), (ba, None)),
        out_specs=((), _lm_cache_specs(caches, (None, ba, "model"))),
    )


def lm_decode_bundle(cfg: tfm.TransformerConfig, shape: ShapeSpec, mesh=None) -> StepBundle:
    """(params, caches, token, pos) -> (logits, caches written in place)
    (``launch/steps.py:183-233``). Under ``mesh``: batched decode (a batch
    of 8 or more) puts the batch over the batch axes and the caches'
    sequence over ``"model"``; long context puts the sequence over every
    axis and gives every rank every token; the logits come back whole."""
    b, s_max = shape.dims["global_batch"], shape.dims["seq_len"]
    caches = tfm.make_caches(cfg, b, s_max, device="meta")
    args = (_init_meta(tfm.init_lm, cfg), caches, _meta((b,), torch.int32), _meta((), torch.int32))
    if mesh is None:
        return StepBundle(
            f"{cfg.name}:decode",
            lambda params, caches, token, pos: tfm.lm_decode_step(params, cfg, caches, token, pos), args,
            donate=(1,), model_flops=lm_decode_flops(cfg, b, s_max),
        )
    tfm.require_gqa(cfg, shape.name)
    long_ctx = b < 8
    ba = batch_axes(mesh)
    shards = tfm.LMShards(mesh, long_context=long_ctx)
    cache_sp = _lm_cache_specs(caches, (None, None, mesh.axis_names) if long_ctx else (None, ba, "model"))
    return StepBundle(
        f"{cfg.name}:decode",
        lambda params, caches, token, pos: tfm.lm_decode_step(params, cfg, caches, token, pos, shards=shards),
        args, donate=(1,), model_flops=lm_decode_flops(cfg, b, s_max),
        in_specs=(tfm.lm_param_specs(cfg), cache_sp, () if long_ctx else (ba,), ()), out_specs=((), cache_sp),
    )


# ---------------------------------------------------------------------------
# GNN family (``launch/steps.py:238-324``)
# ---------------------------------------------------------------------------

_GNN_FNS = {
    GatedGCNConfig: (init_gatedgcn, gatedgcn_loss),
    EGNNConfig: (init_egnn, egnn_loss),
    NequIPConfig: (init_nequip, nequip_loss),
    EquiformerV2Config: (init_equiformer_v2, equiformer_v2_loss),
}
#: each arch's parameters that act on edges: on one rank's edge slice their
#: gradients are partial sums
_GNN_EDGE_PARAMS = {
    GatedGCNConfig: gatedgcn.EDGE_PARAMS,
    EGNNConfig: egnn.EDGE_PARAMS,
    NequIPConfig: nequip.EDGE_PARAMS,
    EquiformerV2Config: equiformer_v2.EDGE_PARAMS,
}
GNN_NODE_PAD = 512  # nodes padded to a multiple of this
GNN_EDGE_PAD = 512 * 8  # edges padded to a multiple of this


def gnn_adapt_config(cfg, shape: ShapeSpec):
    """Bind the dataset's width (d_feat → d_in) into GatedGCN's and EGNN's
    configs; NequIP and Equiformer read the species from ``nodes[:, 0]``."""
    if isinstance(cfg, (GatedGCNConfig, EGNNConfig)):
        return dataclasses.replace(cfg, d_in=shape.dims["d_feat"])
    return cfg


def gnn_padded_sizes(n_nodes: int, n_edges: int) -> tuple[int, int]:
    """The bundle's static sizes: nodes up to a multiple of 512, edges of
    4,096."""
    return round_up(n_nodes, GNN_NODE_PAD), round_up(n_edges, GNN_EDGE_PAD)


def gnn_init(cfg, gen: torch.Generator, *, device: str | torch.device = "cuda"):
    """The arch's parameters (its ``init_*``) drawn from ``gen``."""
    return _GNN_FNS[type(cfg)][0](gen, cfg, device=device)


def gnn_loss_fn(cfg):
    """(params, batch) -> (loss, {}): the arch's loss over a batch's
    ``graph`` and ``labels``."""
    loss = _GNN_FNS[type(cfg)][1]
    return lambda params, batch: (loss(params, batch["graph"], batch["labels"], cfg), {})


def gnn_train_step(cfg, tc: TrainConfig | None = None, *, donate: bool = False):
    """step(state_tree, batch) -> (state_tree, metrics ``loss``,
    ``grad_norm``, ``lr``): ``value_and_grad`` of the loss, then AdamW
    (``gnn_train_bundle``'s step; ``AdamWConfig()`` unless ``tc`` says
    otherwise)."""
    return make_train_step(gnn_loss_fn(cfg), tc or TrainConfig(opt=AdamWConfig()), donate=donate)


def gnn_train_flops(cfg, n_edges: int) -> float:
    """The reference's model-FLOPs proxy: messages × hidden² × layers × 6
    (forward and backward), hidden ``d_hidden`` or ``channels``."""
    d_h = getattr(cfg, "d_hidden", getattr(cfg, "channels", 64))
    return 6.0 * n_edges * d_h * d_h * cfg.n_layers


def gnn_edge_axes(mesh) -> tuple[str, ...]:
    """The axes a GNN step shards its edges over: the batch axes and
    ``"model"`` (``launch/steps.py:291``)."""
    return batch_axes(mesh) + ("model",)


def gnn_graph_specs(mesh) -> dict:
    """A graph batch's specs, field by field: edges over
    :func:`gnn_edge_axes`, nodes replicated (``launch/steps.py:293-304``)."""
    e = gnn_edge_axes(mesh)
    return {"nodes": (None, None), "positions": (None, None), "edges": (e, None), "senders": (e,),
            "receivers": (e,), "node_mask": (None,), "edge_mask": (e,), "graph_id": (None,)}


def shard_graph(g: GraphBatch, mesh) -> GraphBatch:
    """This rank's part of ``g`` on ``mesh``'s device: its slice of the
    edges (:func:`gnn_graph_specs`) and every node, with ``edge_axes`` set
    so the models complete their edge → node sums across the ranks. Edges
    that do not divide over the axes raise ``ValueError``."""
    specs = gnn_graph_specs(mesh)
    fields = {f: getattr(g, f) for f in specs if getattr(g, f) is not None}
    placed = reshard_for_mesh(fields, {f: specs[f] for f in fields}, mesh)
    return g._replace(**placed, edge_axes=MeshAxes(mesh, gnn_edge_axes(mesh)))


def gnn_train_bundle(arch_id: str, cfg, shape: ShapeSpec, mesh=None) -> StepBundle:
    """(params, opt_state, graph, labels) at the shape's padded sizes,
    ``AdamWConfig()`` (``launch/steps.py:251-324``). Under ``mesh`` the
    graph is a rank's :func:`shard_graph` and the rest is replicated; the
    gradients of the parameters that act on edges are summed over the edge
    shards before clipping."""
    cfg = gnn_adapt_config(cfg, shape)
    d = shape.dims
    n_nodes, n_edges = gnn_padded_sizes(d["n_nodes"], d["n_edges"])
    n_graphs = d.get("n_graphs", 1)
    gated = isinstance(cfg, GatedGCNConfig)
    graph = GraphBatch(
        nodes=_meta((n_nodes, d["d_feat"]), torch.float32),
        positions=None if gated else _meta((n_nodes, 3), torch.float32), edges=None,
        senders=_meta((n_edges,), torch.int32), receivers=_meta((n_edges,), torch.int32),
        node_mask=_meta((n_nodes,), torch.bool), edge_mask=_meta((n_edges,), torch.bool),
        graph_id=_meta((n_nodes,), torch.int32), n_graphs=n_graphs,
    )
    labels = _meta((n_nodes,), torch.int32) if gated else _meta((n_graphs, 1), torch.float32)
    params = _init_meta(_GNN_FNS[type(cfg)][0], cfg)
    if mesh is None:
        fn, specs = _train_fn(gnn_loss_fn(cfg), AdamWConfig(), ("graph", "labels")), {}
    else:
        edges = MeshAxes(mesh, gnn_edge_axes(mesh))
        on_edges = edge_param_leaves(params, _GNN_EDGE_PARAMS[type(cfg)])
        step = _train_fn(gnn_loss_fn(cfg), AdamWConfig(), ("graph", "labels"), mesh=mesh, specs=(),
                         sync=lambda loss, grads: (loss, _sum_leaves(edges, grads, on_edges)))

        def fn(params, opt_state, graph, labels):
            if graph.edge_axes is None:
                raise ValueError("under a mesh the GNN step takes a rank's shard_graph(graph, mesh)")
            return step(params, opt_state, graph, labels)

        specs = {"in_specs": ((), (), gnn_graph_specs(mesh), ()), "out_specs": ((), (), None)}
    return StepBundle(
        f"{arch_id}:{shape.name}", fn, (params, adamw_init(params), graph, labels), donate=(0, 1),
        model_flops=gnn_train_flops(cfg, d["n_edges"]), **specs,
    )


def _labels(cfg, n_nodes: int, n_graphs: int, gen: torch.Generator, dev) -> torch.Tensor:
    """Node classes (N,) int32 for GatedGCN, else (n_graphs, 1) float32
    targets, as the bundle's label shapes."""
    if isinstance(cfg, GatedGCNConfig):
        return torch.randint(0, cfg.n_classes, (n_nodes,), generator=gen, device=dev, dtype=torch.int32)
    return torch.randn((n_graphs, 1), generator=gen, device=dev, dtype=torch.float32)


def _on_mesh(batch: dict, mesh) -> dict:
    """A whole batch as one rank of ``mesh`` takes it: its edge slice."""
    if mesh is None:
        return batch
    return {"graph": shard_graph(batch["graph"], mesh), "labels": batch["labels"].to(mesh.device)}


def gnn_batch(cfg, shape: ShapeSpec, gen: torch.Generator, *, device: str | torch.device = "cuda",
              mesh=None) -> dict:
    """A synthetic batch of ``shape``: ``random_graph_batch`` at the shape's
    sizes (positions for the geometric archs), padded as the bundle pads,
    and labels. ``{"graph", "labels"}``; under ``mesh``, this rank's
    :func:`shard_graph` of it (every rank draws the whole batch from its
    ``gen``, so they must be seeded alike)."""
    d = shape.dims
    g = random_graph_batch(gen, n_nodes=d["n_nodes"], n_edges=d["n_edges"], d_feat=d["d_feat"],
                           with_positions=not isinstance(cfg, GatedGCNConfig), n_graphs=d.get("n_graphs", 1),
                           device=device)
    g = pad_graph(g, *gnn_padded_sizes(d["n_nodes"], d["n_edges"]))
    return _on_mesh({"graph": g, "labels": _labels(cfg, g.nodes.shape[0], g.n_graphs, gen, g.nodes.device)}, mesh)


def gnn_minibatch(cfg, sub: dict, *, node_labels, positions=None, device: str | torch.device = "cuda",
                  mesh=None) -> dict:
    """One ``data.sampler.minibatch_stream`` batch as the bundle takes it:
    its padded subgraph (edges padded on to a multiple of 4,096) with the
    batch's ``features``. ``node_labels`` (the whole graph's classes,
    indexed by the batch's node ids) label every sampled node for GatedGCN;
    the geometric archs take ``positions`` (the whole graph's, indexed the
    same way) and the seeds' mean class as the one graph's target. Under
    ``mesh``, this rank's :func:`shard_graph` of it."""
    dev = torch.device(device)
    safe = np.where(sub["node_ids"] >= 0, sub["node_ids"], 0)

    def t(x):
        return x.to(dev) if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)).to(dev)

    n = len(safe)
    g = GraphBatch(nodes=t(sub["features"]), positions=None if positions is None else t(positions[safe]), edges=None,
                   senders=t(sub["senders"]), receivers=t(sub["receivers"]), node_mask=t(sub["node_mask"]),
                   edge_mask=t(sub["edge_mask"]), graph_id=torch.zeros((n,), dtype=torch.int32, device=dev),
                   n_graphs=1)
    g = pad_graph(g, *gnn_padded_sizes(n, len(sub["senders"])))
    if isinstance(cfg, GatedGCNConfig):
        labels = torch.zeros((g.nodes.shape[0],), dtype=torch.int32, device=dev)
        labels[:n] = t(node_labels[safe]).to(torch.int32)
    else:
        labels = t(np.asarray(sub["labels"], np.float32).mean(keepdims=True)[None])
    return _on_mesh({"graph": g, "labels": labels}, mesh)


# ---------------------------------------------------------------------------
# recsys family: BERT4Rec (``launch/steps.py:330-485``)
# ---------------------------------------------------------------------------

BULK_K = 100  # serve_bulk's and retrieval_cand's top-k
BULK_CHUNK = 65536  # table rows per step of serve_bulk's running top-k
BULK_BLOCK = 8192  # sessions per block of serve_bulk on one card


def bert4rec_encoder_flops(cfg: b4r.Bert4RecConfig, batch: int) -> float:
    """A forward over ``batch`` sessions and the whole table: 2·B·(S·blocks·
    12·D² + D·items) (``launch/steps.py:403-406``)."""
    d = cfg.embed_dim
    return 2.0 * batch * (cfg.seq_len * cfg.n_blocks * 12 * d ** 2 + d * cfg.n_items)


def bert4rec_train_flops(cfg: b4r.Bert4RecConfig, batch: int) -> float:
    """6·B·S·(blocks·12·D² + D·items): every position's logits, forward and
    backward (``launch/steps.py:379-382``)."""
    d = cfg.embed_dim
    return 6.0 * batch * cfg.seq_len * (cfg.n_blocks * 12 * d ** 2 + d * cfg.n_items)


def bert4rec_loss_fn(cfg: b4r.Bert4RecConfig, tp: MeshAxes | None = None, batch: MeshAxes | None = None):
    """(params, batch) -> (cloze loss, {}) over ``items`` and
    ``mask_positions``; ``tp`` and ``batch`` as ``bert4rec_loss`` takes
    them on one rank of a mesh."""
    return lambda params, b: (
        b4r.bert4rec_loss(params, cfg, b["items"], b["mask_positions"], tp=tp, batch=batch), {})


def bert4rec_param_specs() -> dict:
    """The reference's ``_b4r_specs`` (``launch/steps.py:330-348``): the
    item table and ``out_bias`` by rows over ``"model"``, the attention's
    q/k/v (weights and biases) by columns and ``wo`` by rows, the MLP's
    ``wg``/``wu`` by columns and ``wd`` by rows; the rest replicated."""
    col, row = (None, None, "model"), (None, "model", None)
    return {
        "item_embed": ("model", None), "pos_embed": (None, None),
        "blocks": {
            "attn": {"wq": col, "wk": col, "wv": col, "wo": row,
                     "bq": (None, "model"), "bk": (None, "model"), "bv": (None, "model")},
            "mlp": {"wg": col, "wu": col, "wd": row},
            "ln1": (None, None), "ln1b": (None, None), "ln2": (None, None), "ln2b": (None, None),
        },
        "ln_f": (None,), "ln_fb": (None,), "out_bias": ("model",),
    }


def _local_top(scores: torch.Tensor, k: int, base: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``topk_first`` of (B, n) scores with ids offset by ``base``; fewer
    than ``k`` columns are padded with −inf (id −1)."""
    n = scores.shape[1]
    if n < k:
        scores = torch.cat([scores, scores.new_full((scores.shape[0], k - n), float("-inf"))], 1)
    top, pos = topk_first(scores, k)
    return top, torch.where(pos < n, pos + base, -1)


def merge_top(scores: torch.Tensor, ids: torch.Tensor, k: int,
              tp: MeshAxes | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of every rank's (B, k') candidates along ``tp``, each
    rank's ids ascending at equal scores and below the next rank's: their
    concatenation in shard order taken by ``topk_first`` keeps the lower
    id at a tie, as ``jax.lax.top_k`` over the whole row does."""
    if tp is None or tp.size == 1:
        return scores, ids
    top, pos = topk_first(tp.gather(scores, 1), k)
    return top, tp.gather(ids, 1).gather(1, pos)


def bert4rec_bulk_step(cfg: b4r.Bert4RecConfig, *, k: int = BULK_K, chunk: int = BULK_CHUNK,
                       tp: MeshAxes | None = None):
    """``serve_bulk``: fn(params, items, block=BULK_BLOCK, chunk=chunk) ->
    (ids (B, k) int32, scores (B, k)), the top-k of every session over the
    whole table (its [MASK] row too) by a running top-k over ``chunk``-row
    slices, the earlier candidate first on ties (``jax.lax.top_k`` over the
    reference's concatenation). Sessions go through in blocks of ``block``;
    every one is served. Over ``tp`` each rank runs the top-k over its rows
    of the table (ids offset by its row base), then the ranks' lists are
    merged (:func:`merge_top`)."""

    @torch.no_grad()
    def bulk_step(params, items, block: int = BULK_BLOCK, chunk: int = chunk):
        table = params["item_embed"]
        base = b4r.row_base(table, tp)
        items = torch.as_tensor(items).to(table.device)
        ids, scores = [], []
        for s0 in range(0, items.shape[0], block):
            q = b4r.bert4rec_serve(params, cfg, items[s0:s0 + block], tp)
            best_s = torch.full((q.shape[0], k), float("-inf"), device=table.device)
            best_i = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=table.device)
            for start in range(0, table.shape[0], chunk):
                best_s, pos = topk_first(torch.cat([best_s, q @ table[start:start + chunk].T], 1), k)
                best_i = torch.where(pos < k, best_i.gather(1, pos.clamp_max(k - 1)),
                                     (pos - k + base + start).to(torch.int32))
            best_s, best_i = merge_top(best_s, best_i, k, tp)
            ids.append(best_i)
            scores.append(best_s)
        return torch.cat(ids), torch.cat(scores)

    return bulk_step


def bert4rec_retrieval_step(cfg: b4r.Bert4RecConfig, n_cand: int, *, k: int = BULK_K, tp: MeshAxes | None = None):
    """``retrieval_cand``: fn(params, items, codes, adt) -> (dense ids (1, k),
    dense scores (1, k), flash ids (k,), flash scores (k,)). The dense top-k
    by inner product over the first ``n_cand`` rows of the table; then the
    paper's candidate acquisition: one ``ops.flash_scan`` of the (n_cand, M)
    codes with the (M, K) table, the 4·k lowest sums, and the exact top-k of
    those. Ids are int32.

    Over ``tp`` the query is replicated and the table and the codes are
    row-sharded, by rows that need not line up (2²⁰ / m table rows, 10⁶ /
    m code rows): each rank takes the dense top-k of its table rows below
    ``n_cand`` and runs ``flash_scan`` over its own code rows (the 4·k
    lowest, ids offset by its code row base); the ranks' lists are merged
    (:func:`merge_top`) and the 4·k candidates' rows gathered from the
    ranks that own them (``layers.vocab_lookup``)."""

    @torch.no_grad()
    def retrieval_step(params, items, codes, adt):
        table = params["item_embed"]
        base = b4r.row_base(table, tp)
        q = b4r.bert4rec_serve(params, cfg, items, tp)  # (1, D)
        mine = table[:max(0, min(n_cand - base, table.shape[0]))]
        top_d, idx_d = merge_top(*_local_top(q @ mine.T, k, base), k, tp)
        est = ops.flash_scan(codes.to(table.device), adt.to(table.device))  # this rank's code rows
        _, idx_f = merge_top(*_local_top(-est.to(torch.float32)[None], 4 * k, b4r.row_base(codes, tp)), 4 * k, tp)
        idx_f = idx_f[0]
        top_f, j = topk_first(L.vocab_lookup(table, idx_f, tp) @ q[0], k)
        return idx_d.to(torch.int32), top_d, idx_f[j].to(torch.int32), top_f

    return retrieval_step


def bert4rec_bundle(cfg: b4r.Bert4RecConfig, shape: ShapeSpec, mesh=None, *, microbatches: int = 1) -> StepBundle:
    """The four recsys cells (``launch/steps.py:351-485``); ``microbatches``
    splits a train step's batch. Under ``mesh``: tensor-parallel over
    ``"model"`` by :func:`bert4rec_param_specs`, sessions over the batch
    axes; a train step's loss and gradients are summed over the batch axes
    and its clipping norm is global."""
    params = b4r.params_tree(b4r.Bert4Rec(cfg, torch.Generator(), device="meta"))
    b = shape.dims["global_batch"]
    items = _meta((b, cfg.seq_len), torch.int32)
    tp = rows = None
    mesh_specs: dict = {}
    if mesh is not None:
        ba = batch_axes(mesh)
        tp, rows, pspecs = MeshAxes(mesh, "model"), MeshAxes(mesh, ba), bert4rec_param_specs()
    if shape.kind == "train":
        keys = ("items", "mask_positions")
        if mesh is None:
            fn = _train_fn(bert4rec_loss_fn(cfg), AdamWConfig(), keys, microbatches=microbatches)
        else:
            ospecs = AdamWState(step=(), mu=pspecs, nu=pspecs)
            fn = _train_fn(bert4rec_loss_fn(cfg, tp, rows), AdamWConfig(), keys, microbatches=microbatches,
                           mesh=mesh, specs=pspecs,
                           sync=lambda loss, g: (rows.sum(loss), _sum_leaves(rows, g, [True] * len(tree_leaves(g)))))
            mesh_specs = {"in_specs": (pspecs, ospecs, (ba, None), (ba, None)), "out_specs": (pspecs, ospecs, None)}
        return StepBundle(
            f"{cfg.n_items}:train", fn, (params, adamw_init(params), items, _meta((b, cfg.seq_len), torch.bool)),
            donate=(0, 1), model_flops=bert4rec_train_flops(cfg, b), **mesh_specs,
        )
    if shape.kind == "serve":
        if mesh is not None:
            mesh_specs = {"in_specs": (pspecs, (ba, None)), "out_specs": (ba, "model")}
        fn = torch.no_grad()(lambda params, items: b4r.bert4rec_score_all(params, cfg, items, tp))
        return StepBundle("serve_p99", fn, (params, items), model_flops=bert4rec_encoder_flops(cfg, b), **mesh_specs)
    if shape.kind == "bulk_serve":
        if mesh is not None:
            mesh_specs = {"in_specs": (pspecs, (ba, None)), "out_specs": ((ba, None), (ba, None))}
        return StepBundle("serve_bulk", bert4rec_bulk_step(cfg, tp=tp), (params, items),
                          model_flops=bert4rec_encoder_flops(cfg, b), **mesh_specs)
    if shape.kind == "retrieval":
        n_cand = shape.dims["n_candidates"]
        if mesh is not None:
            mesh_specs = {"in_specs": (pspecs, (), ("model", None), ()), "out_specs": ((), (), (), ())}
        return StepBundle(
            "retrieval_cand", bert4rec_retrieval_step(cfg, n_cand, tp=tp),
            (params, items, _meta((n_cand, 16), torch.int32), _meta((16, 16), torch.int32)),
            model_flops=2.0 * n_cand * cfg.embed_dim, **mesh_specs,
        )
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Entry (``launch/steps.py:542-561``)
# ---------------------------------------------------------------------------


def build_bundle(arch_id: str, shape_name: str, *, reduced: bool = False, cfg_override: dict | None = None,
                 device: str | torch.device = "cuda", mesh=None, microbatches: int = 1) -> StepBundle:
    """The bundle of one cell of ``registry.assigned_cells()`` at the full
    config (or the reduced one), ``cfg_override`` replacing config fields.
    ``flash-ann``'s cells raise ``ValueError``, as the reference's do: they
    are a segment build and a search, not steps. ``device`` is checked
    (``resolve_device``); the caller makes the inputs there. ``mesh``: the
    cell on one rank of a ``launch.mesh.Mesh``, with its shardings (module
    docstring).
    ``microbatches`` splits BERT4Rec's train step; under a mesh any cell
    of an MLA model raises ``NotImplementedError`` naming its ROADMAP item
    (7.8)."""
    resolve_device(device)
    arch = get_arch(arch_id)
    shape = next(s for s in arch.shapes if s.name == shape_name)
    cfg = arch.make_reduced() if reduced else arch.make_full()
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    if arch.family == "lm":
        make = {"train": lm_train_bundle, "prefill": lm_prefill_bundle, "decode": lm_decode_bundle}[shape.kind]
        return make(cfg, shape, mesh)
    if arch.family == "gnn":
        return gnn_train_bundle(arch_id, cfg, shape, mesh)
    if arch.family == "recsys":
        return bert4rec_bundle(cfg, shape, mesh, microbatches=microbatches)
    raise ValueError((arch_id, shape_name))
