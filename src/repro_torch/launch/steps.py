"""Step construction per (architecture × input shape): the reference's
``repro.launch.steps`` on one card.

``build_bundle(arch, shape)`` gives every cell of
``registry.assigned_cells()`` its ``StepBundle``: the step ``fn`` (an LM
train, prefill or decode step, a GNN train step, or one of BERT4Rec's
train, ``serve_p99``, ``serve_bulk`` and ``retrieval_cand`` steps), its
``args`` as meta tensors of the reference's shapes and dtypes (nothing is
allocated), the positions it updates in place and the reference's model
FLOPs. The reference also gives each cell its shardings on a mesh; those
wait for ROADMAP queue 1, item 7. ``flash-ann``'s cells are not steps
(``graph/segmented.py`` runs them).

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
from repro_torch.kernels import ops
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn.common import GraphBatch, pad_graph, random_graph_batch
from repro_torch.models.gnn.egnn import EGNNConfig, egnn_loss, init_egnn
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config, equiformer_v2_loss, init_equiformer_v2
from repro_torch.models.gnn.gatedgcn import GatedGCNConfig, gatedgcn_loss, init_gatedgcn
from repro_torch.models.gnn.nequip import NequIPConfig, init_nequip, nequip_loss
from repro_torch.models.recsys import bert4rec as b4r
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_loop import TrainConfig, make_train_step
from repro_torch.utils import resolve_device, round_up, topk_first


@dataclass
class StepBundle:
    """One cell's program. ``args`` are meta tensors (PyTorch's
    ``ShapeDtypeStruct``) of the reference's shapes and dtypes, in ``fn``'s
    argument order; ``donate`` the positions ``fn`` updates in place;
    ``model_flops`` the reference's analytic count. ``fn`` runs where its
    inputs lie."""

    name: str
    fn: Callable
    args: tuple
    donate: tuple = ()
    model_flops: float = 0.0


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _init_meta(init, cfg):
    """``init(gen, cfg, device="meta")``'s tree: shapes and dtypes alone."""
    return init(torch.Generator(), cfg, device="meta")


def _train_fn(loss_fn, opt: AdamWConfig, keys: tuple):
    """fn(params, opt_state, *batch) -> (params, opt_state, metrics): the
    donated ``make_train_step`` (one microbatch) over a batch whose leaves
    are named ``keys``, as the reference's bundles lay out a train step."""
    step = make_train_step(loss_fn, TrainConfig(opt=opt), donate=True)

    def train_step(params, opt_state, *batch):
        state, metrics = step({"params": params, "opt_state": opt_state}, dict(zip(keys, batch)))
        return state["params"], state["opt_state"], metrics

    return train_step


def lm_opt_cfg(cfg: tfm.TransformerConfig) -> AdamWConfig:
    """AdamW with bfloat16 moments above 5e10 parameters, else float32
    (``_lm_opt_cfg``, ``launch/steps.py:81-83``)."""
    return AdamWConfig(state_dtype="bf16" if cfg.param_count() > 5e10 else "f32")


def lm_loss_fn(cfg: tfm.TransformerConfig):
    """(params, batch) -> (loss, metrics): ``lm_loss`` over a batch's
    ``tokens`` and ``labels``."""
    return lambda params, batch: tfm.lm_loss(params, cfg, batch["tokens"], batch["labels"])


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


def lm_train_bundle(cfg: tfm.TransformerConfig, shape: ShapeSpec) -> StepBundle:
    """``lm_train_bundle`` (``launch/steps.py:103-137``): (params,
    opt_state, tokens, labels), ``lm_opt_cfg``'s moments."""
    b, s = shape.dims["global_batch"], shape.dims["seq_len"]
    opt = lm_opt_cfg(cfg)
    params = _init_meta(tfm.init_lm, cfg)
    tok = _meta((b, s), torch.int32)
    return StepBundle(
        f"{cfg.name}:train", _train_fn(lm_loss_fn(cfg), opt, ("tokens", "labels")),
        (params, adamw_init(params, state_dtype=opt.state_dtype), tok, tok),
        donate=(0, 1), model_flops=lm_train_flops(cfg, b, s),
    )


def lm_prefill_bundle(cfg: tfm.TransformerConfig, shape: ShapeSpec) -> StepBundle:
    """(params, tokens) -> (last logits, caches) (``launch/steps.py:140-165``)."""
    b, s = shape.dims["global_batch"], shape.dims["seq_len"]
    return StepBundle(
        f"{cfg.name}:prefill", lambda params, tokens: tfm.lm_prefill(params, cfg, tokens),
        (_init_meta(tfm.init_lm, cfg), _meta((b, s), torch.int32)), model_flops=lm_prefill_flops(cfg, b, s),
    )


def lm_decode_bundle(cfg: tfm.TransformerConfig, shape: ShapeSpec) -> StepBundle:
    """(params, caches, token, pos) -> (logits, caches written in place)
    (``launch/steps.py:183-233``)."""
    b, s_max = shape.dims["global_batch"], shape.dims["seq_len"]
    caches = tfm.make_caches(cfg, b, s_max, device="meta")
    return StepBundle(
        f"{cfg.name}:decode",
        lambda params, caches, token, pos: tfm.lm_decode_step(params, cfg, caches, token, pos),
        (_init_meta(tfm.init_lm, cfg), caches, _meta((b,), torch.int32), _meta((), torch.int32)),
        donate=(1,), model_flops=lm_decode_flops(cfg, b, s_max),
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


def gnn_train_bundle(arch_id: str, cfg, shape: ShapeSpec) -> StepBundle:
    """(params, opt_state, graph, labels) at the shape's padded sizes,
    ``AdamWConfig()`` (``launch/steps.py:251-324``)."""
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
    return StepBundle(
        f"{arch_id}:{shape.name}", _train_fn(gnn_loss_fn(cfg), AdamWConfig(), ("graph", "labels")),
        (params, adamw_init(params), graph, labels), donate=(0, 1),
        model_flops=gnn_train_flops(cfg, d["n_edges"]),
    )


def _labels(cfg, n_nodes: int, n_graphs: int, gen: torch.Generator, dev) -> torch.Tensor:
    """Node classes (N,) int32 for GatedGCN, else (n_graphs, 1) float32
    targets, as the bundle's label shapes."""
    if isinstance(cfg, GatedGCNConfig):
        return torch.randint(0, cfg.n_classes, (n_nodes,), generator=gen, device=dev, dtype=torch.int32)
    return torch.randn((n_graphs, 1), generator=gen, device=dev, dtype=torch.float32)


def gnn_batch(cfg, shape: ShapeSpec, gen: torch.Generator, *, device: str | torch.device = "cuda") -> dict:
    """A synthetic batch of ``shape``: ``random_graph_batch`` at the shape's
    sizes (positions for the geometric archs), padded as the bundle pads,
    and labels. ``{"graph", "labels"}``."""
    d = shape.dims
    g = random_graph_batch(gen, n_nodes=d["n_nodes"], n_edges=d["n_edges"], d_feat=d["d_feat"],
                           with_positions=not isinstance(cfg, GatedGCNConfig), n_graphs=d.get("n_graphs", 1),
                           device=device)
    g = pad_graph(g, *gnn_padded_sizes(d["n_nodes"], d["n_edges"]))
    return {"graph": g, "labels": _labels(cfg, g.nodes.shape[0], g.n_graphs, gen, g.nodes.device)}


def gnn_minibatch(cfg, sub: dict, *, node_labels, positions=None, device: str | torch.device = "cuda") -> dict:
    """One ``data.sampler.minibatch_stream`` batch as the bundle takes it:
    its padded subgraph (edges padded on to a multiple of 4,096) with the
    batch's ``features``. ``node_labels`` (the whole graph's classes,
    indexed by the batch's node ids) label every sampled node for GatedGCN;
    the geometric archs take ``positions`` (the whole graph's, indexed the
    same way) and the seeds' mean class as the one graph's target."""
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
    return {"graph": g, "labels": labels}


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


def bert4rec_loss_fn(cfg: b4r.Bert4RecConfig):
    """(params, batch) -> (cloze loss, {}) over ``items`` and ``mask_positions``."""
    return lambda params, batch: (b4r.bert4rec_loss(params, cfg, batch["items"], batch["mask_positions"]), {})


def bert4rec_bulk_step(cfg: b4r.Bert4RecConfig, *, k: int = BULK_K, chunk: int = BULK_CHUNK):
    """``serve_bulk``: fn(params, items, block=BULK_BLOCK) -> (ids (B, k)
    int32, scores (B, k)), the top-k of every session over the whole table
    (its [MASK] row too) by a running top-k over ``chunk``-row slices, the
    earlier candidate first on ties (``jax.lax.top_k`` over the reference's
    concatenation). Sessions go through in blocks of ``block``; every one is
    served."""

    @torch.no_grad()
    def bulk_step(params, items, block: int = BULK_BLOCK):
        table = params["item_embed"]
        items = torch.as_tensor(items).to(table.device)
        ids, scores = [], []
        for s0 in range(0, items.shape[0], block):
            q = b4r.bert4rec_serve(params, cfg, items[s0:s0 + block])
            best_s = torch.full((q.shape[0], k), float("-inf"), device=table.device)
            best_i = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=table.device)
            for start in range(0, table.shape[0], chunk):
                best_s, pos = topk_first(torch.cat([best_s, q @ table[start:start + chunk].T], 1), k)
                best_i = torch.where(pos < k, best_i.gather(1, pos.clamp_max(k - 1)), (pos - k + start).to(torch.int32))
            ids.append(best_i)
            scores.append(best_s)
        return torch.cat(ids), torch.cat(scores)

    return bulk_step


def bert4rec_retrieval_step(cfg: b4r.Bert4RecConfig, n_cand: int, *, k: int = BULK_K):
    """``retrieval_cand``: fn(params, items, codes, adt) -> (dense ids (1, k),
    dense scores (1, k), flash ids (k,), flash scores (k,)). The dense top-k
    by inner product over the first ``n_cand`` rows of the table; then the
    paper's candidate acquisition: one ``ops.flash_scan`` of the (n_cand, M)
    codes with the (M, K) table, the 4·k lowest sums, and the exact top-k of
    those. Ids are int32."""

    @torch.no_grad()
    def retrieval_step(params, items, codes, adt):
        table = params["item_embed"][:n_cand]
        q = b4r.bert4rec_serve(params, cfg, items)  # (1, D)
        top_d, idx_d = topk_first(q @ table.T, k)
        est = ops.flash_scan(codes.to(table.device), adt.to(table.device))  # (n_cand,)
        _, idx_f = topk_first(-est.to(torch.float32), 4 * k)
        top_f, j = topk_first(table[idx_f] @ q[0], k)
        return idx_d.to(torch.int32), top_d, idx_f[j].to(torch.int32), top_f

    return retrieval_step


def bert4rec_bundle(cfg: b4r.Bert4RecConfig, shape: ShapeSpec) -> StepBundle:
    """The four recsys cells (``launch/steps.py:351-485``)."""
    params = b4r.params_tree(b4r.Bert4Rec(cfg, torch.Generator(), device="meta"))
    b = shape.dims["global_batch"]
    items = _meta((b, cfg.seq_len), torch.int32)
    if shape.kind == "train":
        return StepBundle(
            f"{cfg.n_items}:train", _train_fn(bert4rec_loss_fn(cfg), AdamWConfig(), ("items", "mask_positions")),
            (params, adamw_init(params), items, _meta((b, cfg.seq_len), torch.bool)),
            donate=(0, 1), model_flops=bert4rec_train_flops(cfg, b),
        )
    if shape.kind == "serve":
        return StepBundle("serve_p99", torch.no_grad()(lambda params, items: b4r.bert4rec_score_all(params, cfg, items)),
                          (params, items), model_flops=bert4rec_encoder_flops(cfg, b))
    if shape.kind == "bulk_serve":
        return StepBundle("serve_bulk", bert4rec_bulk_step(cfg), (params, items),
                          model_flops=bert4rec_encoder_flops(cfg, b))
    if shape.kind == "retrieval":
        n_cand = shape.dims["n_candidates"]
        return StepBundle(
            "retrieval_cand", bert4rec_retrieval_step(cfg, n_cand),
            (params, items, _meta((n_cand, 16), torch.int32), _meta((16, 16), torch.int32)),
            model_flops=2.0 * n_cand * cfg.embed_dim,
        )
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Entry (``launch/steps.py:542-561``)
# ---------------------------------------------------------------------------


def build_bundle(arch_id: str, shape_name: str, *, reduced: bool = False, cfg_override: dict | None = None,
                 device: str | torch.device = "cuda") -> StepBundle:
    """The bundle of one cell of ``registry.assigned_cells()`` at the full
    config (or the reduced one), ``cfg_override`` replacing config fields.
    ``flash-ann``'s cells raise ``ValueError``, as the reference's do: they
    are a segment build and a search, not steps. ``device`` is checked
    (``resolve_device``); the caller makes the inputs there."""
    resolve_device(device)
    arch = get_arch(arch_id)
    shape = next(s for s in arch.shapes if s.name == shape_name)
    cfg = arch.make_reduced() if reduced else arch.make_full()
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    if arch.family == "lm":
        make = {"train": lm_train_bundle, "prefill": lm_prefill_bundle, "decode": lm_decode_bundle}[shape.kind]
        return make(cfg, shape)
    if arch.family == "gnn":
        return gnn_train_bundle(arch_id, cfg, shape)
    if arch.family == "recsys":
        return bert4rec_bundle(cfg, shape)
    raise ValueError((arch_id, shape_name))
