"""Decoder-only LM: dense (qwen2, qwen1.5, llama3.2) and MoE (deepseek-v3,
moonshot) variants with GQA or MLA attention, in PyTorch.

Entry points (the reference's ``repro.models.transformer``):

  init_lm(gen, cfg, device=)               parameters (layer-stacked tree)
  lm_forward(params, cfg, tokens)          logits (B, S, V) and MoE aux
  lm_loss(params, cfg, tokens, labels)     next-token CE (+ MoE aux, + MTP)
  make_caches(cfg, batch, s_max, device=)  zeroed KV caches
  lm_prefill(params, cfg, tokens)          last logits + caches filled to S
  lm_decode_step(params, cfg, caches, token, pos)   one token per row

The tree is the reference's: ``embed``, ``head``, ``ln_f``, the blocks
stacked on a leading layer axis in ``blocks_dense`` (the first
``moe_first_dense`` layers of an MoE model, or every layer of a dense one)
and ``blocks_moe`` (None where a model has none), and ``mtp_proj`` /
``mtp_block`` when ``mtp_depth``. Layers run as a Python loop over the
stacked axis (``cfg.remat`` rematerialises each layer in the backward).
:func:`params_from_jax` and :func:`params_to_jax` carry the
tree across bit for bit.

Compute dtype: each block's float32 weights are rounded to ``cfg.dtype``
at use, norm scales stay as they are (``_cast_block``), ``embed`` rows and
``head`` are cast at use. :func:`serving_params` makes those roundings
once, at load, which is the same arithmetic; a serving caller holds that
copy instead of the float32 masters.

The decode step writes its position into ``caches`` in place and returns
the same tensors (the reference's jitted step donates them).

Across ranks: :func:`lm_param_specs` and :func:`cache_specs` are the
reference's shardings (per dim None, an axis name or a tuple of names).
``lm_loss``, ``lm_prefill`` and ``lm_decode_step`` take ``shards`` (an
:class:`LMShards`) to run on one rank of a mesh over the shards those
specs give it, computing what the reference's GSPMD program computes, its
gradients included: the vocabulary split over ``"model"`` (the embedding
looked up by the rows' owners; the head's logits by columns, gathered
whole for serving and never gathered by the loss, a vocabulary-parallel
log-softmax), attention by heads (the prefill's caches turned into
sequence chunks by one ``all_to_all``; decode as flash-decoding over the
cache's sequence chunks), the MLP by hidden columns and the MoE
expert-parallel (``moe.py``, its aux losses over every token). MLA models
and MTP under a mesh are ROADMAP queue 1, item 7.8.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.collectives import MeshAxes
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import layers as L
from repro_torch.models.moe import MoEConfig, init_moe, moe_forward
from repro_torch.utils import resolve_device, tree_leaves, tree_map, tree_unflatten

Params = dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int  # dense-layer FFN width
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    attn: str = "gqa"  # "gqa" | "mla"
    # MLA dims (deepseek-v3 defaults)
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # MoE
    moe: MoEConfig | None = None
    moe_first_dense: int = 0
    mtp_depth: int = 0
    # execution
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32  # storage dtype (bf16 for 72B/671B)
    block_q: int | None = None  # query chunk of the blockwise prefill attention
    remat: bool = True  # the reference's rematerialisation in training; serving ignores it

    @property
    def n_dense_layers(self) -> int:
        return self.n_layers if self.moe is None else self.moe_first_dense

    @property
    def n_moe_layers(self) -> int:
        return 0 if self.moe is None else self.n_layers - self.moe_first_dense

    def param_count(self) -> float:
        """Analytic total parameter count (the reference's, for model FLOPs)."""
        d, v = self.d_model, self.vocab
        if self.attn == "mla":
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                + d * self.kv_lora_rank
                + d * self.qk_rope_dim
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        else:
            attn = d * self.head_dim * (self.n_heads * 2 + self.n_kv_heads * 2)
        total = v * d * 2  # embed + head
        total += self.n_dense_layers * (attn + 3 * d * self.d_ff)
        if self.moe is not None:
            m = self.moe
            total += self.n_moe_layers * (attn + 3 * d * m.d_ff * (m.n_experts + m.n_shared) + d * m.n_experts)
        return float(total)

    def active_param_count(self) -> float:
        """Parameters active per token (MoE: the top-k and shared experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        idle = 3 * self.d_model * m.d_ff * (m.n_experts - m.top_k)
        return self.param_count() - self.n_moe_layers * idle


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: TransformerConfig, *, moe: bool, device) -> Params:
    dt = cfg.param_dtype
    if cfg.attn == "mla":
        attn = L.init_mla(gen, d_model=cfg.d_model, n_heads=cfg.n_heads, q_lora_rank=cfg.q_lora_rank,
                          kv_lora_rank=cfg.kv_lora_rank, qk_nope_dim=cfg.qk_nope_dim,
                          qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim, device=device, dtype=dt)
    else:
        attn = L.init_gqa(gen, d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                          head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias, device=device, dtype=dt)
    if moe:
        ffn = init_moe(gen, d_model=cfg.d_model, cfg=cfg.moe, device=device, dtype=dt)
    else:
        ffn = L.init_mlp(gen, d_model=cfg.d_model, d_ff=cfg.d_ff, device=device, dtype=dt)
    ones = torch.ones(cfg.d_model, device=device, dtype=dt)
    return {"attn": attn, "ffn": ffn, "ln1": ones, "ln2": ones.clone()}


def _stack_blocks(gen: torch.Generator, cfg: TransformerConfig, n: int, *, moe: bool, device) -> Params | None:
    """``n`` blocks stacked on a leading axis, drawn one layer at a time."""
    if n == 0:
        return None
    first = _init_block(gen, cfg, moe=moe, device=device)
    if n == 1:
        return tree_map(lambda t: t.unsqueeze(0), first)
    stacked = tree_map(lambda t: torch.empty((n, *t.shape), dtype=t.dtype, device=t.device), first)
    if torch.device(device).type == "meta":  # shapes alone: nothing to draw
        return stacked
    for i in range(n):
        blk = first if i == 0 else _init_block(gen, cfg, moe=moe, device=device)
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, blk)
    return stacked


def init_lm(gen: torch.Generator, cfg: TransformerConfig, *, device: str | torch.device = "cuda") -> Params:
    """Random parameters in the reference's layout (``init_lm``'s
    distributions: embed N(0, 0.02²), head and dense weights 1/√fan_in,
    norm scales 1), drawn from ``gen`` on ``device`` in float32 and stored
    in ``cfg.param_dtype``."""
    dev = resolve_device(device)
    dt = cfg.param_dtype

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(dt)

    p = {
        "embed": normal((cfg.vocab, cfg.d_model), 0.02),
        "blocks_dense": _stack_blocks(gen, cfg, cfg.n_dense_layers, moe=False, device=dev),
        "blocks_moe": _stack_blocks(gen, cfg, cfg.n_moe_layers, moe=True, device=dev),
        "ln_f": torch.ones(cfg.d_model, device=dev, dtype=dt),
        "head": normal((cfg.d_model, cfg.vocab), 1.0 / math.sqrt(cfg.d_model)),
    }
    if cfg.mtp_depth:
        p["mtp_proj"] = normal((2 * cfg.d_model, cfg.d_model), 1.0 / math.sqrt(2 * cfg.d_model))
        p["mtp_block"] = _init_block(gen, cfg, moe=False, device=dev)
    return p


# ---------------------------------------------------------------------------
# Shardings (the reference's ``lm_param_specs``, ``cache_specs``)
# ---------------------------------------------------------------------------


def lm_param_specs(cfg: TransformerConfig) -> Params:
    """The spec tree matching :func:`init_lm` (``transformer.py:169-237``):
    the vocabulary by rows of ``embed`` and columns of ``head`` over
    ``"model"``, attention's q/k/v projections by columns and ``wo`` by
    rows, the MLP's ``wg``/``wu`` by columns and ``wd`` by rows, the
    experts by the expert axis, MLA's up-projections by columns; the rest
    replicated. Stacked blocks carry a leading ``None`` for the layer axis;
    ``mtp_block``'s specs drop it. Metadata alone: every config has one."""
    col, row = (None, None, "model"), (None, "model", None)
    rep2, rep3 = (None, None), (None, None, None)

    def gqa_spec():
        out = {"wq": col, "wk": col, "wv": col, "wo": row}
        if cfg.qkv_bias:
            out.update(bq=(None, "model"), bk=(None, "model"), bv=(None, "model"))
        return out

    def mla_spec():
        return {"wq_a": rep3, "q_norm": rep2, "wq_b": col, "wkv_a": rep3, "kv_norm": rep2, "wk_rope": rep3,
                "wk_b": col, "wv_b": col, "wo": row}

    def mlp_spec():
        return {"wg": col, "wu": col, "wd": row}

    def moe_spec():
        out = {"router": rep3, "wg": (None, "model", None, None), "wu": (None, "model", None, None),
               "wd": (None, "model", None, None)}
        if cfg.moe and cfg.moe.n_shared:
            out["shared"] = mlp_spec()
        return out

    def block_spec(moe):
        return {"attn": mla_spec() if cfg.attn == "mla" else gqa_spec(), "ffn": moe_spec() if moe else mlp_spec(),
                "ln1": rep2, "ln2": rep2}

    def unstacked(tree):
        return {k: unstacked(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[1:]

    specs = {
        "embed": ("model", None),
        "blocks_dense": block_spec(False) if cfg.n_dense_layers else None,
        "blocks_moe": block_spec(True) if cfg.n_moe_layers else None,
        "ln_f": (None,),
        "head": (None, "model"),
    }
    if cfg.mtp_depth:
        specs["mtp_proj"] = rep2
        specs["mtp_block"] = unstacked(block_spec(False))
    return specs


def cache_specs(cfg: TransformerConfig, *, seq_shard: bool) -> dict:
    """The caches' specs (``transformer.py:367-383``): the batch over
    ``("pod", "data")``; ``seq_shard`` puts the sequence over ``"model"``,
    else the Kv heads go there (where there is more than one). A mesh
    without ``"pod"`` drops it (``launch.steps.fix_axes``)."""
    seq = "model" if seq_shard else None
    kv = None if seq_shard else ("model" if cfg.n_kv_heads > 1 else None)
    if cfg.attn == "mla":
        return {"ckv": (None, ("pod", "data"), seq, None), "krope": (None, ("pod", "data"), seq, None)}
    return {"k": (None, ("pod", "data"), seq, kv, None), "v": (None, ("pod", "data"), seq, kv, None)}


class LMShards:
    """Where one rank of ``mesh`` holds a step's tensors, as the reference's
    train, prefill and decode bundles shard them: the parameters by
    :func:`lm_param_specs` (``tp``: the ``"model"`` axis), the batch rows
    over the batch axes (``rows``), the caches' sequence over ``"model"``
    (``seq``). ``long_context`` (decode at a batch below 8) puts the
    sequence over every axis and keeps every row on every rank."""

    def __init__(self, mesh, *, long_context: bool = False):
        self.mesh = mesh
        self.tp = MeshAxes(mesh, "model")
        self.rows = MeshAxes(mesh, () if long_context else batch_axes(mesh))
        self.seq = MeshAxes(mesh, mesh.axis_names if long_context else "model")


def require_gqa(cfg: TransformerConfig, what: str) -> None:
    """Raise for an MLA model, or MTP, whose cells across ranks are not
    ported."""
    if cfg.attn == "mla" or cfg.mtp_depth:
        raise NotImplementedError(f"{cfg.name}:{what} under a mesh: MLA and MTP across ranks are not ported "
                                  "(ROADMAP queue 1, item 7.8)")


# ---------------------------------------------------------------------------
# Weight carry-over and the serving copy
# ---------------------------------------------------------------------------


def _from_numpy(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes, which numpy lacks
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the reference's bfloat16 arrays; comes with JAX

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree_np: Params, cfg: TransformerConfig, device: str | torch.device = "cuda") -> Params:
    """The reference's ``init_lm`` tree (numpy or JAX arrays, bfloat16 as
    ``ml_dtypes``) as tensors on ``device``, bit for bit; the stacked
    blocks must hold ``cfg``'s layer counts."""
    dev = resolve_device(device)
    for key, n in (("blocks_dense", cfg.n_dense_layers), ("blocks_moe", cfg.n_moe_layers)):
        blocks = tree_np.get(key)
        got = 0 if blocks is None else int(np.shape(blocks["ln1"])[0])
        if got != n:
            raise ValueError(f"{key} holds {got} layers where {cfg.name} has {n}")
    return tree_map(lambda a: _from_numpy(a).to(dev), tree_np)


def params_to_jax(params: Params) -> Params:
    """The inverse of :func:`params_from_jax`: numpy arrays of the same
    dtypes (bfloat16 as ``ml_dtypes.bfloat16``), bit for bit."""
    return tree_map(_to_numpy, params)


def _cast_block(blk: Params, dtype: torch.dtype) -> Params:
    """Round a block's float32 weights to the compute dtype; norm scales
    (names holding ``ln`` or ``norm``) and other dtypes stay."""
    def cast(node, name=""):
        if isinstance(node, dict):
            return {k: cast(v, k) for k, v in node.items()}
        if "ln" in name or "norm" in name or node.dtype != torch.float32:
            return node
        return node.to(dtype)

    return cast(blk)


def serving_params(params: Params, cfg: TransformerConfig) -> Params:
    """The tree with every rounding the forwards make at use made once:
    the blocks through ``_cast_block`` and ``embed``/``head`` in
    ``cfg.dtype``. The forwards then compute exactly as from ``params``."""
    out = dict(params)
    for key in ("blocks_dense", "blocks_moe", "mtp_block"):
        if out.get(key) is not None:
            out[key] = _cast_block(out[key], cfg.dtype)
    for key in ("embed", "head", "mtp_proj"):
        if key in out:
            out[key] = out[key].to(cfg.dtype)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layers(params: Params, cfg: TransformerConfig):
    """(layer index, block, is MoE) over the stacked blocks in order. Each
    stacked leaf is unbound once per call: the backward of ``t[i]`` per
    layer would allocate and add a zero tensor the size of the whole
    stacked leaf for every layer, ``unbind``'s is one ``stack``. The block
    holds the stored weights; callers round them with ``_cast_block``."""
    nd = cfg.n_dense_layers
    for key, n, moe, base in (("blocks_dense", nd, False, 0), ("blocks_moe", cfg.n_moe_layers, True, nd)):
        blocks = params[key]
        per_leaf = [torch.unbind(t, 0) for t in tree_leaves(blocks)]
        for i in range(n):
            yield base + i, tree_unflatten(blocks, [views[i] for views in per_leaf]), moe


def _ffn(blk: Params, x: torch.Tensor, cfg: TransformerConfig, moe: bool, shards: LMShards | None = None,
         global_aux: bool = False):
    """The block's second half: (x out, the MoE aux losses, over every
    token of the mesh with ``global_aux``)."""
    h = L.rms_norm(x, blk["ln2"], cfg.norm_eps)
    if not moe:
        return x + L.mlp_forward(blk["ffn"], h, None if shards is None else shards.tp), {}
    on_mesh = {} if shards is None else {"mesh": shards.mesh, "token_axes": shards.rows.axes,
                                         "global_aux": global_aux}
    f, aux = moe_forward(blk["ffn"], h, cfg.moe, **on_mesh)
    return x + f, aux


def _attn_forward(blk: Params, h: torch.Tensor, positions: torch.Tensor, cfg: TransformerConfig,
                  shards: LMShards | None = None) -> torch.Tensor:
    if cfg.attn == "mla":
        return L.mla_forward(blk["attn"], h, positions, n_heads=cfg.n_heads, qk_nope_dim=cfg.qk_nope_dim,
                             qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta,
                             block_q=cfg.block_q)
    return L.gqa_forward(blk["attn"], h, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                         head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, block_q=cfg.block_q,
                         tp=None if shards is None else shards.tp)


def _block_forward(blk: Params, x: torch.Tensor, positions: torch.Tensor, cfg: TransformerConfig, moe: bool,
                   shards: LMShards | None = None):
    """One block over its stored weights (rounded here, so a rematerialised
    block keeps no rounded copy): (x out, aux). ``shards``: this rank's
    shards of it on a mesh."""
    blk = _cast_block(blk, cfg.dtype)
    x = x + _attn_forward(blk, L.rms_norm(x, blk["ln1"], cfg.norm_eps), positions, cfg, shards)
    return _ffn(blk, x, cfg, moe, shards, global_aux=True)


def _block_remat(blk: Params, x: torch.Tensor, positions: torch.Tensor, cfg: TransformerConfig, moe: bool,
                 shards: LMShards | None = None):
    """``_block_forward``, rematerialised in the backward where ``cfg.remat``
    (the reference's ``jax.checkpoint`` per scanned block): only the
    block's input is kept. The blocks draw no random numbers, and the MoE
    routing (``topk_first``, a stable sort) recomputes to the same ids.

    Under a mesh the recomputation re-issues the block's forward
    collectives inside the backward. That is sound only because every rank
    recomputes the same blocks in the same order (one program; the
    backward visits the blocks in reverse, and where the recomputation
    stops early, once the tensors the backward needs are back, every rank
    stops at the same tensor) and routes to the same ids as its forward
    did, so the recomputed exchanges pair up and carry the forward's
    buffers."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(_block_forward, blk, x, positions, cfg, moe, shards, use_reentrant=False,
                          preserve_rng_state=False)
    return _block_forward(blk, x, positions, cfg, moe, shards)


def _embed(params: Params, cfg: TransformerConfig, tokens: torch.Tensor, shards: LMShards | None = None):
    b, s = tokens.shape
    x = L.vocab_lookup(params["embed"], tokens, None if shards is None else shards.tp).to(cfg.dtype)
    return x, torch.arange(s, device=tokens.device).expand(b, s)


def _head(params: Params, cfg: TransformerConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Float32 logits of the hidden ``x``; over ``tp``, this rank's block of
    the vocabulary (``x`` entering through ``copy_to``)."""
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    if tp is not None:
        x = tp.copy_to(x)
    return L.matmul(x, params["head"].to(cfg.dtype)).to(torch.float32)


def _logits(params: Params, cfg: TransformerConfig, x: torch.Tensor, shards: LMShards | None = None) -> torch.Tensor:
    """Float32 logits; across ranks the head's column shards are gathered
    over ``"model"`` and the rows over the batch axes: every rank returns
    the whole (B, V), as the reference's replicated output."""
    out = _head(params, cfg, x, None if shards is None else shards.tp)
    return out if shards is None else shards.rows.gather(shards.tp.gather(out, -1), 0)


def _trunk(params: Params, cfg: TransformerConfig, tokens: torch.Tensor, shards: LMShards | None = None):
    """Embedding and every block: (hidden before ``ln_f`` (B, S, D), aux).
    aux holds each MoE loss averaged over the MoE layers, as
    ``moe/load_balance`` and ``moe/router_z`` (the reference's names; its
    dense blocks add none). ``shards``: this rank's rows and shards."""
    x, positions = _embed(params, cfg, tokens, shards)
    auxs: dict[str, list] = {}
    for _, blk, moe in _layers(params, cfg):
        x, aux = _block_remat(blk, x, positions, cfg, moe, shards)
        for k, v in aux.items():
            auxs.setdefault(f"moe/{k}", []).append(v)
    return x, {k: torch.stack(v).mean() for k, v in auxs.items()}


def lm_forward(params: Params, cfg: TransformerConfig, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, V) float32, aux)."""
    h, aux = _trunk(params, cfg, tokens)
    return _logits(params, cfg, h), aux


def lm_loss(params: Params, cfg: TransformerConfig, tokens: torch.Tensor, labels: torch.Tensor, *,
            lb_coef: float = 0.01, z_coef: float = 1e-4, shards: LMShards | None = None):
    """Next-token cross entropy over the float32 logits, plus the MoE aux
    losses (``lb_coef``·load balance + ``z_coef``·router z) and, with
    ``cfg.mtp_depth``, deepseek-v3's multi-token prediction at weight 0.3:
    one dense block over ``[h_t ; embed(t + 1)] @ mtp_proj`` predicts token
    t + 2 through the shared ``ln_f`` and head, over the positions below
    S − 2 (the last two labels are rolled in from the front). Returns
    (loss, metrics): ``ce``, the aux, and ``mtp_ce`` with MTP.

    ``shards``: one rank of a mesh, ``tokens`` and ``labels`` its rows
    over the batch axes and ``params`` its shards (GQA models without MTP;
    the rest raise, item 7.8). The loss is this rank's part of the global
    batch's, which the ranks along the batch axes sum (their gradients
    too): the CE over this rank's tokens divided by every token of the
    global batch, over a vocabulary block a rank (the (B, S, V) logits are
    never gathered), plus this rank's share (``MeshAxes.share``) of the aux
    losses, which are the global batch's (``moe.py``). The metrics are the
    global batch's."""
    if shards is not None:
        require_gqa(cfg, "train")
    tp, rows = (None, None) if shards is None else (shards.tp, shards.rows)
    h, aux = _trunk(params, cfg, tokens, shards)
    ll = L.vocab_log_prob(_head(params, cfg, h, tp), labels, tp)
    if rows is None or rows.size == 1:
        loss = -ll.mean()
        metrics = {"ce": loss, **aux}
    else:
        loss = -ll.sum() / (ll.numel() * rows.size)
        metrics = {"ce": rows.sum(loss.detach()), **aux}
    if "moe/load_balance" in aux:
        if rows is None or rows.size == 1:
            loss = loss + lb_coef * aux["moe/load_balance"] + z_coef * aux["moe/router_z"]
        else:
            loss = loss + rows.share(lb_coef * aux["moe/load_balance"] + z_coef * aux["moe/router_z"])
    if cfg.mtp_depth:
        b, s = tokens.shape
        nxt = params["embed"][torch.roll(tokens, -1, dims=1)].to(cfg.dtype)
        mtp_in = L.matmul(torch.cat([h, nxt], dim=-1), params["mtp_proj"].to(cfg.dtype))
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        mtp_h, _ = _block_remat(params["mtp_block"], mtp_in, positions, cfg, False)
        ll2 = L.vocab_log_prob(_head(params, cfg, mtp_h), torch.roll(labels, -1, dims=1))
        mask = torch.arange(s, device=tokens.device) < s - 2
        mtp_loss = -(ll2 * mask).sum() / max(max(s - 2, 0) * b, 1)
        loss = loss + 0.3 * mtp_loss
        metrics["mtp_ce"] = mtp_loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def make_caches(cfg: TransformerConfig, batch: int, s_max: int, *, device: str | torch.device = "cuda") -> dict:
    """Zeroed caches in ``cfg.dtype``. GQA: ``k``, ``v`` (L, B, S, Kv, hd);
    MLA: ``ckv`` (L, B, S, r_kv) and ``krope`` (L, B, S, rope)."""
    dev = resolve_device(device)
    n_l = cfg.n_layers
    if cfg.attn == "mla":
        shapes = {"ckv": (cfg.kv_lora_rank,), "krope": (cfg.qk_rope_dim,)}
    else:
        shapes = {"k": (cfg.n_kv_heads, cfg.head_dim), "v": (cfg.n_kv_heads, cfg.head_dim)}
    return {k: torch.zeros((n_l, batch, s_max, *tail), dtype=cfg.dtype, device=dev) for k, tail in shapes.items()}


def _seq_chunks(kv: tuple, cfg: TransformerConfig, total: int, shards: LMShards) -> tuple:
    """A rank's prefill (k, v), (B, S, Kv / ranks or Kv, hd) for its heads
    over the whole prompt, as this rank's chunk of the caches' sequence
    (B, total / ranks, Kv, hd), zero past S. Where a rank holds every head
    the chunk is a slice; else one ``all_to_all`` over ``"model"`` (the
    sequence's axis too) sends each rank its chunk of every rank's heads."""
    k, v = kv
    b, s, heads, hd = k.shape
    m = shards.seq.size
    c = total // m
    both = torch.stack([k, v])
    if s < total:
        both = torch.cat([both, both.new_zeros((2, b, total - s, heads, hd))], 2)
    if heads == cfg.n_kv_heads:
        i = shards.seq.index
        return tuple(both[:, :, i * c:(i + 1) * c])
    blocks = both.reshape(2, b, m, c, heads, hd).permute(2, 0, 1, 3, 4, 5)
    got = shards.seq.all_to_all(blocks.contiguous())  # block i: rank i's heads over this rank's chunk
    return tuple(got.permute(1, 2, 3, 0, 4, 5).reshape(2, b, c, m * heads, hd))


@torch.no_grad()
def lm_prefill(params: Params, cfg: TransformerConfig, tokens: torch.Tensor, s_max: int | None = None, *,
               shards: LMShards | None = None):
    """The forward pass over the prompt, filling the caches. tokens (B, S)
    -> (logits of the last position (B, V) float32, caches filled to S).
    The caches are ``s_max`` long (default S, as the reference's), zero
    past S: a caller that decodes passes the length it decodes to.

    ``shards``: one rank of a mesh (module docstring); ``tokens`` are this
    rank's rows, ``params`` its shards; the logits come back whole and the
    caches as this rank's block (B / batch ranks, s_max / ``"model"``, Kv,
    hd) of ``cache_specs``' sequence-sharded layout."""
    if shards is not None:
        require_gqa(cfg, "prefill")
    b, s = tokens.shape
    total = s if s_max is None else s_max
    if total < s:
        raise ValueError(f"s_max {s_max} is shorter than the prompt's {s} tokens")
    if shards is not None and (total % shards.seq.size or shards.seq.axes != shards.tp.axes):
        raise ValueError(f"caches of {total} slots do not split over {shards.seq}")
    x, positions = _embed(params, cfg, tokens, shards)
    caches = make_caches(cfg, b, total if shards is None else total // shards.seq.size, device=tokens.device)
    for layer, blk, moe in _layers(params, cfg):
        blk = _cast_block(blk, cfg.dtype)
        h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
        if cfg.attn == "mla":
            a, kv = L.mla_prefill(blk["attn"], h, positions, n_heads=cfg.n_heads, qk_nope_dim=cfg.qk_nope_dim,
                                  qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim,
                                  rope_theta=cfg.rope_theta, block_q=cfg.block_q)
            names = ("ckv", "krope")
        else:
            a, kv = L.gqa_prefill(blk["attn"], h, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                                  head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, block_q=cfg.block_q,
                                  tp=None if shards is None else shards.tp)
            names = ("k", "v")
        if shards is None:
            for name, t in zip(names, kv):
                caches[name][layer, :, :s] = t
        else:
            for name, t in zip(names, _seq_chunks(kv, cfg, total, shards)):
                caches[name][layer] = t
        x, _ = _ffn(blk, x + a, cfg, moe, shards)
    return _logits(params, cfg, x[:, -1, :], shards), caches


@torch.no_grad()
def lm_decode_step(params: Params, cfg: TransformerConfig, caches: dict, token: torch.Tensor, pos, *,
                   shards: LMShards | None = None):
    """One token per row: token (B,), ``pos`` an int or a 0-dim tensor (a
    tensor on the card keeps the step free of host syncs but the MoE
    routing's) -> (logits (B, V) float32, caches written at ``pos`` in
    place).

    ``shards``: one rank of a mesh; ``token`` its rows (every row in long
    context), ``caches`` its sequence chunk (``LMShards.seq``); the logits
    come back whole."""
    if shards is not None:
        require_gqa(cfg, "decode")
    x = L.vocab_lookup(params["embed"], token, None if shards is None else shards.tp)[:, None, :].to(cfg.dtype)
    pos = L.decode_position(pos, x.device)
    tp, seq = (None, None) if shards is None else (shards.tp, shards.seq)
    for layer, blk, moe in _layers(params, cfg):
        blk = _cast_block(blk, cfg.dtype)
        h = L.rms_norm(x, blk["ln1"], cfg.norm_eps)
        if cfg.attn == "mla":
            a, _ = L.mla_decode(blk["attn"], h, caches["ckv"][layer], caches["krope"][layer], pos,
                                n_heads=cfg.n_heads, qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
                                v_head_dim=cfg.v_head_dim, kv_lora_rank=cfg.kv_lora_rank,
                                rope_theta=cfg.rope_theta)
        else:
            a, _ = L.gqa_decode(blk["attn"], h, caches["k"][layer], caches["v"][layer], pos,
                                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                                rope_theta=cfg.rope_theta, tp=tp, seq=seq)
        x, _ = _ffn(blk, x + a, cfg, moe, shards)
    return _logits(params, cfg, x[:, 0, :], shards), caches
