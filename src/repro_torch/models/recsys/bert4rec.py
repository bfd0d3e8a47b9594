"""BERT4Rec — bidirectional transformer over item sequences
(arXiv:1904.06690), in PyTorch.

Cloze training: random positions are masked and the model predicts the
masked item from both directions (:func:`bert4rec_loss`, a function of the
reference's parameter tree that carries gradients; ``repro_torch.train``
runs the optimizer). Serving scores the next item at a session's final
(mask) position against the item-embedding table (weights tied).
``Bert4Rec.serve`` gives the (B, D) query vectors that
``models/recsys/retrieval.py`` scores against the catalog. The module and
the tree carry across both ways with :func:`params_from_jax` and
:func:`params_to_jax`; both forwards run :func:`block_forward`.

Tensor-parallel over a mesh's ``"model"`` axis (``tp``, a
``distributed.collectives.MeshAxes``; ``launch/steps.py``'s mesh cells),
the tree holds this rank's shards as the reference's ``_b4r_specs`` lays
them out: the tied item table and ``out_bias`` by vocabulary rows, the
attention by heads, the MLP by hidden columns. The item lookup is
vocabulary-parallel (each rank looks up the ids in its rows, zeros for the
others, summed across the ranks), logits come per vocabulary shard, and
the cloze loss is a vocabulary-parallel log-softmax. ``tp`` None, or one
rank wide, is the one-process model bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.utils import resolve_device, to_numpy, tree_map

#: parameter names outside ``attn``/``mlp``, as the reference's ``init_bert4rec`` lays them out
_BLOCK_NORMS = ("ln1", "ln1b", "ln2", "ln2b")
_TOP = ("item_embed", "pos_embed", "ln_f", "ln_fb", "out_bias")


@dataclass(frozen=True)
class Bert4RecConfig:
    n_items: int = 1_000_000  # production-scale item vocabulary
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    mask_prob: float = 0.2
    dtype: torch.dtype = torch.float32

    @property
    def mask_id(self) -> int:
        return self.n_items  # the extra row

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.n_heads


class Block(nn.Module):
    """Pre-norm encoder block: bidirectional GQA with QKV bias, SwiGLU."""

    def __init__(self, gen: torch.Generator, cfg: Bert4RecConfig, device):
        super().__init__()
        d = cfg.embed_dim
        self.attn = L.GQAAttention(gen, d_model=d, n_heads=cfg.n_heads, n_kv=cfg.n_heads,
                                   head_dim=cfg.head_dim, device=device)
        self.mlp = L.SwiGLU(gen, d_model=d, d_ff=4 * d, device=device)
        self.ln1 = nn.Parameter(torch.ones(d, device=device))
        self.ln1b = nn.Parameter(torch.zeros(d, device=device))
        self.ln2 = nn.Parameter(torch.ones(d, device=device))
        self.ln2b = nn.Parameter(torch.zeros(d, device=device))

    def params(self) -> dict:
        """The block's parameters as the reference's per-block tree."""
        return {"attn": self.attn.params(), "mlp": self.mlp.params(),
                **{k: getattr(self, k) for k in _BLOCK_NORMS}}


def block_forward(blk: dict, cfg: Bert4RecConfig, x: torch.Tensor, positions: torch.Tensor,
                  tp=None) -> torch.Tensor:
    """One pre-norm encoder block over the per-block tree ``blk`` (heads and
    hidden columns split over ``tp``)."""
    h = L.layer_norm(x, blk["ln1"], blk["ln1b"])
    x = x + L.gqa_forward(blk["attn"], h, positions, n_heads=cfg.n_heads, n_kv=cfg.n_heads,
                          head_dim=cfg.head_dim, causal=False, tp=tp)
    h = L.layer_norm(x, blk["ln2"], blk["ln2b"])
    return x + L.mlp_forward(blk["mlp"], h, tp)


def row_base(table: torch.Tensor, tp) -> int:
    """The first vocabulary row of this rank's shard of ``table``."""
    return 0 if tp is None else tp.index * table.shape[0]


def _encode(p: dict, blocks, cfg: Bert4RecConfig, items: torch.Tensor, tp=None) -> torch.Tensor:
    """items (B, S) int -> hidden (B, S, D) over the top-level parameters
    ``p`` and the per-block trees ``blocks``; items move to the table's
    device."""
    items = torch.as_tensor(items).to(p["item_embed"].device).long()
    b, s = items.shape
    x = (L.vocab_lookup(p["item_embed"], items, tp) + p["pos_embed"][None, :s]).to(cfg.dtype)
    positions = torch.arange(s, device=items.device).expand(b, s)
    for blk in blocks:
        x = block_forward(blk, cfg, x, positions, tp)
    return L.layer_norm(x, p["ln_f"], p["ln_fb"])


def _serve(p: dict, blocks, cfg: Bert4RecConfig, items: torch.Tensor, tp=None) -> torch.Tensor:
    """The final position's hidden state: (B, S) -> (B, D) float32 query
    vectors."""
    return _encode(p, blocks, cfg, items, tp)[:, -1, :].to(torch.float32)


def _logits(p: dict, h: torch.Tensor, tp=None) -> torch.Tensor:
    """Hidden states against the tied table: this rank's vocabulary shard
    of the logits (the hidden states enter the shard through ``copy_to``)."""
    if tp is not None:
        h = tp.copy_to(h)
    return h @ p["item_embed"].T + p["out_bias"]


def _score_all(p: dict, blocks, cfg: Bert4RecConfig, items: torch.Tensor, tp=None) -> torch.Tensor:
    """Logits over the whole vocabulary (B, V+1); over ``tp``, this rank's
    vocabulary block (B, (V+1) / ranks)."""
    return _logits(p, _serve(p, blocks, cfg, items, tp), tp)


def _unstack(p: dict, cfg: Bert4RecConfig) -> list:
    """The per-block trees of the reference's tree (blocks stacked on a
    leading ``n_blocks`` axis)."""
    return [tree_map(lambda t, i=i: t[i], p["blocks"]) for i in range(cfg.n_blocks)]


def bert4rec_encode(p: dict, cfg: Bert4RecConfig, items: torch.Tensor, tp=None) -> torch.Tensor:
    """items (B, S) -> hidden (B, S, D) over the reference's parameter tree
    (this rank's shards over ``tp``); carries gradients."""
    return _encode(p, _unstack(p, cfg), cfg, items, tp)


def bert4rec_loss(p: dict, cfg: Bert4RecConfig, items: torch.Tensor, mask_positions: torch.Tensor, *,
                  tp=None, batch=None) -> torch.Tensor:
    """Cloze loss over the parameter tree ``p``: items (B, S); the positions
    where ``mask_positions`` (B, S) is set are replaced with [MASK], and the
    mean negative log-likelihood of their original ids under the tied
    softmax over every item (and [MASK]) is returned, a 0-dim float32.

    Across ranks ``p`` holds this rank's shards over ``tp`` (the model
    axis) and the sessions are its slice over ``batch`` (the batch axes):
    the mean's denominator counts the masked positions of every slice, so
    the loss is this slice's part of the global batch's mean, which the
    ranks along ``batch`` sum."""
    dev = p["item_embed"].device
    items = torch.as_tensor(items).to(dev).long()
    mask_positions = torch.as_tensor(mask_positions).to(dev)
    masked = torch.where(mask_positions, cfg.mask_id, items)
    h = bert4rec_encode(p, cfg, masked, tp)  # (B, S, D)
    logits = _logits(p, h.to(torch.float32), tp)  # (B, S, V+1), or its vocabulary shard
    ll = L.vocab_log_prob(logits, items, tp)
    m = mask_positions.to(torch.float32)
    count = torch.sum(m) if batch is None else batch.sum(torch.sum(m))
    return -torch.sum(ll * m) / torch.clamp_min(count, 1.0)


def bert4rec_serve(p: dict, cfg: Bert4RecConfig, items: torch.Tensor, tp=None) -> torch.Tensor:
    """:meth:`Bert4Rec.serve` over the parameter tree (its shards over ``tp``)."""
    return _serve(p, _unstack(p, cfg), cfg, items, tp)


def bert4rec_score_all(p: dict, cfg: Bert4RecConfig, items: torch.Tensor, tp=None) -> torch.Tensor:
    """:meth:`Bert4Rec.score_all` over the parameter tree; over ``tp``, this
    rank's vocabulary block of the logits."""
    return _score_all(p, _unstack(p, cfg), cfg, items, tp)


class Bert4Rec(nn.Module):
    """The encoder and its tied item table.

    ``item_embed`` and ``out_bias`` have ``n_items + 1`` rows; the last is
    [MASK]. Parameters are drawn from ``gen`` on ``device`` (a generator
    seeded 0 there when none is given).
    """

    def __init__(self, cfg: Bert4RecConfig, gen: torch.Generator | None = None, *,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
        self.cfg = cfg
        d = cfg.embed_dim
        self.item_embed = nn.Parameter(
            torch.randn((cfg.n_items + 1, d), generator=gen, device=dev) * 0.02
        )
        self.pos_embed = nn.Parameter(torch.randn((cfg.seq_len, d), generator=gen, device=dev) * 0.02)
        self.blocks = nn.ModuleList(Block(gen, cfg, dev) for _ in range(cfg.n_blocks))
        self.ln_f = nn.Parameter(torch.ones(d, device=dev))
        self.ln_fb = nn.Parameter(torch.zeros(d, device=dev))
        self.out_bias = nn.Parameter(torch.zeros(cfg.n_items + 1, device=dev))

    @property
    def device(self) -> torch.device:
        return self.item_embed.device

    def _trees(self) -> tuple[dict, list]:
        """The top-level parameters and the per-block trees."""
        return {k: getattr(self, k) for k in _TOP}, [blk.params() for blk in self.blocks]

    @torch.no_grad()
    def encode(self, items: torch.Tensor) -> torch.Tensor:
        """items (B, S) int -> hidden (B, S, D). Bidirectional attention."""
        return _encode(*self._trees(), self.cfg, items)

    @torch.no_grad()
    def serve(self, items: torch.Tensor) -> torch.Tensor:
        """Online scoring: the final position's hidden state (the next-item
        query vector). items (B, S) with items[:, -1] == mask_id by
        convention. Returns (B, D) float32."""
        return _serve(*self._trees(), self.cfg, items)

    @torch.no_grad()
    def score_all(self, items: torch.Tensor) -> torch.Tensor:
        """Bulk scoring: (B, S) -> logits over the full item vocab (B, V+1)."""
        return _score_all(*self._trees(), self.cfg, items)


def items_from_uniform(u: torch.Tensor, cfg: Bert4RecConfig) -> torch.Tensor:
    """Popularity-skewed (zipf-ish) item ids from uniforms u in [1e-6, 1):
    ``clip(int32(u^(−1/1.2) − 1), 0, n_items − 1)``, truncated toward 0."""
    return torch.clamp((u ** (-1 / 1.2) - 1).to(torch.int32), 0, cfg.n_items - 1)


def sample_training_batch(gen: torch.Generator, cfg: Bert4RecConfig, batch: int):
    """Synthetic session data: (items (B, S) int32, mask_positions (B, S)
    bool), with at least the last position masked in every row. Drawn from
    ``gen`` on its device."""
    dev = gen.device
    u = torch.rand((batch, cfg.seq_len), generator=gen, device=dev) * (1.0 - 1e-6) + 1e-6
    items = items_from_uniform(u, cfg)
    mask_positions = torch.rand((batch, cfg.seq_len), generator=gen, device=dev) < cfg.mask_prob
    mask_positions[:, -1] = True
    return items, mask_positions


def params_from_jax(params_np: dict, cfg: Bert4RecConfig, *, device: str | torch.device = "cuda") -> Bert4Rec:
    """A ``Bert4Rec`` holding the reference's parameters, given its tree
    (``init_bert4rec``'s layout) as numpy arrays or tensors. The reference
    stacks the blocks on a leading ``n_blocks`` axis; dense weights are
    (in, out) in both packages."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    model = Bert4Rec(cfg, gen, device=dev)

    def put(param: nn.Parameter, value) -> None:
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value, dtype=np.float32))
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"shape {tuple(value.shape)} does not fit {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(value.to(torch.float32))

    for name in _TOP:
        put(getattr(model, name), params_np[name])
    blocks = params_np["blocks"]
    for i, blk in enumerate(model.blocks):
        tree_map(lambda param, value: put(param, value[i]), blk.params(), blocks)
    return model


def params_tree(model: Bert4Rec) -> dict:
    """The model's parameters as the reference's tree of tensors (copies on
    the model's device, blocks stacked on a leading ``n_blocks`` axis): what
    :func:`bert4rec_loss` and ``repro_torch.train`` take."""
    with torch.no_grad():
        blocks = tree_map(lambda *ts: torch.stack(ts), *[blk.params() for blk in model.blocks])
        return {"blocks": blocks, **{k: getattr(model, k).detach().clone() for k in _TOP}}


def params_to_jax(model: Bert4Rec) -> dict:
    """The inverse of :func:`params_from_jax`: the reference's tree
    (``init_bert4rec``'s layout) as float32 numpy arrays."""
    return tree_map(to_numpy, params_tree(model))
