"""Shared transformer layers: RMS and layer norm, RoPE, grouped attention
(bidirectional, causal, chunked and offset), GQA attention with optional
QKV bias (forward, prefill and one-token decode against a cache), MLA
(multi-head latent attention, with the weight-absorbed decode) and the
SwiGLU MLP.

Weights keep the reference's layout and names: a dense weight is (in,
out) and is applied as ``x @ W`` (``nn.Linear`` would store (out, in)),
so the reference's parameter tree carries across as a plain copy.
Initialisation draws from an explicit ``torch.Generator`` on the
parameters' device; an ``init_*`` draws each leaf in float32 and stores it
in ``dtype`` (the reference draws in float32 and casts the tree). The
forwards are functions of a parameter dict (the reference's names); the
modules (``GQAAttention``, ``SwiGLU``, BERT4Rec's) call them with their
own parameters and training calls them with a tree that carries
gradients.

Mixed dtypes follow ``jnp``'s promotion: a float32 activation against a
bfloat16 weight is a float32 product (``matmul``, ``einsum``), since torch's
products take one dtype. The decode forms write the new position into the
caches in place and return them (the reference returns updated copies,
which its jitted step donates).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.utils import resolve_device


def dense_init(gen: torch.Generator, shape: tuple[int, ...], device) -> torch.Tensor:
    """A normal draw scaled by 1/√fan_in (fan_in = shape[0])."""
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) / math.sqrt(shape[0])


def _promote(*ts: torch.Tensor) -> list[torch.Tensor]:
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two (``jnp.matmul``'s rule)."""
    x, w = _promote(x, w)
    return x @ w


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the promoted dtype of the operands."""
    return torch.einsum(eq, *_promote(*ops))


def _scores_dtype(dtype: torch.dtype) -> torch.dtype:
    """The reference scales scores by a numpy float64 scalar, which lifts
    bfloat16 scores to float32 (float64 is off in JAX)."""
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's RMS norm: in float32, returned in ``x.dtype``."""
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's layer norm: population variance, eps 1e-6 (not
    ``torch.nn.functional.layer_norm``'s 1e-5), in float32."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, hd) with positions (..., S) -> rotated x. The halves
    rotate as split halves, ``concat(x1·cos − x2·sin, x2·cos + x1·sin)``,
    not as interleaved pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, q_offset: int = 0,
           block_q: int | None = None) -> torch.Tensor:
    """Grouped attention, the reference's ``_causal_attend``: q (B, Sq, H,
    hd), k/v (B, Sk, Kv, hd) -> (B, Sq, H, hd_v). ``causal=False`` is the
    bidirectional (encoder) form. Query i sits at position ``q_offset + i``.
    ``block_q`` chunks the query axis so the (Sq × Sk) score tile is never
    made whole (the 32k prefill). A causal chunk scores only the keys at or
    before its last query: the keys after it are masked to −∞ in the
    reference and add exact zeros there, so this changes the order of the
    sums, not their terms."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    scale = 1.0 / math.sqrt(hd)

    def attend_block(q_blk: torch.Tensor, start: int) -> torch.Tensor:
        n = q_blk.shape[1]
        end = min(sk, q_offset + start + n) if causal else sk
        kk, vv = k[:, :end], v[:, :end]
        s = torch.einsum("bqkgd,bskd->bqkgs", q_blk, kk).to(_scores_dtype(q.dtype)) * scale
        if causal:
            qpos = q_offset + start + torch.arange(n, device=q.device)
            mask = torch.arange(end, device=q.device)[None, :] <= qpos[:, None]
            s = s.masked_fill(~mask[None, :, None, None, :], float("-inf"))
        p = torch.softmax(s.to(torch.float32), dim=-1).to(q.dtype)
        return torch.einsum("bqkgs,bskd->bqkgd", p, vv)

    if block_q is None or block_q >= sq:
        out = attend_block(qg, 0)
    else:
        if sq % block_q:
            raise ValueError(f"block_q {block_q} does not divide the query length {sq}")
        out = torch.cat([attend_block(qg[:, i:i + block_q], i) for i in range(0, sq, block_q)], dim=1)
    return out.reshape(b, sq, h, v.shape[-1])


def init_gqa(gen: torch.Generator, *, d_model: int, n_heads: int, n_kv: int, head_dim: int, qkv_bias: bool,
             device="cuda", dtype: torch.dtype = torch.float32) -> dict:
    """The reference's ``init_gqa``: ``wq``, ``wk``, ``wv``, ``wo`` and, with
    ``qkv_bias``, zero ``bq``, ``bk``, ``bv``."""
    device = resolve_device(device)
    p = {
        "wq": dense_init(gen, (d_model, n_heads * head_dim), device).to(dtype),
        "wk": dense_init(gen, (d_model, n_kv * head_dim), device).to(dtype),
        "wv": dense_init(gen, (d_model, n_kv * head_dim), device).to(dtype),
        "wo": dense_init(gen, (n_heads * head_dim, d_model), device).to(dtype),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros(width * head_dim, device=device, dtype=dtype)
    return p


def _qkv(p: dict, x: torch.Tensor, positions: torch.Tensor, n_heads: int, n_kv: int, head_dim: int,
         rope_theta: float):
    """Projected, biased (where ``p`` has ``bq``) and rotated q, k, v."""
    b, s, _ = x.shape
    q, k, v = matmul(x, p["wq"]), matmul(x, p["wk"]), matmul(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(b, s, n_heads, head_dim), positions, rope_theta)
    k = apply_rope(k.reshape(b, s, n_kv, head_dim), positions, rope_theta)
    return q, k, v.reshape(b, s, n_kv, head_dim)


def reduce_partial(tp, t: torch.Tensor) -> torch.Tensor:
    """``tp.reduce_from`` of a rank's partial sums, added in float32 and
    rounded to ``t``'s dtype once (float32 partials are summed as they
    are)."""
    return tp.reduce_from(t.to(torch.float32)).to(t.dtype)


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor, tp=None) -> torch.Tensor:
    """``table[ids]`` where ``table`` is this rank's row shard of a
    vocabulary over ``tp``: each rank looks up the ids in its rows and
    gives zeros for the rest, and the ranks' rows are summed
    (``reduce_from``; one term is not zero, so the sum is exact)."""
    if tp is None or tp.size == 1:
        return table[ids]
    local = ids - tp.index * table.shape[0]
    own = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(own, local, 0)]
    return tp.reduce_from(torch.where(own[..., None], rows, 0.0))


def vocab_log_prob(logits: torch.Tensor, ids: torch.Tensor, tp=None) -> torch.Tensor:
    """log softmax(logits)[ids] along the last dim, float32. Over ``tp``
    (a vocabulary-parallel head: ``logits`` is this rank's block of the
    vocabulary) the logits are never gathered: the shift is the maximum
    over every block (no gradient: the softmax does not depend on it), and
    the sum of exponentials and the target's logit (from the rank that owns
    it) are summed across the blocks with ``reduce_from``, so the result
    is whole on every rank and each rank's backward reaches its own
    block."""
    ids = ids.long()
    if tp is None or tp.size == 1:
        return torch.log_softmax(logits, dim=-1).gather(-1, ids[..., None])[..., 0]
    z = logits - tp.max(logits.detach().amax(-1, keepdim=True))
    lse = torch.log(tp.reduce_from(torch.exp(z).sum(-1)))
    local = ids - tp.index * logits.shape[-1]
    own = (local >= 0) & (local < logits.shape[-1])
    target = z.gather(-1, torch.where(own, local, 0)[..., None])[..., 0]
    return tp.reduce_from(torch.where(own, target, 0.0)) - lse


def _heads_on(tp, n_heads: int, n_kv: int) -> tuple[int, bool]:
    """(query heads a rank of ``tp`` holds, whether its k/v columns are
    whole heads). Query heads that do not divide raise ``ValueError``."""
    if n_heads % tp.size:
        raise ValueError(f"{n_heads} query heads do not divide over {tp.size} ranks")
    return n_heads // tp.size, n_kv % tp.size == 0


def _gather_columns(tp, *ts: torch.Tensor) -> list[torch.Tensor]:
    """Each of ``ts`` (…, this rank's columns) with every rank's columns in
    shard order (…, all of them): one all-gather for all of them. Each
    rank goes on with its own heads' part of the result, so the gather's
    backward sums the gradient over ``tp`` before taking this rank's
    columns (``MeshAxes.gather(per_rank=True)``)."""
    if tp.size == 1:
        return list(ts)
    widths = [t.shape[-1] for t in ts]
    lead = ts[0].shape[:-1]
    whole = tp.gather(torch.cat(ts, -1), -1, per_rank=True).reshape(*lead, tp.size, sum(widths))
    return [part.reshape(*lead, tp.size * w) for part, w in zip(whole.split(widths, -1), widths)]


def _heads(p: dict, x: torch.Tensor, positions: torch.Tensor, n_heads: int, n_kv: int, head_dim: int,
           rope_theta: float, tp):
    """Attention's inputs on one rank of ``tp`` (None: every head): (q of
    this rank's query heads, k and v of the Kv heads they read, the cache
    contents (k, v)), each (B, S, heads, hd), q and k rotated. Where the
    Kv heads divide over the ranks a rank holds whole heads and the cache
    contents are its Kv / ranks heads. Where they do not, a rank's columns
    of ``wk``/``wv`` split a head: the k/v projections are gathered over
    ``tp`` before RoPE, each query head reads its Kv head from the whole,
    and the cache contents hold every head."""
    if tp is None or tp.size == 1:
        q, k, v = _qkv(p, x, positions, n_heads, n_kv, head_dim, rope_theta)
        return q, k, v, (k, v)
    h_loc, whole = _heads_on(tp, n_heads, n_kv)
    if whole:
        q, k, v = _qkv(p, x, positions, h_loc, n_kv // tp.size, head_dim, rope_theta)
        return q, k, v, (k, v)
    b, s, _ = x.shape
    q, k, v = matmul(x, p["wq"]), matmul(x, p["wk"]), matmul(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    k, v = _gather_columns(tp, k, v)
    q = apply_rope(q.reshape(b, s, h_loc, head_dim), positions, rope_theta)
    k = apply_rope(k.reshape(b, s, n_kv, head_dim), positions, rope_theta)
    v = v.reshape(b, s, n_kv, head_dim)
    # the Kv head each of this rank's query heads reads
    kv_of = (tp.index * h_loc + torch.arange(h_loc, device=x.device)) // (n_heads // n_kv)
    return q, k[:, :, kv_of], v[:, :, kv_of], (k, v)


def gqa_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
                rope_theta: float = 10000.0, block_q: int | None = None, causal: bool = True,
                tp=None) -> torch.Tensor:
    """Grouped-query attention over the weights ``p`` (``wq``, ``wk``,
    ``wv``, ``wo``; ``bq``, ``bk``, ``bv`` where present): x (B, S, D),
    positions (B, S) -> (B, S, D).

    ``tp`` (a ``distributed.collectives.MeshAxes``) splits the heads over
    its ranks: ``p`` holds this rank's column block of ``wq``/``wk``/``wv``
    (and the biases), its heads, and the matching row block of ``wo``; the
    input enters through ``copy_to`` and the partial outputs leave through
    ``reduce_from``. Kv heads that do not divide over the ranks are
    gathered before RoPE (:func:`_heads`). ``n_heads`` and ``n_kv`` are
    the whole model's."""
    return _attention(p, x, positions, n_heads, n_kv, head_dim, rope_theta, block_q, causal, tp)[0]


def _attention(p, x, positions, n_heads, n_kv, head_dim, rope_theta, block_q, causal, tp):
    """(out, cache contents) of :func:`gqa_forward` and :func:`gqa_prefill`."""
    b, s, _ = x.shape
    q, k, v, kv = _heads(p, x if tp is None else tp.copy_to(x), positions, n_heads, n_kv, head_dim, rope_theta, tp)
    out = matmul(attend(q, k, v, causal=causal, block_q=block_q).reshape(b, s, -1), p["wo"])
    return (out if tp is None else reduce_partial(tp, out)), kv


def gqa_prefill(p: dict, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
                rope_theta: float, block_q: int | None = None, tp=None):
    """Causal ``gqa_forward`` that also returns the cache contents: (out
    (B, S, D), (k, v) each (B, S, Kv, hd), k rotated). Over ``tp``, k and v
    are this rank's Kv / ranks heads, or every head where the Kv heads do
    not divide over the ranks (:func:`_heads`)."""
    return _attention(p, x, positions, n_heads, n_kv, head_dim, rope_theta, block_q, True, tp)


def decode_position(pos, device) -> torch.Tensor:
    """The decode position as a (1,) int64 tensor on ``device`` (no copy
    where it is one already)."""
    return torch.as_tensor(pos, device=device).reshape(1).to(torch.int64)


def gqa_decode(p: dict, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos, *, n_heads: int,
               n_kv: int, head_dim: int, rope_theta: float, tp=None, seq=None):
    """One-token decode: x (B, 1, D); caches (B, S_max, Kv, hd); ``pos`` an
    int or a 0-dim tensor. Writes position ``pos`` of both caches in place,
    attends over every slot at or below it (float32 softmax, probabilities
    cast to ``x.dtype``) and returns (out (B, 1, D), (k_cache, v_cache)).

    Across ranks (flash-decoding): ``tp`` holds this rank's heads' columns
    of ``wq``/``wk``/``wv`` and rows of ``wo``; the new token's q, k, v are
    gathered over ``tp`` before RoPE (every head, so a head that ``wk``'s
    columns split is whole). ``seq`` splits the caches' sequence: the
    caches are this rank's chunk of S_max / ``seq.size`` slots, written
    only where it holds ``pos``. Each rank scores every head over its chunk
    with the same mask; the softmax's maximum and its sum are combined over
    ``seq`` before the probabilities are formed, and the weighted values
    are summed over ``seq``. The rank's heads' slice of the output goes
    through its rows of ``wo`` and is summed over ``tp``."""
    b, chunk = x.shape[0], k_cache.shape[1]
    pos_t = decode_position(pos, x.device)
    q, k, v = matmul(x, p["wq"]), matmul(x, p["wk"]), matmul(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if tp is not None:
        _heads_on(tp, n_heads, n_kv)
        q, k, v = _gather_columns(tp, q, k, v)
    q = apply_rope(q.reshape(b, 1, n_heads, head_dim), pos_t, rope_theta)
    k = apply_rope(k.reshape(b, 1, n_kv, head_dim), pos_t, rope_theta)
    v = v.reshape(b, 1, n_kv, head_dim)
    spread = seq is not None and seq.size > 1
    base = seq.index * chunk if spread else 0
    if spread:  # only the chunk that holds pos takes the new token
        slot = (pos_t - base).clamp(0, chunk - 1)
        inside = (pos_t >= base) & (pos_t < base + chunk)
        k = torch.where(inside, k, k_cache.index_select(1, slot))
        v = torch.where(inside, v, v_cache.index_select(1, slot))
    else:
        slot = pos_t
    k_cache.index_copy_(1, slot, k)
    v_cache.index_copy_(1, slot, v)
    qg = q.reshape(b, n_kv, n_heads // n_kv, head_dim)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).to(_scores_dtype(q.dtype)) / math.sqrt(head_dim)
    mask = base + torch.arange(chunk, device=x.device) <= pos_t
    s = s.masked_fill(~mask, float("-inf")).to(torch.float32)
    if spread:
        e = torch.exp(s - seq.max(s.amax(-1, keepdim=True)))
        pr = (e / seq.sum(e.sum(-1, keepdim=True))).to(x.dtype)
        out = seq.sum(torch.einsum("bkgs,bskd->bkgd", pr.to(torch.float32), v_cache.to(torch.float32))).to(x.dtype)
    else:
        pr = torch.softmax(s, dim=-1).to(x.dtype)
        out = torch.einsum("bkgs,bskd->bkgd", pr, v_cache)
    if tp is None:
        return matmul(out.reshape(b, 1, n_heads * head_dim), p["wo"]), (k_cache, v_cache)
    h_loc = n_heads // tp.size
    mine = out.reshape(b, 1, n_heads, head_dim)[:, :, tp.index * h_loc:(tp.index + 1) * h_loc]
    return reduce_partial(tp, matmul(mine.reshape(b, 1, h_loc * head_dim), p["wo"])), (k_cache, v_cache)


class GQAAttention(nn.Module):
    """Grouped-query attention with RoPE on q and k (the reference's
    ``init_gqa`` / ``gqa_forward``); QKV bias by default, as BERT4Rec has."""

    def __init__(self, gen: torch.Generator, *, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 rope_theta: float = 10000.0, qkv_bias: bool = True, device: str | torch.device = "cuda"):
        super().__init__()
        self.n_heads, self.n_kv, self.head_dim, self.rope_theta = n_heads, n_kv, head_dim, rope_theta
        p = init_gqa(gen, d_model=d_model, n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, qkv_bias=qkv_bias,
                     device=device)
        self._names = tuple(p)
        for name, value in p.items():
            setattr(self, name, nn.Parameter(value))

    def params(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self._names}

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
        """x (B, S, D), positions (B, S) -> (B, S, D)."""
        return gqa_forward(self.params(), x, positions, n_heads=self.n_heads, n_kv=self.n_kv,
                           head_dim=self.head_dim, rope_theta=self.rope_theta, causal=causal)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, *, d_model: int, d_ff: int, device="cuda",
             dtype: torch.dtype = torch.float32) -> dict:
    device = resolve_device(device)
    return {
        "wg": dense_init(gen, (d_model, d_ff), device).to(dtype),
        "wu": dense_init(gen, (d_model, d_ff), device).to(dtype),
        "wd": dense_init(gen, (d_ff, d_model), device).to(dtype),
    }


class SwiGLU(nn.Module):
    """``(silu(x @ wg) * (x @ wu)) @ wd``."""

    def __init__(self, gen: torch.Generator, *, d_model: int, d_ff: int, device: str | torch.device = "cuda"):
        super().__init__()
        p = init_mlp(gen, d_model=d_model, d_ff=d_ff, device=device)
        self.wg, self.wu, self.wd = (nn.Parameter(p[k]) for k in ("wg", "wu", "wd"))

    def params(self) -> dict[str, torch.Tensor]:
        return {"wg": self.wg, "wu": self.wu, "wd": self.wd}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(self.params(), x)


def mlp_forward(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """``(silu(x @ wg) * (x @ wu)) @ wd`` over the weights ``p``. ``tp``
    splits the hidden width over its ranks as ``gqa_forward`` splits the
    heads: ``wg``/``wu`` by columns, ``wd`` by rows."""
    if tp is not None:
        x = tp.copy_to(x)
    out = matmul(F.silu(matmul(x, p["wg"])) * matmul(x, p["wu"]), p["wd"])
    return out if tp is None else reduce_partial(tp, out)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (deepseek-v3)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, *, d_model: int, n_heads: int, q_lora_rank: int, kv_lora_rank: int,
             qk_nope_dim: int, qk_rope_dim: int, v_head_dim: int, device="cuda",
             dtype: torch.dtype = torch.float32) -> dict:
    """The reference's ``init_mla``: low-rank q and kv projections with
    their norm scales, one shared rope key head, and the output."""
    device = resolve_device(device)
    qk_head = qk_nope_dim + qk_rope_dim

    def w(shape):
        return dense_init(gen, shape, device).to(dtype)

    return {
        "wq_a": w((d_model, q_lora_rank)),
        "q_norm": torch.ones(q_lora_rank, device=device, dtype=dtype),
        "wq_b": w((q_lora_rank, n_heads * qk_head)),
        "wkv_a": w((d_model, kv_lora_rank)),
        "kv_norm": torch.ones(kv_lora_rank, device=device, dtype=dtype),
        "wk_rope": w((d_model, qk_rope_dim)),
        "wk_b": w((kv_lora_rank, n_heads * qk_nope_dim)),
        "wv_b": w((kv_lora_rank, n_heads * v_head_dim)),
        "wo": w((n_heads * v_head_dim, d_model)),
    }


def mla_latent(p: dict, x: torch.Tensor, positions: torch.Tensor, *, qk_rope_dim: int, rope_theta: float):
    """The latent cache contents of x (B, S, D): (c_kv (B, S, r_kv), the
    rotated shared rope key (B, S, 1, rope))."""
    b, s, _ = x.shape
    c_kv = rms_norm(matmul(x, p["wkv_a"]), p["kv_norm"])
    k_rope = apply_rope(matmul(x, p["wk_rope"]).reshape(b, s, 1, qk_rope_dim), positions, rope_theta)
    return c_kv, k_rope


def _mla_query(p: dict, x: torch.Tensor, n_heads: int, qk_nope_dim: int, qk_rope_dim: int):
    b, s, _ = x.shape
    q = matmul(rms_norm(matmul(x, p["wq_a"]), p["q_norm"]), p["wq_b"])
    return q.reshape(b, s, n_heads, qk_nope_dim + qk_rope_dim).split([qk_nope_dim, qk_rope_dim], dim=-1)


def mla_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int, qk_nope_dim: int,
                qk_rope_dim: int, v_head_dim: int, rope_theta: float, block_q: int | None = None) -> torch.Tensor:
    """MLA training/prefill forward in the full multi-head form: x (B, S,
    D) -> (B, S, D)."""
    return mla_prefill(p, x, positions, n_heads=n_heads, qk_nope_dim=qk_nope_dim, qk_rope_dim=qk_rope_dim,
                       v_head_dim=v_head_dim, rope_theta=rope_theta, block_q=block_q)[0]


def mla_prefill(p: dict, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int, qk_nope_dim: int,
                qk_rope_dim: int, v_head_dim: int, rope_theta: float, block_q: int | None = None):
    """``mla_forward`` that also returns the latent cache contents: (out
    (B, S, D), (c_kv (B, S, r_kv), k_rope (B, S, rope)))."""
    b, s, _ = x.shape
    q_nope, q_rope = _mla_query(p, x, n_heads, qk_nope_dim, qk_rope_dim)
    q_rope = apply_rope(q_rope, positions, rope_theta)
    c_kv, k_rope = mla_latent(p, x, positions, qk_rope_dim=qk_rope_dim, rope_theta=rope_theta)
    k_nope = matmul(c_kv, p["wk_b"]).reshape(b, s, n_heads, qk_nope_dim)
    v = matmul(c_kv, p["wv_b"]).reshape(b, s, n_heads, v_head_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, n_heads, qk_rope_dim)], dim=-1)
    out = attend(q_full, k_full, v, block_q=block_q)
    return matmul(out.reshape(b, s, n_heads * v_head_dim), p["wo"]), (c_kv, k_rope[:, :, 0])


def mla_decode(p: dict, x: torch.Tensor, ckv_cache: torch.Tensor, krope_cache: torch.Tensor, pos, *,
               n_heads: int, qk_nope_dim: int, qk_rope_dim: int, v_head_dim: int, kv_lora_rank: int,
               rope_theta: float):
    """Latent-cache decode with weight absorption: x (B, 1, D), caches
    ``ckv`` (B, S_max, r_kv) and ``krope`` (B, S_max, rope), written in
    place at ``pos``. ``wk_b`` folds into the query and ``wv_b`` into the
    output, so attention runs against the latent cache itself. Returns
    (out (B, 1, D), (ckv_cache, krope_cache))."""
    b, s_max = x.shape[0], ckv_cache.shape[1]
    pos_t = decode_position(pos, x.device)
    q_nope, q_rope = _mla_query(p, x, n_heads, qk_nope_dim, qk_rope_dim)
    q_rope = apply_rope(q_rope, pos_t, rope_theta)[:, 0]  # (B, H, rope)
    c_kv, k_rope = mla_latent(p, x, pos_t, qk_rope_dim=qk_rope_dim, rope_theta=rope_theta)
    ckv_cache.index_copy_(1, pos_t, c_kv)
    krope_cache.index_copy_(1, pos_t, k_rope[:, :, 0])
    wk_b = p["wk_b"].reshape(kv_lora_rank, n_heads, qk_nope_dim)
    q_lat = einsum("bhd,rhd->bhr", q_nope[:, 0], wk_b)
    scores = einsum("bhr,bsr->bhs", q_lat, ckv_cache) + einsum("bhr,bsr->bhs", q_rope, krope_cache)
    scores = scores.to(_scores_dtype(scores.dtype)) / math.sqrt(qk_nope_dim + qk_rope_dim)
    mask = torch.arange(s_max, device=x.device) <= pos_t
    scores = scores.masked_fill(~mask, float("-inf"))
    pr = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
    ctx = einsum("bhs,bsr->bhr", pr, ckv_cache)
    wv_b = p["wv_b"].reshape(kv_lora_rank, n_heads, v_head_dim)
    out = einsum("bhr,rhv->bhv", ctx, wv_b)
    return matmul(out.reshape(b, 1, n_heads * v_head_dim), p["wo"]), (ckv_cache, krope_cache)
