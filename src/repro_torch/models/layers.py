"""Shared transformer layers, as far as BERT4Rec uses them: layer norm,
RoPE, bidirectional or causal grouped attention, the GQA attention module
with QKV bias and the SwiGLU MLP module.

Weights keep the reference's layout: a dense weight is (in, out) and is
applied as ``x @ W`` (``nn.Linear`` would store (out, in)), so the
reference's parameter tree carries across as a plain copy. Initialisation
draws from an explicit ``torch.Generator`` on the parameters' device. The
forwards are also functions of a parameter dict (``gqa_forward``,
``mlp_forward``, the reference's names), which the modules call with their
own parameters and training calls with a tree that carries gradients.
``rms_norm``, the prefill and decode forms and MLA are not ported yet
(ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.utils import resolve_device


def dense_init(gen: torch.Generator, shape: tuple[int, ...], device) -> torch.Tensor:
    """A normal draw scaled by 1/√fan_in (fan_in = shape[0])."""
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) / math.sqrt(shape[0])


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's layer norm: population variance, eps 1e-6 (not
    ``torch.nn.functional.layer_norm``'s 1e-5), in float32."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


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


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """Grouped attention: q (B, Sq, H, hd), k/v (B, Sk, Kv, hd) -> (B, Sq,
    H, hd_v). ``causal=False`` is the bidirectional (encoder) form. The
    reference's ``_causal_attend`` without its ``block_q`` chunking and
    ``q_offset`` (query positions start at 0)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, k) * (1.0 / math.sqrt(hd))
    if causal:
        qpos = torch.arange(sq, device=q.device)
        mask = torch.arange(sk, device=q.device)[None, :] <= qpos[:, None]
        s = s.masked_fill(~mask[None, :, None, None, :], float("-inf"))
    p = torch.softmax(s.to(torch.float32), dim=-1).to(q.dtype)
    out = torch.einsum("bqkgs,bskd->bqkgd", p, v)
    return out.reshape(b, sq, h, v.shape[-1])


class GQAAttention(nn.Module):
    """Grouped-query attention with QKV bias and RoPE on q and k (the
    reference's ``init_gqa(qkv_bias=True)`` / ``gqa_forward``)."""

    def __init__(self, gen: torch.Generator, *, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 device: str | torch.device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        self.wq = nn.Parameter(dense_init(gen, (d_model, n_heads * head_dim), device))
        self.wk = nn.Parameter(dense_init(gen, (d_model, n_kv * head_dim), device))
        self.wv = nn.Parameter(dense_init(gen, (d_model, n_kv * head_dim), device))
        self.wo = nn.Parameter(dense_init(gen, (n_heads * head_dim, d_model), device))
        self.bq = nn.Parameter(torch.zeros(n_heads * head_dim, device=device))
        self.bk = nn.Parameter(torch.zeros(n_kv * head_dim, device=device))
        self.bv = nn.Parameter(torch.zeros(n_kv * head_dim, device=device))

    def params(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")}

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
        """x (B, S, D), positions (B, S) -> (B, S, D); RoPE with θ = 10,000."""
        return gqa_forward(self.params(), x, positions, n_heads=self.n_heads, n_kv=self.n_kv,
                           head_dim=self.head_dim, causal=causal)


def gqa_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
                causal: bool = True) -> torch.Tensor:
    """Grouped-query attention with QKV bias over the weights ``p`` (``wq``,
    ``wk``, ``wv``, ``wo``, ``bq``, ``bk``, ``bv``): x (B, S, D), positions
    (B, S) -> (B, S, D); RoPE with θ = 10,000."""
    b, s, _ = x.shape
    q, k, v = x @ p["wq"] + p["bq"], x @ p["wk"] + p["bk"], x @ p["wv"] + p["bv"]
    q = apply_rope(q.reshape(b, s, n_heads, head_dim), positions)
    k = apply_rope(k.reshape(b, s, n_kv, head_dim), positions)
    v = v.reshape(b, s, n_kv, head_dim)
    out = attend(q, k, v, causal=causal)
    return out.reshape(b, s, n_heads * head_dim) @ p["wo"]


class SwiGLU(nn.Module):
    """``(silu(x @ wg) * (x @ wu)) @ wd``."""

    def __init__(self, gen: torch.Generator, *, d_model: int, d_ff: int, device: str | torch.device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.wg = nn.Parameter(dense_init(gen, (d_model, d_ff), device))
        self.wu = nn.Parameter(dense_init(gen, (d_model, d_ff), device))
        self.wd = nn.Parameter(dense_init(gen, (d_ff, d_model), device))

    def params(self) -> dict[str, torch.Tensor]:
        return {"wg": self.wg, "wu": self.wu, "wd": self.wd}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(self.params(), x)


def mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ wg) * (x @ wu)) @ wd`` over the weights ``p``."""
    return (torch.nn.functional.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
