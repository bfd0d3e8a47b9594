"""Mixture-of-Experts layer (deepseek-v3: 1 shared + 256 routed top-8;
moonshot/moonlight: 64 routed top-6 + 2 shared), in PyTorch.

Dispatch, as the reference selects it per config:

* ``"scatter"`` — each (token, slot) assignment takes the next place in
  its expert's capacity buffer (a stable sort by expert id); the (E, C, D)
  buffers go through one grouped SwiGLU and the outputs are gathered back.
  Assignments past an expert's capacity are dropped.
* ``"einsum"`` — the one-hot dispatch and combine products.
* ``"ep"`` — expert parallelism. Without a process group this is the
  reference's own no-mesh branch: scatter at the same capacity. Across
  cards it waits for the mesh (ROADMAP queue 1, item 7).

Routing: softmax gating, or deepseek-v3's sigmoid gating with the top-k
weights normalized. Aux losses: the Switch load balance and the router z.
The top-k is ``jax.lax.top_k``'s (ties to the lower expert id,
``utils.topk_first``), and the sort is stable, so capacity drops pick the
reference's assignments.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.layers import einsum, init_mlp, mlp_forward
from repro_torch.utils import resolve_device, topk_first


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden
    n_shared: int = 0  # shared experts (always on), deepseek style
    capacity_factor: float = 1.25
    router: str = "softmax"  # or "sigmoid" (deepseek-v3)
    impl: str = "scatter"  # "scatter" | "einsum" | "ep"
    ep_axis: str = "model"  # mesh axis the experts are sharded over (impl="ep")


def init_moe(gen: torch.Generator, *, d_model: int, cfg: MoEConfig, device="cuda",
             dtype: torch.dtype = torch.float32) -> dict:
    """The reference's ``init_moe``: ``router`` (D, E), ``wg``/``wu`` (E, D,
    F), ``wd`` (E, F, D) and, with shared experts, a SwiGLU ``shared`` of
    width ``n_shared · d_ff``. The expert weights are drawn one expert at
    a time in float32 and stored in ``dtype`` (a float32 draw of deepseek's
    whole (256, 7168, 2048) tensor would be 15 GB)."""
    device = resolve_device(device)
    e, f = cfg.n_experts, cfg.d_ff

    def experts(shape, scale):
        out = torch.empty((e, *shape), device=device, dtype=dtype)
        for i in range(e):
            out[i] = torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * scale
        return out

    scale = 1.0 / math.sqrt(d_model)
    p = {
        "router": (torch.randn((d_model, e), generator=gen, device=device, dtype=torch.float32) * scale).to(dtype),
        "wg": experts((d_model, f), scale),
        "wu": experts((d_model, f), scale),
        "wd": experts((f, d_model), 1.0 / math.sqrt(f)),
    }
    if cfg.n_shared:
        p["shared"] = init_mlp(gen, d_model=d_model, d_ff=cfg.n_shared * f, device=device, dtype=dtype)
    return p


def _route(p: dict, flat: torch.Tensor, cfg: MoEConfig):
    """(weights (N, k) in ``flat.dtype``, expert ids (N, k) int64, aux
    losses {"load_balance", "router_z"} as 0-dim float32 tensors)."""
    logits = flat.to(torch.float32) @ p["router"].to(torch.float32)
    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
        w, idx = topk_first(scores, cfg.top_k)
        probs = scores / scores.sum(-1, keepdim=True).clamp_min(1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = topk_first(probs, cfg.top_k)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    e = cfg.n_experts
    f_e = F.one_hot(idx, e).to(torch.float32).sum(1).mean(0)
    lb = e * (f_e * probs.mean(0)).sum()
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return w.to(flat.dtype), idx, {"load_balance": lb, "router_z": z}


def _expert_ffn(xe: torch.Tensor, p: dict) -> torch.Tensor:
    """Grouped SwiGLU: xe (E, C, D) -> (E, C, D)."""
    g = einsum("ecd,edf->ecf", xe, p["wg"])
    u = einsum("ecd,edf->ecf", xe, p["wu"])
    return einsum("ecf,efd->ecd", F.silu(g) * u, p["wd"])


def _positions_by_expert(e_flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each assignment's arrival position within its expert: a stable sort
    by expert id, the rank within each run, unsorted."""
    nk = e_flat.shape[0]
    ar = torch.arange(nk, device=e_flat.device)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    start = torch.searchsorted(e_sorted, torch.arange(n_experts, device=e_flat.device, dtype=e_sorted.dtype))
    pos_sorted = ar - start[e_sorted]
    inv = torch.empty_like(order)
    inv[order] = ar
    return pos_sorted[inv]


def _capacity(n: int, cfg: MoEConfig) -> int:
    """Slots per expert: ⌈n·k/E·cf⌉, at least 1 and at most n."""
    return min(max(int(math.ceil(n * cfg.top_k / cfg.n_experts * cfg.capacity_factor)), 1), n)


def _dispatch_scatter(flat, w, idx, p, cfg: MoEConfig, capacity: int) -> torch.Tensor:
    n, d = flat.shape
    k, e = cfg.top_k, cfg.n_experts
    e_flat = idx.reshape(-1)
    pos = _positions_by_expert(e_flat, e)
    keep = pos < capacity
    slot = torch.where(keep, e_flat * capacity + pos, e * capacity)
    # one spare row takes every dropped assignment (the reference's
    # out-of-range slot under mode="drop") and is cut off after
    xe = torch.zeros((e * capacity + 1, d), dtype=flat.dtype, device=flat.device)
    xe[slot] = flat.repeat_interleave(k, dim=0)
    ye = _expert_ffn(xe[:-1].reshape(e, capacity, d), p).reshape(e * capacity, d)
    y_tok = torch.where(keep[:, None], ye[slot.clamp_max(e * capacity - 1)], 0.0)
    return (y_tok.reshape(n, k, d) * w[..., None].to(flat.dtype)).sum(1)


def _dispatch_einsum(flat, w, idx, p, cfg: MoEConfig, capacity: int) -> torch.Tensor:
    n, _ = flat.shape
    e = cfg.n_experts
    e_oh = F.one_hot(idx, e).to(flat.dtype)  # (N, k, E)
    pos = _positions_by_expert(idx.reshape(-1), e).reshape(n, cfg.top_k)
    keep = (pos < capacity).to(flat.dtype)
    # jax.nn.one_hot gives a zero row past the last class; so does keep
    pos_oh = F.one_hot(pos.clamp_max(capacity - 1), capacity).to(flat.dtype) * keep[..., None]
    dispatch = torch.einsum("nke,nkc->nec", e_oh, pos_oh)
    combine = torch.einsum("nke,nkc,nk->nec", e_oh, pos_oh, w.to(flat.dtype))
    xe = torch.einsum("nec,nd->ecd", dispatch, flat)
    return einsum("nec,ecd->nd", combine, _expert_ffn(xe, p))


def moe_forward(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """x (B, S, D) -> (out (B, S, D), aux losses)."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    w, idx, aux = _route(p, flat, cfg)
    capacity = _capacity(flat.shape[0], cfg)
    if cfg.impl == "ep" and torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError("expert-parallel dispatch across cards is not ported yet "
                                  "(ROADMAP queue 1, item 7: the mesh)")
    if cfg.impl in ("scatter", "ep"):
        out = _dispatch_scatter(flat, w, idx, p, cfg, capacity)
    elif cfg.impl == "einsum":
        out = _dispatch_einsum(flat, w, idx, p, cfg, capacity)
    else:
        raise ValueError(f"unknown moe impl {cfg.impl!r}")
    if cfg.n_shared:
        out = out + mlp_forward(p["shared"], flat)
    return out.reshape(b, s, d), aux
