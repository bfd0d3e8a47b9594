"""Mixture-of-Experts layer (deepseek-v3: 1 shared + 256 routed top-8;
moonshot/moonlight: 64 routed top-6 + 2 shared), in PyTorch.

Dispatch, as the reference selects it per config:

* ``"scatter"`` — each (token, slot) assignment takes the next place in
  its expert's capacity buffer (a stable sort by expert id); the (E, C, D)
  buffers go through one grouped SwiGLU and the outputs are gathered back.
  Assignments past an expert's capacity are dropped.
* ``"einsum"`` — the one-hot dispatch and combine products.
* ``"ep"`` — expert parallelism over a mesh's ``ep_axis`` (the
  reference's ``shard_map`` dispatch): each rank routes its chunk of the
  tokens, fills every expert's buffer at a per-device capacity, sends each
  expert's buffer to the rank that holds it (one ``all_to_all``), runs its
  own experts and sends the outputs back (the reverse ``all_to_all``).
  Without a mesh, without ``ep_axis`` on it, or with a token count that
  does not divide over the mesh's ranks or is smaller than their number,
  it is the reference's fallback: scatter at the global capacity.

Under a mesh with the ``"model"`` axis (``moe_forward(..., mesh=)``, or the
ambient ``distributed.context`` mesh, as the reference finds it) a rank
holds its experts' shard of ``wg``/``wu``/``wd`` (E / ep of them, by
``lm_param_specs``), the router whole and the shared experts by hidden
columns. Scatter and einsum then run at the global capacity over every
token this rank's group holds, each rank filling only its own experts'
buffers; the partial outputs are summed over ``"model"``.

With ``global_aux`` (training) the aux losses are the reference's over
every token of the mesh, whose GSPMD program routes them all before it
dispatches: a rank routes its own tokens, and the ingredients, not the
products, are summed over the axes that split the tokens (every axis in
the ep branch, ``token_axes`` in the fallback): the assignment counts with
no gradient, the probabilities' and the squared log-sum-exps' sums with
``reduce_from`` (one all-reduce a layer). Without it (serving, which reads
no aux) they are those of the tokens a rank routed.

For gradients (LM training across ranks), replicated state that meets a
rank's own share of the work enters through ``copy_to``: in the ep branch
the router and the block of tokens a rank takes its chunk from (over the
axes that replicate the block), in the fallback the tokens and their
combine weights (over ``"model"``, each rank running its own experts). The
ep branch's chunks are gathered back with the gather whose backward takes
a rank's own block (``MeshAxes.gather``), and its exchanges send the
gradients back (``MeshAxes.all_to_all``).

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

from repro_torch.distributed.collectives import MeshAxes
from repro_torch.distributed.context import get_current_mesh
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


def _route(p: dict, flat: torch.Tensor, cfg: MoEConfig, toks: MeshAxes | None = None):
    """(weights (N, k) in ``flat.dtype``, expert ids (N, k) int64, aux
    losses {"load_balance", "router_z"} as 0-dim float32 tensors). With
    ``toks`` (the axes that split the tokens, ``flat`` being this rank's)
    the aux losses are over every token of the group: the counts, the
    probabilities' sums and the squared log-sum-exps' sum are summed over
    it in one all-reduce (``reduce_from``: the counts carry no gradient,
    the sums pass theirs back to this rank's tokens)."""
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
    one_hot = F.one_hot(idx, e).to(torch.float32)
    lse2 = torch.logsumexp(logits, dim=-1) ** 2
    if toks is None or toks.size == 1:
        lb = e * (one_hot.sum(1).mean(0) * probs.mean(0)).sum()
        z = lse2.mean()
    else:
        n = flat.shape[0] * toks.size
        sums = toks.reduce_from(torch.cat([one_hot.sum((0, 1)), probs.sum(0), lse2.sum()[None]]))
        lb = e * ((sums[:e] / n) * (sums[e:2 * e] / n)).sum()
        z = sums[2 * e] / n
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


def _slots(idx: torch.Tensor, cfg: MoEConfig, capacity: int, offset: torch.Tensor | None = None):
    """(slot, keep) of every (token, slot) assignment in (E·capacity)
    buffers: its expert's row block and its arrival position, or the spare
    row E·capacity past the capacity. ``offset`` (E,) adds the assignments
    to each expert that arrived before these tokens (other ranks')."""
    e_flat = idx.reshape(-1)
    pos = _positions_by_expert(e_flat, cfg.n_experts)
    if offset is not None:
        pos = pos + offset[e_flat]
    keep = pos < capacity
    return torch.where(keep, e_flat * capacity + pos, cfg.n_experts * capacity), keep


def _fill(flat: torch.Tensor, slot: torch.Tensor, rows: int, k: int) -> torch.Tensor:
    """(rows + 1, D) buffers with every token copy at its slot; the spare
    last row takes every dropped assignment (the reference's out-of-range
    slot under mode="drop") and is cut off by the caller."""
    xe = torch.zeros((rows + 1, flat.shape[1]), dtype=flat.dtype, device=flat.device)
    xe[slot] = flat.repeat_interleave(k, dim=0)
    return xe


def _combine(ye: torch.Tensor, slot, keep, w, n: int, k: int, dtype) -> torch.Tensor:
    """The weighted sum of each token's expert outputs, ye (rows, D)."""
    y_tok = torch.where(keep[:, None], ye[slot.clamp_max(ye.shape[0] - 1)], 0.0)
    return (y_tok.reshape(n, k, -1) * w[..., None].to(dtype)).sum(1)


def _dispatch_scatter(flat, w, idx, p, cfg: MoEConfig, capacity: int, offset=None, e0: int = 0) -> torch.Tensor:
    """Scatter at ``capacity``. ``p`` may hold the experts [e0, e0 + E_loc)
    alone (a rank's shard): only their buffers are filled and run, and the
    other experts' assignments add nothing here."""
    n, d = flat.shape
    k, e_loc = cfg.top_k, p["wg"].shape[0]
    slot, keep = _slots(idx, cfg, capacity, offset)
    if e_loc != cfg.n_experts:
        mine = keep & (slot >= e0 * capacity) & (slot < (e0 + e_loc) * capacity)
        slot, keep = torch.where(mine, slot - e0 * capacity, e_loc * capacity), mine
    xe = _fill(flat, slot, e_loc * capacity, k)
    ye = _expert_ffn(xe[:-1].reshape(e_loc, capacity, d), p).reshape(e_loc * capacity, d)
    return _combine(ye, slot, keep, w, n, k, flat.dtype)


def _dispatch_einsum(flat, w, idx, p, cfg: MoEConfig, capacity: int, offset=None, e0: int = 0) -> torch.Tensor:
    """The one-hot dispatch at ``capacity``; over a rank's experts [e0, e0 +
    E_loc) where ``p`` holds that shard, as :func:`_dispatch_scatter`."""
    n, _ = flat.shape
    e, e_loc = cfg.n_experts, p["wg"].shape[0]
    e_oh = F.one_hot(idx, e)[..., e0:e0 + e_loc].to(flat.dtype)  # (N, k, E_loc)
    pos = _positions_by_expert(idx.reshape(-1), e)
    if offset is not None:
        pos = pos + offset[idx.reshape(-1)]
    pos = pos.reshape(n, cfg.top_k)
    keep = (pos < capacity).to(flat.dtype)
    # jax.nn.one_hot gives a zero row past the last class; so does keep
    pos_oh = F.one_hot(pos.clamp_max(capacity - 1), capacity).to(flat.dtype) * keep[..., None]
    dispatch = torch.einsum("nke,nkc->nec", e_oh, pos_oh)
    combine = torch.einsum("nke,nkc,nk->nec", e_oh, pos_oh, w.to(flat.dtype))
    xe = torch.einsum("nec,nd->ecd", dispatch, flat)
    return einsum("nec,ecd->nd", combine, _expert_ffn(xe, p))


def _dispatch_ep(flat, w, idx, p, cfg: MoEConfig, c_dev: int, ep: MeshAxes) -> torch.Tensor:
    """The reference's ``_dispatch_ep`` on one rank: its tokens (n, D)
    grouped per global expert at the per-device capacity ``c_dev`` (its
    own arrival positions), each expert's group sent to the rank holding it
    (``all_to_all`` over ``ep``), the grouped SwiGLU over this rank's E /
    ep experts, the outputs sent back and combined."""
    n, d = flat.shape
    k, e, m = cfg.top_k, cfg.n_experts, ep.size
    e_loc = e // m
    slot, keep = _slots(idx, cfg, c_dev)
    xe = _fill(flat, slot, e * c_dev, k)[:-1].reshape(m, e_loc * c_dev, d)
    # block j holds experts [j·E_loc, (j+1)·E_loc): rank j receives its own
    # experts' groups from every rank
    xe = ep.all_to_all(xe).reshape(m, e_loc, c_dev, d).transpose(0, 1).reshape(e_loc, m * c_dev, d)
    ye = _expert_ffn(xe, p).reshape(e_loc, m, c_dev, d).transpose(0, 1).reshape(m, e_loc * c_dev, d)
    ye = ep.all_to_all(ye).reshape(e * c_dev, d)
    return _combine(ye, slot, keep, w, n, k, flat.dtype)


def _moe_on_mesh(p: dict, flat: torch.Tensor, cfg: MoEConfig, mesh, token_axes: tuple, global_aux: bool):
    """The dispatch on one rank of ``mesh``: ``flat`` is the block of the
    tokens that this rank's group along ``token_axes`` holds (every token
    where there are none), replicated over the other axes; ``p`` holds
    this rank's experts. Returns (this block's output, aux losses: over
    every token with ``global_aux``, else over this rank's)."""
    ep = MeshAxes(mesh, cfg.ep_axis)
    e_loc = cfg.n_experts // ep.size
    if cfg.n_experts % ep.size or p["wg"].shape[0] != e_loc:
        raise ValueError(f"on a mesh with {cfg.ep_axis!r} of {ep.size} the expert weights are a rank's "
                         f"{cfg.n_experts} / {ep.size} experts; got wg of shape {tuple(p['wg'].shape)}")
    if tuple(token_axes) != mesh.axis_names[:len(token_axes)]:
        raise ValueError(f"token axes {token_axes} must lead the mesh's axes {mesh.axis_names}")
    toks = MeshAxes(mesh, token_axes)
    rest = MeshAxes(mesh, mesh.axis_names[len(token_axes):])
    n, n_dev = flat.shape[0] * toks.size, mesh.size
    if cfg.impl == "ep" and n % n_dev == 0 and n >= n_dev:
        # tokens split over every axis in axis order: this rank's chunk is
        # its position along the axes that replicate the block
        n_loc = n // n_dev
        mine = rest.copy_to(flat)[rest.index * n_loc:(rest.index + 1) * n_loc]
        every = MeshAxes(mesh, mesh.axis_names if global_aux else ())
        w, idx, aux = _route({"router": rest.copy_to(p["router"])}, mine, cfg, every)
        c_loc = max(int(math.ceil(n_loc * cfg.top_k / cfg.n_experts * cfg.capacity_factor)), 1)
        c_loc = -(-c_loc // ep.size) * ep.size  # a multiple of ep for the exchange's split
        return rest.gather(_dispatch_ep(mine, w, idx, p, cfg, c_loc, ep), 0), aux
    # the global capacity-scatter: the assignments of the blocks before this
    # one arrive first at every expert
    w, idx, aux = _route(p, flat, cfg, toks if global_aux else None)
    offset = None
    if toks.size > 1:
        counts = toks.gather(torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)[None], 0)
        offset = counts[:toks.index].sum(0)
    dispatch = {"scatter": _dispatch_scatter, "ep": _dispatch_scatter, "einsum": _dispatch_einsum}[cfg.impl]
    out = dispatch(ep.copy_to(flat), ep.copy_to(w), idx, p, cfg, _capacity(n, cfg), offset, ep.index * e_loc)
    if ep.size > 1:
        out = ep.reduce_from(out.to(torch.float32)).to(flat.dtype)
    return out, aux


def moe_forward(p: dict, x: torch.Tensor, cfg: MoEConfig, *, mesh=None, token_axes: tuple = (),
                global_aux: bool = False):
    """x (B, S, D) -> (out (B, S, D), aux losses). ``mesh`` (default: the
    ambient one): a mesh with ``cfg.ep_axis`` puts the dispatch across its
    ranks (module docstring), ``x`` being the tokens this rank's group
    along ``token_axes`` (leading axes of the mesh) holds; ``global_aux``
    makes the aux losses those of every token there."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    mesh = get_current_mesh() if mesh is None else mesh
    if cfg.impl not in ("scatter", "einsum", "ep"):
        raise ValueError(f"unknown moe impl {cfg.impl!r}")
    if mesh is not None and cfg.ep_axis in mesh.shape:
        out, aux = _moe_on_mesh(p, flat, cfg, mesh, tuple(token_axes), global_aux)
        tp = MeshAxes(mesh, "model")
    else:
        w, idx, aux = _route(p, flat, cfg)
        dispatch = _dispatch_einsum if cfg.impl == "einsum" else _dispatch_scatter
        out, tp = dispatch(flat, w, idx, p, cfg, _capacity(flat.shape[0], cfg)), None
    if cfg.n_shared:
        out = out + mlp_forward(p["shared"], flat, tp)
    return out.reshape(b, s, d), aux
