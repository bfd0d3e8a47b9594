"""AdamW with decoupled weight decay, global-norm clipping and cosine,
linear or constant schedules, over parameter trees (reference:
``repro.train.optimizer``).

The update is the reference's ``upd`` written out, not ``torch.optim.AdamW``:
with bfloat16 moments the reference computes ``mhat`` from the unrounded
float32 ``m2`` and stores only the rounded one. The schedule and the bias
corrections are float32 tensors, as ``jnp`` computes them (Python floats
are float64 and differ in the last bit). The state mirrors the parameter
tree, so it lives wherever each parameter lives.

Under a mesh (``mesh`` and ``specs``: each leaf's ``PartitionSpec``-like
spec) the leaves are a rank's shards and the clipping norm is global: a
leaf's sum of squares is all-reduced over the axes it is sharded on, a
replicated leaf counted once. The caller has summed any partial gradients
(over the batch axes) before.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.distributed.collectives import MeshAxes, axes_of
from repro_torch.train.elastic import map_with_specs
from repro_torch.utils import Tree, tree_global_norm, tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # "cosine" | "linear" | "constant"
    min_lr_frac: float = 0.1
    state_dtype: str = "f32"  # moments: "f32" or "bf16" (half the optimizer memory)


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Tree
    nu: Tree


def adamw_init(params: Tree, *, state_dtype: str = "f32") -> AdamWState:
    dt = torch.bfloat16 if state_dtype == "bf16" else torch.float32
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=dt), params)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), mu=zeros,
                      nu=tree_map(torch.clone, zeros))


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or int tensor), a float32 0-dim
    tensor: linear warmup, then the schedule's decay to ``min_lr_frac``."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_frac) * frac
    else:
        decay = torch.ones((), dtype=torch.float32, device=s.device)
    return cfg.lr * warm * decay


def global_norm(grads: Tree, specs=None, mesh=None) -> torch.Tensor:
    """``tree_global_norm`` of the whole tree whose shards ``grads`` holds
    on this rank of ``mesh`` (``specs``: the leaves' specs, a prefix of the
    tree as ``train.elastic.map_with_specs`` takes). The leaves' sums of
    squares add in leaf order, so a mesh one rank wide gives
    ``tree_global_norm``'s bits."""
    if mesh is None or specs is None:
        return tree_global_norm(grads)
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(grads)]
    axes = tree_leaves(map_with_specs(lambda _, spec: ",".join(axes_of(spec)), grads, specs))
    for key in dict.fromkeys(axes):
        ax = MeshAxes(mesh, tuple(key.split(",")) if key else ())
        idx = [i for i, a in enumerate(axes) if a == key]
        if ax.size > 1:
            for i, total in zip(idx, ax.sum(torch.stack([sq[i] for i in idx])).unbind()):
                sq[i] = total
    return torch.sqrt(sum(sq))


#: elements per slice of a leaf's update: its float32 temporaries stay a
#: few slices' worth, whatever the leaf's size (llama3.2-3b's stacked
#: (28, 3072, 8192) leaves are 2.8 GB each)
_SLICE = 1 << 26


def adamw_update(cfg: AdamWConfig, grads: Tree, state: AdamWState, params: Tree, *,
                 donate: bool = False, mesh=None, specs=None) -> tuple[Tree, AdamWState, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics) with
    metrics ``grad_norm`` (before clipping) and ``lr``, 0-dim tensors.

    The update runs over slices of each leaf in turn. With ``donate`` each
    slice's new parameters and moments are written into the tensors of
    ``params`` and ``state`` (which must be contiguous), and those trees
    are returned: the reference's donated step, with no second copy of the
    state alive. Elementwise arithmetic is the same on any slice, so both
    forms give the same bits. ``mesh`` and ``specs`` make the clipping
    norm global over a mesh's shards (:func:`global_norm`); ``mesh=None``
    is the one-process update."""
    gnorm = global_norm(grads, specs, mesh)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    sf = step.to(torch.float32)
    b1t = 1 - torch.pow(cfg.b1, sf)
    b2t = 1 - torch.pow(cfg.b2, sf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m2 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v2 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        mhat = m2 / b1t
        vhat = v2 / b2t
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return new_p, m2.to(m.dtype), v2.to(v.dtype)

    out = []
    with torch.no_grad():
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu)):
            dst = (p, m, v) if donate else tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                                                 for t in (p, m, v))
            flat_dst = [t.view(-1) for t in dst]
            flat_src = [t.reshape(-1) for t in (p, g, m, v)]
            for lo in range(0, p.numel(), _SLICE):
                for d, new in zip(flat_dst, upd(*(t[lo:lo + _SLICE] for t in flat_src))):
                    d[lo:lo + _SLICE].copy_(new)
            out.append(dst)
    if donate:
        new_p, new_m, new_v = params, state.mu, state.nu
    else:
        new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v), {"grad_norm": gnorm, "lr": lr}
