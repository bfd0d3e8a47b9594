"""AdamW with decoupled weight decay, global-norm clipping and cosine,
linear or constant schedules, over parameter trees (reference:
``repro.train.optimizer``).

The update is the reference's ``upd`` written out, not ``torch.optim.AdamW``:
with bfloat16 moments the reference computes ``mhat`` from the unrounded
float32 ``m2`` and stores only the rounded one. The schedule and the bias
corrections are float32 tensors, as ``jnp`` computes them (Python floats
are float64 and differ in the last bit). The state mirrors the parameter
tree, so it lives wherever each parameter lives.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

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


def adamw_update(cfg: AdamWConfig, grads: Tree, state: AdamWState, params: Tree) -> tuple[Tree, AdamWState, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics) with
    metrics ``grad_norm`` (before clipping) and ``lr``, 0-dim tensors."""
    gnorm = tree_global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    sf = step.to(torch.float32)
    b1t = 1 - torch.pow(cfg.b1, sf)
    b2t = 1 - torch.pow(cfg.b2, sf)

    def upd(p, g, m, v):
        m2 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v2 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        mhat = m2 / b1t
        vhat = v2 / b2t
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return new_p, m2.to(m.dtype), v2.to(v.dtype)

    out = [upd(*a) for a in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
                                 tree_leaves(state.nu))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v), {"grad_norm": gnorm, "lr": lr}
