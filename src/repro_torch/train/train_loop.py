"""Train-step factory and host loop: microbatching, compression,
checkpoints (reference: ``repro.train.train_loop``).

``make_train_step`` builds the (loss → grad → compression → clip → AdamW)
step over a state tree ``{"params", "opt_state"[, "ef_state"]}``:

* gradient accumulation over ``microbatches`` (the batch's leaves carry a
  leading microbatch axis): float32 sums averaged over the microbatches,
  the step's loss the mean of theirs;
* optional gradient compression (bf16, or int8 with error feedback) of the
  accumulated tree before the optimizer.

``train`` is the host loop: auto-resume from the latest checkpoint,
periodic checkpoints, a log line with ``steps_per_s``. With ``donate=True``
each step writes the new parameters and moments into the state's tensors,
so the parameters the caller passed are updated in place and no second
copy of the state is ever alive.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import compression as comp
from repro_torch.train.optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update
from repro_torch.utils import Tree, tree_leaves, tree_map, tree_unflatten

#: (params, batch) -> (loss, metrics), the loss a 0-dim tensor that carries gradients
LossFn = Callable[[Tree, Any], tuple[torch.Tensor, dict]]


@dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    compression: str = "none"  # "none" | "bf16" | "int8_ef"
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
    log_every: int = 10


class TrainState:
    """Params, optimizer state and (with ``int8_ef``) error feedback."""

    def __init__(self, params, opt_state, ef_state=None):
        self.params = params
        self.opt_state = opt_state
        self.ef_state = ef_state

    def tree(self) -> dict:
        t = {"params": self.params, "opt_state": self.opt_state}
        if self.ef_state is not None:
            t["ef_state"] = self.ef_state
        return t

    @classmethod
    def from_tree(cls, t: dict) -> "TrainState":
        return cls(t["params"], t["opt_state"], t.get("ef_state"))


def init_train_state(params: Tree, tc: TrainConfig) -> TrainState:
    ef = comp.ef_init(params) if tc.compression == "int8_ef" else None
    return TrainState(params, adamw_init(params, state_dtype=tc.opt.state_dtype), ef)


def value_and_grad(loss_fn: LossFn, params: Tree, batch) -> tuple[torch.Tensor, dict, Tree]:
    """(loss, metrics, grads) of ``loss_fn`` at ``params``, loss and metrics
    detached; a parameter the loss does not reach gets a zero gradient."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_unflatten(params, grads)


def make_train_step(loss_fn: LossFn, tc: TrainConfig, *, donate: bool = False, sync=None, mesh=None,
                    specs=None):
    """Returns step(state_tree, batch) -> (state_tree, metrics).

    With ``tc.microbatches > 1`` every leaf of ``batch`` has a leading
    microbatch axis of that size (``data.pipeline.microbatch_reshape``);
    the float32 sum starts from the first microbatch's gradients (the
    reference adds them to zeros, which gives the same bits). With
    ``donate`` the step writes the new parameters and moments into the
    state's own tensors as the update reaches each leaf
    (``adamw_update(donate=True)``), and returns the same trees.

    On one rank of a mesh the state holds the rank's shards (``specs``:
    each leaf's spec, a prefix of the parameter tree): ``sync(loss,
    grads) -> (loss, grads)`` completes the rank's partial loss and
    gradients (sums over the batch or edge shards) before compression and
    clipping, and the clipping norm is global (``adamw_update``'s
    ``mesh``).
    """

    def step(state_tree: dict, batch):
        params = state_tree["params"]
        opt_state: AdamWState = state_tree["opt_state"]
        if tc.microbatches > 1:
            grads, losses = None, []
            for i in range(tc.microbatches):
                loss, _, g = value_and_grad(loss_fn, params, tree_map(lambda x, i=i: x[i], batch))
                g = tree_map(lambda t: t.to(torch.float32), g)
                grads = g if grads is None else tree_map(lambda a, b: a.add_(b), grads, g)
                losses.append(loss)
            grads = tree_map(lambda g: g / tc.microbatches, grads)
            loss = torch.mean(torch.stack(losses))
            metrics = {}
        else:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        if sync is not None:
            loss, grads = sync(loss, grads)

        new_ef = state_tree.get("ef_state")
        if tc.compression == "bf16":
            grads = comp.decompress_f32(comp.compress_bf16(grads))
        elif tc.compression == "int8_ef":
            qs, scales, new_ef = comp.compress_int8(grads, state_tree["ef_state"])
            grads = comp.decompress_int8(qs, scales)

        new_params, new_opt, opt_metrics = adamw_update(tc.opt, grads, opt_state, params, donate=donate,
                                                        mesh=mesh, specs=specs)
        out = {"params": new_params, "opt_state": new_opt}
        if new_ef is not None:
            out["ef_state"] = new_ef
        return out, {"loss": loss, **metrics, **opt_metrics}

    return step


def train(
    loss_fn: LossFn,
    params: Tree,
    data_iter,
    *,
    tc: TrainConfig,
    n_steps: int,
    ckpt_dir: str | None = None,
    donate: bool = True,
    log_fn=print,
):
    """Host loop with auto-resume. Returns (final state, history): one
    history entry per log, ``{"step", "loss", …, "steps_per_s"}``.

    It saves every ``checkpoint_every`` steps and once at the end. The
    reference saves the last step twice where ``n_steps`` is a multiple of
    ``checkpoint_every``, and its second ``os.replace`` onto the first
    raises; here the last step is saved once.
    """
    state = init_train_state(params, tc)
    tree = state.tree()
    start_step = 0
    if ckpt_dir and ckpt_mod.latest_checkpoint(ckpt_dir) is not None:
        tree, start_step = ckpt_mod.restore_checkpoint(ckpt_dir, tree)
        log_fn(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(loss_fn, tc, donate=donate)
    history = []
    saved = None
    t_last = time.perf_counter()
    for step in range(start_step, n_steps):
        batch = next(data_iter)
        tree, metrics = step_fn(tree, batch)
        if (step + 1) % tc.log_every == 0 or step + 1 == n_steps:
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            metrics["steps_per_s"] = tc.log_every / dt
            history.append({"step": step + 1, **metrics})
            log_fn(f"[train] step {step + 1} loss {metrics['loss']:.4f} ({metrics['steps_per_s']:.2f} it/s)")
        if ckpt_dir and (step + 1) % tc.checkpoint_every == 0:
            ckpt_mod.save_checkpoint(ckpt_dir, step + 1, tree, keep=tc.keep_checkpoints)
            saved = step + 1
    if ckpt_dir and saved != n_steps:
        ckpt_mod.save_checkpoint(ckpt_dir, n_steps, tree, keep=tc.keep_checkpoints)
    return TrainState.from_tree(tree), history
