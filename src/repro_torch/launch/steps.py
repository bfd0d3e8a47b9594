"""The LM family's train step, optimizer settings and model FLOPs
(reference: ``repro.launch.steps``, its LM part). The reference builds
each step for a mesh; the mesh's shardings wait for ROADMAP queue 1,
item 7, and the GNN and recsys steps for items 9b and 9d.

The FLOPs are the reference's analytic counts: 6·N_active per trained
token, 2·N_active per prefilled token, and a decode step's 2·N_active per
row plus attention against the whole cache.
"""

from __future__ import annotations

from repro_torch.models import transformer as tfm
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainConfig, make_train_step


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
