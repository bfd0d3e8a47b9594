"""Gradient compression before the data-parallel reduction (reference:
``repro.train.compression``), as drop-in wrappers around the gradient tree:

* ``compress_bf16`` — cast the reduced operand to bfloat16 (half the
  traffic);
* ``compress_int8`` — per-tensor symmetric int8 with error feedback (the
  residual carried to the next step keeps the long-run bias at zero).

Both packages round half to even (``jnp.round``, ``torch.round``), so the
results are bit-equal to the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.utils import Tree, tree_leaves, tree_map, tree_unflatten


def compress_bf16(grads: Tree) -> Tree:
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def decompress_f32(grads: Tree) -> Tree:
    return tree_map(lambda g: g.to(torch.float32), grads)


class EFState(NamedTuple):
    """Error-feedback residuals, one per gradient leaf."""

    residual: Tree


def ef_init(params: Tree) -> EFState:
    return EFState(residual=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def _quant_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_int8(grads: Tree, ef: EFState) -> tuple[Tree, Tree, EFState]:
    """Returns (int8 tree, scale tree, new EF state): the int8 tree is what
    crosses the network; dequantize with the scales after the reduction."""

    def one(g, r):
        gf = g.to(torch.float32) + r
        q, scale = _quant_int8(gf)
        deq = q.to(torch.float32) * scale
        return q, scale, gf - deq

    out = [one(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(ef.residual))]
    qs, scales, res = (tree_unflatten(grads, [o[i] for o in out]) for i in range(3))
    return qs, scales, EFState(residual=res)


def decompress_int8(qs: Tree, scales: Tree) -> Tree:
    return tree_map(lambda q, s: q.to(torch.float32) * s, qs, scales)
