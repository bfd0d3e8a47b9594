"""Distance-table quantization (paper §3.3.3, Eq. 9) and 4-bit code packing.

Every partial distance in the asymmetric (ADT) and symmetric (SDT) tables is
mapped to an ``H``-bit level with one shared ``(dist_min, Δ)``:

    η(dist) = floor((dist − dist_min) / Δ · (2^H − 1))

so ADT and SDT sums stay comparable. The op order below is the reference's
(subtract, divide, multiply, floor, all float32), so equal float inputs give
equal levels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TableQuant(NamedTuple):
    """Shared affine quantizer for ADT/SDT entries (Eq. 9)."""

    dist_min: torch.Tensor  # () f32
    delta: torch.Tensor  # () f32 == dist_max - dist_min, clamped > 0
    h: torch.Tensor  # () int32 bits per quantized distance


def fit_table_quant(
    per_subspace_min: torch.Tensor, per_subspace_max: torch.Tensor, *, h: int = 8
) -> TableQuant:
    """dist_max = Σ_i dist_max_i, dist_min = min_i dist_min_i (§3.3.3)."""
    dist_max = per_subspace_max.sum()
    dist_min = per_subspace_min.min()
    delta = torch.clamp_min(dist_max - dist_min, 1e-12)
    return TableQuant(
        dist_min=dist_min,
        delta=delta,
        h=torch.tensor(h, dtype=torch.int32, device=dist_min.device),
    )


def _levels(tq: TableQuant) -> torch.Tensor:
    return (2 ** tq.h.to(torch.int64) - 1).to(torch.float32)


def quantize_table(tq: TableQuant, table: torch.Tensor) -> torch.Tensor:
    """Apply Eq. 9 to float partial distances -> int32 levels."""
    levels = _levels(tq)
    q = torch.floor((table - tq.dist_min) / tq.delta * levels)
    return torch.minimum(torch.clamp_min(q, 0), levels).to(torch.int32)


def dequantize_table(tq: TableQuant, q: torch.Tensor) -> torch.Tensor:
    """Approximate inverse of Eq. 9 (midpoint estimate)."""
    return tq.dist_min + (q.to(torch.float32) + 0.5) / _levels(tq) * tq.delta


def pack4(codes: torch.Tensor) -> torch.Tensor:
    """Pack 4-bit codes (…, M) in [0, 16) into (…, M//2) uint8.

    Low nibble = even subspace, high nibble = odd subspace — the byte format
    the mirror, the kernels and the reference package all share.
    """
    if codes.shape[-1] % 2:
        raise ValueError("pack4 needs an even number of 4-bit codes")
    lo = codes[..., 0::2].to(torch.uint8)
    hi = codes[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack4` -> (…, 2*Mp) int32 in [0, 16)."""
    lo = (packed & 0xF).to(torch.int32)
    hi = ((packed >> 4) & 0xF).to(torch.int32)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)
