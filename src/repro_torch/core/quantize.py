"""Scalar quantization (paper §3.2.2), distance-table quantization (§3.3.3,
Eq. 9) and 4-bit code packing.

The HNSW-SQ baseline maps each dimension to an ``L_SQ``-bit level,
``round((x − lo) / scale · (2^bits − 1))`` with half-to-even rounding (the
reference's ``jnp.round``; ``torch.round`` rounds the same way), and
compares codes in the quantized domain with per-dimension scales.

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


class SQParams(NamedTuple):
    """Per-dimension scalar-quantization parameters.

    lo:    (D,) per-dim minimum.
    scale: (D,) per-dim (hi − lo), clamped away from zero.
    bits:  () int32 — bits per dimension (a 0-d tensor: snapshots carry it).
    """

    lo: torch.Tensor
    scale: torch.Tensor
    bits: torch.Tensor


def sq_fit(x: torch.Tensor, *, bits: int = 8) -> SQParams:
    """Fit per-dimension ranges on (a sample of) the dataset (n, D)."""
    lo = x.amin(0)
    hi = x.amax(0)
    scale = torch.clamp_min(hi - lo, 1e-12)
    return SQParams(lo=lo, scale=scale, bits=torch.tensor(bits, dtype=torch.int32, device=x.device))


def sq_levels(bits):
    """2^bits − 1 for an int, or for a 0-d int tensor (as a tensor)."""
    if isinstance(bits, int):
        return (1 << bits) - 1
    return 2 ** bits.to(torch.int64) - 1


def _sq_levels_f32(params: SQParams) -> torch.Tensor:
    return sq_levels(params.bits).to(torch.float32)


def sq_encode(params: SQParams, x: torch.Tensor) -> torch.Tensor:
    """Encode float vectors (…, D) to int32 codes in [0, 2^bits)."""
    levels = _sq_levels_f32(params)
    q = torch.round((x - params.lo) / params.scale * levels)
    return torch.minimum(torch.clamp_min(q, 0), levels).to(torch.int32)


def sq_decode(params: SQParams, codes: torch.Tensor) -> torch.Tensor:
    """Decode integer codes back to (lossy) floats."""
    return params.lo + codes.to(torch.float32) / _sq_levels_f32(params) * params.scale


def sq_dim_scales(params: SQParams) -> torch.Tensor:
    """Per-dimension squared scales s2_d = (scale_d / levels)², so that
    δ²(x, y) ≈ Σ_d s2_d · (q_d − c_d)² on the codes (no decode)."""
    return torch.square(params.scale / _sq_levels_f32(params))


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
