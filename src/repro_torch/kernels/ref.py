"""Plain PyTorch versions of the port's kernels (the Flash kernels,
``l2_batch`` and ``sq_l2``).

Each function is the semantic ground truth of its CUDA kernel in
``csrc/``: the wrappers in ``ops.py`` take these for CPU tensors, the CPU
tests hold them against the reference package's oracles, and
``chip_smoke.py`` holds each kernel against them on the card. Integer
tables give exact sums; float tables sum in torch's own order.
"""

from __future__ import annotations

import torch

from repro_torch.core import quantize as qz


def _sum_m(vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return vals.sum(-1).to(dtype)


def flash_scan(codes: torch.Tensor, adt: torch.Tensor) -> torch.Tensor:
    """Flat ADT scan: codes (N, M) int in [0, K), adt (M, K) -> (N,) in
    adt's dtype, Σ_m adt[m, codes[n, m]]. The sum runs in m order, the
    kernel's order, so float tables agree with the kernel bit for bit."""
    n, m = codes.shape
    out = torch.zeros(n, dtype=adt.dtype, device=codes.device)
    for j in range(m):
        out += adt[j][codes[:, j].long()]
    return out


def flash_round(codes: torch.Tensor, adts: torch.Tensor) -> torch.Tensor:
    """Bulk refinement-round scan: codes (B, C, M) int in [0, K), adts
    (B, M, K) per-row tables -> (B, C), Σ_m adts[b, m, codes[b, c, m]]."""
    b, _, m = codes.shape
    bi = torch.arange(b, device=codes.device)[:, None, None]
    mi = torch.arange(m, device=codes.device)[None, None, :]
    return _sum_m(adts[bi, mi, codes.long()], adts.dtype)


def flash_expand(
    nodes: torch.Tensor,
    adjacency: torch.Tensor,
    mirror: torch.Tensor,
    adt: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused beam-expansion step, batched over Q queries.

    nodes (Q, W) int32 frontier ids (−1 clamped to row 0, caller-masked);
    adjacency (n, R) int32; mirror (n, R, ⌈M/2⌉) uint8 packed 4-bit codes or
    (n, R, M) int32 unpacked; adt (Q, M, K).
    Returns rows (Q, W, R) int32 = adjacency[max(nodes, 0)] and sums
    (Q, W, R) = Σ_m adt[q, m, code_m] over the mirror row's codes.
    """
    q, m, _ = adt.shape
    safe = nodes.clamp_min(0).long()
    rows = adjacency[safe]
    mir = mirror[safe]  # (Q, W, R, Mp)
    if mirror.dtype == torch.uint8:
        codes = qz.unpack4(mir)[..., :m]
    else:
        codes = mir
    qi = torch.arange(q, device=adt.device)[:, None, None, None]
    mi = torch.arange(m, device=adt.device)[None, None, None, :]
    return rows, _sum_m(adt[qi, mi, codes.long()], adt.dtype)


def flash_scan_blocked(blocks: torch.Tensor, adt: torch.Tensor) -> torch.Tensor:
    """Access-aware blocked scan: blocks (G, M, B) with adt (M, K) -> (G, B),
    or batched blocks (Q, G, M, B) with adt (Q, M, K) -> (Q, G, B);
    Σ_m adt[m, blocks[g, m, b]]."""
    if blocks.dim() == 3:
        return flash_scan_blocked(blocks[None], adt[None])[0]
    q, _, m, _ = blocks.shape
    qi = torch.arange(q, device=adt.device)[:, None, None, None]
    mi = torch.arange(m, device=adt.device)[None, None, :, None]
    return adt[qi, mi, blocks.long()].sum(-2).to(adt.dtype)


def l2_batch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2: x (N, D), y (C, D) -> (N, C) float32,
    ``max(‖x‖² + ‖y‖² − 2·x·yᵀ, 0)`` (the matrix product in full float32
    on the card as long as TF32 is off, which the port never turns on)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1)
    return torch.clamp_min(x2 + y2[None, :] - 2.0 * (x @ y.T), 0.0)


def sq_l2(q: torch.Tensor, db: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Quantized-domain scaled L2: q (D,) int codes, db (N, D) int codes,
    s2 (D,) float32 -> (N,) float32, Σ_d s2_d (db[n, d] − q_d)², with the
    subtraction in int32 (the reference's ``sq_l2_ref``)."""
    diff = (db.to(torch.int32) - q.to(torch.int32)).to(torch.float32)
    return (s2.to(torch.float32)[None, :] * diff * diff).sum(-1)
