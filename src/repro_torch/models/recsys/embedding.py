"""Sparse embedding ops for recsys, from gathers and segment reductions
(reference: ``repro.models.recsys.embedding``). Plain PyTorch, as the
reference computes them outside any kernel of its own:

* ``embedding_bag`` — multi-hot lookup with sum / mean / max over a padded
  (B, L) index matrix and validity mask, and its CSR-style form
  ``embedding_bag_ragged`` (one flat stream of ids with bag ids);
* ``hash_embedding`` — the hashing trick for unbounded vocabularies;
* ``qr_embedding`` — quotient-remainder compositional embedding
  (arXiv:1909.02107): two small tables instead of one huge one.
"""

from __future__ import annotations

import math

import torch

#: the multiplicative hashes of ``hash_embedding``, as the reference's
_PRIMES = (2654435761, 2246822519, 3266489917, 668265263)
_U32 = 0xFFFFFFFF


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, mask: torch.Tensor | None = None, *,
                  reduce: str = "sum") -> torch.Tensor:
    """Multi-hot lookup: table (V, D), indices (B, L) -> (B, D). ``mask``
    (B, L) marks valid slots (padding False); reduce ∈ {sum, mean, max}. A
    bag with no valid slot gives 0 (sum, mean) or float32's lowest (max)."""
    if mask is None:
        mask = torch.ones(indices.shape, dtype=torch.bool, device=indices.device)
    safe = torch.where(mask, indices, 0)
    rows = table[safe.long()]  # (B, L, D)
    m = mask[..., None].to(table.dtype)
    if reduce == "sum":
        return torch.sum(rows * m, dim=-2)
    if reduce == "mean":
        return torch.sum(rows * m, dim=-2) / torch.clamp_min(torch.sum(m, dim=-2), 1.0)
    if reduce == "max":
        return torch.amax(torch.where(m > 0, rows, torch.finfo(table.dtype).min), dim=-2)
    raise ValueError(f"unknown reduce {reduce!r}")


def _segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: ids outside [0, n) are dropped."""
    keep = (segment_ids >= 0) & (segment_ids < n)
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_add_(0, segment_ids[keep].long(), values[keep])


def embedding_bag_ragged(table: torch.Tensor, flat_indices: torch.Tensor, segment_ids: torch.Tensor,
                         n_bags: int, *, reduce: str = "sum") -> torch.Tensor:
    """CSR-style form: flat indices with a bag id each -> (n_bags, D), the
    same bags as :func:`embedding_bag`. An empty bag gives 0 (sum, mean) or
    −inf (max, as ``jax.ops.segment_max``)."""
    rows = table[flat_indices.long()]
    if reduce == "sum":
        return _segment_sum(rows, segment_ids, n_bags)
    if reduce == "mean":
        s = _segment_sum(rows, segment_ids, n_bags)
        c = _segment_sum(torch.ones(flat_indices.shape, dtype=table.dtype, device=table.device), segment_ids, n_bags)
        return s / torch.clamp_min(c, 1.0)[:, None]
    if reduce == "max":
        keep = (segment_ids >= 0) & (segment_ids < n_bags)
        idx = segment_ids[keep].long()[:, None].expand(-1, rows.shape[1])
        out = torch.full((n_bags, rows.shape[1]), float("-inf"), dtype=rows.dtype, device=rows.device)
        return out.scatter_reduce_(0, idx, rows[keep], "amax", include_self=True)
    raise ValueError(f"unknown reduce {reduce!r}")


def _hash_rows(ids: torch.Tensor, prime: int, v: int) -> torch.Tensor:
    """``(uint32(ids) · prime) mod 2³² mod v`` in int64: ids taken mod 2³²
    (a negative id as its two's complement), the product split at 16 bits
    so no partial product reaches 2⁶³."""
    u = ids.to(torch.int64) & _U32
    lo = u * (prime & 0xFFFF)
    hi = ((u * (prime >> 16)) & 0xFFFF) << 16
    return ((lo + hi) & _U32) % v


def hash_embedding(table: torch.Tensor, ids: torch.Tensor, *, n_hashes: int = 2) -> torch.Tensor:
    """Hashing-trick lookup: ids (any integers) -> (…, D), the sum of
    ``n_hashes`` multiplicative hashes into one table over √n_hashes
    (collisions average out, Weinberger et al.)."""
    v = table.shape[0]
    out = None
    for pr in _PRIMES[:n_hashes]:
        rows = table[_hash_rows(ids, pr, v)]
        out = rows if out is None else out + rows
    return out / math.sqrt(n_hashes)


def qr_embedding(q_table: torch.Tensor, r_table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Quotient-remainder embedding: O(√V) rows instead of O(V); floor
    division and modulo as Python's (and ``jnp``'s)."""
    ids = ids.long()
    n_r = r_table.shape[0]
    q = q_table[(ids // n_r) % q_table.shape[0]]
    r = r_table[ids % n_r]
    return q * r  # multiplicative composition


def embedding_bag_oracle(table: torch.Tensor, indices: torch.Tensor, mask: torch.Tensor, *,
                         reduce: str = "sum") -> torch.Tensor:
    """Dense one-hot matmul oracle (an index outside [0, V) is a zero row,
    as ``jax.nn.one_hot`` gives)."""
    v = table.shape[0]
    oh = (indices[..., None].long() == torch.arange(v, device=table.device)).to(table.dtype)
    oh = oh * mask[..., None].to(table.dtype)
    if reduce == "sum":
        return torch.einsum("blv,vd->bd", oh, table)
    if reduce == "mean":
        s = torch.einsum("blv,vd->bd", oh, table)
        return s / torch.clamp_min(mask.to(table.dtype).sum(-1, keepdim=True), 1.0)
    raise ValueError(reduce)
