"""Small shared helpers: integer padding, device resolution, tie-exact argmin."""

from __future__ import annotations

import torch


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    """Round ``a`` up to the next multiple of ``b``."""
    return ceil_div(a, b) * b


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device without a card
    raises: the port never carries on on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU"
        )
    return dev


def first_argmin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the FIRST minimum along ``dim`` (``jnp.argmin``'s tie rule),
    written out so it does not rest on a backend's argmin tie order."""
    lo = x.amin(dim=dim, keepdim=True)
    size = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = size
    pos = torch.arange(size, device=x.device).view(shape)
    return torch.where(x == lo, pos, size).amin(dim=dim)


def first_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the FIRST maximum along ``dim`` (``jnp.argmax``'s tie rule)."""
    hi = x.amax(dim=dim, keepdim=True)
    size = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = size
    pos = torch.arange(size, device=x.device).view(shape)
    return torch.where(x == hi, pos, size).amin(dim=dim)


def sync(device: torch.device) -> None:
    """Wait for the card (a no-op on the CPU) — used around timed phases."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def topk_first(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the k largest values, ordered
    by value descending and, among equal values, by index ascending; at a
    tie on the k-th value the lower indices are taken. ``torch.topk``
    promises no tie order, so it only finds the k-th value here; the
    selection is then exact in one pass (no sort of the whole row). One
    difference stays: −0.0 and +0.0 are equal here, XLA puts −0.0 lower.
    Returns (values, int64 indices), each (..., k)."""
    lead, n = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, n)
    if k == 0 or x2.shape[0] == 0:
        empty = x2[:, :0]
        return empty.reshape(*lead, 0), empty.long().reshape(*lead, 0)
    thr = torch.topk(x2, k, dim=1).values[:, -1:]
    above = x2 > thr
    eq = x2 == thr
    need = k - above.sum(1, keepdim=True)
    take = above | (eq & (torch.cumsum(eq, 1, dtype=torch.int32) <= need))
    idx = take.nonzero()[:, 1].view(-1, k)  # row-major: ascending index per row
    vals, order = torch.sort(x2.gather(1, idx), dim=1, descending=True, stable=True)
    return vals.reshape(*lead, k), idx.gather(1, order).reshape(*lead, k)
