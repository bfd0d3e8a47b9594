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
