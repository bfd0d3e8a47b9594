"""Small shared helpers: integer padding, device resolution, tie-exact
argmin, and the tree math the optimizer needs.

A *tree* is the reference's pytree as plain Python: dicts (walked in sorted
key order), lists and tuples, NamedTuples (fields in declaration order) and
``None`` (no leaves) around leaves that are tensors or numpy arrays. The
walk order and the path strings are ``jax.tree_util.tree_flatten_with_path``'s
(``['params']/['blocks']/['attn']/['wq']``, ``['opt_state']/.mu/...``), so a
checkpoint's manifest names an array the same way in both packages.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

Tree = Any


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


def _children(node) -> list[tuple[str, Any]] | None:
    """(path key, child) pairs of a tree node in the reference's order, or
    None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def tree_paths(tree: Tree) -> list[tuple[str, Any]]:
    """(path, leaf) pairs in flatten order; the path is the reference's
    ``"/".join(str(k) for k in keypath)``."""
    out: list[tuple[str, Any]] = []

    def walk(node, prefix: str) -> None:
        kids = _children(node)
        if kids is None:
            out.append((prefix, node))
            return
        for key, child in kids:
            walk(child, f"{prefix}/{key}" if prefix else key)

    walk(tree, "")
    return out


def tree_leaves(tree: Tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the structure is kept."""
    return tree_unflatten(tree, [fn(*xs) for xs in zip(tree_leaves(tree), *map(tree_leaves, rest))])


def tree_unflatten(like: Tree, leaves) -> Tree:
    """A tree of ``like``'s structure holding ``leaves`` in flatten order."""
    pos = iter(leaves)

    def build(node):
        if _children(node) is None:
            return next(pos)
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        return type(node)(build(c) for c in node)

    return build(like)


def tree_size(tree: Tree) -> int:
    """Total number of elements across all leaves."""
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def tree_bytes(tree: Tree) -> int:
    """Total bytes across all leaves."""
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in tree_leaves(tree))


def tree_global_norm(tree: Tree) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), in float32, as a 0-dim tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)))


def tree_cast(tree: Tree, dtype: torch.dtype) -> Tree:
    return tree_map(lambda x: x.to(dtype), tree)


def to_numpy(x) -> np.ndarray:
    """A leaf as a numpy array; bfloat16 (which numpy lacks) as float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def fingerprint(tree: Tree) -> float:
    """Cheap deterministic scalar fingerprint of a tree (for checkpoint
    checks), summed by numpy as the reference sums it. bfloat16 leaves take
    the integer branch, as the reference's (numpy kind ``V``) do."""
    total = 0.0
    for leaf in tree_leaves(tree):
        arr = to_numpy(leaf)
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        if arr.dtype.kind in "fc" and not bf16:
            total += float(np.sum(np.nan_to_num(arr, posinf=1e30, neginf=-1e30)))
        else:
            total += float(np.sum(arr.astype(np.int64) % 1000003))
    return total
