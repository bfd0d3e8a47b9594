"""Elastic scaling and the straggler policy (reference:
``repro.train.elastic``).

Checkpoints hold whole (unsharded) arrays with a manifest, so a restart
on another topology re-shards at load; batches are a pure function of
(seed, step, shard), so a restarted run replays the same data
(``repro_torch.data.pipeline``); ``ElasticPolicy`` is what a launcher
executes: synchronous steps with a deadline, a host that misses enough of
them is declared failed and the job restarts from the last checkpoint on
the survivors, data shards reassigned by rank.

A mesh's axis sizes are a mapping of axis name → size (``mesh.shape``,
as in JAX); ``reshard_for_mesh`` places a tree on a ``launch.mesh.Mesh``
of ranks, each rank taking its own shard, and ``gather_from_mesh`` puts
the whole tree back together on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch


@dataclass(frozen=True)
class ElasticPolicy:
    step_deadline_s: float = 300.0
    max_missed_deadlines: int = 2
    min_healthy_fraction: float = 0.75  # below this, park the job
    checkpoint_every: int = 200

    def should_restart(self, missed: int) -> bool:
        return missed >= self.max_missed_deadlines

    def can_continue(self, healthy: int, total: int) -> bool:
        return healthy >= self.min_healthy_fraction * total


def map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``, keeping its structure. ``specs``
    follows ``tree`` through dicts, lists and named tuples; a spec leaf (a
    plain tuple: per array dim None, an axis name or a tuple of names, as a
    ``PartitionSpec`` holds) where ``tree`` goes on applies to every leaf
    below it (a prefix, as in JAX). A None in ``tree`` (an absent subtree,
    as an LM's ``blocks_moe`` of a dense model) stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, tree[k], specs[k] if isinstance(specs, dict) else specs) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        same = isinstance(specs, type(tree))
        return type(tree)(*(map_with_specs(fn, getattr(tree, f), getattr(specs, f) if same else specs)
                            for f in tree._fields))
    if isinstance(tree, list):
        return [map_with_specs(fn, t, specs[i] if isinstance(specs, list) else specs) for i, t in enumerate(tree)]
    return fn(tree, tuple(specs))


def reshard_for_mesh(tree, specs, mesh):
    """Place a host-resident checkpoint tree on ``mesh`` per ``specs``: each
    rank gets, on its device, the shard of every leaf that
    ``NamedSharding(mesh, spec)`` gives the device at its coordinates.

    ``specs`` has ``tree``'s structure (or a prefix of it,
    :func:`map_with_specs`); a leaf's spec holds, per array dim, None, an
    axis name or a tuple of names (the first major), as a ``PartitionSpec``
    does, and may be shorter than the array's rank. Every shard is a new
    tensor, never a view of ``tree``'s (a donated step may write into it). A spec whose axes do not
    divide their dim raises ``ValueError``. Works for any mesh whose axis
    sizes divide the named dims: the elastic restart path (a checkpoint of
    one topology loaded on another)."""

    def put(x, spec):
        x = torch.as_tensor(x)
        _check_divides(tuple(x.shape), spec, mesh)
        for dim, names in enumerate(spec):
            if names is None:
                continue
            names = names if isinstance(names, tuple) else (names,)
            size = x.shape[dim] // math.prod(mesh.shape[n] for n in names)
            x = x.narrow(dim, mesh.axis_index(names) * size, size)
        return x.to(mesh.device, copy=True, memory_format=torch.contiguous_format)  # never a view of the input

    return map_with_specs(put, tree, specs)


def gather_from_mesh(tree, specs, mesh):
    """The inverse of :func:`reshard_for_mesh`: every rank's shards of
    ``tree`` (placed by ``specs``) gathered back into whole tensors on this
    rank's device (every rank returns the whole tree). A dim sharded over
    several axes is gathered minor axis first."""

    def whole(x, spec):
        for dim, names in enumerate(spec):
            if names is None:
                continue
            for name in reversed(names if isinstance(names, tuple) else (names,)):
                if mesh.shape[name] > 1:
                    x = torch.cat(mesh.all_gather(x.contiguous(), name), dim)
        return x

    return map_with_specs(whole, tree, specs)


def _check_divides(shape: tuple[int, ...], spec, mesh) -> None:
    if not validate_divisibility(shape, spec, mesh.shape):
        raise ValueError(f"spec {tuple(spec)} does not divide shape {shape} over the mesh's {mesh.shape}")


def reassign_data_shards(n_shards: int, healthy_ranks: list[int]) -> dict[int, list[int]]:
    """Round-robin reassignment of data shards to surviving hosts: shard i
    goes to ``sorted(healthy_ranks)[i % len(healthy)]``, so every survivor
    computes the same assignment without coordination."""
    if not healthy_ranks:
        raise ValueError("no healthy hosts")
    healthy = sorted(healthy_ranks)
    out: dict[int, list[int]] = {r: [] for r in healthy}
    for shard in range(n_shards):
        out[healthy[shard % len(healthy)]].append(shard)
    return out


def validate_divisibility(shape: tuple[int, ...], spec, mesh_shape: Mapping[str, int]) -> bool:
    """Whether an array of ``shape`` can be sharded by ``spec`` (per array
    dim: None, an axis name or a tuple of them) over a mesh of
    ``mesh_shape`` (axis name → size)."""
    for dim, names in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if names is None:
            continue
        names = names if isinstance(names, tuple) else (names,)
        size = int(np.prod([mesh_shape[n] for n in names]))
        if dim % size:
            return False
    return True
