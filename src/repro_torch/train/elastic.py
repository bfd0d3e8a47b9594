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
of ranks, each rank taking its own shard.
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


def reshard_for_mesh(tree, specs, mesh):
    """Place a host-resident checkpoint tree on ``mesh`` per ``specs``: each
    rank gets, on its device, the shard of every leaf that
    ``NamedSharding(mesh, spec)`` gives the device at its coordinates.

    ``specs`` has ``tree``'s dict structure; a leaf's spec holds, per array
    dim, None, an axis name or a tuple of names (the first major), as a
    ``PartitionSpec`` does, and may be shorter than the array's rank. A spec
    whose axes do not divide their dim raises ``ValueError``. Works for any
    mesh whose axis sizes divide the named dims: the elastic restart path
    (a checkpoint of one topology loaded on another)."""

    def put(x, spec):
        x = torch.as_tensor(x)
        spec = tuple(spec)
        if not validate_divisibility(tuple(x.shape), spec, mesh.shape):
            raise ValueError(f"spec {spec} does not divide shape {tuple(x.shape)} over the mesh's {mesh.shape}")
        for dim, names in enumerate(spec):
            if names is None:
                continue
            names = names if isinstance(names, tuple) else (names,)
            size = x.shape[dim] // math.prod(mesh.shape[n] for n in names)
            x = x.narrow(dim, mesh.axis_index(names) * size, size)
        return x.contiguous().to(mesh.device)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k]) for k in t}
        return put(t, s)

    return walk(tree, specs)


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
