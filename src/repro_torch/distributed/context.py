"""Ambient mesh context (reference: ``repro.distributed.context``): lets
deep code (``graph.sharded.ShardedBuilder._resolve_mode``) find the mesh
without threading it through every call signature.

``ShardedBuilder`` consults :func:`get_current_mesh` when no mesh was passed
explicitly: a mesh of more than one rank selects the mesh build, a 1-wide
(or absent) mesh degrades to the process-pool / inline path.
``launch.mesh.run_ranks`` runs its function inside :func:`mesh_context`."""

from __future__ import annotations

import contextlib

_CURRENT_MESH = None


def device_count(mesh) -> int:
    """Total devices in ``mesh`` (product over every axis); 0 for ``None``."""
    if mesh is None:
        return 0
    n = 1
    for extent in mesh.shape.values():
        n *= int(extent)
    return n


def set_current_mesh(mesh) -> None:
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def get_current_mesh():
    return _CURRENT_MESH


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the ambient mesh for the block; the outer one comes back
    on exit."""
    global _CURRENT_MESH
    prev = _CURRENT_MESH
    _CURRENT_MESH = mesh
    try:
        yield mesh
    finally:
        _CURRENT_MESH = prev
