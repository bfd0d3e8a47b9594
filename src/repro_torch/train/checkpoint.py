"""Fault-tolerant checkpoints in the reference's format (reference:
``repro.train.checkpoint``), so a checkpoint written by either package
restores in the other.

A checkpoint is ``step_{step:010d}/`` holding ``arrays.npz`` (``a0``,
``a1``, … in the tree's flatten order) and ``manifest.json`` (each array's
tree path, shape, dtype and CRC32 of its bytes). A save goes to a ``.tmp``
directory renamed into place, so a crash never leaves a torn latest
checkpoint; the newest ``keep`` are kept. bfloat16 leaves, which numpy
lacks, are stored as their raw 2-byte words (``'|V2'``, as ``np.savez``
stores the reference's ``ml_dtypes`` arrays) with ``"dtype": "bfloat16"``
in the manifest, and read back as ``torch.bfloat16``; the CRC is over the
same bytes in both packages.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib

import numpy as np
import torch

from repro_torch.utils import Tree, tree_paths, tree_unflatten

_BF16 = "bfloat16"


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """(numpy array, manifest dtype) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def save_checkpoint(ckpt_dir: str, step: int, tree: Tree, *, keep: int = 3) -> str:
    """Atomically write checkpoint ``step``; prune to the newest ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {}
    manifest = {"step": step, "arrays": {}}
    for i, (key, leaf) in enumerate(tree_paths(tree)):
        arr, dtype = _host_array(leaf)
        name = f"a{i}"
        arrays[name] = arr
        manifest["arrays"][name] = {"path": key, "shape": list(arr.shape), "dtype": dtype, "crc": _crc(arr)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final)  # atomic on POSIX
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    for s in list_checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"), ignore_errors=True)


def list_checkpoints(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                continue
    return sorted(out)


def latest_checkpoint(ckpt_dir: str) -> int | None:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, tree_like: Tree, *, step: int | None = None,
                       verify: bool = True) -> tuple[Tree, int]:
    """Restore into the structure of ``tree_like``. Returns (tree, step).

    Every leaf comes back as a tensor of the manifest's dtype, on the device
    of ``tree_like``'s leaf where that is a tensor (else on the CPU). Every
    array's CRC is checked (a torn write or bit rot fails loudly), and every
    shape against ``tree_like``'s.
    """
    if step is None:
        step = latest_checkpoint(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    by_path = {}
    for name, meta in manifest["arrays"].items():
        arr = data[name]
        if verify and _crc(arr) != meta["crc"]:
            raise IOError(f"checksum mismatch for {meta['path']} in step {step}")
        by_path[meta["path"]] = (arr, meta["dtype"])
    leaves = []
    for key, leaf in tree_paths(tree_like):
        if key not in by_path:
            raise KeyError(f"checkpoint missing array for {key}")
        arr, dtype = by_path[key]
        want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else tuple(np.shape(leaf))
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs model {want}")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if dtype == _BF16 else torch.from_numpy(arr)
        leaves.append(t.to(leaf.device) if isinstance(leaf, torch.Tensor) else t)
    return tree_unflatten(tree_like, leaves), manifest["step"]
