"""Atomic index snapshots on disk, in the reference's format (reference:
repro.serve.snapshot).

A snapshot is a directory:

    <path>/
      manifest.json     format_version, index kind, the index's meta and,
                        per array, {name, shape, dtype, crc32}
      arrays.npz        every array of ``export_state`` (graph, raw vectors,
                        tombstone/retired masks, the backend's state)
      sidecar.json      (optional) a small JSON dict saved with it
      seg_000/ …        (segmented snapshots only) one index snapshot per
                        segment beside the coordinator's routing arrays

The files are byte for byte the layout ``repro.serve.snapshot`` writes
(format version 3), so a snapshot written by either package loads in the
other. Writes go to ``<path>.tmp`` first and one ``os.replace`` publishes
them; an overwrite keeps the previous snapshot at ``<path>.old`` through
the swap, and ``load_index`` falls back to it. Every array carries a CRC32,
so bitrot and torn writes fail loudly on load. ``load_index`` restores on
``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.graph.index import AnnIndex
from repro_torch.graph.segmented import SegmentedAnnIndex
from repro_torch.testing import faults
from repro_torch.utils import resolve_device

#: the reference's format version (v2: packed flash_blocked mirrors; v3: the
#: optional ``backend.raw`` table); ``load_index`` refuses newer ones
FORMAT_VERSION = 3

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_SIDECAR = "sidecar.json"

#: payload fully written to <path>.tmp; the publishing rename hasn't run.
P_AFTER_TMP_WRITE = faults.declare("snapshot/after_tmp_write")
#: the overwrite swap's no-snapshot instant: old moved aside, new not yet in.
P_BETWEEN_RENAMES = faults.declare("snapshot/between_renames")
#: new snapshot live at <path>; the stale <path>.old not yet removed.
P_AFTER_PUBLISH = faults.declare("snapshot/after_publish")
#: bitrot injection: one array's stored bytes flip after its CRC is taken.
P_BITFLIP_ARRAY = faults.declare("snapshot/bitflip_array", kind="inject")



def segment_dir(path: str, s: int) -> str:
    """The per-segment subdirectory ``seg_NNN`` of a segmented snapshot
    (shared by :func:`save_index`, :func:`load_index` and the sharded
    build's workers, which save straight into it)."""
    return os.path.join(path, f"seg_{s:03d}")


def _write_payload(dirpath: str, manifest: dict, arrays: dict) -> None:
    entries = {}
    stored = {}
    for i, (name, arr) in enumerate(sorted(arrays.items())):
        # ascontiguousarray promotes 0-d to 1-d, so it only makes the CRC's
        # byte view: the stored array keeps its exact shape
        arr = np.asarray(arr)
        key = f"a{i}"
        stored[key] = arr
        entries[key] = {
            "name": name,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
        }
        if faults.check(P_BITFLIP_ARRAY) and arr.size:
            stored[key] = faults.bit_flip(arr)  # the CRC above saw the original
    np.savez(os.path.join(dirpath, _ARRAYS), **stored)
    manifest = dict(manifest, format_version=FORMAT_VERSION, arrays=entries)
    with open(os.path.join(dirpath, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)


def _read_payload(dirpath: str, *, verify: bool) -> tuple[dict, dict]:
    manifest_path = os.path.join(dirpath, _MANIFEST)
    if not os.path.isfile(manifest_path):
        raise FileNotFoundError(
            f"snapshot at {dirpath} has no {_MANIFEST} — not a snapshot "
            "directory, or its write was lost"
        )
    with open(manifest_path) as f:
        try:
            manifest = json.load(f)
        except json.JSONDecodeError as exc:
            raise IOError(f"snapshot manifest {manifest_path} is truncated or corrupt ({exc})") from exc
    version = manifest.get("format_version")
    if version is None or version > FORMAT_VERSION:
        raise ValueError(
            f"snapshot at {dirpath} has format_version={version!r}; this "
            f"build reads <= {FORMAT_VERSION}"
        )
    arrays_path = os.path.join(dirpath, _ARRAYS)
    if not os.path.isfile(arrays_path):
        raise FileNotFoundError(f"snapshot at {dirpath} is missing its array file {_ARRAYS}")
    arrays = {}
    with np.load(arrays_path) as data:
        for key, meta in manifest["arrays"].items():
            try:
                arr = data[key]
            except KeyError as exc:
                raise IOError(
                    f"array {meta['name']!r} ({key}) missing from snapshot "
                    f"{dirpath} — manifest and {_ARRAYS} disagree"
                ) from exc
            if verify and zlib.crc32(np.ascontiguousarray(arr).tobytes()) != meta["crc"]:
                raise IOError(
                    f"checksum mismatch for {meta['name']!r} in snapshot "
                    f"{dirpath} (torn write or bitrot)"
                )
            arrays[meta["name"]] = arr
    return manifest, arrays


def save_index(path: str, index: Any, *, overwrite: bool = True, sidecar: dict | None = None) -> str:
    """Atomically snapshot an :class:`AnnIndex` or :class:`SegmentedAnnIndex`.

    Writes ``<path>.tmp``, then publishes it (:func:`publish_snapshot`);
    with ``overwrite`` an existing snapshot at ``path`` is swapped out only
    after the new one is whole on disk. ``sidecar`` (a small JSON-able dict)
    is written inside the tmp directory, so it and the snapshot publish as
    one unit. Returns ``path``."""
    if not isinstance(index, (AnnIndex, SegmentedAnnIndex)):
        raise TypeError(f"save_index expects AnnIndex or SegmentedAnnIndex, got {type(index).__name__}")
    quarantined = getattr(index, "quarantined", ())
    if quarantined:
        raise RuntimeError(
            f"refusing to snapshot a degraded index: segments {sorted(quarantined)} "
            "are quarantined and their data is not recoverable from this process — "
            "restore from a good snapshot instead of overwriting one"
        )
    path = os.path.abspath(path)
    if os.path.lexists(path) and not overwrite:
        raise FileExistsError(f"snapshot already exists at {path}")
    tmp = path + ".tmp"
    if os.path.lexists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        if isinstance(index, SegmentedAnnIndex):
            meta, arrays, segments = index.export_state()
            _write_payload(tmp, {"kind": "segmented_ann_index", "meta": meta}, arrays)
            for s, (seg_meta, seg_arrays) in enumerate(segments):
                seg_dir = segment_dir(tmp, s)
                os.makedirs(seg_dir)
                _write_payload(seg_dir, {"kind": "ann_index", "meta": seg_meta}, seg_arrays)
        else:
            meta, arrays = index.export_state()
            _write_payload(tmp, {"kind": "ann_index", "meta": meta}, arrays)
        if sidecar is not None:
            with open(os.path.join(tmp, _SIDECAR), "w") as f:
                json.dump(sidecar, f, indent=1, sort_keys=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return publish_snapshot(tmp, path)


def publish_snapshot(tmp: str, path: str) -> str:
    """Atomically publish a whole ``<path>.tmp`` directory at ``path`` (the
    commit half of :func:`save_index`; the sharded build publishes its
    manifest and every segment in one rename). Swapping out an existing
    snapshot takes two renames; the old one waits at ``<path>.old`` in
    between, where :func:`load_index` finds it."""
    faults.crash_point(P_AFTER_TMP_WRITE)
    if os.path.lexists(path):
        old = path + ".old"
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
        faults.crash_point(P_BETWEEN_RENAMES)
        os.replace(tmp, path)
        faults.crash_point(P_AFTER_PUBLISH)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, path)  # atomic on POSIX
    return path


def write_segmented_manifest(dirpath: str, *, centroids, global_of, locate,
                             sidecar: dict | None = None) -> str:
    """Write the coordinator half of a segmented snapshot into ``dirpath``:
    the (S, D) centroids, the per-segment local→global id maps and the
    (N, 2) global→(segment, local) locator. With every segment saved into
    ``segment_dir(dirpath, s)`` the directory is laid out exactly as
    ``save_index(path, SegmentedAnnIndex)`` lays it out. ``dirpath`` is
    written in place: stage it as a ``.tmp`` and :func:`publish_snapshot`."""
    arrays = {
        "centroids": np.asarray(centroids, np.float32),
        "locate": np.asarray(locate, np.int64),
    }
    for s, gids in enumerate(global_of):
        arrays[f"global_of.{s}"] = np.asarray(gids, np.int64)
    _write_payload(dirpath, {"kind": "segmented_ann_index", "meta": {"n_segments": len(global_of)}},
                   arrays)
    if sidecar is not None:
        with open(os.path.join(dirpath, _SIDECAR), "w") as f:
            json.dump(sidecar, f, indent=1, sort_keys=True)
    return dirpath


def load_sidecar(path: str) -> dict | None:
    """The sidecar dict saved with a snapshot (None if it has none), with
    :func:`load_index`'s ``<path>.old`` fallback."""
    path = os.path.abspath(path)
    if not os.path.isdir(path) and os.path.isdir(path + ".old"):
        path = path + ".old"
    sidecar_path = os.path.join(path, _SIDECAR)
    if not os.path.isfile(sidecar_path):
        return None
    with open(sidecar_path) as f:
        return json.load(f)


def load_index(path: str, *, verify: bool = True, quarantine: bool = False,
               device: str | torch.device = "cuda"):
    """Load a snapshot of either package onto ``device``: the type that was
    saved, searching exactly as the saved index did and open to
    ``add``/``delete``/``compact``. ``verify`` checks every array's CRC32.

    If ``path`` is missing but ``<path>.old`` exists (an overwrite crashed
    between its renames), the old snapshot loads and is moved back to
    ``path``. ``quarantine`` (segmented snapshots) restores a segment whose
    payload is missing, truncated or fails its CRC as quarantined instead
    of raising; a bad coordinator payload, or every segment bad, still
    raises."""
    dev = resolve_device(device)
    requested = path = os.path.abspath(path)
    fell_back = False
    if not os.path.isdir(path):
        old = path + ".old"
        if not os.path.isdir(old):
            raise FileNotFoundError(f"no snapshot directory at {path}")
        path, fell_back = old, True
    manifest, arrays = _read_payload(path, verify=verify)
    kind = manifest.get("kind")
    if kind == "ann_index":
        index = AnnIndex.restore(manifest["meta"], arrays, device=dev)
    elif kind == "segmented_ann_index":
        n_seg = int(manifest["meta"]["n_segments"])
        segments = []
        for s in range(n_seg):
            try:
                seg_manifest, seg_arrays = _read_payload(segment_dir(path, s), verify=verify)
            except (OSError, ValueError, KeyError, zipfile.BadZipFile):
                if not quarantine:
                    raise
                obs.tick("snapshot_quarantined_segments_total")
                segments.append(None)  # SegmentedAnnIndex.restore quarantines it
                continue
            segments.append((seg_manifest["meta"], seg_arrays))
        if n_seg > 0 and all(seg is None for seg in segments):
            raise IOError(
                f"snapshot at {path}: all {n_seg} segments failed verification — nothing left to serve"
            )
        index = SegmentedAnnIndex.restore(manifest["meta"], arrays, segments, device=dev)
    else:
        raise ValueError(f"snapshot at {path} has unknown kind {kind!r}")
    if fell_back:
        os.replace(path, requested)  # the surviving copy becomes the snapshot again
    return index


def snapshot_bytes(path: str) -> int:
    """Total on-disk size of a snapshot directory."""
    total = 0
    for root, _dirs, files in os.walk(path):
        for name in files:
            total += os.path.getsize(os.path.join(root, name))
    return total
