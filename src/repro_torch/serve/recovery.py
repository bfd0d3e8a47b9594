"""Boot-time crash recovery + background checkpointing (reference:
repro.serve.recovery; DESIGN.md §15).

The durability contract the serving stack makes is small and absolute:
**an acked mutation survives any crash**. This module is the half that
cashes it in. A durable index root is one directory::

    <root>/
      snapshot/        last checkpoint (serve/snapshot.py layout), with a
                       sidecar.json {"lsn": L, "generation": g} written
                       atomically inside it — the WAL position it covers
      snapshot.old/    transient: mid-swap survivor of an overwriting save
      wal/             rotating CRC32-framed mutation log (serve/wal.py)

Recovery is a three-state machine::

    LOAD      load_index(snapshot) — falls back to snapshot.old if a
              checkpoint crashed between its two renames, heals the layout
              on success; segmented snapshots may quarantine bad segments
    REPLAY    scan the WAL (torn/corrupt tail frames detected by CRC and
              dropped), apply every record with lsn > sidecar lsn through
              the SAME apply_record the live path used — replayed state is
              acked state by construction
    SERVE     wrap the index in an IndexHandle over a fresh WAL segment;
              a Checkpointer re-arms ops-triggered snapshotting

Checkpointing runs *off the mutator thread*: the handle's commit hook only
bumps an ops counter; when it crosses ``every_ops`` the background thread
snapshots the then-current generation with its LSN sidecar, then truncates
every WAL segment the snapshot covers. A crash at any instant of that
protocol leaves either (old snapshot + full log) or (new snapshot + full
log) or (new snapshot + truncated log) — all recoverable.

The root's files are the reference's (snapshot format v3, the shared WAL
frames), so a root written by either package recovers in the other. Every
entry point that loads an index takes ``device=`` (the card unless the
caller asks for the CPU).

CLI::

    python -m repro_torch.serve.recovery verify  <root> [--device cpu]   # read-only health check
    python -m repro_torch.serve.recovery recover <root> [--device cpu]   # replay + re-checkpoint
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from typing import Any, NamedTuple

from repro_torch import obs
from repro_torch.serve import wal as wal_mod
from repro_torch.serve.handle import IndexHandle
from repro_torch.serve.snapshot import load_index, load_sidecar, save_index
from repro_torch.testing import faults

SNAPSHOT_DIR = "snapshot"
WAL_DIR = "wal"

#: checkpoint about to write its snapshot (WAL still whole).
P_CKPT_BEFORE_SNAPSHOT = faults.declare("checkpoint/before_snapshot")
#: new snapshot + sidecar published; covered WAL segments not yet removed.
P_CKPT_BEFORE_TRUNCATE = faults.declare("checkpoint/before_truncate")
#: checkpoint fully done (snapshot + truncation).
P_CKPT_AFTER = faults.declare("checkpoint/after")


def snapshot_path(root: str) -> str:
    return os.path.join(os.path.abspath(root), SNAPSHOT_DIR)


def wal_path(root: str) -> str:
    return os.path.join(os.path.abspath(root), WAL_DIR)


class RecoveryResult(NamedTuple):
    """What :func:`recover` reconstructed and what it cost to get there."""

    index: Any             #: the live, fully-recovered index
    checkpoint_lsn: int    #: sidecar LSN the loaded snapshot covered
    last_lsn: int          #: LSN of the last replayed (or covered) record
    replayed: int          #: WAL records applied on top of the snapshot
    dropped_frames: int    #: torn/corrupt frames discarded from the tail
    truncated: bool        #: True if any WAL segment ended mid-frame
    degraded: bool         #: True if segments were quarantined at load
    quarantined: tuple     #: quarantined segment indices (degraded serving)


def init(root: str, index, *, overwrite: bool = False) -> str:
    """Create a durable index root: checkpoint ``index`` at LSN 0 and an
    empty WAL directory. Returns ``root``; refuses to clobber an existing
    root unless ``overwrite``."""
    root = os.path.abspath(root)
    if os.path.isdir(snapshot_path(root)) and not overwrite:
        raise FileExistsError(f"durable index root already exists at {root}")
    os.makedirs(root, exist_ok=True)
    save_index(
        snapshot_path(root), index,
        sidecar={"lsn": 0, "generation": 0},
    )
    os.makedirs(wal_path(root), exist_ok=True)
    return root


def init_from_manifest(
    root: str, manifest_path: str, *, overwrite: bool = False,
    verify: bool = True, quarantine: bool = False, device="cuda",
):
    """Adopt a sharded-build manifest directory as a durable index root.

    ``manifest_path`` is the segmented snapshot a
    :class:`repro_torch.graph.sharded.ShardedBuilder` published — coordinator
    routing arrays plus per-segment payloads, each of which may have been
    built and written by a worker on a different host (DESIGN.md §16).
    Loading it here *is* the attach-on-another-host step: the manifest is
    verified (CRC per array), re-checkpointed under ``root`` at LSN 0 with
    an empty WAL, and returned live — from this point the ordinary
    :func:`attach` / :func:`recover` / :class:`Checkpointer` cycle owns it.
    Returns ``(root, index)``, the index on ``device``."""
    index = load_index(
        manifest_path, verify=verify, quarantine=quarantine, device=device
    )
    return init(root, index, overwrite=overwrite), index


def recover(
    root: str, *, verify: bool = True, quarantine: bool = True,
    device="cuda",
) -> RecoveryResult:
    """LOAD + REPLAY: reconstruct the acked index state from disk.

    Read-only with one exception: a successful load from ``snapshot.old``
    promotes it back to ``snapshot`` (healing a crashed swap). Raises if
    there is no loadable snapshot; with ``quarantine`` (default) a
    segmented snapshot with some corrupt segments comes back degraded
    instead of failing the whole boot. The index loads on ``device``."""
    root = os.path.abspath(root)
    with obs.span("recover", root=root) as sp:
        with obs.span("recover/load_snapshot"):
            index = load_index(
                snapshot_path(root), verify=verify, quarantine=quarantine,
                device=device,
            )
        side = load_sidecar(snapshot_path(root)) or {}
        ckpt_lsn = int(side.get("lsn", 0))
        with obs.span("recover/replay", from_lsn=ckpt_lsn):
            scanned = wal_mod.scan(wal_path(root))
            replayed = 0
            last = ckpt_lsn
            for rec in scanned.records:
                if rec.lsn <= ckpt_lsn:
                    continue  # already inside the checkpoint
                wal_mod.apply_record(index, rec.op, rec.arrays)
                replayed += 1
                last = rec.lsn
                obs.tick("wal_replayed_total")
        health = getattr(index, "health", None)
        h = health() if callable(health) else {}
        sp.set(replayed=replayed, dropped=scanned.dropped_frames,
               degraded=bool(h.get("degraded", False)))
    return RecoveryResult(
        index=index,
        checkpoint_lsn=ckpt_lsn,
        last_lsn=last,
        replayed=replayed,
        dropped_frames=scanned.dropped_frames,
        truncated=scanned.truncated,
        degraded=bool(h.get("degraded", False)),
        quarantined=tuple(h.get("quarantined", ())),
    )


class Checkpointer:
    """Ops-triggered snapshot + WAL-truncation daemon.

    Registered as a commit hook on the handle: every flip advances an
    ops-since-checkpoint counter; crossing ``every_ops`` wakes the
    checkpoint thread (``background=True``, the serving default) or
    checkpoints inline (``background=False`` — deterministic, what the
    chaos harness uses). The snapshot is taken of a *published* generation
    pinned at its commit — immutable by the COW contract — so the mutator
    keeps flipping while the checkpoint writes.
    """

    def __init__(self, root: str, handle: IndexHandle, *,
                 every_ops: int = 256, background: bool = True):
        if every_ops < 1:
            raise ValueError(f"every_ops must be >= 1, got {every_ops}")
        self.root = os.path.abspath(root)
        self.handle = handle
        self.every_ops = int(every_ops)
        self.background = bool(background)
        side = load_sidecar(snapshot_path(self.root)) or {}
        self._ckpt_lsn = int(side.get("lsn", 0))
        self._latest = None  # (Generation, lsn) pinned at commit
        self._lock = threading.Lock()
        self._closed = False
        inst = str(obs.REGISTRY.next_instance())
        self._m_ckpts = obs.counter("checkpoints_total", inst=inst)
        self._g_ckpt_lsn = obs.gauge("checkpoint_last_lsn", inst=inst)
        self._g_pending = obs.gauge("checkpoint_pending_ops", inst=inst)
        self._g_ckpt_lsn.set(self._ckpt_lsn)
        self._wake = threading.Event()
        self._thread = None
        if self.background:
            self._thread = threading.Thread(
                target=self._loop, name="recovery-checkpointer", daemon=True
            )
            self._thread.start()
        handle.on_commit(self._on_commit)

    @property
    def checkpoint_lsn(self) -> int:
        return self._ckpt_lsn

    @property
    def pending_ops(self) -> int:
        """Acked records not yet covered by a checkpoint."""
        return max(0, self.handle.last_lsn - self._ckpt_lsn)

    def _on_commit(self, gen, lsn: int, n_records: int) -> None:
        with self._lock:
            self._latest = (gen, lsn)
        pending = self.pending_ops
        self._g_pending.set(pending)
        if pending >= self.every_ops:
            if self.background:
                self._wake.set()
            else:
                self.checkpoint_now()

    def _loop(self) -> None:
        while True:
            self._wake.wait()
            self._wake.clear()
            if self._closed:
                return
            try:
                self.checkpoint_now()
            except Exception:  # noqa: BLE001 — a failed checkpoint must not
                pass           # kill the daemon; the next trigger retries

    def checkpoint_now(self) -> int:
        """Snapshot the latest committed generation and truncate the WAL it
        covers; returns the new checkpoint LSN (no-op if already covered)."""
        with self._lock:
            latest = self._latest
        if latest is None:
            gen, lsn = self.handle.current, self.handle.last_lsn
        else:
            gen, lsn = latest
        if lsn <= self._ckpt_lsn:
            return self._ckpt_lsn
        health = getattr(gen.index, "health", None)
        if callable(health) and health().get("degraded"):
            # quarantined segments are unrecoverable from this process —
            # overwriting the snapshot would make the data loss permanent
            return self._ckpt_lsn
        with obs.span("recover/checkpoint", lsn=lsn, gen=gen.gen):
            faults.crash_point(P_CKPT_BEFORE_SNAPSHOT)
            save_index(
                snapshot_path(self.root), gen.index,
                sidecar={"lsn": int(lsn), "generation": int(gen.gen)},
            )
            faults.crash_point(P_CKPT_BEFORE_TRUNCATE)
            if self.handle.wal is not None:
                self.handle.wal.rotate()  # seal the tail the snapshot covers
                self.handle.wal.truncate_upto(lsn)
            faults.crash_point(P_CKPT_AFTER)
        self._ckpt_lsn = int(lsn)
        self._m_ckpts.inc()
        self._g_ckpt_lsn.set(self._ckpt_lsn)
        self._g_pending.set(self.pending_ops)
        return self._ckpt_lsn

    def stats(self) -> dict:
        return {
            "checkpoint_lsn": self._ckpt_lsn,
            "pending_ops": self.pending_ops,
            "checkpoints": int(self._m_ckpts.value),
            "every_ops": self.every_ops,
            "background": self.background,
        }

    def close(self, *, final_checkpoint: bool = False) -> None:
        """Stop the daemon; optionally take one last synchronous checkpoint
        (clean shutdowns restart with an empty replay)."""
        self._closed = True
        if self._thread is not None:
            self._wake.set()
            self._thread.join(timeout=60.0)
        if final_checkpoint:
            self.checkpoint_now()

    def __repr__(self) -> str:
        return (
            f"Checkpointer(root={self.root!r}, lsn={self._ckpt_lsn}, "
            f"pending={self.pending_ops}, every_ops={self.every_ops})"
        )


def attach(
    root: str, *,
    fsync: str = "batch",
    checkpoint_every: int = 256,
    background: bool = True,
    verify: bool = True,
    quarantine: bool = True,
    rotate_bytes: int = 64 << 20,
    device="cuda",
) -> tuple[IndexHandle, Checkpointer, RecoveryResult]:
    """The boot path: recover, then wire the recovered index for durable
    serving. Returns ``(handle, checkpointer, recovery_result)`` — hand the
    handle to :class:`~repro_torch.serve.runtime.Runtime` and every mutation it
    applies is WAL-logged before it is acked."""
    result = recover(root, verify=verify, quarantine=quarantine, device=device)
    writer = wal_mod.WalWriter(
        wal_path(root), fsync=fsync, rotate_bytes=rotate_bytes
    )
    handle = IndexHandle(result.index, wal=writer)
    ckpt = Checkpointer(
        root, handle, every_ops=checkpoint_every, background=background
    )
    if result.replayed:
        # records survived only in the WAL: fold them into a fresh
        # checkpoint now so the next boot's replay starts empty (the new
        # writer resumed LSNs after the scanned tail, so handle.last_lsn
        # already covers the replay)
        ckpt.checkpoint_now()
    elif result.dropped_frames or result.truncated:
        # nothing to replay, but a crash left torn/corrupt frames behind
        # (e.g. the first append after a checkpoint tore mid-frame):
        # retire every checkpoint-covered segment now so the poisoned
        # tail can't slow — or, before scan() learned to follow dense
        # LSNs across segments, silently break — the next boot's scan
        writer.truncate_upto(ckpt.checkpoint_lsn)
    return handle, ckpt, result


def verify_root(root: str, *, device="cuda") -> dict:
    """Read-only integrity report for a durable root (the ``verify`` CLI):
    does the snapshot load (on ``device``), what LSN does it cover, how
    much WAL tail is replayable, and was any of it torn."""
    root = os.path.abspath(root)
    report: dict = {"root": root, "ok": True, "errors": []}
    try:
        index = load_index(
            snapshot_path(root), verify=True, quarantine=True, device=device
        )
        health = getattr(index, "health", None)
        h = health() if callable(health) else {"degraded": False}
        report["snapshot"] = {
            "loadable": True,
            "n": int(index.n),
            "degraded": bool(h.get("degraded", False)),
            "quarantined": sorted(h.get("quarantined", ())),
        }
        if h.get("degraded"):
            report["ok"] = False
            report["errors"].append(
                f"snapshot degraded: segments {sorted(h['quarantined'])} "
                "quarantined"
            )
    except Exception as exc:  # noqa: BLE001 — report, don't crash the CLI
        report["snapshot"] = {"loadable": False, "error": str(exc)}
        report["ok"] = False
        report["errors"].append(f"snapshot unloadable: {exc}")
    side = load_sidecar(snapshot_path(root)) or {}
    ckpt_lsn = int(side.get("lsn", 0))
    report["checkpoint_lsn"] = ckpt_lsn
    scanned = wal_mod.scan(wal_path(root))
    replayable = sum(1 for r in scanned.records if r.lsn > ckpt_lsn)
    report["wal"] = {
        "segments": len(scanned.segments),
        "records": len(scanned.records),
        "replayable": replayable,
        "last_lsn": scanned.last_lsn,
        "dropped_frames": scanned.dropped_frames,
        "truncated_tail": scanned.truncated,
    }
    if scanned.dropped_frames:
        report["errors"].append(
            f"wal: {scanned.dropped_frames} torn/corrupt frame(s) dropped "
            "(expected only after a crash mid-append; they were never acked)"
        )
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.recovery",
        description="verify or recover a durable index root",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_verify = sub.add_parser("verify", help="read-only integrity report")
    p_verify.add_argument("root")
    p_verify.add_argument(
        "--device", default="cuda", help="torch device (default: the card)"
    )
    p_recover = sub.add_parser(
        "recover", help="replay the WAL tail and write a fresh checkpoint"
    )
    p_recover.add_argument("root")
    p_recover.add_argument(
        "--no-quarantine", action="store_true",
        help="fail on any corrupt segment instead of serving degraded",
    )
    p_recover.add_argument(
        "--device", default="cuda", help="torch device (default: the card)"
    )
    args = parser.parse_args(argv)

    if args.cmd == "verify":
        report = verify_root(args.root, device=args.device)
        json.dump(report, sys.stdout, indent=2, sort_keys=True)
        print()
        return 0 if report["ok"] else 1

    handle, ckpt, result = attach(
        args.root, quarantine=not args.no_quarantine, background=False,
        device=args.device,
    )
    # attach already folded any replayed tail into a fresh checkpoint; the
    # explicit command exists to do exactly that and exit clean
    handle.wal.close()
    json.dump(
        {
            "root": os.path.abspath(args.root),
            "replayed": result.replayed,
            "checkpoint_lsn": ckpt.checkpoint_lsn,
            "dropped_frames": result.dropped_frames,
            "degraded": result.degraded,
            "quarantined": list(result.quarantined),
        },
        sys.stdout, indent=2, sort_keys=True,
    )
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
