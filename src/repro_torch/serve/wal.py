"""Durable mutation write-ahead log (reference: repro.serve.wal; DESIGN.md §15).

The COW :class:`~repro_torch.serve.handle.IndexHandle` makes mutations *atomic*;
this module makes them *durable*. Every ``add``/``delete``/``compact`` is
serialized into one CRC32-framed record and appended here before its
generation flip publishes, so an ack always means "on disk": boot-time
recovery (serve/recovery.py) replays the tail of this log over the last
checkpoint and reconstructs exactly the acked state.

Frame format (little-endian)::

    +------+----------+----------+------------------+
    | RWAL | len: u32 | crc: u32 | payload (len B)  |
    +------+----------+----------+------------------+

The payload is an ``.npz`` byte blob: the record's arrays plus a
``__meta__`` uint8 array holding JSON ``{"lsn": int, "op": str}``. CRC
covers the payload only — a frame whose magic, length, or CRC doesn't
check out ends *its segment's* valid prefix (frame boundaries past a
tear cannot be trusted), but not the log's: a crashed writer restarts
into a fresh segment whose LSNs continue densely from the valid prefix,
and those records may be acked, so the scan follows them. Only an LSN
*gap* ends the replayable prefix for good. LSNs (log sequence numbers)
are assigned densely at append; a checkpoint records the LSN it covers
and :meth:`WalWriter.truncate_upto` retires whole segments at or below
it.

Durability policy (``fsync=``):

  ``"always"``  fsync after every append — one disk flush per record.
  ``"batch"``   group commit (the default): appends buffer; one fsync per
                :meth:`WalWriter.commit`, which the handle calls once per
                generation flip — a flip carrying a whole mutation group
                pays ONE flush, the write-side twin of request batching.
  ``"none"``    flush to the OS only (page cache); survives process death
                but not power loss — for tests and throwaway indexes.

A writer opening an existing log directory never appends into an old
segment (its tail may be torn): it scans for the last valid LSN, then
starts a fresh segment numbered after every existing one.

The format is the reference's, byte for byte: a record's arrays go to the
host as numpy before ``np.savez``, so one record frames to the same bytes
in both packages, and a log written by either scans and replays in the
other.
"""

from __future__ import annotations

import io
import json
import os
import re
import struct
import threading
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.testing import faults

MAGIC = b"RWAL"
_HEADER = struct.Struct("<4sII")  # magic, payload length, payload crc32
FSYNC_POLICIES = ("always", "batch", "none")

_SEG_RE = re.compile(r"^wal-(\d{8})\.log$")

#: between append and fsync: the record is in the page cache, not durable,
#: and NOT yet acked — recovery may or may not see it (at-least-once).
P_BEFORE_APPEND = faults.declare("wal/before_append")
P_AFTER_APPEND = faults.declare("wal/after_append")
#: after fsync, before the flip publishes: durable but unacked.
P_AFTER_FSYNC = faults.declare("wal/after_fsync")
#: torn write: half a frame reaches the disk, then power dies.
P_TORN_APPEND = faults.declare("wal/torn_append")
#: bitrot: one bit of the payload flips between CRC and write.
P_BITFLIP_FRAME = faults.declare("wal/bitflip_frame", kind="inject")


def _seg_name(seq: int) -> str:
    return f"wal-{seq:08d}.log"


class WalRecord(NamedTuple):
    """One logged mutation: ``op`` ∈ {add, delete, compact}, payload arrays
    keyed by name (``vectors`` / ``ids``), and its log sequence number."""

    lsn: int
    op: str
    arrays: dict


class WalScan(NamedTuple):
    """Result of reading a log directory: the valid record prefix plus what
    the scan had to discard to find it."""

    records: list          # list[WalRecord], lsn-ascending
    last_lsn: int          # 0 when the log is empty
    dropped_frames: int    # frames rejected by magic/length/CRC
    truncated: bool        # True if any segment ended mid-frame
    segments: list         # scanned segment filenames, in order
    segment_last_lsns: list  # per segment: last valid LSN at or below it


def to_host(v) -> np.ndarray:
    """A record array as numpy on the host (a tensor leaves its device)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def encode_record(lsn: int, op: str, arrays: dict) -> bytes:
    """Serialize one record to a full frame (header + npz payload)."""
    meta = np.frombuffer(
        json.dumps({"lsn": int(lsn), "op": str(op)}).encode(), np.uint8
    )
    buf = io.BytesIO()
    np.savez(buf, __meta__=meta, **{k: to_host(v) for k, v in arrays.items()})
    payload = buf.getvalue()
    if faults.check(P_BITFLIP_FRAME):
        payload = faults.bit_flip(payload)
    return _HEADER.pack(MAGIC, len(payload), faults.checksum(payload)) + payload


def decode_payload(payload: bytes) -> WalRecord:
    with np.load(io.BytesIO(payload)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    return WalRecord(lsn=int(meta["lsn"]), op=str(meta["op"]), arrays=arrays)


def apply_record(index: Any, op: str, arrays: dict):
    """Apply one record through the facade's maintenance API — the ONE
    spelling shared by the live path (``IndexHandle`` mutating a clone) and
    replay (``recovery.recover`` rebuilding from a checkpoint), so a
    recovered index is bit-identical to the acked one by construction."""
    if op == "add":
        return index.add(arrays["vectors"])
    if op == "delete":
        return index.delete(np.asarray(arrays["ids"], np.int64))
    if op == "compact":
        return index.compact()
    raise ValueError(f"unknown WAL op {op!r}")


def _scan_segment(path: str) -> tuple[list, int, bool]:
    """(records, dropped, truncated) for one segment file; stops at the
    first invalid frame — everything after a torn/corrupt frame is suspect
    because frame boundaries can no longer be trusted."""
    records: list = []
    with open(path, "rb") as f:
        data = f.read()
    off, n = 0, len(data)
    while off < n:
        if n - off < _HEADER.size:
            return records, 0, True  # mid-header tear
        magic, length, crc = _HEADER.unpack_from(data, off)
        if magic != MAGIC:
            return records, 1, False  # garbage frame boundary
        start = off + _HEADER.size
        if n - start < length:
            return records, 0, True  # mid-payload tear
        payload = data[start:start + length]
        if faults.checksum(payload) != crc:
            return records, 1, False  # bitrot / overwritten tail
        try:
            records.append(decode_payload(payload))
        except Exception:
            return records, 1, False  # CRC passed but payload unparseable
        off = start + length
    return records, 0, False


def scan(wal_dir: str) -> WalScan:
    """Read every segment in LSN order, validating frames and LSN density.

    A torn/corrupt frame ends trust in *its own* segment — frame
    boundaries past it are meaningless — but not in the log: the normal
    shape after a crash-and-restart is a poisoned old tail followed by a
    fresh segment from the restarted writer whose LSNs continue densely
    from the valid prefix, and those records may be acked, so they must
    replay. The valid prefix therefore ends only at an LSN *gap* (a gap
    means acked history was lost — records after it cannot be replayed
    without reordering history)."""
    wal_dir = os.path.abspath(wal_dir)
    names = sorted(
        n for n in (os.listdir(wal_dir) if os.path.isdir(wal_dir) else [])
        if _SEG_RE.match(n)
    )
    records: list = []
    seg_last: list = []
    dropped = 0
    truncated = False
    last = None
    cursor = 0  # truncation attribution: last valid LSN at/below a segment
    gap = False
    for name in names:
        segs, seg_dropped, seg_torn = _scan_segment(os.path.join(wal_dir, name))
        if segs:
            cursor = segs[-1].lsn
        seg_last.append(cursor)
        if gap:
            dropped += len(segs)  # count (not replay) what trails the gap
            continue
        dropped += seg_dropped
        truncated = truncated or seg_torn
        for j, rec in enumerate(segs):
            if last is not None and rec.lsn != last + 1:
                dropped += len(segs) - j
                gap = True  # LSN gap: history is broken from here on
                break
            records.append(rec)
            last = rec.lsn
    return WalScan(
        records=records,
        last_lsn=records[-1].lsn if records else 0,
        dropped_frames=dropped,
        truncated=truncated,
        segments=names,
        segment_last_lsns=seg_last,
    )


class WalWriter:
    """Append-only writer over a log directory of rotating segments.

    Usage (what :class:`~repro_torch.serve.handle.IndexHandle` does per flip)::

        wal = WalWriter(root, fsync="batch")
        wal.append("add", {"vectors": batch})   # buffered
        wal.append("delete", {"ids": ids})      # buffered
        wal.commit()                            # ONE fsync — now ack

    The handle's mutation lock serializes all *appends*; the writer's own
    re-entrant lock additionally serializes them against
    :meth:`truncate_upto`, which the background checkpointer calls from its
    own thread.
    """

    def __init__(self, wal_dir: str, *, fsync: str = "batch",
                 rotate_bytes: int = 64 << 20):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync must be one of {FSYNC_POLICIES}, got {fsync!r}"
            )
        self.dir = os.path.abspath(wal_dir)
        self.fsync = fsync
        self.rotate_bytes = int(rotate_bytes)
        self._mutex = threading.RLock()  # appends vs checkpoint truncation
        os.makedirs(self.dir, exist_ok=True)
        prior = scan(self.dir)
        self._lsn = prior.last_lsn
        #: closed segments' (seq, last_lsn) — what truncation retires;
        #: attribution comes straight from the scan (one pass over the log)
        self._closed: list[tuple[int, int]] = []
        seq = 0
        for name, seg_last in zip(prior.segments, prior.segment_last_lsns):
            seq = max(seq, int(_SEG_RE.match(name).group(1)) + 1)
            self._closed.append((int(_SEG_RE.match(name).group(1)), seg_last))
        self._seq = seq
        self._f = open(os.path.join(self.dir, _seg_name(seq)), "wb")
        self._seg_bytes = 0
        self._dirty = False
        self._fsync_dir()  # the fresh segment's dirent must survive power loss
        inst = str(obs.REGISTRY.next_instance())
        self._m_appends = obs.counter("wal_appends_total", inst=inst)
        self._m_fsyncs = obs.counter("wal_fsyncs_total", inst=inst)
        self._m_bytes = obs.counter("wal_bytes_total", inst=inst)
        self._g_segments = obs.gauge("wal_segments", inst=inst)
        self._g_segments.set(len(self._closed) + 1)

    @property
    def last_lsn(self) -> int:
        """LSN of the most recently appended record (0 = empty log)."""
        return self._lsn

    def append(self, op: str, arrays: dict | None = None) -> int:
        """Frame + write one record; returns its LSN. Durability depends on
        the fsync policy — under ``"batch"`` nothing is durable until
        :meth:`commit`."""
        with self._mutex:
            if self._f.closed:
                raise ValueError("WalWriter is closed")
            faults.crash_point(P_BEFORE_APPEND)
            if self._seg_bytes >= self.rotate_bytes:
                self.rotate()
            lsn = self._lsn + 1
            frame = encode_record(lsn, op, arrays or {})
            if faults.check(P_TORN_APPEND):
                # a torn write: half the frame reaches the OS, then power dies
                self._f.write(faults.torn_write(frame))
                self._f.flush()
                faults.crash_now()
            self._f.write(frame)
            self._lsn = lsn
            self._seg_bytes += len(frame)
            self._dirty = True
            self._m_appends.inc()
            self._m_bytes.inc(len(frame))
            faults.crash_point(P_AFTER_APPEND)
            if self.fsync == "always":
                self._sync()
            return lsn

    def commit(self) -> None:
        """Group-commit barrier: make every buffered append durable (one
        fsync under ``"batch"``; a flush under ``"none"``; no-op under
        ``"always"`` — each append already synced)."""
        with self._mutex:
            if not self._dirty:
                return
            if self.fsync == "none":
                self._f.flush()
                self._dirty = False
                return
            self._sync()

    def _sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._dirty = False
        self._m_fsyncs.inc()
        faults.crash_point(P_AFTER_FSYNC)

    def _fsync_dir(self) -> None:
        """Make the log directory's entries durable: fsyncing a segment's
        data says nothing about its *dirent* — after power loss a freshly
        created segment (and every acked frame in it) could vanish from the
        directory unless the directory itself was synced."""
        if self.fsync == "none":
            return
        fd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def mark(self) -> tuple[int, int, int]:
        """Position token ``(segment seq, byte offset, lsn)`` for
        :meth:`rewind` — take one before appending a group whose flip may
        still abort."""
        with self._mutex:
            return (self._seq, self._seg_bytes, self._lsn)

    def rewind(self, mark: tuple[int, int, int]) -> None:
        """Roll the log back to ``mark``, erasing every frame appended
        after it — the undo for a mutation group whose append or commit
        failed before its flip published. None of the erased frames was
        ever acked (the ack IS the flip), so the truncation cannot lose
        acked state; *without* it the orphaned LSNs would sit under later
        acked records and replay a mutation whose caller saw it fail."""
        seq, offset, lsn = mark
        with self._mutex:
            if self._f.closed:
                raise ValueError("WalWriter is closed")
            if seq > self._seq or (seq == self._seq
                                   and offset > self._seg_bytes):
                raise ValueError(f"cannot rewind forward to {mark!r}")
            if seq != self._seq:
                # the group rotated mid-append: drop the newer segments
                # and re-open the marked one as the active tail
                self._f.close()
                for s in range(seq + 1, self._seq + 1):
                    try:
                        os.remove(os.path.join(self.dir, _seg_name(s)))
                    except FileNotFoundError:
                        pass
                self._closed = [(s, l) for s, l in self._closed if s < seq]
                self._seq = seq
                try:
                    self._f = open(os.path.join(self.dir, _seg_name(seq)), "r+b")
                except FileNotFoundError:
                    # a checkpoint covering exactly the mark's LSN truncated
                    # the marked segment away mid-group: everything at or
                    # below the mark is snapshot-covered, so the rewound
                    # tail is simply empty
                    self._f = open(os.path.join(self.dir, _seg_name(seq)), "wb")
                    offset = 0
            self._f.seek(offset)
            self._f.truncate()
            self._seg_bytes = offset
            self._lsn = lsn
            self._dirty = False
            if self.fsync != "none":
                os.fsync(self._f.fileno())
            self._fsync_dir()
            self._g_segments.set(len(self._closed) + 1)

    def rotate(self) -> int:
        """Close the current segment and open the next; returns the new
        segment sequence number."""
        with self._mutex:
            self.commit()
            self._f.close()
            self._closed.append((self._seq, self._lsn))
            self._seq += 1
            self._f = open(os.path.join(self.dir, _seg_name(self._seq)), "wb")
            self._seg_bytes = 0
            self._fsync_dir()  # new dirent durable before any append is acked
            self._g_segments.set(len(self._closed) + 1)
            return self._seq

    def truncate_upto(self, lsn: int) -> int:
        """Delete closed segments entirely covered by a checkpoint at
        ``lsn`` (their last record ≤ lsn); returns the number removed.
        The active segment is never deleted — rotation bounds its size."""
        with self._mutex:
            removed = 0
            keep = []
            for seq, seg_last in self._closed:
                if seg_last <= lsn:
                    try:
                        os.remove(os.path.join(self.dir, _seg_name(seq)))
                        removed += 1
                    except FileNotFoundError:
                        pass
                else:
                    keep.append((seq, seg_last))
            self._closed = keep
            if removed:
                self._fsync_dir()  # deletions durable: no zombie segments
            self._g_segments.set(len(self._closed) + 1)
            return removed

    def stats(self) -> dict:
        return {
            "last_lsn": self._lsn,
            "appends": int(self._m_appends.value),
            "fsyncs": int(self._m_fsyncs.value),
            "bytes": int(self._m_bytes.value),
            "segments": len(self._closed) + 1,
            "fsync_policy": self.fsync,
        }

    def close(self) -> None:
        with self._mutex:
            if not self._f.closed:
                self.commit()
                self._f.close()

    def __enter__(self) -> "WalWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (
            f"WalWriter(dir={self.dir!r}, fsync={self.fsync!r}, "
            f"last_lsn={self._lsn}, segments={len(self._closed) + 1})"
        )
