"""Deterministic fault injection — named crash points + corruption injectors
(the port's copy of the reference's ``repro.testing.faults``, numpy only).

Durability code is only as trustworthy as the crashes it has survived, and
real crashes don't aim: they land *between* the append and the fsync,
*between* the two renames of a directory swap. This module gives those
instants names so tests can land a failure on any one of them, every time:

  * **Declare** — modules call :func:`declare` at import for each crash site
    they contain and :func:`crash_point` at the site itself. Disarmed (the
    default and the production state) a crash point is one truthiness check
    on an empty dict.
  * **Arm** — a test calls :func:`arm`, or sets ``REPRO_FAULTS`` in a child
    process' environment (``"crash:snapshot/between_renames"`` or
    ``"raise:snapshot/after_publish:2"``). Mode ``"crash"`` exits the process
    immediately via ``os._exit`` (no atexit, no buffer flush: SIGKILL or a
    power cut). Mode ``"raise"`` raises :class:`FaultInjected` for
    in-process tests. The optional ``:N`` suffix fires on the N-th hit.
  * **Inject** — :func:`torn_write` and :func:`bit_flip` corrupt byte
    strings / arrays deterministically.

Points are registered with a *kind*: ``"crash"`` sites are process-death
candidates; ``"inject"`` sites are data-corruption hooks (a flipped
snapshot bit) that tests arm one by one through :func:`check`.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

#: Exit status used by ``mode="crash"`` — distinct from every normal error
#: code so a test harness can tell "the armed fault fired" apart from "the
#: worker died of something else".
CRASH_EXIT_CODE = 86

ENV_VAR = "REPRO_FAULTS"

_MODES = ("crash", "raise")


class FaultInjected(RuntimeError):
    """Raised by an armed ``mode="raise"`` fault point."""


# name -> kind ("crash" | "inject"); insertion-ordered so the chaos matrix
# enumerates points in declaration order.
_POINTS: dict[str, str] = {}
# name -> [mode, hits_remaining]
_ARMED: dict[str, list] = {}


def declare(name: str, *, kind: str = "crash") -> str:
    """Register a fault point (idempotent; modules call this at import)."""
    if kind not in ("crash", "inject"):
        raise ValueError(f"unknown fault kind {kind!r}")
    _POINTS.setdefault(name, kind)
    return name


def points(*, kind: str | None = None) -> tuple[str, ...]:
    """Every declared fault point (optionally filtered by kind), in
    declaration order — the chaos matrix iterates this."""
    return tuple(n for n, k in _POINTS.items() if kind is None or k == kind)


def arm(name: str, mode: str = "raise", hits: int = 1) -> None:
    """Arm ``name`` to trigger on its ``hits``-th execution (default: the
    first). ``mode="crash"`` kills the process with ``os._exit``;
    ``mode="raise"`` raises :class:`FaultInjected` once, then disarms."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    if hits < 1:
        raise ValueError(f"hits must be >= 1, got {hits}")
    declare(name) if name not in _POINTS else None
    _ARMED[name] = [mode, int(hits)]


def disarm(name: str | None = None) -> None:
    """Disarm one point, or every point (``name=None``) — test teardown."""
    if name is None:
        _ARMED.clear()
    else:
        _ARMED.pop(name, None)


def armed(name: str) -> bool:
    return name in _ARMED


def check(name: str) -> bool:
    """Consume one hit of an armed point; True when it is due to trigger.

    The building block for *custom* fault behavior (a torn write needs to
    emit half a frame before dying — only the call site can do that).
    Disarmed cost: one empty-dict truthiness test."""
    if not _ARMED:
        return False
    state = _ARMED.get(name)
    if state is None:
        return False
    state[1] -= 1
    if state[1] > 0:
        return False
    if state[0] == "raise":  # one-shot: a handled raise must not re-trigger
        del _ARMED[name]
    return True


def crash_now() -> None:
    """Die like a power cut: no atexit hooks, no stream flush, no cleanup."""
    os._exit(CRASH_EXIT_CODE)


def crash_point(name: str) -> None:
    """Execute a declared fault point: no-op unless armed, else crash/raise."""
    if not _ARMED:
        return
    state = _ARMED.get(name)
    if state is None:
        return
    if not check(name):
        return
    if state[0] == "crash":
        crash_now()
    raise FaultInjected(name)


def _parse_env(value: str) -> dict[str, list]:
    out: dict[str, list] = {}
    for part in value.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) == 2:
            mode, name, hits = bits[0], bits[1], 1
        elif len(bits) == 3:
            mode, name, hits = bits[0], bits[1], int(bits[2])
        else:
            raise ValueError(
                f"bad {ENV_VAR} entry {part!r}; want mode:point[:hits]"
            )
        if mode not in _MODES:
            raise ValueError(f"bad {ENV_VAR} mode {mode!r} in {part!r}")
        out[name] = [mode, int(hits)]
    return out


def arm_from_env(value: str | None = None) -> None:
    """Arm points from ``REPRO_FAULTS`` (or an explicit string) — how the
    chaos harness arms a *child* process before it imports anything."""
    value = os.environ.get(ENV_VAR, "") if value is None else value
    for name, (mode, hits) in _parse_env(value).items():
        arm(name, mode, hits)


# ---------------------------------------------------------------------------
# Corruption injectors (deterministic — no entropy source anywhere)
# ---------------------------------------------------------------------------


def torn_write(data: bytes, keep=0.5) -> bytes:
    """The prefix of ``data`` a torn write would leave behind: ``keep`` as a
    fraction (0 < keep < 1) or an absolute byte count. Never the whole
    buffer — a torn write by definition lost the tail."""
    n = len(data)
    cut = int(keep) if isinstance(keep, int) else int(n * float(keep))
    cut = max(0, min(cut, n - 1))
    return data[:cut]


def bit_flip(buf, *, bit: int | None = None):
    """Flip one bit. ``bytes`` in → ``bytes`` out; ndarray in → same-shape
    copy with one flipped bit in its byte view. ``bit`` defaults to the
    middle bit (deterministic), and is taken modulo the buffer size."""
    if isinstance(buf, (bytes, bytearray)):
        raw = bytearray(buf)
        if not raw:
            raise ValueError("cannot bit-flip an empty buffer")
        pos = (len(raw) * 4) if bit is None else int(bit)
        byte, shift = (pos // 8) % len(raw), pos % 8
        raw[byte] ^= 1 << shift
        return bytes(raw)
    arr = np.asarray(buf)
    flat = np.ascontiguousarray(arr).view(np.uint8).reshape(-1).copy()
    if flat.size == 0:
        raise ValueError("cannot bit-flip an empty array")
    pos = (flat.size * 4) if bit is None else int(bit)
    byte, shift = (pos // 8) % flat.size, pos % 8
    flat[byte] ^= 1 << shift
    return flat.view(arr.dtype).reshape(arr.shape)


def checksum(data: bytes) -> int:
    """CRC32 as the WAL/snapshot layers compute it (one shared spelling)."""
    return zlib.crc32(data) & 0xFFFFFFFF


# Child processes armed via the environment need no cooperation from the
# code under test: the import of this module (pulled in by any crash point)
# arms everything listed.
if os.environ.get(ENV_VAR):
    arm_from_env()
