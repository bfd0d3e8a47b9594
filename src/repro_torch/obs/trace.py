"""Nestable spans + the process clock (the port's copy of ``repro.obs.trace``).

A :func:`span` is a wall-clock interval with a name, free-form attributes,
optional cost fold-ins (``add_cost``: distance evaluations and hops), and
children (spans opened while it is active on the same thread). Spans live
at host boundaries, around the calls whose results the host reads anyway,
so the build profiler can attribute wall time and distance evaluations per
phase without adding a sync of its own.

Zero-cost-when-disabled: the module-level enable flag (``REPRO_OBS=1`` at
import, or :func:`enable`/:func:`disable` at runtime) is checked before
any label formatting or clock read; disabled ``span()`` yields a shared
null singleton whose ``add_cost``/``set`` are no-ops — ``add_cost``
receives raw values and only the *real* span converts them with
``float()``, so a disabled span never forces a device sync.

:data:`now` is the one monotonic clock of every stats path in ``serve/``,
so all timestamps (deadlines included) share one timebase.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time

__all__ = [
    "NULL_SPAN",
    "Span",
    "clear_spans",
    "disable",
    "enable",
    "enabled",
    "export_jsonl",
    "iter_spans",
    "now",
    "span",
    "spans",
]

#: The process-wide monotonic clock (seconds, arbitrary epoch).
now = time.perf_counter

_ENABLED = os.environ.get("REPRO_OBS", "") not in ("", "0", "false", "False")


def enabled() -> bool:
    """Whether spans/traces/gated counters are being recorded."""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


class Span:
    """One recorded interval; build via :func:`span`, not directly."""

    __slots__ = ("name", "attrs", "t0", "dur_s", "n_dists", "n_hops", "children")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = dict(attrs)
        self.t0 = 0.0
        self.dur_s = 0.0
        self.n_dists = 0.0
        self.n_hops = 0.0
        self.children: list = []

    def add_cost(self, n_dists=0, n_hops=0) -> "Span":
        """Fold a cost delta in. ``float()`` happens HERE (on the enabled
        path only), so callers may pass device scalars without paying a
        sync when tracing is off."""
        self.n_dists += float(n_dists)
        self.n_hops += float(n_hops)
        return self

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "dur_s": self.dur_s,
            "n_dists": self.n_dists,
            "n_hops": self.n_hops,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    def __repr__(self) -> str:
        return (
            f"Span({self.name!r}, dur_s={self.dur_s:.6f}, "
            f"n_dists={self.n_dists:g}, children={len(self.children)})"
        )


class _NullSpan:
    """The disabled-path singleton: every method is a no-argument-touching
    no-op (``add_cost`` never calls ``float()`` on its inputs)."""

    __slots__ = ()

    def add_cost(self, n_dists=0, n_hops=0) -> "_NullSpan":
        return self

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()

_tls = threading.local()
_lock = threading.Lock()
#: finished ROOT spans (children hang off their parents), bounded.
_finished: collections.deque = collections.deque(maxlen=1024)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Open a span; nests under the innermost active span of this thread.

    Disabled mode yields :data:`NULL_SPAN` without reading the clock or
    touching the attrs."""
    if not _ENABLED:
        yield NULL_SPAN
        return
    sp = Span(name, attrs)
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    parent = stack[-1] if stack else None
    stack.append(sp)
    sp.t0 = now()
    try:
        yield sp
    finally:
        sp.dur_s = now() - sp.t0
        stack.pop()
        if parent is not None:
            parent.children.append(sp)
        else:
            with _lock:
                _finished.append(sp)


def spans(name: str | None = None) -> list:
    """Finished root spans (most recent last), optionally filtered by name."""
    with _lock:
        out = list(_finished)
    if name is not None:
        out = [s for s in out if s.name == name]
    return out


def iter_spans(name: str | None = None):
    """Every finished span, roots and descendants (depth-first)."""
    todo = spans()
    while todo:
        sp = todo.pop(0)
        if name is None or sp.name == name:
            yield sp
        todo[:0] = sp.children


def clear_spans() -> None:
    with _lock:
        _finished.clear()


def export_jsonl(path_or_file) -> int:
    """Write finished root spans as JSON lines; returns the line count."""
    roots = spans()
    if hasattr(path_or_file, "write"):
        for sp in roots:
            path_or_file.write(json.dumps(sp.to_dict()) + "\n")
    else:
        with open(path_or_file, "w") as f:
            for sp in roots:
                f.write(json.dumps(sp.to_dict()) + "\n")
    return len(roots)
