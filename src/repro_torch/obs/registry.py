"""Process-wide metrics registry (the port's copy of ``repro.obs.registry``).

Three primitive metric types — :class:`Counter`, :class:`Gauge`,
:class:`Histogram` — stored in one :data:`REGISTRY` keyed by
``(name, sorted labels)``. Get-or-create is idempotent, so every subsystem
(serving engine, admission controller, build facade, kernel dispatchers)
can hold direct references to its own metrics and the hot path never
touches the registry dict or formats a label string.

Concurrency model (the "lock-free-on-read" contract the tests hold this
to):

  * **Writes** take the metric's own lock (a plain increment under
    contention from the Runtime scheduler + mutator + client threads must
    be exact, and ``+=`` alone is not atomic across a bytecode boundary).
  * **Counter/Gauge reads** take no lock: a single attribute read of an
    int/float is atomic under the GIL, so ``stats()`` paths never contend
    with the scheduler thread.
  * **Histogram reads** copy the bounded window under the metric lock
    (iterating a deque while another thread appends raises RuntimeError),
    then compute percentiles on the copy.
  * **Registry snapshots** hold the registration lock only long enough to
    copy the metric list, then read each metric as above — a snapshot
    taken mid-update is a consistent point-in-time view, never an error.

Histograms are bounded reservoirs (sliding window of the most recent
``window`` observations, plus all-time count/sum); :func:`pcts_ms` is the
one percentile definition every latency ``stats()`` surface reports.
"""

from __future__ import annotations

import collections
import itertools
import threading

import numpy as np

__all__ = [
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "pcts_ms",
]


def pcts_ms(values) -> tuple[float, float]:
    """(p50, p99) of a seconds-scale window, in milliseconds.

    THE percentile definition for every latency ``stats()`` surface:
    ``np.percentile`` over a float64 copy, scaled to ms.
    """
    lat = np.asarray(values, np.float64)
    if not lat.size:
        return 0.0, 0.0
    return (
        float(np.percentile(lat, 50) * 1e3),
        float(np.percentile(lat, 99) * 1e3),
    )


class _Metric:
    """Shared identity: a name plus a sorted tuple of (key, value) labels."""

    __slots__ = ("name", "labels", "_lock")
    kind = "untyped"

    def __init__(self, name: str, labels: tuple = ()):
        self.name = str(name)
        self.labels = tuple(labels)
        self._lock = threading.Lock()

    @property
    def key(self) -> str:
        """Prometheus-style series key, e.g. ``name{a="1",b="x"}``."""
        if not self.labels:
            return self.name
        inner = ",".join(f'{k}="{v}"' for k, v in self.labels)
        return f"{self.name}{{{inner}}}"

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.key})"


class Counter(_Metric):
    """Monotonic (between resets) numeric counter."""

    __slots__ = ("_value",)
    kind = "counter"

    def __init__(self, name: str, labels: tuple = ()):
        super().__init__(name, labels)
        self._value = 0

    def inc(self, amount=1) -> "Counter":
        with self._lock:
            self._value += amount
        return self

    @property
    def value(self):
        return self._value  # GIL-atomic read: no lock

    def reset(self) -> "Counter":
        with self._lock:
            self._value = 0
        return self


class Gauge(_Metric):
    """Last-write-wins numeric level (queue depth, generation, …)."""

    __slots__ = ("_value",)
    kind = "gauge"

    def __init__(self, name: str, labels: tuple = ()):
        super().__init__(name, labels)
        self._value = 0

    def set(self, value) -> "Gauge":
        self._value = value  # single store: GIL-atomic
        return self

    def inc(self, amount=1) -> "Gauge":
        with self._lock:
            self._value += amount
        return self

    @property
    def value(self):
        return self._value

    def reset(self) -> "Gauge":
        self._value = 0
        return self


class Histogram(_Metric):
    """Bounded-reservoir distribution: sliding window + all-time count/sum.

    Observations are seconds-scale latencies everywhere in this repo; the
    snapshot reports window percentiles in milliseconds (:func:`pcts_ms`).
    """

    __slots__ = ("window", "_values", "_count", "_sum")
    kind = "histogram"

    def __init__(self, name: str, labels: tuple = (), *, window: int = 4096):
        super().__init__(name, labels)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self._values: collections.deque = collections.deque(maxlen=self.window)
        self._count = 0
        self._sum = 0.0

    def observe(self, value) -> "Histogram":
        v = float(value)
        with self._lock:
            self._values.append(v)
            self._count += 1
            self._sum += v
        return self

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def __len__(self) -> int:
        return len(self._values)

    def values(self) -> np.ndarray:
        """Float64 copy of the current window (taken under the lock)."""
        with self._lock:
            return np.asarray(self._values, np.float64)

    def pcts_ms(self) -> tuple[float, float]:
        """(p50_ms, p99_ms) over the window — the shared ``_pcts``."""
        return pcts_ms(self.values())

    def snapshot(self) -> dict:
        with self._lock:
            vals = np.asarray(self._values, np.float64)
            count, total = self._count, self._sum
        p50, p99 = pcts_ms(vals)
        return {
            "count": count,
            "sum": total,
            "window_len": int(vals.size),
            "window": self.window,
            "p50_ms": p50,
            "p99_ms": p99,
        }

    def reset(self) -> "Histogram":
        with self._lock:
            self._values.clear()
            self._count = 0
            self._sum = 0.0
        return self


class MetricsRegistry:
    """Get-or-create store of labeled metrics + consistent snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}
        self._inst = itertools.count()

    def next_instance(self) -> int:
        """Process-unique id for per-instance ``inst=`` labels (one per
        SearchEngine / AdmissionController / Runtime)."""
        return next(self._inst)

    def _get(self, cls, name: str, labels: dict, **kwargs):
        key = (
            str(name),
            tuple(sorted((str(k), str(v)) for k, v in labels.items())),
        )
        with self._lock:
            metric = self._metrics.get(key)
            if metric is None:
                metric = cls(key[0], key[1], **kwargs)
                self._metrics[key] = metric
                return metric
        if not isinstance(metric, cls):
            raise TypeError(
                f"metric {metric.key} already registered as "
                f"{metric.kind}, requested {cls.kind}"
            )
        return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, *, window: int = 4096, **labels) -> Histogram:
        """Get-or-create; ``window`` applies only on first creation."""
        return self._get(Histogram, name, labels, window=window)

    def metrics(self) -> list:
        """Point-in-time copy of the registered metric objects."""
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """Structured dump: {counters, gauges, histograms} keyed by series.

        The registration lock is held only to copy the metric list; each
        metric is then read per its own concurrency contract, so a
        snapshot racing live updates is a consistent view, never an error.
        """
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            if isinstance(m, Counter):
                out["counters"][m.key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.key] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][m.key] = m.snapshot()
        return out

    def reset(self) -> "MetricsRegistry":
        """Zero every registered metric (identities are kept: references
        held by live engines/controllers stay valid)."""
        for m in self.metrics():
            m.reset()
        return self

    def clear(self) -> "MetricsRegistry":
        """Forget every registered series (tests). Live holders of metric
        objects keep working; their series just leave future snapshots."""
        with self._lock:
            self._metrics.clear()
        return self


#: The process-wide registry every subsystem reports into.
REGISTRY = MetricsRegistry()
