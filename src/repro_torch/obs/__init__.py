"""``repro_torch.obs`` — the port's observability layer (the reference's
``repro.obs``, the same series names, labels and span names).

One process-wide metrics registry (labeled counters / gauges / bounded-
reservoir histograms, :mod:`repro_torch.obs.registry`), nestable host-side
spans with cost fold-ins (:mod:`repro_torch.obs.trace`), and report
rendering (Prometheus text exposition + JSON dump + the
``python -m repro_torch.obs.report`` CLI, :mod:`repro_torch.obs.report`).

Two tiers of instrumentation:

  * **Always-on metric primitives** back the serving ``stats()`` surfaces
    (engine latency window, admission counters, queue depth, cold
    dispatches): one locked increment or deque append per event, with
    references held directly so the hot path never formats a label.
  * **Gated extras** — spans, trace export, dispatch counters and build-
    phase counters — cost nothing unless the module-level enable flag is
    set (``REPRO_OBS=1`` env, or :func:`enable` at runtime): :func:`tick`
    and :func:`span` check it before touching labels or the clock.

A registry holds Python numbers only; a caller that reports a device count
converts it where it already syncs. This package imports nothing from
``repro_torch.graph`` / ``repro_torch.serve`` (they import it), except
lazily inside the report CLI.
"""

from __future__ import annotations

from repro_torch.obs.registry import (  # noqa: F401
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    pcts_ms,
)
from repro_torch.obs.trace import (  # noqa: F401
    NULL_SPAN,
    Span,
    clear_spans,
    disable,
    enable,
    enabled,
    export_jsonl,
    iter_spans,
    now,
    span,
    spans,
)

__all__ = [
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_SPAN",
    "Span",
    "clear_spans",
    "counter",
    "disable",
    "enable",
    "enabled",
    "export_jsonl",
    "gauge",
    "histogram",
    "iter_spans",
    "now",
    "pcts_ms",
    "snapshot",
    "span",
    "spans",
    "tick",
]


def counter(name: str, **labels) -> Counter:
    """Get-or-create a counter in the process registry."""
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, *, window: int = 4096, **labels) -> Histogram:
    return REGISTRY.histogram(name, window=window, **labels)


def snapshot() -> dict:
    """Consistent point-in-time dump of every registered metric."""
    return REGISTRY.snapshot()


def tick(name: str, n=1, **labels) -> None:
    """Gated counter bump: a no-op (before any label formatting) unless
    obs is enabled. The idiom for dispatch counters and host-side build
    counters."""
    if not enabled():
        return
    REGISTRY.counter(name, **labels).inc(n)
