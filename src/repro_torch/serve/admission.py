"""Admission control for the serving runtime (reference:
repro.serve.admission; DESIGN.md §13).

A serving system's cheapest request is the one it never runs: under
overload, queueing theory guarantees unbounded latency unless work is
refused *before* it burns compute. This module owns that policy for
:class:`repro_torch.serve.runtime.Runtime` and keeps the books the SLO story is
told from:

  * **Reject at the door** — a queue-depth limit (``max_queue``): a submit
    against a full queue raises :class:`QueueFullError` synchronously
    (backpressure the client can see), costing zero scheduler or engine
    work.
  * **Shed at dequeue** — per-request deadlines: a request whose deadline
    has already passed when the scheduler pops it is failed with
    :class:`DeadlineExceededError` instead of being packed into a batch —
    the compute it would have burned goes to requests that can still make
    their SLO.
  * **Account for misses** — a request that is served but completes after
    its deadline still returns its result, and is counted as a
    ``deadline_miss`` (the lenient half of the policy: sunk compute is
    delivered, not discarded).

Every decision increments a counter and the served path records queue /
service / end-to-end latency into bounded windows — all backed by the
``repro_torch.obs`` registry: the decision counters are
``serve_admission_total{inst=…,decision=…}`` series and the windows are
obs histograms, so one registry snapshot shows them next to build and
kernel metrics. :meth:`AdmissionController.stats` stays the API-compatible
view — the arithmetic contract (``admitted == served + shed + pending``;
rejected requests are never admitted) is held by the tests.
"""

from __future__ import annotations

import dataclasses
import threading

from repro_torch import obs


class QueueFullError(RuntimeError):
    """Submit refused: the runtime's queue is at its depth limit."""


class DeadlineExceededError(TimeoutError):
    """Request shed: its deadline expired before any compute was spent."""


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission policy knobs.

    max_queue            pending-request ceiling; ``None`` = unbounded.
    default_deadline_ms  deadline applied to submits that don't carry one;
                         ``None`` = no deadline (never shed).
    """

    max_queue: int | None = None
    default_deadline_ms: float | None = None

    def __post_init__(self):
        if self.max_queue is not None and self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")
        if (
            self.default_deadline_ms is not None
            and self.default_deadline_ms < 0
        ):
            raise ValueError(
                f"default_deadline_ms must be >= 0, got "
                f"{self.default_deadline_ms}"
            )


class AdmissionController:
    """Counters + policy for one :class:`~repro_torch.serve.runtime.Runtime`.

    Thread-safe: submits (client threads), sheds (scheduler thread), and
    serve records (scheduler thread) all mutate under one lock. Latency
    windows are bounded obs histograms (most recent ``WINDOW`` requests) so
    a long-lived server never grows per-request state; metric references
    are resolved once here, so the hot path never formats a label.
    """

    WINDOW = 4096

    def __init__(self, config: AdmissionConfig | None = None):
        self.config = config or AdmissionConfig()
        self._lock = threading.Lock()
        inst = str(obs.REGISTRY.next_instance())
        self._counters = {
            name: obs.counter(
                "serve_admission_total", inst=inst, decision=name
            )
            for name in ("admitted", "rejected", "shed", "served", "missed")
        }
        self._queue_lat = obs.histogram(
            "serve_queue_latency_seconds", window=self.WINDOW, inst=inst
        )
        self._service_lat = obs.histogram(
            "serve_service_latency_seconds", window=self.WINDOW, inst=inst
        )
        self._e2e_lat = obs.histogram(
            "serve_e2e_latency_seconds", window=self.WINDOW, inst=inst
        )

    # ---- policy ----------------------------------------------------------

    def deadline_for(
        self, deadline_ms: float | None, now: float | None = None
    ) -> float | None:
        """Absolute monotonic-clock (``obs.now``) deadline for a submit,
        or None."""
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        if deadline_ms is None:
            return None
        if deadline_ms < 0:
            raise ValueError(f"deadline_ms must be >= 0, got {deadline_ms}")
        return (obs.now() if now is None else now) + deadline_ms / 1e3

    def admit(self, queue_depth: int) -> None:
        """Gate one submit against ``queue_depth`` already-pending requests.

        Raises :class:`QueueFullError` (and counts the reject) at the
        limit; otherwise counts the admit."""
        mq = self.config.max_queue
        with self._lock:
            if mq is not None and queue_depth >= mq:
                self._counters["rejected"].inc()
                raise QueueFullError(
                    f"queue full: {queue_depth} pending >= max_queue={mq}"
                )
            self._counters["admitted"].inc()

    def shed(self, n: int = 1) -> None:
        """Count ``n`` requests shed at dequeue (deadline already past)."""
        with self._lock:
            self._counters["shed"].inc(n)

    def record_served(
        self, queue_s: float, service_s: float, *, missed: bool
    ) -> None:
        """Fold one served request into the latency/SLO books."""
        with self._lock:
            self._counters["served"].inc()
            if missed:
                self._counters["missed"].inc()
            self._queue_lat.observe(queue_s)
            self._service_lat.observe(service_s)
            self._e2e_lat.observe(queue_s + service_s)

    # ---- telemetry -------------------------------------------------------

    def stats(self) -> dict:
        """Counters + p50/p99 of the queue / service / end-to-end windows.

        ``admitted - served - shed`` is the number still pending (0 after a
        drain); ``rejected`` requests were never admitted."""
        with self._lock:
            admitted = int(self._counters["admitted"].value)
            shed = int(self._counters["shed"].value)
            q50, q99 = self._queue_lat.pcts_ms()
            s50, s99 = self._service_lat.pcts_ms()
            e50, e99 = self._e2e_lat.pcts_ms()
            return {
                "admitted": admitted,
                "rejected": int(self._counters["rejected"].value),
                "shed": shed,
                "served": int(self._counters["served"].value),
                "deadline_misses": int(self._counters["missed"].value),
                "shed_rate": shed / admitted if admitted else 0.0,
                "queue_p50_ms": q50,
                "queue_p99_ms": q99,
                "service_p50_ms": s50,
                "service_p99_ms": s99,
                "p50_ms": e50,
                "p99_ms": e99,
            }

    def reset_stats(self) -> "AdmissionController":
        with self._lock:
            for c in self._counters.values():
                c.reset()
            self._queue_lat.reset()
            self._service_lat.reset()
            self._e2e_lat.reset()
        return self

    #: steady-state measurement alias (the obs-wide reset spelling).
    reset = reset_stats
