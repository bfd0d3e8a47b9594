"""Continuous-batching serving runtime (reference: repro.serve.runtime;
DESIGN.md §13).

The original coalescing front-end batched one bucket at a time and could
not overlap maintenance with search. This module replaces it with an
inference-stack-shaped runtime in the forward-batch style of modern LLM
servers: ONE scheduler loop owns all engine dispatches, draining a priority
queue of per-request states and greedily packing compatible requests into
the best already-warm (Q-bucket × :class:`~repro_torch.graph.rerank.SearchSpec`)
key of the :class:`~repro_torch.serve.engine.SearchEngine`; ONE mutator
loop owns all index mutations, group-committing queued ``add`` / ``delete``
/ ``compact`` requests into copy-on-write generation flips of an
:class:`~repro_torch.serve.handle.IndexHandle` while readers keep serving the old
graph.

The three invariants the tests hold this to:

  * **Snapshot isolation** — every request pins ``handle.current`` at
    submit and is served from exactly that generation; a result set is
    always consistent with one published index version.
  * **Shed before compute** — admission control
    (:mod:`repro_torch.serve.admission`) rejects at the door on queue depth
    and sheds expired-deadline requests at dequeue, before any engine work;
    served-but-late requests are delivered and counted as deadline misses.
  * **No cold key after a flip** — the handle's prepare hook runs
    :meth:`SearchEngine.warm_view` on each clone *before* it is published
    (on the mutator thread), so the scheduler loop only dispatches warm
    keys; ``stats()['cold_dispatches']`` is the meter and stays 0.

Packing keys on ``(spec, generation)``: requests under the same spec share
one key per bucket, and requests pinned to the same generation share one
index — both must match for their queries to ride one padded block.
Deadlines order the queue (earliest first; arrival breaks ties), so under
backlog the requests closest to their SLO are packed first and hopeless
ones are shed without burning the batch's budget.

On the card both threads launch on the current CUDA stream: a mutation's
insert batches and a reader's dispatch queue one behind the other on the
card, while neither blocks the other on the host. The kernels are built
before the threads start. A future's result holds its row of ids and
distances on the host, as a server hands them on.
"""

from __future__ import annotations

import heapq
import itertools
import queue as queue_mod
import sys
import threading
import time
import traceback
from concurrent.futures import Future

import numpy as np

from repro_torch import obs
from repro_torch.graph.hnsw import SearchResult
from repro_torch.graph.rerank import SearchSpec, rerank_mode
from repro_torch.serve.admission import (
    AdmissionConfig,
    AdmissionController,
    DeadlineExceededError,
)
from repro_torch.serve.engine import DEFAULT_BUCKETS, SearchEngine
from repro_torch.serve.handle import (
    IndexHandle,
    add_record,
    compact_record,
    delete_record,
)
from repro_torch.serve.wal import apply_record, to_host

_NO_DEADLINE = float("inf")


class _Request:
    """Per-request scheduler state (the forward-batch unit)."""

    __slots__ = ("query", "spec", "gen", "arrival", "deadline", "future", "seq")

    def __init__(self, query, spec, gen, arrival, deadline, future, seq):
        self.query = query
        self.spec = spec
        self.gen = gen            # Generation pinned at submit
        self.arrival = arrival
        self.deadline = deadline  # absolute obs.now() time, or None
        self.future = future
        self.seq = seq

    @property
    def key(self) -> tuple:
        """Heap priority: earliest deadline first, then arrival order."""
        d = _NO_DEADLINE if self.deadline is None else self.deadline
        return (d, self.seq)


class Runtime:
    """Continuous-batching scheduler + admission + copy-on-write mutation.

    Usage::

        with serve.Runtime(index, k=10, ef=64, max_queue=256,
                           default_deadline_ms=50.0) as rt:
            rt.warmup()
            fut = rt.submit(query, deadline_ms=20.0)   # -> Future
            print(fut.result().ids)
            rt.add(new_vectors).result()               # COW flip, readers
            ...                                        # never blocked

    Construct over an ``AnnIndex`` (wrapped in a fresh
    :class:`IndexHandle`), an existing handle (shared with other runtimes),
    or an existing ``engine=`` (the legacy-scheduler migration path). One
    daemon scheduler thread owns every search dispatch; one daemon mutator
    thread owns every generation flip.
    """

    def __init__(
        self,
        index=None,
        *,
        engine: SearchEngine | None = None,
        spec: SearchSpec | None = None,
        k: int = 10,
        ef: int = 64,
        width: int = 1,
        rerank: bool | str = True,
        rerank_mult: int | None = None,
        q_buckets: tuple = DEFAULT_BUCKETS,
        max_wait_ms: float = 2.0,
        max_batch: int | None = None,
        max_queue: int | None = None,
        default_deadline_ms: float | None = None,
        admission: AdmissionController | None = None,
        wal=None,
    ):
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if index is None and engine is None:
            raise ValueError("Runtime needs an index, an IndexHandle, or an engine")
        if index is None:
            index = engine.index
        if isinstance(index, IndexHandle):
            if wal is not None:
                raise ValueError(
                    "pass the WAL when constructing the IndexHandle (or use "
                    "serve.recovery.attach) — a handle's log is part of its "
                    "identity, not per-runtime"
                )
            self.handle = index
        else:
            self.handle = IndexHandle(index, wal=wal)
        if engine is None:
            if spec is None:
                spec = SearchSpec(
                    k=int(k), ef=int(ef), width=int(width),
                    rerank=rerank_mode(rerank), rerank_mult=rerank_mult,
                )
            engine = SearchEngine(
                self.handle.current.index, spec=spec, q_buckets=q_buckets
            )
        elif engine.index is not self.handle.current.index:
            engine.refresh(index=self.handle.current.index)
        self.engine = engine
        self.max_wait = float(max_wait_ms) / 1e3
        self.max_batch = int(max_batch or engine.q_buckets[-1])
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.admission = admission or AdmissionController(AdmissionConfig(
            max_queue=max_queue, default_deadline_ms=default_deadline_ms,
        ))

        self._cv = threading.Condition()
        self._heap: list = []        # (key, seq, _Request)
        self._seq = itertools.count()
        self._closed = False
        self._specs_seen = {engine.spec}
        # batching telemetry (scheduler thread only, reads are racy-but-fine)
        inst = str(obs.REGISTRY.next_instance())
        self._n_batches = 0
        self._n_packed = 0
        self._max_batch_seen = 0
        self._batch_sizes: list = []
        self._m_cold = obs.counter("serve_cold_dispatch_total", inst=inst)
        self._m_restarts = obs.counter("thread_restarts_total", inst=inst)
        self._g_depth = obs.gauge("serve_queue_depth", inst=inst)

        self._mut_q: queue_mod.SimpleQueue = queue_mod.SimpleQueue()
        self.handle.on_prepare(self._prepare_generation)
        if self.handle.current.index.device.type == "cuda":
            from repro_torch.kernels import build

            build.build_all()  # before either thread can launch a kernel

        # the supervisor wrapper keeps each loop alive across crashes: a
        # raising iteration is counted, backed off, and re-entered — one
        # poisoned request must not turn into a dead scheduler that strands
        # every future behind it
        self._scheduler = threading.Thread(
            target=self._supervised, args=(self._schedule_loop,),
            name="runtime-scheduler", daemon=True,
        )
        self._mutator = threading.Thread(
            target=self._supervised, args=(self._mutate_loop,),
            name="runtime-mutator", daemon=True,
        )
        self._scheduler.start()
        self._mutator.start()

    def _supervised(self, target) -> None:
        """Restart ``target`` on any escape, with capped exponential
        backoff; normal return ends the thread. Crash counts land in
        ``thread_restarts_total`` (surfaced by :meth:`health`)."""
        backoff = 0.05
        while True:
            try:
                target()
                return
            except BaseException:  # noqa: BLE001 — the loop IS the fallback
                self._m_restarts.inc()
                print(
                    f"runtime: {threading.current_thread().name} crashed, "
                    f"restarting in {backoff:.2f}s",
                    file=sys.stderr,
                )
                traceback.print_exc()
                time.sleep(backoff)
                backoff = min(backoff * 2.0, 1.0)

    # ---- client side: search ---------------------------------------------

    def submit(
        self, query, *, spec: SearchSpec | None = None,
        deadline_ms: float | None = None,
    ) -> Future:
        """Enqueue one query vector; returns a Future of its SearchResult.

        ``deadline_ms`` (relative; default the admission config's
        ``default_deadline_ms``) bounds total time in the runtime: expired
        requests are shed before compute (the Future raises
        :class:`DeadlineExceededError`). A full queue raises
        :class:`~repro_torch.serve.admission.QueueFullError` synchronously.
        """
        q = to_host(query).astype(np.float32, copy=False)
        if q.ndim != 1:
            raise ValueError(
                f"submit takes a single (d,) query, got shape {q.shape}; "
                "batches go straight to SearchEngine.search"
            )
        spec = self.engine.spec if spec is None else spec
        now = obs.now()
        deadline = self.admission.deadline_for(deadline_ms, now)
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("Runtime is closed")
            self.admission.admit(len(self._heap))
            req = _Request(q, spec, self.handle.current, now, deadline, fut,
                           next(self._seq))
            heapq.heappush(self._heap, (req.key, req.seq, req))
            self._g_depth.set(len(self._heap))
            self._specs_seen.add(spec)
            self._cv.notify_all()
        return fut

    def search(
        self, query, timeout: float | None = None, *,
        spec: SearchSpec | None = None, deadline_ms: float | None = None,
    ) -> SearchResult:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(query, spec=spec, deadline_ms=deadline_ms).result(timeout)

    # ---- client side: mutation -------------------------------------------

    def _submit_mutation(self, fn, records=None) -> Future:
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("Runtime is closed")
        self._mut_q.put((fn, fut, records))
        return fut

    def _submit_record(self, record) -> Future:
        op, arrays = record
        return self._submit_mutation(
            lambda index: apply_record(index, op, arrays), [record]
        )

    def add(self, vectors) -> Future:
        """Insert a batch behind the reader path; Future of BuildStats.

        Mutations are applied by the background mutator as copy-on-write
        generation flips — searches in flight (and submitted meanwhile)
        keep serving the pre-mutation generation until the flip publishes.
        Queued mutations group-commit into one flip (one clone, one warm,
        one publish — and, with a WAL attached, one fsync) whenever the
        mutator is behind — the write-side twin of request batching."""
        return self._submit_record(add_record(vectors))

    def delete(self, ids) -> Future:
        """Tombstone ids behind the reader path; Future of the newly-deleted
        count. Same ``n``: the flip re-uses every warm key."""
        return self._submit_record(delete_record(ids))

    def compact(self) -> Future:
        """Rewire tombstones out behind the reader path; Future of
        BuildStats. Shape-preserving (retired slots keep their rows), so
        the flip costs no cold key."""
        return self._submit_record(compact_record())

    def mutate(self, fn) -> Future:
        """Run an arbitrary ``fn(index)`` as one atomic generation flip —
        e.g. an add+delete pair that must never be observed half-applied.
        Future of ``fn``'s return value. Refused on a durable runtime: an
        opaque closure cannot be WAL-logged for replay — use
        ``add``/``delete``/``compact``."""
        if self.handle.wal is not None:
            raise ValueError(
                "this Runtime's IndexHandle has a WAL attached: arbitrary "
                "mutation closures cannot be replayed at recovery — use "
                "add/delete/compact"
            )
        return self._submit_mutation(fn)

    # ---- lifecycle -------------------------------------------------------

    def warmup(self, *, specs: tuple = ()) -> "Runtime":
        """Warm every (bucket × spec) key off the request path; also
        registers ``specs`` so generation flips keep them warm."""
        with self._cv:
            self._specs_seen.update(specs)
        self.engine.warmup(specs=specs)
        return self

    def close(self, timeout: float | None = 60.0) -> None:
        """Drain and stop: every pending search is served (or shed, if its
        deadline expired), every queued mutation is applied, then both
        worker threads exit.

        ``timeout`` bounds each join (None = wait forever, the legacy
        behavior). A wedged loop thread — stuck in a hung dispatch, say —
        no longer deadlocks shutdown: on timeout every still-pending search
        and mutation future is failed with :class:`RuntimeError` so no
        caller blocks forever, and the same error is raised here (the
        daemon threads die with the process)."""
        # a wedged scheduler may be parked inside _take_pack HOLDING _cv, so
        # even the lock acquisition must be bounded; _closed is a plain
        # attribute store (GIL-atomic) and notify only matters for threads
        # that are actually waiting — which a wedged one is not
        acquired = self._cv.acquire(timeout=-1 if timeout is None else timeout)
        self._closed = True
        if acquired:
            try:
                self._cv.notify_all()
            finally:
                self._cv.release()
        self._scheduler.join(timeout)
        self._mut_q.put(None)
        self._mutator.join(timeout)
        wedged = [
            t.name for t in (self._scheduler, self._mutator) if t.is_alive()
        ]
        if wedged:
            err = RuntimeError(
                f"Runtime.close timed out after {timeout}s: "
                f"{', '.join(wedged)} wedged"
            )
            n_failed = self._fail_pending(err)
            obs.tick("serve_close_timeouts_total")
            raise RuntimeError(
                f"Runtime.close timed out after {timeout}s: "
                f"{', '.join(wedged)} still alive; failed {n_failed} pending "
                "future(s) instead of deadlocking"
            )

    def _fail_pending(self, exc: BaseException) -> int:
        """Fail every queued search + mutation future (wedged shutdown)."""
        n = 0
        acquired = self._cv.acquire(timeout=1.0)  # wedge may hold the lock
        try:
            pending = [req for _, _, req in self._heap]
            self._heap.clear()
            self._g_depth.set(0)
        finally:
            if acquired:
                self._cv.release()
        for req in pending:
            if not req.future.done():
                req.future.set_exception(exc)
                n += 1
        while True:
            try:
                item = self._mut_q.get_nowait()
            except queue_mod.Empty:
                break
            if item is None:
                continue
            if not item[1].done():
                item[1].set_exception(exc)
                n += 1
        return n

    def __enter__(self) -> "Runtime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- scheduler loop --------------------------------------------------

    def _earliest_deadline(self) -> float | None:
        ds = [req.deadline for _, _, req in self._heap
              if req.deadline is not None]
        return min(ds) if ds else None

    def _take_pack(self) -> tuple[list, list]:
        """Pop (under the lock) one dispatchable pack + the shed list.

        Priority order: shed everything already past deadline; the first
        live request seeds the pack's ``(spec, generation)`` key; compatible
        requests join up to ``max_batch``; the rest go back on the heap.
        """
        now = obs.now()
        batch: list = []
        shed: list = []
        keep: list = []
        key = None
        while self._heap:
            item = heapq.heappop(self._heap)
            req = item[2]
            if req.deadline is not None and now > req.deadline:
                shed.append(req)
                continue
            if key is None:
                key = (req.spec, req.gen.gen)
            if (req.spec, req.gen.gen) == key and len(batch) < self.max_batch:
                batch.append(req)
            else:
                keep.append(item)
        for item in keep:
            heapq.heappush(self._heap, item)
        self._g_depth.set(len(self._heap))
        return batch, shed

    def _schedule_loop(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._closed:
                    self._cv.wait()
                if not self._heap:  # closed and drained
                    return
                if not self._closed and self.max_wait > 0:
                    # batch-forming window: the head request waits at most
                    # max_wait for company — capped by the earliest pending
                    # deadline so forming never blows an SLO by itself
                    form = obs.now() + self.max_wait
                    while len(self._heap) < self.max_batch and not self._closed:
                        until = form
                        dl = self._earliest_deadline()
                        if dl is not None:
                            until = min(until, dl)
                        left = until - obs.now()
                        if left <= 0:
                            break
                        self._cv.wait(left)
                batch, shed = self._take_pack()
            if shed:
                self.admission.shed(len(shed))
                for req in shed:
                    req.future.set_exception(DeadlineExceededError(
                        "request shed before dispatch: deadline expired "
                        f"{(obs.now() - req.deadline) * 1e3:.1f}ms ago"
                    ))
            if batch:
                self._serve(batch)

    def _serve(self, batch: list) -> None:
        gen, spec = batch[0].gen, batch[0].spec
        try:
            if not self.engine.is_warm(len(batch), spec, n=gen.index.n):
                # steady state never lands here: warm_view warmed
                # every published generation's buckets before its flip
                self._m_cold.inc()
            t0 = obs.now()
            block = np.stack([r.query for r in batch])
            res = self.engine.search(block, spec=spec, view=gen)
            ids = res.ids.cpu().numpy()
            dists = res.dists.cpu().numpy()
            # per-query cost divides by dispatched padded slots, not the
            # real batch size (every padded row runs the same program)
            slots = self.engine.padded_queries(len(batch))
            per_q = res.n_dists / slots
            per_scan = res.n_scan / slots
            per_rerank = res.n_rerank / slots
            t1 = obs.now()
            self._n_batches += 1
            self._n_packed += len(batch)
            self._max_batch_seen = max(self._max_batch_seen, len(batch))
            self._batch_sizes.append(len(batch))
            if len(self._batch_sizes) > 4096:  # bounded window
                del self._batch_sizes[:2048]
            for i, req in enumerate(batch):
                missed = req.deadline is not None and t1 > req.deadline
                self.admission.record_served(
                    t0 - req.arrival, t1 - t0, missed=missed
                )
                req.future.set_result(SearchResult(
                    ids=ids[i], dists=dists[i], n_dists=per_q,
                    n_scan=per_scan, n_rerank=per_rerank,
                ))
        except BaseException as exc:  # noqa: BLE001 — fail the waiters, not the loop
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(exc)

    # ---- mutator loop ----------------------------------------------------

    def _prepare_generation(self, gen) -> None:
        """Handle prepare hook: warm the clone's (bucket × spec) keys
        before the flip publishes (no-op for same-``n`` flips)."""
        with self._cv:
            specs = tuple(self._specs_seen)
        self.engine.warm_view(gen, specs=specs)

    def _apply_mutations(self, group: list) -> None:
        results = [None] * len(group)

        def fn(index):
            for i, (mfn, _, _) in enumerate(group):
                results[i] = mfn(index)

        records = None
        if self.handle.wal is not None:
            # the group's flip logs all its records and group-commits them
            # with ONE fsync before any member future is acked
            records = [r for _, _, recs in group for r in (recs or ())]
        try:
            gen, _ = self.handle.mutate(fn, records=records)
        except BaseException as exc:  # noqa: BLE001
            if len(group) == 1:
                group[0][1].set_exception(exc)
                return
            # isolate the offender: replay each mutation as its own flip so
            # one bad request doesn't fail the innocents it grouped with
            for item in group:
                self._apply_mutations([item])
            return
        # rebind the engine default to the new generation (same key
        # table — refresh never drops warm keys); pinned in-flight
        # requests keep their own generation view
        try:
            self.engine.refresh(index=gen.index)
        finally:
            # the flip already published (and, durably, hit the WAL): ack
            # the group even if refresh blows up, or the supervisor restart
            # would strand these callers until close() fails them
            for (_, fut, _), res in zip(group, results):
                if not fut.done():
                    fut.set_result(res)

    def _mutate_loop(self) -> None:
        exit_after = False
        while not exit_after:
            item = self._mut_q.get()
            if item is None:
                return
            group = [item]
            # group-commit: everything queued behind this mutation rides the
            # same clone -> warm -> flip cycle (one publish, one warm pass)
            while True:
                try:
                    nxt = self._mut_q.get_nowait()
                except queue_mod.Empty:
                    break
                if nxt is None:
                    exit_after = True
                    break
                group.append(nxt)
            self._apply_mutations(group)

    # ---- telemetry -------------------------------------------------------

    @property
    def generation(self) -> int:
        """The latest published index generation number."""
        return self.handle.generation

    def health(self) -> dict:
        """Liveness + degradation surface (DESIGN.md §15): are both loop
        threads alive, how often has the supervisor restarted one, is the
        served index degraded (quarantined segments), and — for durable
        handles — where the WAL stands. ``healthy`` is the AND of it all."""
        gen = self.handle.current
        idx_health = getattr(gen.index, "health", None)
        idx = (
            idx_health() if callable(idx_health)
            else {"healthy": True, "degraded": False}
        )
        alive_sched = self._scheduler.is_alive()
        alive_mut = self._mutator.is_alive()
        degraded = bool(idx.get("degraded", False))
        return {
            "healthy": (
                alive_sched and alive_mut and not degraded and not self._closed
            ),
            "closed": self._closed,
            "scheduler_alive": alive_sched,
            "mutator_alive": alive_mut,
            "thread_restarts": int(self._m_restarts.value),
            "degraded": degraded,
            "generation": gen.gen,
            "pending": len(self._heap),
            "index": idx,
            "wal": (
                self.handle.wal.stats() if self.handle.wal is not None else None
            ),
        }

    def stats(self) -> dict:
        """The extended serving telemetry surface (DESIGN.md §13):
        admission counters (admitted/rejected/shed/served/deadline_misses),
        queue + service + end-to-end p50/p99, batching shape, generation
        and cold-dispatch meters, plus the nested engine stats."""
        sizes = np.asarray(self._batch_sizes, np.float64)
        return {
            "generation": self.handle.generation,
            "pending": len(self._heap),
            "batches": self._n_batches,
            "requests": self._n_packed,
            "mean_batch": float(sizes.mean()) if sizes.size else 0.0,
            "max_batch_seen": self._max_batch_seen,
            "cold_dispatches": int(self._m_cold.value),
            "thread_restarts": int(self._m_restarts.value),
            **self.admission.stats(),
            "engine": self.engine.stats(),
        }

    def reset_stats(self) -> "Runtime":
        """Zero the runtime + admission + engine counters (for phase-split
        measurements; call at a quiescent point — in-flight requests would
        skew the admitted/served arithmetic)."""
        self.admission.reset_stats()
        self._n_batches = self._n_packed = self._max_batch_seen = 0
        self._batch_sizes = []
        self._m_cold.reset()
        self.engine.reset_stats()
        return self

    #: steady-state measurement alias (the obs-wide reset spelling).
    reset = reset_stats

    def __repr__(self) -> str:
        return (
            f"Runtime(gen={self.handle.generation}, engine={self.engine!r}, "
            f"max_batch={self.max_batch}, max_wait_ms={self.max_wait * 1e3:g})"
        )
