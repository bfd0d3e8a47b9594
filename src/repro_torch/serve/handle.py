"""Copy-on-write index handle — RCU-style generations (reference:
repro.serve.handle; DESIGN.md §13).

The facade's ``add``/``delete``/``compact`` mutate the index *in place*,
which is exactly right for a single-threaded pipeline and exactly wrong for
a serving runtime: a reader that picks up ``index.graph`` mid-``compact``
can observe purged adjacency rows next to a not-yet-rewired backend mirror.
:class:`IndexHandle` removes that window the classic read-copy-update way:

  * **Readers** grab :attr:`current` — an immutable :class:`Generation`
    holding one fully-consistent index plus its device tombstone mask — and
    use that object for the *whole* request. A generation is never mutated
    after publication, so a reader can take arbitrarily long without ever
    observing a half-applied update; it simply finishes on the generation it
    started with.
  * **Mutators** call :meth:`mutate` (or the ``add``/``delete``/``compact``
    conveniences): the current index is cloned through the existing
    ``export_state``/``restore`` machinery (``AnnIndex.clone``), the
    mutation runs against the private clone (``add`` grows the clone's
    backend via ``backend.extend`` exactly as always), and the new
    generation is published by ONE reference assignment — atomic under the
    GIL, so readers see either the old index or the new one, never a blend.
  * **Prepare hooks** run on the fully-built clone *before* the flip:
    the serving runtime uses this to warm the (Q-bucket × spec) keys of a
    grown index off the request path (``SearchEngine.warm_view``), so the
    scheduler never dispatches a cold key after a flip.

Mutations are serialized by the handle's lock (last-writer-wins is not a
thing here: each mutation builds on the previously published generation),
and this module is the ONE mutation path for any index that is being
served.

On the card the clone is ``AnnIndex.clone``: the whole state goes to the
host and back (``export_state``/``restore``), timed by the
``serve/flip/clone`` span. The mutator launches on the same CUDA stream as
the readers, so the caching allocator never hands a reader memory that a
mutation still writes; a reader's dispatch queues on the card behind the
mutation's insert batches, though no host lock blocks it.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch import obs
from repro_torch.serve.wal import apply_record, to_host
from repro_torch.testing import faults

#: mutation logged + durable, reference store not yet executed: recovery
#: replays it, the caller was never acked — the at-least-once window.
P_BEFORE_FLIP = faults.declare("handle/before_flip")
#: reference store done, ack not yet delivered to the caller.
P_AFTER_FLIP = faults.declare("handle/after_flip")


def add_record(vectors) -> tuple[str, dict]:
    """Normalize an ``add`` into its WAL record ``(op, arrays)`` form. The
    normalized array is both what gets logged and what gets applied
    (:func:`repro_torch.serve.wal.apply_record`), so log and index can never
    disagree about the inserted payload."""
    arr = to_host(vectors).astype(np.float32, copy=False)
    if arr.ndim == 1:
        arr = arr[None]
    return "add", {"vectors": arr}


def delete_record(ids) -> tuple[str, dict]:
    """Normalize a ``delete`` into its WAL record form."""
    return "delete", {"ids": np.atleast_1d(to_host(ids).astype(np.int64, copy=False))}


def compact_record() -> tuple[str, dict]:
    """A ``compact`` WAL record (no payload — the op is deterministic)."""
    return "compact", {}


class Generation:
    """One published, immutable index version.

    ``gen`` is the monotonically increasing generation number (0 = the
    handle's initial index); ``index`` is the index object itself, which
    must not be mutated after publication. ``banned`` is the tombstone mask
    search dispatches need, a bool tensor on the index's device, built once
    and cached — safe because the tombstone set is frozen with the
    generation. ``any_banned`` says whether it strikes anything: a search
    with no tombstones passes no mask, as ``AnnIndex.search`` does.
    """

    __slots__ = ("gen", "index", "_banned", "_any")

    def __init__(self, gen: int, index):
        self.gen = int(gen)
        self.index = index
        self._banned = None
        self._any = False

    def _mask(self) -> torch.Tensor:
        if self._banned is None:
            dead = self.index.deleted_ids
            mask = np.zeros(self.index.n, bool)
            mask[dead] = True
            self._any = bool(dead.size)
            self._banned = torch.from_numpy(mask).to(self.index.device)  # idempotent if raced
        return self._banned

    @property
    def banned(self) -> torch.Tensor:
        """(n,) bool mask of tombstoned ids on the index's device (True =
        never return)."""
        return self._mask()

    @property
    def any_banned(self) -> bool:
        """Whether the generation has any tombstone."""
        self._mask()
        return self._any

    def __repr__(self) -> str:
        return f"Generation(gen={self.gen}, index={self.index!r})"


class IndexHandle:
    """Atomic snapshot-swap container around one :class:`repro_torch.index.AnnIndex`.

    Usage::

        handle = IndexHandle(index)
        gen = handle.current            # reader: pin a generation
        ...serve the whole request from gen.index / gen.banned...
        handle.add(new_vectors)         # mutator: clone -> apply -> flip
        handle.current.gen              # readers now see the new generation

    The handle never mutates a published index: every maintenance op runs on
    a private clone and publishes a fresh generation. In-flight readers keep
    their pinned generation alive (plain refcounting — no epoch bookkeeping
    needed) and retired generations are garbage once the last reader drops
    them.
    """

    def __init__(self, index, *, wal=None):
        if not hasattr(index, "export_state"):
            raise TypeError(
                "IndexHandle wraps a repro_torch.index.AnnIndex-like object with "
                f"export_state/restore snapshot hooks; got {type(index).__name__}"
            )
        self._generation = Generation(0, index)
        self._mutex = threading.Lock()  # serializes mutators, not readers
        self._prepare_hooks: list = []
        self._commit_hooks: list = []
        self.wal = wal  # WalWriter or None; owned by the handle once attached
        self._last_lsn = wal.last_lsn if wal is not None else 0
        self._poisoned = False  # set when a failed append can't be rewound

    # ---- reader side -----------------------------------------------------

    @property
    def current(self) -> Generation:
        """The latest published generation (atomic reference read)."""
        return self._generation

    @property
    def generation(self) -> int:
        """The latest published generation number."""
        return self._generation.gen

    @property
    def last_lsn(self) -> int:
        """WAL LSN of the last published mutation (0 when no WAL)."""
        return self._last_lsn

    # ---- mutator side ----------------------------------------------------

    def on_prepare(self, hook) -> "IndexHandle":
        """Register ``hook(generation)`` to run on every fully-built clone
        *before* it is published — the warm-keys window. Hooks run
        under the mutation lock, off the reader path; a raising hook aborts
        the flip (the old generation stays current)."""
        self._prepare_hooks.append(hook)
        return self

    def on_commit(self, hook) -> "IndexHandle":
        """Register ``hook(generation, lsn, n_records)`` to run after every
        successful flip, still under the mutation lock — the checkpointer's
        ops-since-checkpoint trigger. A raising hook propagates to the
        mutator but cannot un-publish the flip."""
        self._commit_hooks.append(hook)
        return self

    def mutate(self, fn, *, records=None):
        """Clone-apply-log-flip: run ``fn(clone)`` against a private copy of
        the current index, then atomically publish the result.

        Returns ``(generation, result)`` — the newly published
        :class:`Generation` and whatever ``fn`` returned. ``fn`` may call
        any facade maintenance method (or several: a batched group of
        mutations flips once). If ``fn`` raises, nothing is published.

        With a WAL attached, ``records`` — the ``(op, arrays)`` list
        describing exactly what ``fn`` applies (see :func:`add_record` et
        al.) — is appended and group-committed (ONE fsync for the whole
        group) *after* the clone mutates and warms but *before* the
        reference store, so by the time any caller sees the new generation
        (the ack), its mutations are on disk. The one crash window left is
        logged-but-unflipped: recovery replays a mutation nobody was acked
        for — at-least-once, never lost-ack (DESIGN.md §15). If the append
        or commit itself fails, the half-logged group is rewound out of the
        log (nothing in it was acked) before the error propagates; a rewind
        that *also* fails poisons the handle — logged and live state may
        now disagree, so further mutations are refused until re-attach. A
        durable handle refuses record-less mutations: an arbitrary closure
        can't be replayed."""
        with self._mutex:
            if self._poisoned:
                raise RuntimeError(
                    "IndexHandle is poisoned: a WAL append failed and the "
                    "log tail could not be rewound, so logged and live "
                    "state may disagree — re-attach (serve.recovery.attach) "
                    "before mutating again"
                )
            if self.wal is not None and records is None:
                raise ValueError(
                    "this IndexHandle has a WAL attached: mutate() needs "
                    "records=[(op, arrays), ...] so the mutation can be "
                    "replayed at recovery (use add/delete/compact, or build "
                    "records with serve.handle.add_record et al.)"
                )
            with obs.span("serve/flip", base_gen=self._generation.gen) as flip:
                base = self._generation
                with obs.span("serve/flip/clone"):
                    clone = base.index.clone()
                with obs.span("serve/flip/apply"):
                    result = fn(clone)
                new = Generation(base.gen + 1, clone)
                new.banned  # build the device mask before readers can need it
                with obs.span("serve/flip/prepare"):
                    for hook in self._prepare_hooks:
                        hook(new)
                lsn = self._last_lsn
                if self.wal is not None and records:
                    with obs.span("serve/flip/log", n_records=len(records)):
                        wal_mark = self.wal.mark()
                        try:
                            for op, arrays in records:
                                lsn = self.wal.append(op, arrays)
                            self.wal.commit()  # group commit: durable, then ack
                        except BaseException:
                            # a half-logged group must not outlive its abort:
                            # later acked records would stack above the
                            # orphaned LSNs and the next recovery would
                            # replay a mutation whose caller saw it fail
                            try:
                                self.wal.rewind(wal_mark)
                            except BaseException:
                                self._poisoned = True  # log tail unknown
                            raise
                faults.crash_point(P_BEFORE_FLIP)
                flip.set(gen=new.gen)
                self._generation = new  # flip: one atomic reference store
                self._last_lsn = lsn
                faults.crash_point(P_AFTER_FLIP)
            obs.tick("serve_flips_total")
            for hook in self._commit_hooks:
                hook(new, lsn, len(records) if records else 0)
        return new, result

    def _mutate_records(self, records):
        def fn(index):
            out = [apply_record(index, op, arrays) for op, arrays in records]
            return out[0] if len(out) == 1 else out

        return self.mutate(fn, records=records)

    def add(self, vectors) -> Generation:
        """Publish a generation with ``vectors`` inserted (facade ``add``)."""
        return self._mutate_records([add_record(vectors)])[0]

    def delete(self, ids) -> Generation:
        """Publish a generation with ``ids`` tombstoned (facade ``delete``)."""
        return self._mutate_records([delete_record(ids)])[0]

    def compact(self) -> Generation:
        """Publish a generation with tombstones rewired out (facade
        ``compact``) — array shapes are preserved (retired slots keep their
        rows), so this flip meets no cold engine key downstream."""
        return self._mutate_records([compact_record()])[0]

    def __repr__(self) -> str:
        g = self._generation
        return f"IndexHandle(gen={g.gen}, index={g.index!r})"
