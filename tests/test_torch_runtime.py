"""The port's ``IndexHandle`` and ``Runtime`` against the reference's, on the
CPU.

The index is the reference's: an fp32 HNSW over integer rows in [−8, 8]
(every distance an exact float32 integer), built with JAX and restored in
the port. Both handles apply the same mutations; after each flip the
published states must be bit-equal, and the futures of a ``Runtime`` must
return the rows of the engine's direct search, which equal the reference
engine's. WAL-before-ack, the poisoned handle, shedding, rejection and a
wedged ``close`` follow the reference's own tests. Every ``Future.result``
takes a timeout and every ``Runtime`` is closed in a ``with`` or a
``finally``, so a hang fails the test instead of the suite.
"""

from __future__ import annotations

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.graph.engine import BuildParams as JParams
from repro.graph.index import AnnIndex as JIndex
from repro_torch import serve
from repro_torch.index import AnnIndex
from repro_torch.serve import recovery, wal as wal_mod
from repro_torch.testing import faults

PARAMS = dict(r_upper=8, r_base=16, ef=32, batch=16, max_layers=3)
N, N_ADD, D = 600, 40, 16
T = 60  # seconds any one future may take


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture(scope="module")
def sets():
    x = np.random.default_rng(13).integers(-8, 9, size=(N + N_ADD + 32, D)).astype(np.float32)
    return x[:N], x[N:N + N_ADD], x[N + N_ADD:]


@pytest.fixture(scope="module")
def ref_index(sets):
    base, _, _ = sets
    return JIndex.build(jnp.asarray(base), algo="hnsw", backend="fp32", params=JParams(**PARAMS),
                        strategy="incremental")


@pytest.fixture
def port_index(ref_index):
    meta, arrays = ref_index.export_state()
    return AnnIndex.restore(meta, {k: np.asarray(v) for k, v in arrays.items()}, device="cpu")


def _state_equal(port, ref):
    got, want = port.export_state()[1], ref.export_state()[1]
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


# ---------------------------------------------------------------------------
# IndexHandle
# ---------------------------------------------------------------------------


def test_handle_flips_equal_reference(ref_index, port_index, sets):
    """Add, delete and compact flips: generation numbers, the published
    states (bit-equal to the reference's), the banned masks, and pinned
    generations that never change."""
    _, extra, queries = sets
    ph = serve.IndexHandle(port_index)
    jh = jserve.IndexHandle(JIndex.restore(*ref_index.export_state()))
    g0 = ph.current
    before = g0.index.search(queries, k=5, ef=24).ids.numpy()
    seen = []
    ph.on_prepare(lambda gen: seen.append((gen.gen, gen.index.n, ph.generation)))
    for op, arg in (("add", extra[:12]), ("delete", [3, 7, 11]), ("compact", None)):
        pg = getattr(ph, op)(*(() if arg is None else (arg,)))
        jg = getattr(jh, op)(*(() if arg is None else (jnp.asarray(arg) if op == "add" else arg,)))
        assert pg.gen == jg.gen == ph.generation
        _state_equal(pg.index, jg.index)
        np.testing.assert_array_equal(pg.banned.numpy(), np.asarray(jg.banned))
        assert pg.banned.device == pg.index.device and pg.banned.dtype == torch.bool
    assert seen == [(1, N + 12, 0), (2, N + 12, 1), (3, N + 12, 2)]
    # the pinned generation 0 never changed
    assert g0.index is port_index and g0.index.n == N and not g0.any_banned
    np.testing.assert_array_equal(g0.index.search(queries, k=5, ef=24).ids.numpy(), before)
    with pytest.raises(TypeError, match="export_state"):
        serve.IndexHandle(object())


def test_raising_mutation_publishes_nothing(port_index):
    handle = serve.IndexHandle(port_index)

    def bad(index):
        index.delete([0])
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        handle.mutate(bad)
    assert handle.generation == 0 and handle.current.index is port_index
    assert port_index.deleted_ids.size == 0


def test_wal_before_ack(tmp_path, port_index, sets):
    """A flip that dies after its record is durable was never acked, yet
    recovery replays it (at-least-once); the log holds the exact frames."""
    _, extra, _ = sets
    root = recovery.init(str(tmp_path / "root"), port_index)
    handle, _, _ = recovery.attach(root, background=False, fsync="batch", device="cpu")
    try:
        handle.add(extra[:2])
        assert handle.wal.stats()["fsyncs"] == 1 and handle.last_lsn == 1
        faults.arm("handle/before_flip")
        with pytest.raises(faults.FaultInjected):
            handle.add(extra[2:5])
        assert handle.generation == 1  # never published, never acked
        scanned = wal_mod.scan(recovery.wal_path(root))
        assert [r.op for r in scanned.records] == ["add", "add"]
        np.testing.assert_array_equal(scanned.records[1].arrays["vectors"], extra[2:5])
    finally:
        handle.wal.close()
    rec = recovery.recover(root, device="cpu")
    assert rec.replayed == 2 and rec.index.n == N + 5


def test_failed_append_poisons_handle(tmp_path, port_index, sets, monkeypatch):
    """A failed append whose rewind also fails leaves the log tail unknown:
    the handle refuses every later mutation; a failed append that rewinds
    leaves no orphan behind."""
    _, extra, queries = sets
    root = recovery.init(str(tmp_path / "root"), port_index)
    handle, _, _ = recovery.attach(root, background=False, fsync="none", device="cpu")
    try:
        handle.add(extra[:2])
        recs = [serve.handle.add_record(extra[2:4]), serve.handle.delete_record([0])]
        faults.arm("wal/before_append", hits=2)  # the group's second append fails
        with pytest.raises(faults.FaultInjected):
            handle.mutate(lambda index: [wal_mod.apply_record(index, op, a) for op, a in recs],
                          records=recs)
        assert handle.generation == 1 and handle.last_lsn == 1  # rewound
        handle.delete([9])
        assert handle.last_lsn == 2
        with pytest.raises(ValueError, match="records"):
            handle.mutate(lambda index: index.compact())

        def broken_rewind(mark):
            raise OSError("disk went away")

        monkeypatch.setattr(handle.wal, "rewind", broken_rewind)
        faults.arm("wal/before_append")
        with pytest.raises(faults.FaultInjected):
            handle.add(extra[:1])
        with pytest.raises(RuntimeError, match="poisoned"):
            handle.add(extra[:1])
        live = handle.current.index
    finally:
        handle.wal.close()
    rec = recovery.recover(root, device="cpu")
    assert rec.replayed == 2 and rec.index.n == N + 2
    np.testing.assert_array_equal(rec.index.search(queries, k=5, ef=24).ids.numpy(),
                                  live.search(queries, k=5, ef=24).ids.numpy())


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------


def test_runtime_results_equal_engine(ref_index, port_index, sets):
    """Packed requests return the rows of the engine's direct search,
    which equal the reference engine's; counts per query are the padded
    slots' share, as the reference's."""
    _, _, queries = sets
    jeng = jserve.SearchEngine(ref_index, k=5, ef=24, q_buckets=(1, 8))
    with serve.Runtime(port_index, k=5, ef=24, q_buckets=(1, 8), max_wait_ms=100.0) as rt:
        rt.warmup()
        futs = [rt.submit(queries[i]) for i in range(12)]
        results = [f.result(timeout=T) for f in futs]
        direct = rt.engine.search(queries[:12], record=False)
        stats = rt.stats()
    want = jeng.search(jnp.asarray(queries[:12]))
    np.testing.assert_array_equal(direct.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(direct.dists.numpy(), np.asarray(want.dists))
    for i, res in enumerate(results):
        np.testing.assert_array_equal(res.ids, direct.ids.numpy()[i])
        np.testing.assert_array_equal(res.dists, direct.dists.numpy()[i])
        assert res.n_dists > 0
    assert stats["requests"] == stats["served"] == stats["admitted"] == 12
    assert stats["batches"] < 12 and stats["max_batch_seen"] >= 2
    assert stats["shed"] == stats["rejected"] == stats["cold_dispatches"] == 0
    assert stats["thread_restarts"] == 0


def test_runtime_mutations_flip_and_stay_warm(ref_index, port_index, sets):
    """add / delete / compact through the runtime publish the reference's
    states, readers never see a cold key, and a pinned generation keeps
    its deleted id."""
    _, extra, queries = sets
    jh = jserve.IndexHandle(JIndex.restore(*ref_index.export_state()))
    with serve.Runtime(port_index, k=5, ef=24, q_buckets=(1, 8), max_wait_ms=5.0) as rt:
        rt.warmup()
        rt.add(extra[:12]).result(timeout=T)
        jh.add(jnp.asarray(extra[:12]))
        assert rt.generation == 1 and port_index.n == N
        pinned = rt.handle.current
        victim = int(rt.search(queries[0], T).ids[0])
        compiles = rt.engine.n_compiles
        assert rt.delete([victim]).result(timeout=T) == 1
        jh.delete([victim])
        assert victim not in rt.search(queries[0], T).ids
        rt.compact().result(timeout=T)
        jh.compact()
        assert victim not in rt.search(queries[0], T).ids
        old = rt.engine.search(queries[0], view=pinned, record=False).ids.numpy()
        assert victim in old
        _state_equal(rt.handle.current.index, jh.current.index)
        assert rt.engine.n_compiles == compiles  # same-n flips warm nothing
        stats = rt.stats()
    assert stats["cold_dispatches"] == 0 and stats["generation"] == 3


def test_runtime_queue_full_and_deadline_shedding(port_index, sets):
    _, _, queries = sets
    with serve.Runtime(port_index, k=5, ef=24, q_buckets=(1,), max_queue=0) as rt:
        with pytest.raises(serve.QueueFullError, match="queue full"):
            rt.submit(queries[0])
        with pytest.raises(ValueError, match="single"):
            rt.submit(queries[:2])
        stats = rt.stats()
    assert stats["rejected"] == 1 and stats["admitted"] == 0
    with serve.Runtime(port_index, k=5, ef=24, q_buckets=(1, 8), max_wait_ms=50.0) as rt:
        rt.warmup()
        rt.reset_stats()
        dead = rt.submit(queries[0], deadline_ms=0.0)
        with pytest.raises(serve.DeadlineExceededError):
            dead.result(timeout=T)
        for f in [rt.submit(q) for q in queries[1:5]]:
            assert f.result(timeout=T).ids.shape == (5,)
        stats = rt.stats()
    assert stats["shed"] == 1 and stats["served"] == 4
    assert stats["admitted"] == stats["served"] + stats["shed"]
    assert stats["shed_rate"] == pytest.approx(1 / 5)


def test_runtime_close_drains_and_fails_wedged(port_index, sets):
    """``close`` serves what is queued; a wedged scheduler makes ``close``
    fail every pending future instead of hanging."""
    _, _, queries = sets
    rt = serve.Runtime(port_index, k=5, ef=24, q_buckets=(1, 8), max_wait_ms=2000.0).warmup()
    try:
        futs = [rt.submit(queries[i]) for i in range(6)]
    finally:
        rt.close()
    assert all(f.result(timeout=0).ids.shape == (5,) for f in futs)
    with pytest.raises(RuntimeError, match="closed"):
        rt.submit(queries[0])
    with pytest.raises(RuntimeError, match="closed"):
        rt.add(queries[:2])

    rt = serve.Runtime(port_index, k=5, ef=24, max_wait_ms=0)
    release = threading.Event()

    def wedged():
        release.wait()  # a hung dispatch holding the runtime's lock
        return [], []

    rt._take_pack = wedged
    fut = rt.submit(queries[0])
    try:
        with pytest.raises(RuntimeError, match="timed out"):
            rt.close(timeout=0.5)
        with pytest.raises(RuntimeError):
            fut.result(timeout=5)
    finally:
        release.set()


def test_runtime_supervisor_counts_restarts(port_index, sets):
    """A raising scheduler iteration is restarted and counted in
    ``thread_restarts_total``; the request behind it is still served."""
    _, _, queries = sets
    rt = serve.Runtime(port_index, k=5, ef=24, max_wait_ms=0.5)
    try:
        orig = rt._take_pack
        armed = {"hit": True}

        def poisoned():
            if armed.pop("hit", False):
                raise RuntimeError("poisoned dispatch")
            return orig()

        rt._take_pack = poisoned
        assert rt.submit(queries[0]).result(timeout=T).ids.shape == (5,)
        h = rt.health()
        assert h["thread_restarts"] >= 1 and h["scheduler_alive"]
        assert rt.stats()["thread_restarts"] == h["thread_restarts"]
    finally:
        rt.close()


def test_durable_runtime_end_to_end(tmp_path, port_index, sets):
    _, extra, queries = sets
    root = recovery.init(str(tmp_path / "root"), port_index)
    handle, _, _ = recovery.attach(root, background=False, fsync="none", device="cpu")
    with pytest.raises(ValueError, match="IndexHandle"):
        serve.Runtime(handle, wal=object())
    rt = serve.Runtime(handle, k=5, ef=24, max_wait_ms=0.5)
    try:
        rt.add(extra[:4]).result(timeout=T)
        rt.delete([1]).result(timeout=T)
        with pytest.raises(ValueError, match="replayed"):
            rt.mutate(lambda index: index.compact())
        h = rt.health()
        assert h["healthy"] and h["wal"]["appends"] == 2
        live = rt.handle.current.index
    finally:
        rt.close()
        handle.wal.close()
    rec = recovery.recover(root, device="cpu")
    assert rec.replayed == 2
    _state_equal(rec.index, live)
    np.testing.assert_array_equal(rec.index.search(queries, k=5, ef=24).ids.numpy(),
                                  live.search(queries, k=5, ef=24).ids.numpy())


def test_readers_never_observe_torn_generations():
    """The reference's RCU stress case: every generation holds exactly one
    live sentinel on top of the probe (each flip adds sentinel g and deletes
    sentinel g − 1), so a reader must see exactly one sentinel and never an
    older one after a newer; more reader threads than a flip needs, with a
    short switch interval, race the mutator."""
    import sys

    from repro_torch.graph.engine import BuildParams

    flips, readers, n0 = 4, 8, 300
    rng = np.random.default_rng(23)
    corpus = rng.normal(size=(n0, D)).astype(np.float32)
    probe = corpus.mean(axis=0) + 6.0
    sentinels = (probe[None, :] + rng.normal(scale=1e-3, size=(flips + 1, D))).astype(np.float32)
    idx = AnnIndex.build(np.concatenate([corpus, sentinels[:1]]), algo="hnsw", backend="fp32",
                         params=BuildParams(r_upper=4, r_base=8, ef=16, batch=32, max_layers=2),
                         device="cpu")
    sentinel_ids = set(range(n0, n0 + flips + 1))
    failures, observed = [], []
    done = threading.Event()

    def read_loop(tid, rt):
        last = -1
        while not done.is_set():
            ids = [int(v) for v in rt.search(probe, T).ids]
            live = [v for v in ids if v in sentinel_ids]
            if len(live) != 1:
                failures.append(f"reader {tid}: {live} in {ids}")
            elif live[0] - n0 < last:
                failures.append(f"reader {tid}: generation went back {last} -> {live[0] - n0}")
            else:
                last = live[0] - n0
                observed.append(last)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with serve.Runtime(idx, k=4, ef=24, q_buckets=(1, 8), max_wait_ms=1.0) as rt:
            rt.warmup()
            threads = [threading.Thread(target=read_loop, args=(t, rt)) for t in range(readers)]
            for t in threads:
                t.start()
            try:
                for g in range(1, flips + 1):
                    def swap(index, g=g):
                        index.add(sentinels[g:g + 1])
                        index.delete([n0 + g - 1])

                    rt.mutate(swap).result(timeout=T)
            finally:
                done.set()
                for t in threads:
                    t.join(T)
            assert not any(t.is_alive() for t in threads)
            stats = rt.stats()
    finally:
        sys.setswitchinterval(switch)
    assert not failures, "\n".join(failures[:5])
    assert len(set(observed)) > 1 and stats["generation"] == flips
    assert stats["served"] == len(observed) and stats["admitted"] == stats["served"] + stats["shed"]
