"""The port's WAL and recovery against the reference's, on the CPU.

* WAL frames: one record encodes to the same bytes in both packages, and a
  log written by either scans in the other; a torn tail and a bit-flipped
  frame end the valid prefix the same way.
* A durable root written by the reference (``init`` + WAL ``add`` /
  ``delete`` / ``compact``) recovers in the port bit-equal to the
  reference's own ``recover`` (``flash_blocked`` and ``fp32``), and the
  reverse.
* ``Checkpointer``, ``verify_root`` and the recovery CLI with
  ``--device cpu``.
* A segmented root adopted from a manifest (``init_from_manifest``) replays
  a routed ``add`` (``ops.nearest_centroid``: the plain ``l2_batch`` here)
  equal to a live ``SegmentedAnnIndex.add`` and to the reference's replay.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro.graph.engine import BuildParams as JParams
from repro.graph.index import AnnIndex as JIndex
from repro.graph.segmented import SegmentedAnnIndex as JSeg
from repro.serve import recovery as jrecovery
from repro.serve import wal as jwal
from repro_torch.index import AnnIndex, SegmentedAnnIndex
from repro_torch.serve import recovery, snapshot as snap, wal as wal_mod
from repro_torch.testing import faults
from conftest import make_clustered

PARAMS = dict(r_upper=8, r_base=16, ef=32, batch=16, max_layers=3)
FLASH_KW = dict(d_f=16, m_f=8, l_f=4, h=8, kmeans_iters=6)
N, N_ADD, D = 600, 40, 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture(scope="module")
def sets():
    x = make_clustered(N + N_ADD + 32, D, n_clusters=12, seed=17)
    return x[:N], x[N:N + N_ADD], x[N + N_ADD:]


def _records(extra):
    return [("add", {"vectors": extra[:5]}), ("delete", {"ids": np.array([3, 1, 4], np.int64)}),
            ("compact", {}), ("add", {"vectors": extra[5:6]})]


def _assert_same_state(got, want):
    a, b = got.export_state()[1], want.export_state()[1]
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)


# ---------------------------------------------------------------------------
# WAL frames
# ---------------------------------------------------------------------------


def test_frames_byte_equal(sets):
    import torch

    _, extra, _ = sets
    for lsn, (op, arrays) in enumerate(_records(extra), 1):
        frame = wal_mod.encode_record(lsn, op, arrays)
        assert frame == jwal.encode_record(lsn, op, arrays)
        # a tensor payload frames to the same bytes as its numpy array
        tensors = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
        assert wal_mod.encode_record(lsn, op, tensors) == frame
        rec = wal_mod.decode_payload(frame[12:])
        assert (rec.lsn, rec.op) == (lsn, op)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_log_scans_both_ways(tmp_path, sets, writer):
    """A log written by one package (with a rotation and a group commit)
    scans to the same records in both."""
    _, extra, _ = sets
    cls = wal_mod.WalWriter if writer == "port" else jwal.WalWriter
    with cls(str(tmp_path / "wal"), fsync="batch", rotate_bytes=600) as w:
        for op, arrays in _records(extra):
            w.append(op, arrays)
        w.commit()
        assert w.stats()["segments"] > 1
    got, want = wal_mod.scan(str(tmp_path / "wal")), jwal.scan(str(tmp_path / "wal"))
    assert got.last_lsn == want.last_lsn == 4
    assert got.segments == want.segments and got.segment_last_lsns == want.segment_last_lsns
    for a, b in zip(got.records, want.records):
        assert (a.lsn, a.op) == (b.lsn, b.op) and a.arrays.keys() == b.arrays.keys()
        for k in a.arrays:
            np.testing.assert_array_equal(a.arrays[k], b.arrays[k])


@pytest.mark.parametrize("damage", ["torn", "bitflip"])
def test_torn_tail_and_bitflip(tmp_path, sets, damage):
    _, extra, _ = sets
    d = str(tmp_path / "wal")
    with wal_mod.WalWriter(d, fsync="none") as w:
        w.append("add", {"vectors": extra[:2]})
        w.append("delete", {"ids": np.array([1], np.int64)})
    seg = os.path.join(d, "wal-00000000.log")
    frame = wal_mod.encode_record(3, "add", {"vectors": extra[2:4]})
    if damage == "torn":
        tail = faults.torn_write(frame)
    else:
        faults.arm("wal/bitflip_frame", mode="raise")
        tail = wal_mod.encode_record(3, "add", {"vectors": extra[2:4]})
        assert tail != frame
    with open(seg, "ab") as f:
        f.write(tail)
    got, want = wal_mod.scan(d), jwal.scan(d)
    assert [r.lsn for r in got.records] == [r.lsn for r in want.records] == [1, 2]
    assert (got.truncated, got.dropped_frames) == (want.truncated, want.dropped_frames)
    assert got.truncated == (damage == "torn") and got.dropped_frames == (damage == "bitflip")
    # a writer reopening the log resumes after the valid prefix
    with wal_mod.WalWriter(d, fsync="none") as w:
        assert w.append("compact") == 3


# ---------------------------------------------------------------------------
# durable roots across the packages
# ---------------------------------------------------------------------------


def _rows(x, backend):
    """fp32 runs on integer rows (every distance an exact float32)."""
    return x if backend == "flash_blocked" else np.round(x * 2)


def _ref_index(base, backend):
    kw = FLASH_KW if backend == "flash_blocked" else {}
    return JIndex.build(jnp.asarray(_rows(base, backend)), algo="hnsw", backend=backend,
                        params=JParams(**PARAMS), backend_kwargs=kw, strategy="incremental")


@pytest.fixture(scope="module")
def fp32_port(sets):
    """The reference's fp32 build over integer rows, restored in the port."""
    meta, arrays = _ref_index(sets[0], "fp32").export_state()
    return AnnIndex.restore(meta, {k: np.asarray(v) for k, v in arrays.items()}, device="cpu")


@pytest.mark.parametrize("backend", ["flash_blocked", "fp32"])
def test_reference_root_recovers_bit_equal(tmp_path, sets, backend):
    base, extra, queries = sets
    extra = _rows(extra, backend)
    jidx = _ref_index(base, backend)
    root = jrecovery.init(str(tmp_path / "root"), jidx)
    handle, _, _ = jrecovery.attach(root, background=False, fsync="batch")
    handle.add(jnp.asarray(extra[:12]))
    handle.delete([2, 5, 40])
    handle.compact()
    handle.add(jnp.asarray(extra[12:20]))
    handle.wal.close()
    want = jrecovery.recover(root)
    got = recovery.recover(root, device="cpu")
    assert (got.replayed, got.last_lsn, got.checkpoint_lsn) == (want.replayed, want.last_lsn, 0) == (4, 4, 0)
    assert got.dropped_frames == want.dropped_frames == 0
    _assert_same_state(got.index, want.index)
    np.testing.assert_array_equal(got.index.search(queries, k=10, ef=32).ids.numpy(),
                                  np.asarray(want.index.search(jnp.asarray(queries), k=10, ef=32).ids))


def test_port_root_recovers_in_reference(tmp_path, sets, fp32_port):
    base, extra, _ = sets
    port = fp32_port
    root = recovery.init(str(tmp_path / "root"), port)
    handle, _, _ = recovery.attach(root, background=False, fsync="none", device="cpu")
    handle.add(np.round(extra[:6] * 2))
    handle.delete([0, 9])
    live = handle.current.index
    handle.wal.close()
    want = jrecovery.recover(root)
    assert want.replayed == 2
    _assert_same_state(live, want.index)


def test_checkpointer_verify_and_cli(tmp_path, sets, fp32_port, capsys):
    base, extra, _ = sets
    port = fp32_port
    root = recovery.init(str(tmp_path / "root"), port)
    with pytest.raises(FileExistsError):
        recovery.init(root, port)
    handle, ckpt, _ = recovery.attach(root, background=False, checkpoint_every=2, fsync="none",
                                      device="cpu")
    try:
        handle.add(extra[:2])
        handle.add(extra[2:4])  # crosses every_ops: an inline checkpoint
        assert ckpt.checkpoint_lsn == 2 and handle.wal.stats()["segments"] == 1
        handle.delete([1])
        assert ckpt.pending_ops == 1 and ckpt.stats()["checkpoints"] == 1
    finally:
        handle.wal.close()
    report = recovery.verify_root(root, device="cpu")
    assert report["ok"] and report["checkpoint_lsn"] == 2 and report["wal"]["replayable"] == 1
    assert report == jrecovery.verify_root(root) | {"root": report["root"]}
    assert recovery.main(["recover", root, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["replayed"] == 1 and out["checkpoint_lsn"] == 3
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.serve.recovery", "verify", root,
                           "--device", "cpu"], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["ok"] and report["wal"]["replayable"] == 0 and report["snapshot"]["n"] == N + 4


def test_background_checkpointer(tmp_path, sets, fp32_port):
    import time

    base, extra, _ = sets
    port = fp32_port
    root = recovery.init(str(tmp_path / "root"), port)
    handle, ckpt, _ = recovery.attach(root, background=True, checkpoint_every=2, fsync="none",
                                      device="cpu")
    try:
        handle.add(extra[:2])
        handle.add(extra[2:4])
        deadline = time.time() + 60
        while ckpt.checkpoint_lsn < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert ckpt.checkpoint_lsn == 2
    finally:
        ckpt.close()
        handle.wal.close()
    assert recovery.recover(root, device="cpu").replayed == 0


def test_segmented_root_replays_routed_add(tmp_path, sets):
    """``init_from_manifest`` over a segmented snapshot, one WAL ``add``,
    then ``recover``: the routed segments equal a live add of the same
    rows, and the reference's recovery of the same root."""
    base, extra, queries = sets
    jcoll = JSeg.build(jnp.asarray(base).reshape(2, N // 2, D), algo="hnsw", backend="flash_blocked",
                       params=JParams(**PARAMS), backend_kwargs=FLASH_KW, strategy="incremental")
    meta, arrays, segs = jcoll.export_state()
    coll = SegmentedAnnIndex.restore(
        meta, {k: np.asarray(v) for k, v in arrays.items()},
        [(m, {k: np.asarray(v) for k, v in a.items()}) for m, a in segs], device="cpu")
    manifest = snap.save_index(str(tmp_path / "manifest"), coll)
    root, adopted = recovery.init_from_manifest(str(tmp_path / "root"), manifest, device="cpu")
    assert isinstance(adopted, SegmentedAnnIndex) and adopted.n == N
    with wal_mod.WalWriter(recovery.wal_path(root), fsync="batch") as w:
        w.append("add", {"vectors": extra})
        w.commit()
    got = recovery.recover(root, device="cpu")
    assert got.replayed == 1 and isinstance(got.index, SegmentedAnnIndex)
    gids = coll.add(extra)
    np.testing.assert_array_equal(gids, N + np.arange(N_ADD))
    want = jrecovery.recover(root)
    for s in range(2):
        np.testing.assert_array_equal(got.index.global_ids(s), coll.global_ids(s))
        np.testing.assert_array_equal(got.index.global_ids(s), want.index.global_ids(s))
        _assert_same_state(got.index.segments[s], coll.segments[s])
        _assert_same_state(got.index.segments[s], want.index.segments[s])
    np.testing.assert_array_equal(got.index.search(queries, k=10, ef=32).ids.numpy(),
                                  coll.search(queries, k=10, ef=32).ids.numpy())
