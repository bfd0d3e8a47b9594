"""The port's snapshot file I/O (``repro_torch.serve.snapshot``) and the
sharded builder's publish / attach / process pool, on the CPU.

* Port save → port load searches identically (ids and distances), also
  after ``add`` / ``delete``, for a single index and a segmented one.
* The files are the reference's format: a port snapshot loads in
  ``repro.serve.snapshot.load_index`` and a reference snapshot in the
  port's, with equal search ids; the same state saved by both packages
  gives equal manifests (names, shapes, dtypes, CRCs).
* Damage fails loudly: a CRC mismatch, a flipped bit, a torn manifest or
  array file, a future format. A crash between the two renames of an
  overwrite recovers ``<path>.old``; a crash before publishing keeps the
  last good snapshot; a corrupt segment quarantines under
  ``quarantine=True``.
* ``ShardedBuilder`` with ``snapshot_path=`` (inline) and with
  ``workers=2`` (a spawn pool) gives segments bit-equal to the inline build
  of the same plan; ``model_parallel_wall`` equals the reference's.
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest

from repro.graph.engine import BuildParams as JParams
from repro.graph.index import AnnIndex as JIndex
from repro.graph.sharded import model_parallel_wall as j_model_parallel_wall
from repro.serve import snapshot as jsnap
from repro_torch.graph.engine import BuildParams
from repro_torch.graph.sharded import model_parallel_wall
from repro_torch.index import AnnIndex, SegmentedAnnIndex, ShardConfig, ShardedBuilder
from repro_torch.serve import snapshot as snap
from repro_torch.testing import faults
from conftest import make_clustered

N, D = 900, 32
FLASH_KW = dict(d_f=32, m_f=16, l_f=4, h=8, kmeans_iters=8)
PARAMS = dict(r_upper=8, r_base=16, ef=32, batch=16, max_layers=2)


@pytest.fixture(scope="module")
def sets():
    x = make_clustered(N + 100 + 40, D, seed=5)
    return x[:N], x[N:N + 100], x[N + 100:]  # base, extra rows, queries


@pytest.fixture(scope="module")
def port_index(sets):
    base, _, _ = sets
    return AnnIndex.build(base, params=BuildParams(**PARAMS), backend_kwargs=FLASH_KW, device="cpu")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()


def _same_search(a, b, queries, *, exact: bool = True):
    ra, rb = a.search(queries, k=10, ef=32), b.search(queries, k=10, ef=32)
    np.testing.assert_array_equal(np.asarray(ra.ids), np.asarray(rb.ids))
    if exact:
        np.testing.assert_array_equal(np.asarray(ra.dists), np.asarray(rb.dists))


def _flip_file(path: str) -> None:
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(faults.bit_flip(raw))


@pytest.mark.parametrize("after_maintenance", [False, True])
def test_port_round_trip_is_exact(sets, port_index, tmp_path, after_maintenance):
    _, extra, queries = sets
    idx = port_index.clone()
    if after_maintenance:
        idx.add(extra)
        idx.delete([1, 5, 9, 950])
    loaded = snap.load_index(snap.save_index(str(tmp_path / "snap"), idx), device="cpu")
    assert isinstance(loaded, AnnIndex) and loaded.device.type == "cpu"
    assert (loaded.n, loaded.n_active, loaded.build_strategy) == (idx.n, idx.n_active, idx.build_strategy)
    np.testing.assert_array_equal(loaded.deleted_ids, idx.deleted_ids)
    _same_search(idx, loaded, queries)
    # the loaded copy is live: the same maintenance keeps both in step
    idx.delete([2])
    loaded.delete([2])
    idx.compact()
    loaded.compact()
    _same_search(idx, loaded, queries)


def test_segmented_round_trip_is_exact(sets, tmp_path):
    base, extra, queries = sets
    coll = SegmentedAnnIndex.build(base.reshape(3, N // 3, D), params=BuildParams(**PARAMS),
                                   backend_kwargs=FLASH_KW, device="cpu")
    gids = coll.add(extra[:20])
    coll.delete(gids[:3])
    path = snap.save_index(str(tmp_path / "seg"), coll, sidecar={"lsn": 7})
    loaded = snap.load_index(path, device="cpu")
    assert isinstance(loaded, SegmentedAnnIndex)
    assert (loaded.n, loaded.n_active) == (coll.n, coll.n_active)
    for s in range(3):
        np.testing.assert_array_equal(loaded.global_ids(s), coll.global_ids(s))
    _same_search(coll, loaded, queries)
    assert snap.load_sidecar(path) == {"lsn": 7}
    assert snap.snapshot_bytes(path) == sum(
        os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs
    ) > 0
    # and the reference reads the port's segmented snapshot
    ref = jsnap.load_index(path)
    np.testing.assert_array_equal(
        np.asarray(ref.search(jnp.asarray(queries), k=10, ef=32).ids),
        coll.search(queries, k=10, ef=32).ids.numpy(),
    )


def test_port_snapshot_loads_in_the_reference(sets, port_index, tmp_path):
    _, _, queries = sets
    path = snap.save_index(str(tmp_path / "snap"), port_index)
    ref = jsnap.load_index(path)
    assert ref.n == port_index.n and ref.backend_kind == "flash_blocked"
    np.testing.assert_array_equal(np.asarray(ref.search(jnp.asarray(queries), k=10, ef=32).ids),
                                  port_index.search(queries, k=10, ef=32).ids.numpy())


def test_reference_snapshot_loads_in_the_port(sets, tmp_path):
    base, _, queries = sets
    jidx = JIndex.build(jnp.asarray(base), algo="hnsw", backend="flash_blocked", params=JParams(**PARAMS),
                        backend_kwargs=FLASH_KW, strategy="bulk")
    jpath = jsnap.save_index(str(tmp_path / "ref"), jidx)
    port = snap.load_index(jpath, device="cpu")
    np.testing.assert_array_equal(port.search(queries, k=10, ef=32).ids.numpy(),
                                  np.asarray(jidx.search(jnp.asarray(queries), k=10, ef=32).ids))
    # the same state written back by the port: the reference's manifest
    ppath = snap.save_index(str(tmp_path / "port"), port)
    manifests = []
    for p in (jpath, ppath):
        with open(os.path.join(p, "manifest.json")) as f:
            manifests.append(json.load(f))
    assert manifests[0]["arrays"] == manifests[1]["arrays"]
    assert manifests[0]["format_version"] == manifests[1]["format_version"] == snap.FORMAT_VERSION


def test_version_and_checksum_guards(port_index, tmp_path):
    path = snap.save_index(str(tmp_path / "snap"), port_index)
    with pytest.raises(FileExistsError):
        snap.save_index(path, port_index, overwrite=False)
    with pytest.raises(FileNotFoundError):
        snap.load_index(str(tmp_path / "nope"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        snap.load_index(path)  # the default device is the card
    manifest_path = os.path.join(path, "manifest.json")
    with open(manifest_path) as f:
        manifest = json.load(f)
    with open(manifest_path, "w") as f:
        json.dump(dict(manifest, format_version=snap.FORMAT_VERSION + 1), f)
    with pytest.raises(ValueError, match="format_version"):
        snap.load_index(path, device="cpu")
    key = next(iter(manifest["arrays"]))
    manifest["arrays"][key]["crc"] ^= 0xDEADBEEF
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(IOError, match="checksum"):
        snap.load_index(path, device="cpu")
    assert snap.load_index(path, verify=False, device="cpu").n == port_index.n


def test_bit_flip_names_the_array_and_the_path(port_index, tmp_path):
    path = snap.save_index(str(tmp_path / "snap"), port_index)
    npz = os.path.join(path, "arrays.npz")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(npz) as d:
        stored = {k: d[k] for k in d.files}
    key = max(stored, key=lambda k: stored[k].size)
    stored[key] = faults.bit_flip(stored[key])
    np.savez(npz, **stored)
    with pytest.raises(IOError, match="checksum mismatch") as ei:
        snap.load_index(path, device="cpu")
    assert repr(manifest["arrays"][key]["name"]) in str(ei.value) and path in str(ei.value)


@pytest.mark.parametrize("which", ["manifest.json", "arrays.npz"])
def test_torn_write_fails_loudly(port_index, tmp_path, which):
    path = snap.save_index(str(tmp_path / "snap"), port_index)
    target = os.path.join(path, which)
    raw = open(target, "rb").read()
    with open(target, "wb") as f:
        f.write(faults.torn_write(raw))
    with pytest.raises((OSError, ValueError, zipfile.BadZipFile)):
        snap.load_index(path, device="cpu")


def test_injected_bitrot_fails_verification(port_index, tmp_path):
    faults.arm("snapshot/bitflip_array")
    path = snap.save_index(str(tmp_path / "rot"), port_index)
    with pytest.raises(IOError, match="checksum mismatch"):
        snap.load_index(path, device="cpu")


def test_crash_between_renames_recovers_old(sets, port_index, tmp_path):
    _, _, queries = sets
    path = snap.save_index(str(tmp_path / "snap"), port_index)
    want = port_index.search(queries, k=10, ef=32).ids.numpy()
    newer = port_index.clone()
    newer.delete([0, 1])
    faults.arm("snapshot/between_renames")
    with pytest.raises(faults.FaultInjected):
        snap.save_index(path, newer)
    assert not os.path.isdir(path) and os.path.isdir(path + ".old")
    assert snap.load_sidecar(path) is None
    back = snap.load_index(path, device="cpu")
    np.testing.assert_array_equal(back.search(queries, k=10, ef=32).ids.numpy(), want)
    assert os.path.isdir(path) and not os.path.isdir(path + ".old")  # healed


def test_crash_before_publish_keeps_last_good(port_index, tmp_path):
    path = snap.save_index(str(tmp_path / "snap"), port_index)
    newer = port_index.clone()
    newer.delete([2])
    faults.arm("snapshot/after_tmp_write")
    with pytest.raises(faults.FaultInjected):
        snap.save_index(path, newer)
    assert snap.load_index(path, device="cpu").n_active == port_index.n_active
    assert snap.load_index(snap.save_index(path, newer), device="cpu").n_active == newer.n_active


def test_corrupt_segment_quarantines(sets, tmp_path):
    base, extra, queries = sets
    coll = SegmentedAnnIndex.build(base.reshape(3, N // 3, D), params=BuildParams(**PARAMS),
                                   backend_kwargs=FLASH_KW, device="cpu")
    path = snap.save_index(str(tmp_path / "seg"), coll)
    _flip_file(os.path.join(snap.segment_dir(path, 1), "arrays.npz"))
    with pytest.raises((OSError, ValueError, KeyError, zipfile.BadZipFile)):
        snap.load_index(path, device="cpu")
    before = snap.counters["snapshot_quarantined_segments_total"]
    deg = snap.load_index(path, quarantine=True, device="cpu")
    assert snap.counters["snapshot_quarantined_segments_total"] == before + 1
    h = deg.health()
    assert h["degraded"] and h["quarantined"] == [1] and h["lost_ids"] == N // 3
    lost = set(coll.global_ids(1).tolist())
    assert not set(deg.search(queries, k=10, ef=32).ids.numpy().ravel().tolist()) & lost
    assert len(deg.add(extra[:2])) == 2  # adds route to healthy segments
    with pytest.raises(RuntimeError, match="quarantin"):
        snap.save_index(str(tmp_path / "seg2"), deg)
    for s in (0, 2):
        _flip_file(os.path.join(snap.segment_dir(path, s), "arrays.npz"))
    with pytest.raises(IOError, match="all 3 segments"):
        snap.load_index(path, quarantine=True, device="cpu")


@pytest.fixture(scope="module")
def inline_build(sets, tmp_path_factory):
    """The inline sharded build (no snapshot) and its plan."""
    base, _, _ = sets
    cfg = ShardConfig(n_segments=3, chunk_size=256, params=BuildParams(**PARAMS),
                      backend_kwargs=FLASH_KW, sample_size=512)
    res = ShardedBuilder(cfg, workdir=str(tmp_path_factory.mktemp("inline")), device="cpu").build(base)
    return cfg, res


def _assert_same_segments(got, want):
    assert got.n == want.n
    np.testing.assert_array_equal(got._locate, want._locate)
    for a, b in zip(got.segments, want.segments):
        np.testing.assert_array_equal(a.graph.adj0.numpy(), b.graph.adj0.numpy())
        np.testing.assert_array_equal(a.graph.adj_up.numpy(), b.graph.adj_up.numpy())
        np.testing.assert_array_equal(a.backend.nbr_codes.numpy(), b.backend.nbr_codes.numpy())


@pytest.mark.parametrize("workers", [None, 2])
def test_sharded_publish_and_pool_equal_the_inline_build(sets, inline_build, tmp_path, workers):
    _, _, queries = sets
    cfg, inline = inline_build
    builder = ShardedBuilder(cfg, workers=workers, workdir=str(tmp_path), device="cpu")
    target = str(tmp_path / "published")
    res = builder.build(plan=inline.plan, snapshot_path=target)
    assert res.mode == ("pool" if workers else "inline") and res.n_workers == (workers or 1)
    assert res.snapshot_path == target and os.path.isdir(target)
    assert [m["snapshot"] for m in res.segments] == [snap.segment_dir(target + ".tmp", s) for s in range(3)]
    if workers:
        assert all(m["pid"] != os.getpid() for m in res.segments)
    _assert_same_segments(res.index, inline.index)
    _same_search(res.index, inline.index, queries)
    # attach=False only publishes
    again = builder.build(plan=inline.plan, snapshot_path=target, attach=False)
    assert again.index is None
    _assert_same_segments(snap.load_index(target, device="cpu"), inline.index)


def test_pool_defaults_to_a_snapshot_under_the_workdir(inline_build, tmp_path):
    cfg, inline = inline_build
    res = ShardedBuilder(cfg, workers=2, workdir=str(tmp_path), device="cpu").build(plan=inline.plan)
    assert res.snapshot_path == os.path.join(str(tmp_path), "index")
    _assert_same_segments(res.index, inline.index)


def test_pool_worker_error_reaches_the_caller(inline_build, tmp_path):
    cfg, inline = inline_build
    plan = inline.plan
    bad = ShardConfig(**{**cfg.__dict__, "algo_kwargs": {"knn_k": 8}})  # an option hnsw does not take
    with pytest.raises(TypeError, match="knn_k"):
        ShardedBuilder(bad, workers=2, workdir=str(tmp_path), device="cpu").build(plan=plan)
    shutil.rmtree(str(tmp_path / "index.tmp"), ignore_errors=True)


@pytest.mark.parametrize("walls,workers", [([3.0, 1.0, 2.0, 2.0, 5.0], 2), ([1.5] * 7, 3), ([4.0, 0.5], 8),
                                           ([], 2)])
def test_model_parallel_wall_equals_the_reference(walls, workers):
    assert model_parallel_wall(walls, workers) == j_model_parallel_wall(walls, workers)
