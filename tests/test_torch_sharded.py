"""The port's scale-out layer (``graph/sharded.py``, ``graph/segmented.py``,
``rerank.merge_rerank_topk``) against the reference package's, on the CPU.

* The host-side pieces are bit-equal: ``reservoir_sample`` and
  ``_route_balanced``; ``stream_assign`` given the reference's centroids
  writes byte-equal spill files and an equal ``plan.json``, balanced and
  unbalanced (the port's float32 distances come from torch, the
  reference's from XLA; on this seeded set no row's two nearest centroids
  are within 1e-3 of each other, which the test measures, so no route can
  flip).
* ``bootstrap_centroids`` draws from a ``torch.Generator``, so it is held
  on quality: its k-means inertia on the sample is at most 5% above the
  reference's.
* A collection the reference built inline (3 segments) restores into the
  port and searches equal ids, fanned out and sequential; a routed ``add``
  gives equal global ids, locator and search ids.
* The port's own streaming build reaches a recall@10 within 0.03 of the
  reference's.
* The pool and ``snapshot_path=`` are held in
  ``tests/test_torch_snapshot.py``, the mesh mode in
  ``tests/test_torch_mesh.py``.
* The launch counters stay exact under ``fanout_map``'s eight threads.
"""

from __future__ import annotations

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.engine import BuildParams as JParams
from repro.graph.rerank import ExactReranker as JExact
from repro.graph.rerank import RawVectors as JRaw
from repro.graph.rerank import merge_rerank_topk as j_merge
from repro.graph.segmented import SegmentedAnnIndex as JSeg
from repro.graph.sharded import _route_balanced as j_route_balanced
from repro.graph.sharded import reservoir_sample as j_reservoir
from repro.graph.sharded import stream_assign as j_stream_assign
from repro_torch.graph import sharded as tsh
from repro_torch.graph.engine import BuildParams
from repro_torch.graph.rerank import ExactReranker, RawVectors, merge_rerank_topk
from repro_torch.index import SegmentedAnnIndex, ShardConfig, ShardedBuilder, exact_knn, recall_at_k
from repro_torch.kernels import ops

N, D, S = 1200, 32, 3
FLASH_KW = dict(d_f=32, m_f=16, l_f=4, h=8, kmeans_iters=8)
PARAMS = dict(r_upper=8, r_base=16, ef=32, batch=32, max_layers=2)


def clustered(n: int, d: int = D, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, d)).astype(np.float32) * 1.5
    x = centers[rng.integers(0, 8, n)]
    return (x + rng.normal(size=(n, d)).astype(np.float32) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return clustered(N)


@pytest.fixture(scope="module")
def queries():
    return clustered(24, seed=99)


@pytest.fixture(scope="module")
def ref_coll(data, tmp_path_factory):
    """The reference's inline streaming build (its one build in this file)."""
    wd = tmp_path_factory.mktemp("ref")
    return JSeg.build_streaming(
        data, n_segments=S, chunk_size=256, workdir=str(wd), backend="flash_blocked",
        params=JParams(**PARAMS), backend_kwargs=FLASH_KW, seed=0,
    )


def _port_of(jcoll) -> SegmentedAnnIndex:
    meta, arrays, segs = jcoll.export_state()
    segs = [(m, {k: np.asarray(v) for k, v in a.items()}) for m, a in segs]
    return SegmentedAnnIndex.restore(meta, {k: np.asarray(v) for k, v in arrays.items()},
                                     segs, device="cpu")


def _recall(ids: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1] for a, b in zip(ids, gt)]))


# ---------------------------------------------------------------------------
# host-side assignment pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,chunk", [(300, 128), (2000, 256)])
def test_reservoir_sample_bit_equal(data, size, chunk):
    got = tsh.reservoir_sample(data, size, seed=7, chunk_size=chunk)
    np.testing.assert_array_equal(got, j_reservoir(data, size, seed=7, chunk_size=chunk))


def test_route_balanced_bit_equal():
    rng = np.random.default_rng(4)
    d2 = rng.random((500, 6)).astype(np.float32)
    d2[:, 2] *= 0.1  # one popular segment that overflows
    rem_t = np.full(6, 90, np.int64)
    rem_j = rem_t.copy()
    np.testing.assert_array_equal(tsh._route_balanced(d2, rem_t), j_route_balanced(d2, rem_j))
    np.testing.assert_array_equal(rem_t, rem_j)


@pytest.mark.parametrize("balanced", [True, False])
def test_stream_assign_spill_files_byte_equal(data, tmp_path, balanced):
    cents = np.asarray(data[::97][:S] + 0.01, np.float32)
    d2 = ((data[:, None, :] - cents[None]) ** 2).sum(-1)
    two = np.sort(d2, 1)[:, :2]
    assert float((two[:, 1] - two[:, 0]).min()) > 1e-3  # no near tie to flip
    jp = j_stream_assign(data, cents, str(tmp_path / "j"), chunk_size=256, balanced=balanced)
    tp = tsh.stream_assign(data, cents, str(tmp_path / "t"), chunk_size=256,
                           balanced=balanced, device="cpu")
    assert tp.seg_sizes == jp.seg_sizes
    for name in sorted(os.listdir(tmp_path / "j")):
        a = (tmp_path / "j" / name).read_bytes()
        b = (tmp_path / "t" / name).read_bytes()
        if name == "plan.json":
            assert json.loads(a) == json.loads(b)
        else:
            assert a == b, name
    np.testing.assert_array_equal(tp.locate(), jp.locate())


def test_bootstrap_inertia_within_5_percent_of_reference(data):
    from repro.graph.sharded import bootstrap_centroids as j_boot

    sample = j_reservoir(data, 512, seed=0)

    def inertia(c):
        return float(((sample[:, None, :] - c[None]) ** 2).sum(-1).min(1).sum())

    jc = np.asarray(j_boot(data, 8, sample_size=512, seed=0))
    tc = tsh.bootstrap_centroids(data, 8, sample_size=512, seed=0, device="cpu")
    assert tc.shape == jc.shape == (8, D)
    assert inertia(tc) <= 1.05 * inertia(jc)


# ---------------------------------------------------------------------------
# the collection: restore, search, merge, add
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fanout", [None, True, False])
@pytest.mark.parametrize("width", [1, 4])
def test_restored_collection_searches_equal(ref_coll, queries, fanout, width):
    port = _port_of(ref_coll)
    want = ref_coll.search(jnp.asarray(queries), k=10, ef=48, width=width)
    got = port.search(queries, k=10, ef=48, width=width, fanout=fanout)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), rtol=1e-5, atol=1e-4)
    assert got.n_rerank == int(want.n_rerank) and got.n_scan == int(want.n_scan)
    assert port.n == N and port.n_active == N and len(port.segments) == S


def test_default_fanout_is_the_loop_on_one_device(ref_coll, queries, monkeypatch):
    """Every segment on one device: the default search takes the loop."""
    seen = []
    real = tsh.fanout_map

    def spy(fn, items, *, parallel=True):
        seen.append(parallel)
        return real(fn, items, parallel=parallel)

    monkeypatch.setattr(tsh, "fanout_map", spy)
    port = _port_of(ref_coll)
    port.search(queries[:8], k=10, ef=48)
    port.search(queries[:8], k=10, ef=48, fanout=True)
    assert seen == [False, True]


def test_merge_rerank_topk_equal_with_duplicate_ids():
    rng = np.random.default_rng(8)
    vecs = rng.normal(size=(60, 8)).astype(np.float32)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    cand = rng.integers(-1, 40, (5, 48)).astype(np.int32)  # many repeats and −1
    cand_d = rng.random((5, 48)).astype(np.float32)
    for rr in (True, False):
        t_rr = ExactReranker(RawVectors(torch.from_numpy(vecs))) if rr else None
        j_rr = JExact(JRaw(jnp.asarray(vecs))) if rr else None
        ids, d, n = merge_rerank_topk(t_rr, torch.from_numpy(q), torch.from_numpy(cand),
                                      torch.from_numpy(cand_d), 10)
        jids, jd, jn = j_merge(j_rr, jnp.asarray(q), jnp.asarray(cand), jnp.asarray(cand_d), 10)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
        assert n == int(jn)
        for row in ids.numpy():
            live = row[row >= 0]
            assert live.size == np.unique(live).size  # every id once


def test_routed_add_equal_routing_locate_and_search(ref_coll, queries):
    new = clustered(40, seed=5)
    port = _port_of(ref_coll)
    jcoll = JSeg.restore(*ref_coll.export_state())
    g_t = port.add(new)
    g_j = jcoll.add(jnp.asarray(new))
    np.testing.assert_array_equal(g_t, np.asarray(g_j))
    np.testing.assert_array_equal(port._locate, jcoll._locate)
    for s in range(S):
        np.testing.assert_array_equal(port.global_ids(s), jcoll.global_ids(s))
    got = port.search(queries, k=10, ef=48, width=4)
    want = jcoll.search(jnp.asarray(queries), k=10, ef=48, width=4)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(port.raw_vectors.numpy(), np.asarray(jcoll.raw_vectors))
    # deletes map global ids to their segments: none comes back
    dead = np.arange(0, N + 40, 7)
    assert port.delete(dead) == jcoll.delete(dead)
    port.compact()
    res = port.search(queries, k=10, ef=48, width=4)
    assert not np.isin(res.ids.numpy(), dead).any()
    assert port.n_active == N + 40 - dead.size


def test_own_streaming_build_recall_within_003(ref_coll, data, queries, tmp_path):
    d2 = ((queries[:, None, :] - data[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1, kind="stable")[:, :10]
    port = SegmentedAnnIndex.build_streaming(
        data, n_segments=S, chunk_size=256, workdir=str(tmp_path), backend="flash_blocked",
        params=BuildParams(**PARAMS), backend_kwargs=FLASH_KW, seed=0, device="cpu",
    )
    assert sum(s.n for s in port.segments) == N
    for ef in (32, 64):
        r_ref = _recall(np.asarray(ref_coll.search(jnp.asarray(queries), k=10, ef=ef).ids), gt)
        r_port = _recall(port.search(queries, k=10, ef=ef).ids.numpy(), gt)
        assert r_port >= r_ref - 0.03, f"ef={ef}: port {r_port:.4f} vs reference {r_ref:.4f}"
    ids, _ = exact_knn(torch.from_numpy(queries), torch.from_numpy(data), k=10)
    assert recall_at_k(ids, gt, 10) == 1.0


def test_build_from_slices_keeps_stream_order_ids(data, queries):
    """``SegmentedAnnIndex.build`` over pre-sliced segments: contiguous
    global ids, the segments' means as the routing table, and a fan-out
    search equal to a plain merge of the segments' own scans (local ids
    mapped to global ones, exact distances in numpy, top 10)."""
    slices = [data[:500], data[500:900], data[900:]]
    coll = SegmentedAnnIndex.build(slices, backend="flash_blocked", params=BuildParams(**PARAMS),
                                   backend_kwargs=FLASH_KW, seed=0, device="cpu")
    assert [s.n for s in coll.segments] == [500, 400, 300] and coll.n == N
    np.testing.assert_array_equal(coll.global_ids(1), np.arange(500, 900))
    means = np.stack([sl.mean(0) for sl in slices])
    np.testing.assert_allclose(coll.centroids.numpy(), means, rtol=1e-5, atol=1e-5)
    assert coll.health()["healthy"] and coll.health()["n_segments"] == S
    res = coll.search(queries, k=10, ef=64)
    cands = np.concatenate([
        coll.global_ids(s)[seg.search(queries, k=64, ef=64, rerank=False).ids.numpy()]
        for s, seg in enumerate(coll.segments)
    ], 1)
    exact = ((data[cands] - queries[:, None, :]) ** 2).sum(-1)
    want = np.take_along_axis(cands, np.argsort(exact, 1, kind="stable")[:, :10], 1)
    np.testing.assert_array_equal(res.ids.numpy(), want)


def test_builder_reports_assignment_and_segment_metrics(data, tmp_path):
    cfg = ShardConfig(n_segments=S, chunk_size=256, backend="flash_blocked",
                      params=BuildParams(**PARAMS), backend_kwargs=FLASH_KW, sample_size=512)
    builder = ShardedBuilder(cfg, workdir=str(tmp_path), device="cpu")
    res = builder.build(data)
    assert res.mode == "inline" and res.n_workers == 1
    assert set(builder.assign_seconds) == {"bootstrap", "stream"}
    assert [m["seg"] for m in res.segments] == list(range(S))
    assert sum(m["n_vectors"] for m in res.segments) == N
    assert all(m["wall_s"] > 0 and m["n_dists"] > 0 and "bulk" in m["phases"] for m in res.segments)


def test_one_shot_iterator_rejected(data, tmp_path):
    cfg = ShardConfig(n_segments=S, chunk_size=256)
    with pytest.raises(TypeError, match="re-creates"):
        ShardedBuilder(cfg, workdir=str(tmp_path), device="cpu").assign(iter([data]))


def test_launch_counters_exact_under_fanout_threads():
    """Eight fan-out threads counting at once give the sequential total."""

    def work(_):
        for _ in range(3000):
            ops.count_launch("l2_batch")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: races would show
    try:
        ops.reset_launches()
        for i in range(8):
            work(i)
        sequential = ops.launches["l2_batch"]
        ops.reset_launches()
        tsh.fanout_map(work, range(8))
        assert ops.launches["l2_batch"] == sequential == 8 * 3000
    finally:
        sys.setswitchinterval(old)
        ops.reset_launches()
