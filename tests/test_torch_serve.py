"""The port's ``SearchEngine``, ``AdmissionController`` and ``SegmentRouter``
against the reference's (``repro.serve``), on the CPU.

Indexes come from the reference: built with JAX, then carried across
through ``export_state`` → ``repro_torch`` ``restore(device="cpu")``. Both
engines then serve the same query blocks: ids must be equal, exact-rerank
distances within rtol 1e-5, and the counts equal once the port's ints are
rounded to the reference's float32. The port counts a "compile" at the
first dispatch of a (bucket, spec, n) key, the reference at each XLA trace;
over one sequence (warmup, mixed block sizes, a spec override, an ``add``
that grows ``n``, ``warm_view``) the two counts must agree step by step.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.graph.engine import BuildParams as JParams
from repro.graph.index import AnnIndex as JIndex
from repro.graph.segmented import SegmentedAnnIndex as JSeg
from repro.serve.admission import AdmissionConfig as JAdmCfg
from repro.serve.admission import AdmissionController as JAdm
from repro.serve.handle import Generation as JGeneration
from repro_torch import serve
from repro_torch.graph.rerank import SearchSpec
from repro_torch.index import AnnIndex, SegmentedAnnIndex
from repro_torch.serve.admission import AdmissionConfig, AdmissionController
from repro_torch.serve.handle import Generation
from conftest import make_clustered

PARAMS = dict(r_upper=8, r_base=16, ef=32, batch=16, max_layers=3)
FLASH_KW = dict(d_f=16, m_f=8, l_f=4, h=8, kmeans_iters=6)
N, N_ADD, D = 900, 60, 16
BLOCKS = (1, 3, 8, 17, 32, 45)  # 45 > the top bucket: chunked 32 + 13


@pytest.fixture(scope="module")
def sets():
    x = make_clustered(N + N_ADD + 96, D, n_clusters=16, seed=5)
    return x[:N], x[N:N + N_ADD], x[N + N_ADD:]


def _port_of(jidx) -> AnnIndex:
    meta, arrays = jidx.export_state()
    return AnnIndex.restore(meta, {k: np.asarray(v) for k, v in arrays.items()}, device="cpu")


def _seg_port_of(jcoll) -> SegmentedAnnIndex:
    meta, arrays, segs = jcoll.export_state()
    segs = [(m, {k: np.asarray(v) for k, v in a.items()}) for m, a in segs]
    return SegmentedAnnIndex.restore(meta, {k: np.asarray(v) for k, v in arrays.items()},
                                     segs, device="cpu")


@pytest.fixture(scope="module", params=["flash_blocked", "flash"])
def pair(request, sets):
    """(reference index, port index) over one build."""
    base, _, _ = sets
    jidx = JIndex.build(jnp.asarray(base), algo="hnsw", backend=request.param,
                        params=JParams(**PARAMS), backend_kwargs=FLASH_KW, strategy="incremental")
    return jidx, _port_of(jidx)


def _same(got, want):
    """Port result vs the reference's: ids equal, dists rtol 1e-5, counts
    equal in float32."""
    gi, wi = got.ids.numpy(), np.asarray(want.ids)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), rtol=1e-5, atol=1e-4)
    for f in ("n_dists", "n_scan", "n_rerank"):
        assert np.float32(getattr(got, f)) == np.float32(getattr(want, f)), f


def test_engine_blocks_equal_reference(pair, sets):
    """Every block size, chunking above the top bucket included, returns
    the reference engine's ids, distances and counts, and the port
    facade's ids."""
    jidx, port = pair
    _, _, queries = sets
    jeng = jserve.SearchEngine(jidx, k=10, ef=32).warmup()
    peng = serve.SearchEngine(port, k=10, ef=32).warmup()
    off = 0
    for b in BLOCKS:
        q = queries[off:off + b]
        off += b
        got, want = peng.search(q), jeng.search(jnp.asarray(q))
        _same(got, want)
        np.testing.assert_array_equal(got.ids.numpy(), port.search(q, k=10, ef=32).ids.numpy())
    single = peng.search(queries[0])
    assert tuple(single.ids.shape) == (10,)
    _same(single, jeng.search(jnp.asarray(queries[0])))
    ps, js = peng.stats(), jeng.stats()
    for key in ("calls", "blocks", "queries", "padded_queries", "compiles", "cache_hits",
                "bucket_hits"):
        assert ps[key] == js[key], key
    assert np.float32(ps["n_dists_per_query"]) == np.float32(js["n_dists_per_query"])
    assert ps["qps"] > 0 and ps["p99_ms"] >= ps["p50_ms"]


def _fresh(pair):
    """Independent copies of a pair's index on both sides (no rebuild)."""
    jidx, port = pair
    return JIndex.restore(*jidx.export_state()), port.clone()


@pytest.mark.parametrize("pair", ["flash_blocked"], indirect=True)
def test_compile_count_sequence_equals_reference(pair, sets):
    """The port's first-dispatch count follows the reference's trace count
    over warmup, mixed sizes, a spec override, a growing ``add`` and
    ``warm_view`` of a grown generation."""
    _, extra, queries = sets
    jidx, port = _fresh(pair)
    premium = dict(k=10, ef=32, rerank="exact", rerank_mult=2)
    jeng = jserve.SearchEngine(jidx, k=10, ef=32, q_buckets=(8, 32))
    peng = serve.SearchEngine(port, k=10, ef=32, q_buckets=(8, 32))
    seq = []

    def step(name, fj, fp):
        fj(jeng)
        fp(peng)
        seq.append((name, jeng.n_compiles, peng.n_compiles))

    step("construct", lambda e: None, lambda e: None)
    step("warmup", lambda e: e.warmup(), lambda e: e.warmup())
    for b in BLOCKS:
        q = queries[:b]
        step(f"q{b}", lambda e, q=q: e.search(jnp.asarray(q)), lambda e, q=q: e.search(q))
    step("override", lambda e: e.search(jnp.asarray(queries[:5]), spec=jserve.SearchSpec(**premium)),
         lambda e: e.search(queries[:5], spec=SearchSpec(**premium)))
    step("override_again", lambda e: e.search(jnp.asarray(queries[:7]), spec=jserve.SearchSpec(**premium)),
         lambda e: e.search(queries[:7], spec=SearchSpec(**premium)))
    jview, pview = JGeneration(1, JIndex.restore(*jidx.export_state())), Generation(1, port.clone())
    jidx.add(jnp.asarray(extra[:20]))
    port.add(extra[:20])
    step("grown_q3", lambda e: e.search(jnp.asarray(queries[:3])), lambda e: e.search(queries[:3]))
    step("grown_q40", lambda e: e.search(jnp.asarray(queries[:40])), lambda e: e.search(queries[:40]))
    # a view at the pre-add n: only the override's bucket 32 is cold there
    step("warm_view", lambda e: e.warm_view(jview, specs=(jserve.SearchSpec(**premium),)),
         lambda e: e.warm_view(pview, specs=(SearchSpec(**premium),)))
    step("warm_view_again", lambda e: e.warm_view(jview), lambda e: e.warm_view(pview))
    assert [s[1] for s in seq] == [s[2] for s in seq], seq
    assert seq[-1][1] > seq[1][1]  # the sequence did grow the key table
    # the pinned view serves through its warm keys with the reference's ids
    _same(peng.search(queries[:20], view=pview), jeng.search(jnp.asarray(queries[:20]), view=jview))
    assert jeng.n_compiles == peng.n_compiles == seq[-1][1]


@pytest.mark.parametrize("pair", ["flash_blocked"], indirect=True)
def test_engine_tombstones_before_and_after_refresh(pair, sets):
    """With tombstones the engine's ids equal the facade's and the
    reference's, before ``refresh`` (the stale mask) and after; an ``add``
    after a delete resyncs the mask without a refresh."""
    _, extra, queries = sets
    jidx, port = _fresh(pair)
    jeng = jserve.SearchEngine(jidx, k=10, ef=32, q_buckets=(8, 32)).warmup()
    peng = serve.SearchEngine(port, k=10, ef=32, q_buckets=(8, 32)).warmup()
    victims = np.unique(port.search(queries, k=2, ef=32).ids.numpy().ravel())
    jidx.delete(victims)
    port.delete(victims)
    # before refresh: the mask is the construction-time one (no tombstones)
    _same(peng.search(queries[:20]), jeng.search(jnp.asarray(queries[:20])))
    jeng.refresh()
    peng.refresh()
    got = peng.search(queries[:20])
    _same(got, jeng.search(jnp.asarray(queries[:20])))
    assert not np.isin(got.ids.numpy(), victims).any()
    np.testing.assert_array_equal(got.ids.numpy(), port.search(queries[:20], k=10, ef=32).ids.numpy())
    jidx.add(jnp.asarray(extra[:8]))
    port.add(extra[:8])
    got = peng.search(extra[:8])  # no refresh: the engine resyncs itself
    _same(got, jeng.search(jnp.asarray(extra[:8])))
    assert (got.ids.numpy()[:, 0] >= N).any()
    assert not np.isin(got.ids.numpy(), victims).any()


@pytest.mark.parametrize("spec", [dict(k=10, ef=32, rerank="exact", rerank_mult=2),
                                  dict(k=5, ef=24, rerank="none"),
                                  dict(k=10, ef=48, width=4, rerank="exact")],
                         ids=["mult2", "none", "w4"])
def test_engine_spec_override_equals_reference(pair, sets, spec):
    jidx, port = pair
    _, _, queries = sets
    jeng = jserve.SearchEngine(jidx, k=10, ef=32, q_buckets=(8,))
    peng = serve.SearchEngine(port, k=10, ef=32, q_buckets=(8,))
    got = peng.search(queries[:13], spec=SearchSpec(**spec))
    _same(got, jeng.search(jnp.asarray(queries[:13]), spec=jserve.SearchSpec(**spec)))
    np.testing.assert_array_equal(
        got.ids.numpy(), port.search(queries[:13], spec=SearchSpec(**spec)).ids.numpy())
    assert peng.n_compiles == jeng.n_compiles == 1


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def _drive_admission(adm, qfe):
    out = []
    for depth in (0, 1, 2, 3, 4):
        try:
            adm.admit(depth)
            out.append("ok")
        except qfe:
            out.append("full")
    adm.shed(2)
    for i in range(5):
        adm.record_served(0.001 * i, 0.002 * (5 - i), missed=i % 2 == 1)
    return out, adm.stats()


def test_admission_equals_reference():
    got = _drive_admission(AdmissionController(AdmissionConfig(max_queue=3)), serve.QueueFullError)
    want = _drive_admission(JAdm(JAdmCfg(max_queue=3)), jserve.QueueFullError)
    assert got == want
    cfg, jcfg = AdmissionConfig(default_deadline_ms=50.0), JAdmCfg(default_deadline_ms=50.0)
    a, j = AdmissionController(cfg), JAdm(jcfg)
    assert a.deadline_for(None, now=10.0) == j.deadline_for(None, now=10.0) == 10.05
    assert a.deadline_for(5.0, now=1.0) == j.deadline_for(5.0, now=1.0)
    assert AdmissionController().deadline_for(None) is None
    for bad in (dict(max_queue=-1), dict(default_deadline_ms=-1.0)):
        with pytest.raises(ValueError):
            AdmissionConfig(**bad)
    with pytest.raises(ValueError):
        a.deadline_for(-1.0)
    assert a.reset().stats() == j.reset().stats()


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def seg_pair(sets):
    base, _, _ = sets
    jcoll = JSeg.build(jnp.asarray(base).reshape(3, N // 3, D), algo="hnsw", backend="flash_blocked",
                       params=JParams(**PARAMS), backend_kwargs=FLASH_KW, strategy="incremental")
    return jcoll, _seg_port_of(jcoll)


@pytest.mark.parametrize("n_probe", [1, 3])
def test_router_equals_reference(seg_pair, sets, n_probe):
    """Probe sets, ids, distances and counts equal the reference router's;
    the full probe equals the segmented search, and the fan-out threads
    the loop."""
    jcoll, coll = seg_pair
    _, _, queries = sets
    jr = jserve.SegmentRouter(jcoll, n_probe=n_probe, k=10, ef=32, q_buckets=(32,)).warmup()
    pr = serve.SegmentRouter(coll, n_probe=n_probe, k=10, ef=32, q_buckets=(32,)).warmup()
    np.testing.assert_array_equal(pr.route(queries), jr.route(queries))
    got, want = pr.search(queries), jr.search(queries)
    _same(got, want)
    loop = serve.SegmentRouter(coll, n_probe=n_probe, k=10, ef=32, q_buckets=(32,),
                               fanout=False).search(queries)
    assert torch.equal(loop.ids, got.ids)
    if n_probe == 3:
        np.testing.assert_array_equal(got.ids.numpy(), coll.search(queries, k=10, ef=32).ids.numpy())
    ps, js = pr.stats(), jr.stats()
    assert (ps["compiles"], ps["queries"]) == (js["compiles"], js["queries"])
    single = pr.search(queries[0])
    assert tuple(single.ids.shape) == (10,)
    with pytest.raises(ValueError, match="exceeds"):
        pr.search(queries[:2], k=11)
    with pytest.raises(ValueError, match="n_probe"):
        serve.SegmentRouter(coll, n_probe=4)


def _replicated(coll_cls, seg_state):
    """A two-segment collection whose segments are one segment's replicas:
    the same vectors under the same global ids (restored, not built)."""
    meta, arrays = seg_state
    n0 = int(np.asarray(arrays["data"]).shape[0])
    cent = np.asarray(arrays["data"], np.float32).mean(0)
    gids = np.arange(n0, dtype=np.int64)
    coord = {"centroids": np.stack([cent, cent]), "locate": np.stack([np.zeros(n0, np.int64), gids], 1),
             "global_of.0": gids, "global_of.1": gids}
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    if coll_cls is JSeg:
        return JSeg.restore({"n_segments": 2}, coord, [(meta, arrays)] * 2)
    return SegmentedAnnIndex.restore({"n_segments": 2}, coord, [(meta, arrays)] * 2, device="cpu")


def test_router_same_global_id_scored_once(seg_pair, sets):
    """Two replicas of one segment with the same global ids: the merge
    returns each id at most once, as the reference's does."""
    jcoll, _ = seg_pair
    _, _, queries = sets
    seg0 = jcoll.export_state()[2][0]
    coll, jrep = _replicated(SegmentedAnnIndex, seg0), _replicated(JSeg, seg0)
    got = serve.SegmentRouter(coll, n_probe=2, k=10, ef=32, q_buckets=(32,)).search(queries)
    want = jserve.SegmentRouter(jrep, n_probe=2, k=10, ef=32, q_buckets=(32,)).search(queries)
    ids = got.ids.numpy()
    for row in ids:
        assert len(np.unique(row)) == len(row)
    assert (ids >= 0).all() and np.isin(ids, coll.global_ids(0)).all()
    np.testing.assert_array_equal(ids, np.asarray(want.ids))


def test_router_reranks_ids_added_after_construction(seg_pair, sets):
    """Ids added to the collection after the router was built are merged
    and re-scored on the grown corpus: the full probe equals the grown
    collection's own search, and the distances are the exact ones."""
    _, extra, _ = sets
    coll = SegmentedAnnIndex.restore(*seg_pair[1].export_state(), device="cpu")
    pr = serve.SegmentRouter(coll, n_probe=3, k=1, ef=32, q_buckets=(8,)).warmup()
    gids = coll.add(extra[:16])
    pr.refresh()
    got = pr.search(extra[:8])
    hits = got.ids.numpy()[:, 0]
    assert np.isin(hits, gids).any()
    np.testing.assert_array_equal(hits, coll.search(extra[:8], k=1, ef=32).ids.numpy()[:, 0])
    raw = coll.raw_vectors.numpy()
    for q, gid, d in zip(extra[:8], hits, got.dists.numpy()[:, 0]):
        np.testing.assert_allclose(d, ((raw[gid] - q) ** 2).sum(), rtol=1e-5)
