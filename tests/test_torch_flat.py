"""The port's flat graphs (Vamana, NSG) and the algorithm registry against
the reference's, on the CPU.

* The registry and the facade's flags; flat ``flash_blocked`` builds and
  searches reach the fused beam; the reference's NSG over the blocked
  mirror with ``knn_k == r_base`` is reproduced bit for bit.
* Flat ``add``/``delete``/``compact`` and the reconstruct rerank equal the
  reference's; a segmented Vamana/SQ build equals the reference's segment
  for segment, a routed ``add`` included; ``build_vamana`` returns pass
  1's account, as the reference does.

The builds of every algorithm × strategy × backend are in
``test_torch_flat_exact.py`` (exact inputs) and
``test_torch_flat_float.py`` (float inputs); the shared inputs in
``_flat_common.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import backends as jbk
from repro.graph.engine import BuildParams as JParams
from repro.graph.index import AnnIndex as JIndex
from repro.graph.nsg import build_nsg as j_build_nsg
from repro.graph.segmented import SegmentedAnnIndex as JSeg
from repro.graph.vamana import build_vamana as j_build_vamana
from repro_torch.graph import backends as tbk
from repro_torch.graph.engine import BuildParams
from repro_torch.graph.nsg import build_nsg
from repro_torch.graph.vamana import FlatIndex, build_vamana, medoid_id
from repro_torch.index import AnnIndex, SegmentedAnnIndex
from _flat_common import D, N, PARAMS, R, _state, exact_pair, int_rows  # noqa: F401 (fixture)


def test_registry_and_facade_flags(int_rows):
    from repro.graph import index as jix
    from repro_torch.graph import index as tix

    assert tix.algos() == jix.algos() == ("hnsw", "vamana", "nsg")
    for name in tix.algos():
        t, j = tix._REGISTRY[name], jix._REGISTRY[name]
        assert (t.layered, dataclasses.asdict(t.default_params)) == (j.layered, dataclasses.asdict(j.default_params))
    assert {c.__name__: k for c, k in tix._KIND_OF_TYPE.items()} == {c.__name__: k for c, k in jix._KIND_OF_TYPE.items()}
    x, _ = int_rows
    idx = AnnIndex.build(x, algo="nsg", backend="fp32", params=BuildParams(**PARAMS), device="cpu")
    assert not idx.layered and isinstance(idx.graph, FlatIndex) and idx.graph.entry == medoid_id(torch.from_numpy(x))
    assert "nsg" in repr(idx)
    with pytest.raises(ValueError, match="unknown backend kind"):
        AnnIndex.build(x, algo="vamana", backend="opq", device="cpu")
    with pytest.raises(ValueError, match="unknown build strategy"):
        build_vamana(torch.from_numpy(x), tbk.FP32Backend(torch.from_numpy(x)), strategy="greedy")


def test_flat_blocked_builds_and_searches_take_the_fused_beam(int_rows, monkeypatch):
    """Every beam over a flat graph has the mirror's width, so flat
    ``flash_blocked`` builds (insert batches, repair) and searches reach
    ``fused_beam`` (one ``flash_beam`` launch on the card)."""
    x, queries = int_rows
    calls = {"n": 0}
    orig = tbk.FlashBlockedBackend.fused_beam

    def counted(self, *a, **k):
        calls["n"] += 1
        return orig(self, *a, **k)

    monkeypatch.setattr(tbk.FlashBlockedBackend, "fused_beam", counted)
    _, tb = exact_pair("flash_blocked", x)
    params = BuildParams(**dict(PARAMS, alpha=1.2))
    # NSG's beams walk the k-NN graph: with knn_k == r_base it has the
    # mirror's width (the reference's fused path; see the next test)
    for algo, akw in (("vamana", {}), ("nsg", {"knn_k": R})):
        calls["n"] = 0
        idx = AnnIndex.build(x, algo=algo, backend=tb, params=params, strategy="incremental",
                             device="cpu", **akw)
        assert calls["n"] >= -(-N // PARAMS["batch"]) - 1, (algo, calls)
        calls["n"] = 0
        fused = idx.search(queries, k=8, ef=32)
        assert calls["n"] == 1
        unfused = idx.search(queries, k=8, ef=32, fused=False)
        assert calls["n"] == 1 and torch.equal(fused.ids, unfused.ids)


def test_nsg_over_the_blocked_mirror_reproduces_the_reference():
    """The reference's NSG beam walks the k-NN graph; with ``knn_k ==
    r_base`` it has the mirror's width, so the fused path scores it with the
    mirror rows of the graph under construction. The port reproduces that
    bit for bit, and it differs from the same build over plain ``flash``
    (with ``knn_k`` = 6 the two agree)."""
    x = np.random.default_rng(0).standard_normal((300, 16)).astype(np.float32)
    params = dict(r_upper=8, r_base=8, ef=16, batch=32, max_layers=3)
    jflash = jbk.make_backend("flash", jnp.asarray(x), jax.random.PRNGKey(0), d_f=16, m_f=8)
    jblocked = jbk.FlashBlockedBackend(jflash.coder, jflash.codes, jnp.zeros((300, 8, 4), jnp.uint8))
    rows = {}
    for knn_k in (8, 6):
        for name, jb in (("flash", jflash), ("flash_blocked", jblocked)):
            jg, _ = j_build_nsg(jnp.asarray(x), jb, params=JParams(**params), knn_k=knn_k)
            tb = tbk.CLASSES[type(jb).__name__].from_state(_state(jb), device="cpu")
            tg, _ = build_nsg(torch.from_numpy(x), tb, params=BuildParams(**params), knn_k=knn_k)
            np.testing.assert_array_equal(tg.adj.numpy(), np.asarray(jg.adj))
            np.testing.assert_array_equal(tg.adj_d.numpy(), np.asarray(jg.adj_d))
            rows[(knn_k, name)] = tg.adj.numpy()
    same = {k: float((rows[(k, "flash")] == rows[(k, "flash_blocked")]).all(1).mean()) for k in (8, 6)}
    print(f"rows equal to the plain-flash build: knn_k = 8: {same[8]:.3f}, knn_k = 6: {same[6]:.3f}")
    assert same[6] == 1.0 and same[8] < 0.1


@pytest.fixture(scope="module")
def flat_pair(int_rows):
    """A reference Vamana index over the blocked backend and the port's
    restore of it."""
    x, _ = int_rows
    jb, _ = exact_pair("flash_blocked", x)
    jidx = JIndex.build(jnp.asarray(x), algo="vamana", backend=jb,
                        params=JParams(**dict(PARAMS, alpha=1.2)), strategy="incremental")
    meta, arrays = jidx.export_state()
    return jidx, AnnIndex.restore(meta, {k: np.asarray(v) for k, v in arrays.items()}, device="cpu")


@pytest.mark.parametrize("kind", ["fp32", "flash_blocked"])
def test_flat_maintenance_bit_equal(int_rows, kind):
    x, queries = int_rows
    base, new = x[:300], x[300:]
    jb, _ = exact_pair(kind, base)
    jidx = JIndex.build(jnp.asarray(base), algo="vamana", backend=jb,
                        params=JParams(**dict(PARAMS, alpha=1.2)), strategy="bulk")
    meta, arrays = jidx.export_state()
    port = AnnIndex.restore(meta, {k: np.asarray(v) for k, v in arrays.items()}, device="cpu")
    dead = np.concatenate([[int(np.asarray(arrays["entry"]))], np.arange(0, 380, 9)])

    def same():
        jm, ja = jidx.export_state()
        tm, ta = port.export_state()
        assert tm == jm
        for key, arr in ja.items():
            np.testing.assert_array_equal(ta[key], np.asarray(arr), err_msg=key)
        np.testing.assert_array_equal(port.search(queries, k=8, ef=32).ids.numpy(),
                                      np.asarray(jidx.search(jnp.asarray(queries), k=8, ef=32).ids))

    s_t, s_j = port.add(new), jidx.add(jnp.asarray(new))
    assert s_t.n_dists == float(s_j.n_dists) > 0
    same()
    assert port.delete(dead) == jidx.delete(dead)
    same()
    s_t, s_j = port.compact(), jidx.compact()
    assert s_t.n_dists == float(s_j.n_dists) > 0
    same()  # the medoid entry was deleted: both pick the live vertex nearest the live mean
    assert port.graph.entry != dead[0]
    twin = port.clone()
    twin.add(queries[:4])
    assert twin.n == port.n + 4 and twin.graph.entry == port.graph.entry


def test_flat_reconstruct_rerank_and_from_graph(flat_pair, int_rows):
    jidx, port = flat_pair
    _, queries = int_rows
    for rerank in ("reconstruct", "none", "exact"):
        a = port.search(queries, k=8, ef=48, width=4, rerank=rerank)
        b = jidx.search(jnp.asarray(queries), k=8, ef=48, width=4, rerank=rerank)
        np.testing.assert_array_equal(a.ids.numpy(), np.asarray(b.ids))
        np.testing.assert_allclose(a.dists.numpy(), np.asarray(b.dists), rtol=1e-5, atol=1e-4)
    wrapped = AnnIndex.from_graph(port.graph, port.data, algo="vamana", device="cpu")
    assert torch.equal(wrapped.search(queries, k=8, ef=48).ids, port.search(queries, k=8, ef=48).ids)


def test_segmented_vamana_sq_equals_the_reference():
    """Three inline segments of integer rows in [0, 255] (every dimension
    spans the whole range in every segment, so SQ's s2 is exactly 1 and
    every distance an exact integer): the port's ``SegmentedAnnIndex.build(
    algo="vamana", backend="sq")`` equals the reference's segment for
    segment, and so does a routed ``add``."""
    rng = np.random.default_rng(8)
    centers = rng.integers(40, 216, (3, D))
    segs = []
    for c in centers:
        seg = np.clip(c + rng.integers(-30, 31, (150, D)), 0, 255)
        seg[0], seg[1] = 0, 255
        segs.append(seg.astype(np.float32))
    new = np.clip(centers[rng.integers(0, 3, 40)] + rng.integers(-20, 21, (40, D)), 0, 255).astype(np.float32)
    params = dict(PARAMS, alpha=1.2)
    jcoll = JSeg.build([jnp.asarray(s) for s in segs], algo="vamana", backend="sq",
                       params=JParams(**params), backend_kwargs=dict(bits=8), seed=3)
    tcoll = SegmentedAnnIndex.build(segs, algo="vamana", backend="sq", params=BuildParams(**params),
                                    backend_kwargs=dict(bits=8), seed=3, device="cpu")

    def same():
        for js, ts in zip(jcoll.segments, tcoll.segments):
            jm, ja = js.export_state()
            tm, ta = ts.export_state()
            assert tm == jm
            for key, arr in ja.items():
                np.testing.assert_array_equal(ta[key], np.asarray(arr), err_msg=key)
            assert float(np.asarray(ts.backend.coder.s2).max()) == 1.0

    same()
    np.testing.assert_array_equal(tcoll.add(new), np.asarray(jcoll.add(jnp.asarray(new))))
    same()
    q = new[:10] + 1
    np.testing.assert_array_equal(tcoll.search(q, k=8, ef=32).ids.numpy(),
                                  np.asarray(jcoll.search(jnp.asarray(q), k=8, ef=32).ids))


def test_build_vamana_returns_pass_one_account(int_rows):
    """The reference returns pass 1's account only; so does the port, and a
    one-pass build counts the same."""
    x, _ = int_rows
    _, tb = exact_pair("fp32", x)
    jb, _ = exact_pair("fp32", x)
    params = dict(PARAMS, alpha=1.2)
    tg, ts = build_vamana(torch.from_numpy(x), tb, params=BuildParams(**params), two_pass=True)
    _, ts1 = build_vamana(torch.from_numpy(x), tb, params=BuildParams(**params), two_pass=False)
    jg, js = j_build_vamana(jnp.asarray(x), jb, params=JParams(**params), two_pass=True)
    assert ts.n_dists == ts1.n_dists == float(js.n_dists)
    assert "pass2" in ts.seconds and "pass2" not in ts1.seconds
    np.testing.assert_array_equal(tg.adj.numpy(), np.asarray(jg.adj))
