"""Every distance backend of the port against the reference's, hook by
hook, on the CPU, given the reference's coder (carried across through
``from_state(reference.state_dict())``).

Flash distances are integer level sums: equal. The baselines compute float
distances in the reference's difference-then-square form; XLA and torch may
sum in another order, so they are allclose at rtol 1e-5 (atol 1e-4). Codes
the port encodes itself (``extend``) are equal except at near ties (at most
1 row in 100). State dicts carry the reference's dotted keys and dtypes, and
snapshot files load in both directions for every backend class.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import backends as jbk
from repro.graph.engine import BuildParams as JParams
from repro.graph.index import AnnIndex as JIndex
from repro.graph.rerank import make_reranker as j_make_reranker
from repro.serve import snapshot as jsnap
from repro_torch.graph import backends as tbk
from repro_torch.graph.engine import BuildParams
from repro_torch.graph.rerank import make_reranker
from repro_torch.index import AnnIndex
from repro_torch.serve import snapshot as tsnap
from conftest import make_clustered

KINDS = ("fp32", "pq", "sq", "pca", "flash", "flash_blocked")
CODER_KW = {
    "fp32": {},
    "pq": dict(m=6, l_pq=5, kmeans_iters=6),
    "sq": dict(bits=8),
    "pca": dict(alpha=0.9),
    "flash": dict(d_f=16, m_f=8, l_f=4, h=8, kmeans_iters=6),
    "flash_blocked": dict(d_f=16, m_f=8, l_f=4, h=8, kmeans_iters=6, r_for_blocked=12),
}
N, D, R = 600, 22, 12
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def sets():
    x = make_clustered(N + 40 + 30, D, seed=9)
    return x[:N], x[N:N + 40], x[N + 40:]


@pytest.fixture(scope="module", params=KINDS)
def pair(request, sets):
    """(kind, reference backend with keep_raw, the port's from its state)."""
    kind = request.param
    data, _, _ = sets
    jb = jbk.make_backend(kind, jnp.asarray(data), jax.random.PRNGKey(0),
                          keep_raw=kind != "fp32", **CODER_KW[kind])
    if kind == "flash_blocked":  # a mirror with content: commit some rows
        nbr = np.random.default_rng(0).integers(-1, N, (N, R)).astype(np.int32)
        jb = jb.with_updated_edges(jnp.arange(N, dtype=jnp.int32), jnp.asarray(nbr))
    state = {k: np.asarray(v) for k, v in jb.state_dict().items()}
    return kind, jb, tbk.CLASSES[type(jb).__name__].from_state(state, device="cpu")


def _close(got, want, kind):
    got, want = got.detach().cpu().numpy(), np.asarray(want)
    assert got.shape == want.shape
    if kind.startswith("flash"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_query_side_hooks(pair, sets):
    kind, jb, tb = pair
    _, queries, _ = sets
    rng = np.random.default_rng(1)
    ids = rng.integers(0, N, (40, 3, R)).astype(np.int32)
    jctx = jax.vmap(jb.prepare_query)(jnp.asarray(queries))
    tctx = tb.prepare_query(torch.from_numpy(queries))
    want = jax.vmap(jb.query_dists)(jctx, jnp.asarray(ids))
    _close(tb.query_dists(tctx, torch.from_numpy(ids)), want, kind)
    _close(tb.neighbor_dists_batch(tctx, torch.from_numpy(ids[:, :, 0]), torch.from_numpy(ids)),
           jax.vmap(jb.neighbor_dists_batch)(jctx, jnp.asarray(ids[:, :, 0]), jnp.asarray(ids)), kind)
    cand = rng.integers(0, N, (40, 24)).astype(np.int32)
    _close(tb.round_dists(tctx, torch.from_numpy(cand)), jb.round_dists(jctx, jnp.asarray(cand)), kind)
    # the rows of a context: one way for every kind of context
    sub = tbk.ctx_rows(tctx, slice(5, 9))
    _close(tb.query_dists(sub, torch.from_numpy(ids[5:9])), np.asarray(want)[5:9], kind)


def test_pair_hooks(pair):
    kind, jb, tb = pair
    rng = np.random.default_rng(2)
    a = rng.integers(0, N, (30, 1)).astype(np.int32)
    b = rng.integers(0, N, (1, 50)).astype(np.int32)
    _close(tb.pair_dists(torch.from_numpy(a), torch.from_numpy(b)),
           jb.pair_dists(jnp.asarray(a), jnp.asarray(b)), kind)
    ids = rng.integers(0, N, (7, 20)).astype(np.int32)
    want = jb.pair_dists(jnp.asarray(ids[:, :, None]), jnp.asarray(ids[:, None, :]))
    got = tb.pair_matrix(torch.from_numpy(ids))
    _close(got, want, kind)
    assert tb.pair_matrix_bytes(20) >= 4 * 20 * 20


def test_gathers_cut_into_pieces_give_the_same_values(pair, sets, monkeypatch):
    """The baselines' gathers are cut at ``_GATHER_BYTES``; pieces of one
    row or one element change no value."""
    kind, _, tb = pair
    _, queries, _ = sets
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, N, (40, 24)).astype(np.int32))
    ctx = tb.prepare_query(torch.from_numpy(queries))
    whole = (tb.query_dists(ctx, ids), tb.pair_matrix(ids[:6]), tb.pair_dists(ids[:, :1], ids[:1, :]))
    monkeypatch.setattr(tbk, "_GATHER_BYTES", 64)
    cut = (tb.query_dists(ctx, ids), tb.pair_matrix(ids[:6]), tb.pair_dists(ids[:, :1], ids[:1, :]))
    for w, c in zip(whole, cut):
        assert torch.equal(w, c)


def test_rerank_sources(pair, sets):
    kind, jb, tb = pair
    _, queries, _ = sets
    ids = np.random.default_rng(4).integers(0, N, (40, 16)).astype(np.int32)
    q, jq = torch.from_numpy(queries), jnp.asarray(queries)
    _close(tb.raw_dists(q, torch.from_numpy(ids)), jax.vmap(jb.raw_dists)(jq, jnp.asarray(ids)), "fp32")
    _close(tb.recon_vectors(torch.from_numpy(ids)), jb.recon_vectors(jnp.asarray(ids)), "fp32")
    want = jax.vmap(j_make_reranker("reconstruct", backend=jb).dists)(jq, jnp.asarray(ids))
    _close(make_reranker("reconstruct", backend=tb).dists(q, torch.from_numpy(ids)), want, "fp32")
    assert tb.has_raw


def test_extend_and_clone(pair, sets):
    kind, jb, tb = pair
    _, _, new = sets
    jg, tg = jb.extend(jnp.asarray(new)), tb.extend(torch.from_numpy(new))
    assert tg.n == jg.n == N + len(new) and type(tg) is type(tb)
    js, ts = jg.state_dict(), tg.state_dict()
    for key in js:
        want, got = np.asarray(js[key]), ts[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if want.dtype.kind in "iu":
            rows = (got != want).reshape(len(got), -1).any(1) if got.ndim else got != want
            assert rows.sum() <= max(1, len(new) // 100), key
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=key)
    twin = tb.clone()
    twin.with_updated_edges(torch.arange(3, dtype=torch.int32), torch.full((3, R), 5, dtype=torch.int32))
    np.testing.assert_array_equal(tb.state_dict().get("nbr_codes", 0), np.asarray(jb.state_dict().get("nbr_codes", 0)))


def test_state_dict_keys_dtypes_and_round_trip(pair):
    kind, jb, tb = pair
    js, ts = jb.state_dict(), tb.state_dict()
    assert sorted(ts) == sorted(js)
    for key in js:
        want = np.asarray(js[key])
        assert ts[key].dtype == want.dtype and ts[key].shape == want.shape, key
        np.testing.assert_array_equal(ts[key], want, err_msg=key)
    back = type(tb).from_state(ts, device="cpu")
    for key, arr in back.state_dict().items():
        np.testing.assert_array_equal(arr, ts[key])
    # the reference restores the port's state too
    jback = type(jb).from_state(ts)
    for key, arr in jback.state_dict().items():
        np.testing.assert_array_equal(np.asarray(arr), ts[key])


def test_make_backend_kinds_and_fp32_options(sets):
    data, _, _ = sets
    assert tbk.KINDS == jbk.KINDS == tbk.kinds()
    assert sorted(tbk.CLASSES) == sorted(jbk.CLASSES)
    with pytest.raises(ValueError, match="no coder options"):
        tbk.make_backend("fp32", data, device="cpu", bits=8)
    with pytest.raises(ValueError, match="unknown backend kind"):
        tbk.make_backend("opq", data, device="cpu")
    for kind in ("pq", "sq", "pca"):
        be = tbk.make_backend(kind, data, device="cpu", keep_raw=True, **CODER_KW[kind])
        assert be.n == N and be.has_raw and type(be).__name__ == type(
            jbk.make_backend(kind, jnp.asarray(data[:200]), **CODER_KW[kind])).__name__


@pytest.mark.parametrize("kind", KINDS)
def test_snapshot_files_both_ways(kind, sets, tmp_path):
    """A reference index over each backend class saved by ``repro.serve``
    loads in the port and searches identically; the port's save of it loads
    back in the reference (flat Vamana graphs for half the kinds)."""
    data, queries, _ = sets
    algo = "hnsw" if kind in ("fp32", "sq", "flash") else "vamana"
    kw = dict(CODER_KW[kind])
    kw.pop("r_for_blocked", None)
    jidx = JIndex.build(jnp.asarray(data), algo=algo, backend=kind, strategy="bulk",
                        params=JParams(r_upper=6, r_base=R, ef=24, batch=16, max_layers=2,
                                       alpha=1.2 if algo == "vamana" else 1.0),
                        backend_kwargs=kw)
    path = jsnap.save_index(str(tmp_path / "ref"), jidx)
    port = tsnap.load_index(path, device="cpu")
    assert port.algo == algo and type(port.backend).__name__ == type(jidx.backend).__name__
    want = jidx.search(jnp.asarray(queries), k=8, ef=32)
    got = port.search(queries, k=8, ef=32)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), rtol=RTOL, atol=ATOL)
    back = jsnap.load_index(tsnap.save_index(str(tmp_path / "port"), port))
    np.testing.assert_array_equal(np.asarray(back.search(jnp.asarray(queries), k=8, ef=32).ids),
                                  np.asarray(want.ids))


def test_restore_refuses_a_layered_flag_that_does_not_match(sets):
    data, _, _ = sets
    idx = AnnIndex.build(data[:200], algo="vamana", backend="fp32",
                         params=BuildParams(r_upper=6, r_base=R, ef=24, batch=16), device="cpu")
    meta, arrays = idx.export_state()
    assert meta["layered"] is False and np.asarray(arrays["entry"]).shape == ()
    with pytest.raises(ValueError, match="layered"):
        AnnIndex.restore(dict(meta, layered=True), arrays, device="cpu")
    with pytest.raises(ValueError, match="unregistered algo"):
        AnnIndex.restore(dict(meta, algo="diskann"), arrays, device="cpu")
