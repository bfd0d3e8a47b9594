"""The port's BERT4Rec retrieval path against the reference package's.

* The registry's ``bert4rec`` entry equals the reference's, full and
  reduced; ``flash-ann`` resolves to the reference's coder settings.
* The reference's ``init_bert4rec`` parameters, carried by
  ``params_from_jax``, give ``encode``/``serve``/``score_all`` within atol
  2e-5 of ``bert4rec_encode``/``bert4rec_serve``/``bert4rec_score_all``
  (float32 sums in another order), at the reduced config and at the full
  widths (D = 64, S = 200, 2 blocks, 2 heads) with a 5,000-row table.
* The GQA attention module (grouped or not, causal or bidirectional)
  holds atol 2e-5 against ``gqa_forward`` on the same weights.
* ``sample_training_batch``'s ids, fed the same uniforms, are equal.
* ``score_flash`` on the reference's coder and codes returns the
  reference's ids (``impl="ref"``) on a 20,000-row table whose int32 scan
  sums tie at the ``k · rerank`` cut (the test asserts the ties exist).
* ``score_dense`` returns the reference's ids except where the k-th and
  (k+1)-th exact scores are within 1e-5 (a near tie, counted).
* ``search_index`` through the port's ``AnnIndex`` (and through a bare
  ``HNSWIndex``) over a prebuilt ``FlashBackend`` returns the reference's
  ids on the same graph (the port's build, restored into the reference;
  ``tests/test_torch_graph.py`` holds the build itself bit-equal).
* The reference's ``test_flash_scan_recall``, repeated with the port's own
  coder fit: recall@10 ≥ 0.5 and within 0.03 of the reference's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import registry as jreg
from repro.data.synthetic import vector_dataset
from repro.graph.index import AnnIndex as JIndex
from repro.models import layers as jl
from repro.models.recsys import bert4rec as jb
from repro.models.recsys import retrieval as jret
from repro_torch.configs import registry as treg
from repro_torch.core import flash as tflash
from repro_torch.graph.backends import FlashBackend as TFlashBackend
from repro_torch.graph.engine import BuildParams
from repro_torch.index import AnnIndex
from repro_torch.models import layers as tl
from repro_torch.models.recsys import bert4rec as tb
from repro_torch.models.recsys import retrieval as tret

CFG_FIELDS = ("n_items", "embed_dim", "n_blocks", "n_heads", "seq_len", "mask_prob")
GRAPH_PARAMS = dict(r_upper=8, r_base=16, ef=48, batch=32)


def _jcfg(cfg: tb.Bert4RecConfig) -> jb.Bert4RecConfig:
    return jb.Bert4RecConfig(**{f: getattr(cfg, f) for f in CFG_FIELDS})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_coder(jcoder) -> tflash.FlashCoder:
    return tflash.FlashCoder(*(torch.from_numpy(np.array(a)) for a in jcoder))


def _sessions(cfg, batch: int, seed: int) -> np.ndarray:
    """Reference sessions ending in [MASK], as numpy."""
    items, _ = jb.sample_training_batch(jax.random.PRNGKey(seed), _jcfg(cfg), batch)
    return np.array(items.at[:, -1].set(cfg.mask_id))


def test_registry_matches_reference():
    for make in ("make_full", "make_reduced"):
        want = getattr(jreg.get_arch("bert4rec"), make)()
        got = getattr(treg.get_arch("bert4rec"), make)()
        assert all(getattr(got, f) == getattr(want, f) for f in CFG_FIELDS)
    assert [(s.name, s.kind, s.dims) for s in treg.RECSYS_SHAPES] == [
        (s.name, s.kind, s.dims) for s in jreg.RECSYS_SHAPES
    ]
    assert treg.get_arch("flash-ann").make_full() == jreg.get_arch("flash-ann").make_full()


@pytest.mark.parametrize("cfg", [
    treg.get_arch("bert4rec").make_reduced(),
    tb.Bert4RecConfig(n_items=5000, embed_dim=64, n_blocks=2, n_heads=2, seq_len=200),
], ids=["reduced", "full_widths"])
def test_encoder_matches_reference(cfg):
    params = jb.init_bert4rec(jax.random.PRNGKey(0), _jcfg(cfg))
    model = tb.params_from_jax(_np_tree(params), cfg, device="cpu")
    items = _sessions(cfg, 4, seed=1)
    h = model.encode(torch.from_numpy(items))
    want = np.asarray(jb.bert4rec_encode(params, _jcfg(cfg), jnp.asarray(items)))
    assert tuple(h.shape) == want.shape
    np.testing.assert_allclose(h.numpy(), want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(
        model.serve(torch.from_numpy(items)).numpy(),
        np.asarray(jb.bert4rec_serve(params, _jcfg(cfg), jnp.asarray(items))), rtol=0, atol=2e-5,
    )
    np.testing.assert_allclose(
        model.score_all(torch.from_numpy(items)).numpy(),
        np.asarray(jb.bert4rec_score_all(params, _jcfg(cfg), jnp.asarray(items))), rtol=0, atol=2e-5,
    )


@pytest.mark.parametrize("n_heads,n_kv,causal", [(4, 2, True), (2, 2, False)])
def test_gqa_attention_matches_reference(n_heads, n_kv, causal):
    d, hd, b, s = 32, 8, 2, 12
    p = jl.init_gqa(jax.random.PRNGKey(3), d_model=d, n_heads=n_heads, n_kv=n_kv, head_dim=hd, qkv_bias=True)
    p = {k: np.array(v) + 0.1 * (k[0] == "b") for k, v in p.items()}  # non-zero biases
    attn = tl.GQAAttention(torch.Generator().manual_seed(0), d_model=d, n_heads=n_heads, n_kv=n_kv,
                           head_dim=hd, device="cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(attn, k).copy_(torch.from_numpy(v))
    x = np.random.default_rng(0).normal(size=(b, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    want = jl.gqa_forward({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.asarray(pos),
                          n_heads=n_heads, n_kv=n_kv, head_dim=hd, rope_theta=10000.0, causal=causal)
    with torch.no_grad():
        got = attn(torch.from_numpy(x), torch.from_numpy(np.array(pos)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("make", [
    lambda g: tl.GQAAttention(g, d_model=32, n_heads=4, n_kv=2, head_dim=8),
    lambda g: tl.SwiGLU(g, d_model=32, d_ff=64),
], ids=["GQAAttention", "SwiGLU"])
def test_layers_default_to_the_card(monkeypatch, make):
    """Like every entry point, the layers build on "cuda" unless asked for
    the CPU, and raise where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(torch.Generator().manual_seed(0))


def test_sample_training_batch_matches_reference(monkeypatch):
    """The same uniforms through both packages' formulas give equal ids
    (the reference's ``jax.random.uniform`` draws are replaced by numpy's)."""
    cfg = treg.get_arch("bert4rec").make_full()
    rng = np.random.default_rng(0)
    u = (rng.random((64, cfg.seq_len), dtype=np.float32) * (1 - 1e-6) + 1e-6).astype(np.float32)
    m = rng.random((64, cfg.seq_len), dtype=np.float32)
    draws = [jnp.asarray(u), jnp.asarray(m)]
    monkeypatch.setattr(jax.random, "uniform", lambda *a, **kw: draws.pop(0))
    items, mask = jb.sample_training_batch(jax.random.PRNGKey(0), _jcfg(cfg), 64)
    np.testing.assert_array_equal(tb.items_from_uniform(torch.from_numpy(u), cfg).numpy(), np.asarray(items))
    assert np.asarray(mask)[:, -1].all()


def test_sample_training_batch_on_a_generator():
    cfg = treg.get_arch("bert4rec").make_reduced()
    gen = torch.Generator().manual_seed(0)
    items, mask = tb.sample_training_batch(gen, cfg, 32)
    assert items.dtype == torch.int32 and tuple(items.shape) == (32, cfg.seq_len)
    assert int(items.min()) >= 0 and int(items.max()) < cfg.n_items
    assert bool(mask[:, -1].all()) and 0.1 < float(mask[:, :-1].float().mean()) < 0.3
    again, _ = tb.sample_training_batch(torch.Generator().manual_seed(0), cfg, 32)
    assert torch.equal(items, again)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.Bert4Rec(treg.get_arch("bert4rec").make_reduced())


@pytest.fixture(scope="module")
def catalog():
    """A 20,000 × 64 normalized table (the repo's stand-in for a trained
    item table), the reference's coder and codes (d_f = 48, M = 16), and two
    query sets: encoder queries from a full-width model whose table rows are
    the catalog, and near-item queries."""
    n, d = 20000, 64
    table = vector_dataset(0, n=n, d=d, n_clusters=256)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    key = jax.random.PRNGKey(0)
    coder = jcore.fit_flash(key, jnp.asarray(table), d_f=48, m_f=16, kmeans_iters=10)
    codes = np.array(jcore.encode(coder, jnp.asarray(table)))
    cfg = tb.Bert4RecConfig(n_items=n, embed_dim=d, n_blocks=2, n_heads=2, seq_len=200)
    params = jb.init_bert4rec(key, _jcfg(cfg))
    params["item_embed"] = params["item_embed"].at[:n].set(jnp.asarray(table))
    enc_q = np.array(jb.bert4rec_serve(params, _jcfg(cfg), jnp.asarray(_sessions(cfg, 16, seed=2))))
    near_q = table[:16] + 0.03 * np.random.default_rng(1).normal(size=(16, d)).astype(np.float32)
    return table, coder, codes, {"encoder": enc_q, "near_item": near_q}


@pytest.mark.parametrize("queries", ["encoder", "near_item"])
@pytest.mark.parametrize("k,rerank", [(10, 8), (100, 4)])
def test_score_flash_matches_reference_with_ties(catalog, queries, k, rerank):
    table, coder, codes, qsets = catalog
    q = qsets[queries]
    want = jret.score_flash(jnp.asarray(q), coder, jnp.asarray(codes), jnp.asarray(table),
                            k=k, rerank=rerank, impl="ref")
    tcoder = _port_coder(coder)
    # the same query tables first: the scan's order rests on them
    jadt = np.asarray(jax.vmap(lambda v: jcore.query_ctx(coder, v).adt_q)(jnp.asarray(q)))
    tadt = tflash.query_ctx(tcoder, torch.from_numpy(q)).adt_q.numpy()
    assert int((jadt != tadt).sum()) == 0, "ADT levels differ from the reference's"
    # ties at the k·rerank cut: rows beyond the cut share the cut-off sum
    kk = k * rerank
    sums = jadt[:, np.arange(codes.shape[1])[None, :], codes].sum(-1)  # (Q, N)
    cut = np.sort(sums, axis=1)[:, kk - 1]
    tied = ((sums <= cut[:, None]).sum(1) > kk).sum()
    assert tied >= len(q) // 2, f"only {tied} of {len(q)} queries tie at the cut"
    got = tret.score_flash(torch.from_numpy(q), tcoder, torch.from_numpy(codes), torch.from_numpy(table),
                           k=k, rerank=rerank)
    assert got.ids.dtype == torch.int32 and tuple(got.ids.shape) == (len(q), k)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("queries", ["encoder", "near_item"])
def test_score_dense_matches_reference(catalog, queries):
    """Equal ids, except where the reference's k-th and (k+1)-th scores are
    within 1e-5 (float32 products sum in another order): such rows are
    counted and must be all the rows that differ."""
    table, _, _, qsets = catalog
    q, k = qsets[queries], 10
    want = jret.score_dense(jnp.asarray(q), jnp.asarray(table), k=k + 1)
    got = tret.score_dense(torch.from_numpy(q), torch.from_numpy(table), k=k)
    want_ids, want_sc = np.asarray(want.ids), np.asarray(want.scores)
    near = want_sc[:, k - 1] - want_sc[:, k] <= 1e-5
    differ = (got.ids.numpy() != want_ids[:, :k]).any(1)
    assert not (differ & ~near).any(), f"{int(differ.sum())} rows differ, {int(near.sum())} near ties"
    np.testing.assert_allclose(got.scores.numpy(), want_sc[:, :k], rtol=1e-5, atol=1e-6)


def test_retrieval_recall_matches_reference(catalog):
    """Equal up to the reference's float32 mean."""
    table, coder, codes, qsets = catalog
    q = jnp.asarray(qsets["encoder"])
    exact = jret.score_dense(q, jnp.asarray(table), k=10)
    fl = jret.score_flash(q, coder, jnp.asarray(codes), jnp.asarray(table), k=10, rerank=2, impl="ref")
    port = [tret.RetrievalResult(torch.from_numpy(np.array(r.ids)), torch.from_numpy(np.array(r.scores)))
            for r in (fl, exact)]
    assert tret.retrieval_recall(*port, 10) == pytest.approx(jret.retrieval_recall(fl, exact, 10), abs=1e-6)


@pytest.fixture(scope="module")
def graph_pair(catalog):
    """The retrieval graph over the catalog's first 2,000 rows, built by the
    port from the reference's coder and codes (a prebuilt ``FlashBackend``,
    as the serving example builds it) and restored into the reference."""
    table, coder, codes, _ = catalog
    n = 2000
    tidx = AnnIndex.build(table[:n], algo="hnsw",
                          backend=TFlashBackend(_port_coder(coder), torch.from_numpy(codes[:n])),
                          params=BuildParams(**GRAPH_PARAMS), device="cpu")
    jidx = JIndex.restore(*tidx.export_state())
    return table[:n], jidx, tidx


@pytest.mark.parametrize("legacy", [False, True], ids=["ann_index", "bare_hnsw"])
def test_search_index_matches_reference(catalog, graph_pair, legacy):
    _, _, _, qsets = catalog
    table, jidx, tidx = graph_pair
    q = np.concatenate([qsets["encoder"], qsets["near_item"]])
    jarg, targ = (jidx.graph, tidx.graph) if legacy else (jidx, tidx)
    want = jret.search_index(jnp.asarray(q), jarg, jnp.asarray(table), k=10, ef_search=96)
    got = tret.search_index(torch.from_numpy(q), targ, torch.from_numpy(table), k=10, ef_search=96)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5, atol=1e-5)
    if legacy:
        shallow = tret.search_index(torch.from_numpy(q), targ, torch.from_numpy(table), k=10,
                                    ef_search=96, max_layers=1)
        want = jret.search_index(jnp.asarray(q), jarg, jnp.asarray(table), k=10, ef_search=96, max_layers=1)
        np.testing.assert_array_equal(shallow.ids.numpy(), np.asarray(want.ids))
    else:
        with pytest.raises(ValueError, match="max_layers"):
            tret.search_index(torch.from_numpy(q), targ, torch.from_numpy(table), k=10, max_layers=1)


def test_flash_scan_recall_with_the_ports_own_coder(key):
    """The reference's ``test_flash_scan_recall`` (tests/test_recsys.py),
    with the port's own coder fit beside the reference's: recall@10 ≥ 0.5,
    and within 0.03 of the reference's on the same rows and queries."""
    n, d = 20000, 32
    emb = vector_dataset(0, n=n, d=d, n_clusters=128)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[:16] + 0.02 * np.random.default_rng(0).normal(size=(16, d)).astype(np.float32)
    jcoder = jcore.fit_flash(key, jnp.asarray(emb[:8192]), d_f=24, m_f=12, kmeans_iters=8)
    jfl = jret.score_flash(jnp.asarray(q), jcoder, jcore.encode(jcoder, jnp.asarray(emb)), jnp.asarray(emb),
                           k=10, rerank=16)
    exact = jret.score_dense(jnp.asarray(q), jnp.asarray(emb), k=10)
    r_ref = jret.retrieval_recall(jfl, exact, 10)
    temb = torch.from_numpy(emb)
    tcoder = tflash.fit_flash(emb[:8192], d_f=24, m_f=12, kmeans_iters=8, device="cpu")
    tfl = tret.score_flash(torch.from_numpy(q), tcoder, tflash.encode(tcoder, temb), temb, k=10, rerank=16)
    r_port = tret.retrieval_recall(tfl, tret.score_dense(torch.from_numpy(q), temb, k=10), 10)
    assert r_port >= 0.5 and abs(r_port - r_ref) <= 0.03, f"port {r_port:.4f} vs reference {r_ref:.4f}"
