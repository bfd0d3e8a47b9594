"""The port's facade end to end, against the reference package's facade.

* The port's own build (its own coder fit) reaches a recall@10 within 0.02
  of the reference facade's on the same data and params.
* An index the reference built restores into the port
  (``restore(export_state())``) and searches equal ids; exact-rerank
  distances are allclose with rtol 1e-5, atol 1e-4 (float sums in another
  order). The other way round, an index the port built restores into the
  reference and searches equal ids there.
* The entry points default to the card and raise without one.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.engine import BuildParams as JParams
from repro.graph.index import AnnIndex as JIndex
from repro_torch.graph.engine import BuildParams
from repro_torch.index import AnnIndex
from conftest import make_clustered

FLASH_KW = dict(d_f=32, m_f=16, l_f=4, h=8, kmeans_iters=8)
PARAMS = dict(r_upper=8, r_base=16, ef=32, batch=16, max_layers=3)


def _recall(ids: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1] for a, b in zip(ids, gt)]))


@pytest.fixture(scope="module")
def setup():
    x = make_clustered(2096, 48, seed=7)
    data, queries = x[:2000], x[2000:]
    d2 = ((queries[:, None, :] - data[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1, kind="stable")[:, :10]
    jidx = JIndex.build(jnp.asarray(data), algo="hnsw", backend="flash_blocked",
                        params=JParams(**PARAMS), backend_kwargs=FLASH_KW, strategy="bulk")
    tidx = AnnIndex.build(data, algo="hnsw", backend="flash_blocked",
                          params=BuildParams(**PARAMS), backend_kwargs=FLASH_KW,
                          strategy="bulk", device="cpu")
    return data, queries, gt, jidx, tidx


def test_own_build_recall_matches_reference(setup):
    data, queries, gt, jidx, tidx = setup
    for ef in (32, 64):
        r_ref = _recall(np.asarray(jidx.search(jnp.asarray(queries), k=10, ef=ef).ids), gt)
        r_port = _recall(tidx.search(queries, k=10, ef=ef).ids.numpy(), gt)
        assert r_port >= r_ref - 0.02, f"ef={ef}: port {r_port:.4f} vs reference {r_ref:.4f}"
    st = tidx.last_stats
    assert st.n_dists == sum(st.phases) and st.phases[3] > 0
    assert {"coder_fit", "bulk_refine_l0", "bulk_commit_l0", "repair"} <= set(st.seconds)


def test_fused_and_unfused_search_agree(setup):
    _, queries, _, _, tidx = setup
    for width in (1, 4):
        a = tidx.search(queries, k=10, ef=48, width=width)
        b = tidx.search(queries, k=10, ef=48, width=width, fused=False)
        assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
        assert a.n_dists == b.n_dists


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("rerank", [True, False])
def test_restored_reference_index_searches_equal(setup, width, rerank):
    _, queries, _, jidx, _ = setup
    meta, arrays = jidx.export_state()
    port = AnnIndex.restore(meta, {k: np.asarray(v) for k, v in arrays.items()}, device="cpu")
    ref = jidx.search(jnp.asarray(queries), k=10, ef=64, width=width, rerank=rerank)
    got = port.search(queries, k=10, ef=64, width=width, rerank=rerank)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    if rerank:
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(ref.dists), rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_array_equal(got.dists.numpy(), np.asarray(ref.dists))
    assert got.n_scan == int(ref.n_scan) and got.n_rerank == int(ref.n_rerank)


def test_port_index_restores_into_reference(setup):
    _, queries, _, _, tidx = setup
    meta, arrays = tidx.export_state()
    ref = JIndex.restore(meta, arrays)
    want = tidx.search(queries, k=10, ef=64)
    got = ref.search(jnp.asarray(queries), k=10, ef=64)
    np.testing.assert_array_equal(np.asarray(got.ids), want.ids.numpy())
    np.testing.assert_allclose(np.asarray(got.dists), want.dists.numpy(), rtol=1e-5, atol=1e-4)


def test_entry_points_default_to_the_card(setup):
    data, _, _, _, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AnnIndex.build(data[:100], backend_kwargs=FLASH_KW)
    with pytest.raises(ValueError, match="unknown algo"):
        AnnIndex.build(data[:100], algo="diskann", device="cpu")
    # the flat algorithms build (they raised until they were ported)
    flat = AnnIndex.build(data[:100], algo="vamana", backend="fp32", device="cpu")
    assert flat.algo == "vamana" and not flat.layered
    # the incremental strategy builds (it raised until it was ported)
    inc = AnnIndex.build(data[:100], strategy="incremental", backend_kwargs=FLASH_KW, device="cpu")
    assert inc.build_strategy == "incremental" and inc.last_stats.phases[0] > 0
