"""Shared inputs of the flat-graph tests (``test_torch_flat*.py``): the
backend kinds and build parameters, the reference/port backend pairs over
exactly representable integer rows (``exact_pair``), the module fixtures
``int_rows`` and ``float_sets``, the exact builds' check
(``check_exact_build``) and the float builds' coder options. Not
collected by pytest (no ``test_`` prefix); the test files import from it.
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
from repro.graph.nsg import build_nsg as j_build_nsg
from repro_torch.core import baselines as tbl
from repro_torch.core import quantize as tqz
from repro_torch.graph import backends as tbk
from repro_torch.graph.engine import BuildParams
from repro_torch.graph.nsg import build_nsg
from repro_torch.index import AnnIndex
from conftest import make_clustered

KINDS = ("fp32", "pq", "sq", "pca", "flash", "flash_blocked")
N, D, R = 400, 16, 12
PARAMS = dict(r_upper=8, r_base=R, ef=24, batch=32, max_layers=2)
FLASH_KW = dict(d_f=D, m_f=8, l_f=4, h=8, kmeans_iters=6)


def _state(be) -> dict:
    return {k: np.asarray(v) for k, v in be.state_dict().items()}


def exact_pair(kind: str, x: np.ndarray):
    """(reference backend, port backend) over integer rows ``x`` with one
    state: hand-made coders for the baselines, the reference's fitted coder
    for Flash."""
    t = torch.from_numpy(x)
    if kind.startswith("flash"):
        kw = dict(FLASH_KW, r_for_blocked=R) if kind == "flash_blocked" else FLASH_KW
        jb = jbk.make_backend(kind, jnp.asarray(x), jax.random.PRNGKey(0), **kw)
        return jb, tbk.CLASSES[type(jb).__name__].from_state(_state(jb), device="cpu")
    d = x.shape[1]
    if kind == "fp32":
        tb = tbk.FP32Backend(t)
    elif kind == "pq":
        cb = torch.from_numpy(np.random.default_rng(3).integers(-8, 9, (4, 16, d // 4)).astype(np.float32))
        diff = cb[:, :, None, :] - cb[:, None, :, :]
        coder = tbl.PQCoder(codebooks=cb, sdc=(diff * diff).sum(-1))
        tb = tbk.PQBackend(coder, tbl.pq_encode(coder, t))
    elif kind == "sq":
        ones = torch.ones(d)
        coder = tbl.SQCoder(tqz.SQParams(-8 * ones, 16 * ones, torch.tensor(8, dtype=torch.int32)), ones)
        tb = tbk.SQBackend(coder, tbl.sq_encode(coder, t))
    else:
        coder = tbl.PCACoder(mean=torch.zeros(d), rot=torch.eye(d)[:, ::2].contiguous())
        tb = tbk.PCABackend(coder, tbl.pca_encode(coder, t))
    return jbk.CLASSES[type(tb).__name__].from_state(_state(tb)), tb


@pytest.fixture(scope="module")
def int_rows():
    rng = np.random.default_rng(5)
    return rng.integers(-8, 9, (N, D)).astype(np.float32), rng.integers(-8, 9, (24, D)).astype(np.float32)


def _graph_arrays(state: dict, layered: bool) -> dict:
    keys = ("adj0", "adj0_d", "adj_up", "adj_up_d", "levels") if layered else ("adj", "adj_d")
    return {k: np.asarray(state[k]) for k in keys + ("entry",)}


CASES = [
    ("hnsw", "bulk", {}), ("hnsw", "incremental", {}),
    ("vamana", "incremental", {"two_pass": True}), ("vamana", "incremental", {"two_pass": False}),
    ("vamana", "bulk", {}), ("nsg", "incremental", {}), ("nsg", "bulk", {}),
]


def check_exact_build(int_rows, kind: str, algo: str, strategy: str, kw: dict) -> None:
    """One build of ``algo``/``strategy`` over ``kind`` in both packages on
    the integer rows: graphs, distances, entries, n_dists and searches equal
    (``test_torch_flat_exact*.py``)."""
    x, _ = int_rows
    jb, tb = exact_pair(kind, x)
    params = dict(PARAMS, alpha=1.2 if algo == "vamana" else 1.0)
    if algo == "nsg" and strategy == "incremental":
        # the builders themselves, with the reference's k-NN graph carried
        jg, knn = j_build_nsg(jnp.asarray(x), jb, params=JParams(**params), knn_k=8)
        tg, _ = build_nsg(torch.from_numpy(x), tb, params=BuildParams(**params), knn_k=8,
                          knn_adj=torch.from_numpy(np.array(knn)))
        for f in ("adj", "adj_d", "entry"):
            np.testing.assert_array_equal(np.asarray(getattr(tg, f)), np.asarray(getattr(jg, f)), err_msg=f)
        np.testing.assert_array_equal(tg.backend.state_dict().get("nbr_codes", 0),
                                      np.asarray(jg.backend.state_dict().get("nbr_codes", 0)))
        return
    akw = dict(kw, **({"knn_k": 8} if algo == "nsg" else {}))
    jidx = JIndex.build(jnp.asarray(x), algo=algo, backend=jb, params=JParams(**params),
                        strategy=strategy, **akw)
    tidx = AnnIndex.build(x, algo=algo, backend=tb, params=BuildParams(**params), strategy=strategy,
                          device="cpu", **akw)
    jmeta, jarr = jidx.export_state()
    tmeta, tarr = tidx.export_state()
    assert tmeta == jmeta
    want, got = _graph_arrays(jarr, jidx.layered), _graph_arrays(tarr, tidx.layered)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in tarr:
        if key.startswith("backend."):
            np.testing.assert_array_equal(tarr[key], np.asarray(jarr[key]), err_msg=key)
    if jidx.last_stats is not None:  # the reference's NSG reports no stats
        assert tidx.last_stats.n_dists == float(jidx.last_stats.n_dists)
        assert list(tidx.last_stats.phases) == [float(v) for v in np.asarray(jidx.last_stats.phases)]
    _, queries = int_rows
    for rerank in (True, "reconstruct"):
        a = tidx.search(queries, k=8, ef=32, width=2, rerank=rerank)
        b = jidx.search(jnp.asarray(queries), k=8, ef=32, width=2, rerank=rerank)
        np.testing.assert_array_equal(a.ids.numpy(), np.asarray(b.ids))
        assert a.n_scan == int(b.n_scan)
        if rerank is True:  # exact squared L2 of integer rows
            np.testing.assert_array_equal(a.dists.numpy(), np.asarray(b.dists))
        else:  # decoded vectors are not integers: float sums, allclose
            np.testing.assert_allclose(a.dists.numpy(), np.asarray(b.dists), rtol=1e-5, atol=1e-4)


def _recall(ids: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1] for a, b in zip(ids, gt)]))


@pytest.fixture(scope="module")
def float_sets():
    x = make_clustered(900, 24, seed=21)
    data, queries = x[:860], x[860:]
    d2 = ((queries[:, None, :] - data[None]) ** 2).sum(-1)
    return data, queries, np.argsort(d2, axis=1, kind="stable")[:, :10]


FLOAT_KW = {"fp32": {}, "pq": dict(m=6, l_pq=5, kmeans_iters=6), "sq": dict(bits=8),
            "pca": dict(alpha=0.9), "flash": dict(d_f=16, m_f=8, kmeans_iters=6),
            "flash_blocked": dict(d_f=16, m_f=8, kmeans_iters=6, r_for_blocked=R)}
