"""The port's incremental HNSW build against the reference's, bit for bit.

* ``build_hnsw(strategy="incremental")`` — ``BuildEngine.bootstrap`` (the
  exact sequential seed batch) then ``build_layered``'s insert batches —
  started from the reference's fitted Flash coder and codes
  (``FlashBackend.from_state`` / ``FlashBlockedBackend.from_state``) gives
  bit-equal ``adj0``, ``adj_up``, ``levels``, ``entry``, mirror, per-phase
  ``n_dists`` and ``n_hops``. The port builds its own query tables; each
  case first requires them level-equal to the reference's, which is what
  makes the comparison exact.
* ``AnnIndex.from_graph`` wraps a built graph in the facade in either
  package, and the state round-trips between them with equal search ids.
* The facade's own incremental build (its own coder fit) reaches a recall@10
  within 0.02 of the reference facade's.
* ``ShardConfig(strategy="incremental")`` builds every segment that way.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flash as jflash
from repro.graph import backends as jbk
from repro.graph.hnsw import HNSWParams as JParams
from repro.graph.hnsw import build_hnsw as jbuild
from repro.graph.index import AnnIndex as JIndex
from repro_torch.core.flash import query_ctx
from repro_torch.graph import backends as tbk
from repro_torch.graph.engine import PH_BEAM_BASE, PH_BOOTSTRAP, BuildParams
from repro_torch.graph.hnsw import build_hnsw as tbuild
from repro_torch.index import AnnIndex, ShardConfig, ShardedBuilder
from conftest import make_clustered

N, D = 1500, 48
R_BASE = 16
FLASH_KW = dict(d_f=32, l_f=4, h=8, kmeans_iters=8)
PARAMS = dict(r_upper=8, r_base=R_BASE, ef=32, batch=16)

#: (name, n, max_layers, backend kind, m_f, extra params): n ∈ {2, batch − 1,
#: 2·batch + 5, 1,500}, 1 and 3 layers, both Flash backends, m_f ∈ {6, 16},
#: one case each of the ablation modes
CASES = [
    ("n2", 2, 3, "flash_blocked", 16, {}),
    ("batch_minus_1", 15, 1, "flash", 16, {}),
    ("two_batches_plus_5", 37, 3, "flash_blocked", 6, {}),
    ("n1500_l3", N, 3, "flash_blocked", 16, {}),
    ("n1500_l1_flash_m6", N, 1, "flash", 6, {}),
    ("prune_farthest", 300, 3, "flash_blocked", 16, {"prune_mode": "farthest"}),
    ("select_closest", 300, 3, "flash", 6, {"select_mode": "closest"}),
]


@pytest.fixture(scope="module")
def sets():
    x = make_clustered(N + 64, D, seed=3)
    return x[:N], x[N:]


@pytest.fixture(scope="module")
def coders(sets):
    """The reference's fitted blocked backend (coder + codes) per m_f."""
    data, _ = sets
    return {
        m: jbk.make_backend("flash_blocked", jnp.asarray(data), jax.random.PRNGKey(0),
                            r_for_blocked=R_BASE, m_f=m, **FLASH_KW)
        for m in (6, 16)
    }


def _ref_backend(jbe, kind: str, n: int):
    """The reference backend of ``kind`` over the first n rows' codes."""
    codes = jbe.codes[:n]
    if kind == "flash":
        return jbk.FlashBackend(jbe.coder, codes)
    return jbk.FlashBlockedBackend(jbe.coder, codes, jnp.zeros((n,) + jbe.nbr_codes.shape[1:], jnp.uint8))


def _port_backend(jbe, kind: str):
    cls = tbk.FlashBlockedBackend if kind == "flash_blocked" else tbk.FlashBackend
    return cls.from_state({k: np.asarray(v) for k, v in jbe.state_dict().items()}, device="cpu")


def _recall(ids: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1] for a, b in zip(ids, gt)]))


@pytest.mark.parametrize("name,n,layers,kind,m_f,extra", CASES, ids=[c[0] for c in CASES])
def test_incremental_build_is_bit_equal_to_reference(sets, coders, name, n, layers, kind, m_f, extra):
    data = sets[0][:n]
    params = dict(PARAMS, max_layers=layers, **extra)
    jbe = _ref_backend(coders[m_f], kind, n)
    tbe = _port_backend(jbe, kind)
    jctx = jax.vmap(lambda v: jflash.query_ctx(jbe.coder, v))(jnp.asarray(data))
    mismatch = int((query_ctx(tbe.coder, torch.from_numpy(data)).adt_q.numpy() != np.asarray(jctx.adt_q)).sum())
    assert mismatch == 0, f"{mismatch} ADT levels differ from the reference's: the builds cannot be compared bit for bit"

    jidx, jst = jbuild(jnp.asarray(data), jbe, params=JParams(**params), seed=0, strategy="incremental")
    tidx, tst = tbuild(torch.from_numpy(data), tbe, params=BuildParams(**params), seed=0,
                       strategy="incremental")
    np.testing.assert_array_equal(tidx.adj0.numpy(), np.asarray(jidx.adj0))
    np.testing.assert_array_equal(tidx.adj0_d.numpy(), np.asarray(jidx.adj0_d))
    np.testing.assert_array_equal(tidx.adj_up.numpy(), np.asarray(jidx.adj_up))
    np.testing.assert_array_equal(tidx.adj_up_d.numpy(), np.asarray(jidx.adj_up_d))
    assert tidx.adj_up.shape[0] == layers - 1
    np.testing.assert_array_equal(tidx.levels.numpy(), np.asarray(jidx.levels))
    assert tidx.entry == int(jidx.entry)
    if kind == "flash_blocked":
        np.testing.assert_array_equal(tidx.backend.nbr_codes.numpy(), np.asarray(jidx.backend.nbr_codes))
        assert int(tbe.nbr_codes.sum()) == 0  # the build wrote a copy of the mirror
    np.testing.assert_array_equal(np.asarray(tst.phases), np.asarray(jst.phases, np.float64))
    assert (tst.n_dists, tst.n_hops) == (float(jst.n_dists), float(jst.n_hops))
    p = min(PARAMS["batch"], n)
    assert tst.phases[PH_BOOTSTRAP] == p * p
    if n > PARAMS["batch"]:
        assert tst.phases[PH_BEAM_BASE] > 0
    assert {"bootstrap", "insert_batches"} <= set(tst.seconds)


@pytest.fixture(scope="module")
def from_graph_pair(sets, coders):
    """The same incremental graph built by both packages, each wrapped by its
    own ``from_graph``."""
    data, queries = sets
    params = dict(PARAMS, max_layers=3)
    jbe = coders[16]
    jgraph, jst = jbuild(jnp.asarray(data), jbe, params=JParams(**params), seed=0, strategy="incremental")
    tgraph, tst = tbuild(torch.from_numpy(data), _port_backend(jbe, "flash_blocked"),
                         params=BuildParams(**params), seed=0, strategy="incremental")
    jidx = JIndex.from_graph(jgraph, jnp.asarray(data), params=JParams(**params),
                             backend_kind="flash_blocked", stats=jst)
    tidx = AnnIndex.from_graph(tgraph, data, params=BuildParams(**params),
                               backend_kind="flash_blocked", stats=tst, device="cpu")
    return data, queries, jidx, tidx


def test_from_graph_searches_like_the_reference(from_graph_pair):
    _, queries, jidx, tidx = from_graph_pair
    assert tidx.build_strategy == "incremental" and tidx.n == jidx.n
    for ef, width in ((32, 1), (64, 4)):
        want = jidx.search(jnp.asarray(queries), k=10, ef=ef, width=width)
        got = tidx.search(queries, k=10, ef=ef, width=width)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_from_graph_state_round_trips(from_graph_pair, direction):
    _, queries, jidx, tidx = from_graph_pair
    if direction == "port_to_reference":
        meta, arrays = tidx.export_state()
        other = JIndex.restore(meta, arrays)
        ids = np.asarray(other.search(jnp.asarray(queries), k=10, ef=64).ids)
    else:
        meta, arrays = jidx.export_state()
        other = AnnIndex.restore(meta, {k: np.asarray(v) for k, v in arrays.items()}, device="cpu")
        ids = other.search(queries, k=10, ef=64).ids.numpy()
    assert meta["strategy"] == "incremental" and other.build_strategy == "incremental"
    np.testing.assert_array_equal(ids, tidx.search(queries, k=10, ef=64).ids.numpy())


def test_from_graph_checks_device_and_algo(from_graph_pair):
    data, _, _, tidx = from_graph_pair
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AnnIndex.from_graph(tidx.graph, data)  # the default device is the card
    with pytest.raises(NotImplementedError, match="item 6"):
        AnnIndex.from_graph(tidx.graph, data, algo="vamana", device="cpu")


def test_own_incremental_build_recall_matches_reference(sets):
    data, queries = sets
    d2 = ((queries[:, None, :] - data[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1, kind="stable")[:, :10]
    params = dict(PARAMS, max_layers=3)
    kw = dict(FLASH_KW, m_f=16)
    jidx = JIndex.build(jnp.asarray(data), algo="hnsw", backend="flash_blocked",
                        params=JParams(**params), backend_kwargs=kw, strategy="incremental")
    tidx = AnnIndex.build(data, algo="hnsw", backend="flash_blocked", params=BuildParams(**params),
                          backend_kwargs=kw, strategy="incremental", device="cpu")
    for ef in (32, 64):
        r_ref = _recall(np.asarray(jidx.search(jnp.asarray(queries), k=10, ef=ef).ids), gt)
        r_port = _recall(tidx.search(queries, k=10, ef=ef).ids.numpy(), gt)
        assert r_port >= r_ref - 0.02, f"ef={ef}: port {r_port:.4f} vs reference {r_ref:.4f}"
    st = tidx.last_stats
    assert st.n_dists == sum(st.phases) and min(st.phases[:3]) > 0 and st.phases[3] == st.phases[4] == 0
    assert {"coder_fit", "bootstrap", "insert_batches"} <= set(st.seconds)
    assert tidx.build_strategy == "incremental"


def test_sharded_incremental_segments_equal_their_own_builds(sets, tmp_path):
    data, _ = sets
    params = BuildParams(**PARAMS, max_layers=2)
    kw = dict(FLASH_KW, m_f=16)
    res = ShardedBuilder(
        ShardConfig(n_segments=3, chunk_size=256, params=params, strategy="incremental",
                    backend_kwargs=kw, sample_size=600),
        workdir=str(tmp_path), device="cpu",
    ).build(data[:600])
    for s, seg in enumerate(res.index.segments):
        assert seg.build_strategy == "incremental"
        phases = res.segments[s]["phases"]
        assert phases["bootstrap"] > 0 and phases["bulk"] == phases["repair"] == 0
        vecs, _ = res.plan.load_segment(s)
        own = AnnIndex.build(vecs, params=params, backend_kwargs=kw, seed=s, strategy="incremental",
                             device="cpu")
        np.testing.assert_array_equal(seg.graph.adj0.numpy(), own.graph.adj0.numpy())
        np.testing.assert_array_equal(seg.graph.adj_up.numpy(), own.graph.adj_up.numpy())
