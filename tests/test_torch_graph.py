"""The port's graph layer against the reference package's, bit for bit.

* Batched ``beam_search`` (fused and unfused, W ∈ {1, 4, 8}) and
  ``greedy_descent`` on a reference-built index restored into the port,
  fed the reference's query tables, equal the reference's ``vmap`` on ids,
  integer-level distances and both cost counters.
* ``select_neighbors`` / ``prune_list`` give equal selections.
* The whole bulk build (``build_hnsw(strategy="bulk")``), started from the
  reference's fitted coder and codes, gives bit-equal ``adj0``/``adj_up``,
  an equal mirror and equal per-phase ``n_dists`` — the params are small
  enough that reachability repair re-inserts vertices, so the incremental
  engine (beam, selection, forward and reverse commits) runs too. The port
  builds its own query tables; the test measures their level mismatches
  against the reference's first and, should there be any, holds ≥ 99% of
  adjacency rows equal instead of all (it says so in its message).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flash as jflash
from repro.graph import backends as jbk
from repro.graph import beam as jbeam
from repro.graph import select as jselect
from repro.graph.hnsw import HNSWParams as JParams
from repro.graph.hnsw import build_hnsw as jbuild
from repro_torch.core.flash import FlashQueryCtx, query_ctx
from repro_torch.graph import backends as tbk
from repro_torch.graph import beam as tbeam
from repro_torch.graph import select as tselect
from repro_torch.graph.engine import BuildParams
from repro_torch.graph.hnsw import build_hnsw as tbuild
from conftest import make_clustered

FLASH_KW = dict(d_f=32, m_f=16, l_f=4, h=8, kmeans_iters=8)
PARAMS = dict(r_upper=8, r_base=16, ef=32, batch=16, max_layers=2)


@pytest.fixture(scope="module")
def ref_build():
    """Reference backend before the build, the built index and its stats."""
    x = make_clustered(2064, 48, seed=0)
    data, queries = x[:2000], x[2000:]
    be = jbk.make_backend("flash_blocked", jnp.asarray(data), jax.random.PRNGKey(0),
                          r_for_blocked=PARAMS["r_base"], **FLASH_KW)
    index, stats = jbuild(jnp.asarray(data), be, params=JParams(**PARAMS), seed=0, strategy="bulk")
    return data, queries, be, index, stats


def _port_backend(jbe) -> tbk.FlashBlockedBackend:
    return tbk.FlashBlockedBackend.from_state(
        {k: np.asarray(v) for k, v in jbe.state_dict().items()}, device="cpu"
    )


def _ref_ctx(jbe, x: np.ndarray):
    ref = jax.vmap(lambda v: jflash.query_ctx(jbe.coder, v))(jnp.asarray(x))
    port = FlashQueryCtx(*(torch.from_numpy(np.array(a)) for a in ref))
    return ref, port


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("width", [1, 4, 8])
def test_beam_search_matches_reference(ref_build, width, fused):
    data, queries, _, jidx, _ = ref_build
    tbe = _port_backend(jidx.backend)
    jctx, tctx = _ref_ctx(jidx.backend, queries)
    rng = np.random.default_rng(width)
    entries = rng.integers(0, len(data), len(queries)).astype(np.int32)
    ef = 32

    def one(qc, e):
        return jbeam.beam_search(jidx.backend, qc, jidx.adj0, e[None], ef=ef, width=width,
                                 fused=fused)

    ref = jax.jit(jax.vmap(one))(jctx, jnp.asarray(entries))
    got = tbeam.beam_search(tbe, tctx, torch.from_numpy(np.array(jidx.adj0)),
                            torch.from_numpy(entries)[:, None], ef=ef, width=width, fused=fused)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(ref.dists))
    np.testing.assert_array_equal(got.n_dists.numpy(), np.asarray(ref.n_dists))
    np.testing.assert_array_equal(got.n_hops.numpy(), np.asarray(ref.n_hops))


def test_greedy_descent_matches_reference(ref_build):
    data, queries, _, jidx, _ = ref_build
    tbe = _port_backend(jidx.backend)
    jctx, tctx = _ref_ctx(jidx.backend, queries)
    entries = np.full(len(queries), int(jidx.entry), np.int32)
    adj = jidx.adj_up[0]
    ref = jax.vmap(lambda qc, e: jbeam.greedy_descent(jidx.backend, qc, adj, e))(
        jctx, jnp.asarray(entries)
    )
    got = tbeam.greedy_descent(tbe, tctx, torch.from_numpy(np.array(adj)), torch.from_numpy(entries))
    np.testing.assert_array_equal(got.node.numpy(), np.asarray(ref.node))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
    np.testing.assert_array_equal(got.n_dists.numpy(), np.asarray(ref.n_dists))


@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_select_and_prune_match_reference(ref_build, alpha):
    data, _, jbe, _, _ = ref_build
    tbe = _port_backend(jbe)
    rng = np.random.default_rng(int(alpha * 10))
    rows, c, r = 40, 48, 16
    ids = np.stack([rng.choice(len(data), c, replace=False) for _ in range(rows)]).astype(np.int32)
    ids[rng.random((rows, c)) < 0.1] = -1
    jctx, tctx = _ref_ctx(jbe, data[:rows])
    d = np.asarray(jax.vmap(jbe.query_dists)(jctx, jnp.asarray(np.maximum(ids, 0))))
    d = np.where(ids >= 0, d, np.inf).astype(np.float32)
    # unsorted rows for prune_list (both modes)
    for mode in ("heuristic", "farthest"):
        ref = jax.vmap(lambda a, b: jselect.prune_list(jbe, a, b, r=r, alpha=alpha, mode=mode))(
            jnp.asarray(ids), jnp.asarray(d)
        )
        got = tselect.prune_list(tbe, torch.from_numpy(ids), torch.from_numpy(d), r=r,
                                 alpha=alpha, mode=mode)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
        np.testing.assert_array_equal(got.dists.numpy(), np.asarray(ref.dists))
        np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    # sorted rows for select_neighbors, including a candidate list shorter than r
    order = np.argsort(d, axis=1, kind="stable")
    ids_s = np.take_along_axis(ids, order, 1)[:, :12]
    d_s = np.take_along_axis(d, order, 1)[:, :12]
    ref = jax.vmap(lambda a, b: jselect.select_neighbors(jbe, a, b, r=r, alpha=alpha))(
        jnp.asarray(ids_s), jnp.asarray(d_s)
    )
    got = tselect.select_neighbors(tbe, torch.from_numpy(ids_s), torch.from_numpy(d_s), r=r, alpha=alpha)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))


def test_bulk_build_is_bit_equal_to_reference(ref_build):
    data, _, jbe, jidx, jstats = ref_build
    tbe = _port_backend(jbe)
    # how far the port's own query tables are from the reference's here
    jctx = jax.vmap(lambda v: jflash.query_ctx(jbe.coder, v))(jnp.asarray(data))
    own = query_ctx(tbe.coder, torch.from_numpy(data))
    level_mismatch = int((own.adt_q.numpy() != np.asarray(jctx.adt_q)).sum())

    index, stats = tbuild(torch.from_numpy(data), tbe, params=BuildParams(**PARAMS), seed=0,
                          strategy="bulk")
    assert stats.phases[4] > 0, "repair did not run: the test would not cover insert_batch"
    ref_phases = np.asarray(jstats.phases, np.float64)
    adj0, ref_adj0 = index.adj0.numpy(), np.asarray(jidx.adj0)
    if level_mismatch == 0:
        np.testing.assert_array_equal(adj0, ref_adj0)
        np.testing.assert_array_equal(index.adj_up.numpy(), np.asarray(jidx.adj_up))
        np.testing.assert_array_equal(index.adj0_d.numpy(), np.asarray(jidx.adj0_d))
        np.testing.assert_array_equal(index.backend.nbr_codes.numpy(),
                                      np.asarray(jidx.backend.nbr_codes))
        np.testing.assert_array_equal(np.asarray(stats.phases), ref_phases)
        assert stats.n_hops == float(jstats.n_hops)
        assert index.entry == int(jidx.entry)
    else:
        same = float((adj0 == ref_adj0).all(1).mean())
        assert same >= 0.99, (
            f"{level_mismatch} ADT levels differ from the reference's; only "
            f"{same:.4f} of adjacency rows are identical"
        )
    # the backend handed in is untouched: the build wrote a copy of its mirror
    assert int(tbe.nbr_codes.sum()) == 0


@pytest.mark.parametrize("max_passes", [0, 1])
def test_repair_matches_reference_on_cut_islands(ref_build, max_passes):
    """Cut every in-edge of 70 vertices, then repair. max_passes=0 runs the
    structural graft stage alone; max_passes=1 re-inserts first (5 batches
    of 16, padded to 8 as the reference pads them)."""
    from repro.graph import engine as jeng
    from repro_torch.graph import engine as teng

    data, _, _, jidx, _ = ref_build
    n = len(data)
    rng = np.random.default_rng(11)
    cut = np.zeros(n, bool)
    cut[rng.choice(np.delete(np.arange(n), int(jidx.entry)), 70, replace=False)] = True
    adj = np.array(jidx.adj0)
    adj_d = np.array(jidx.adj0_d)
    drop = (adj >= 0) & cut[np.maximum(adj, 0)] & ~cut[:, None]
    adj[drop], adj_d[drop] = -1, np.inf
    order = np.argsort(adj < 0, axis=1, kind="stable")  # keep rows packed
    adj, adj_d = np.take_along_axis(adj, order, 1), np.take_along_axis(adj_d, order, 1)
    jbe = jidx.backend.with_updated_edges(jnp.arange(n), jnp.asarray(adj))
    params = BuildParams(**PARAMS)
    ref = jeng.repair_reachability(
        jnp.asarray(data), jnp.asarray(adj), jnp.asarray(adj_d), jidx.adj_up, jidx.adj_up_d,
        jbe, jidx.levels, int(jidx.entry), params=JParams(**PARAMS), max_passes=max_passes,
    )
    tbe = _port_backend(jbe)
    got = teng.repair_reachability(
        torch.from_numpy(data), torch.from_numpy(adj), torch.from_numpy(adj_d),
        torch.from_numpy(np.array(jidx.adj_up)), torch.from_numpy(np.array(jidx.adj_up_d)),
        tbe, torch.from_numpy(np.array(jidx.levels)), int(jidx.entry), params=params,
        max_passes=max_passes,
    )
    assert got[7][0] >= 70  # (vertices reached only through the cut ones too)
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got[4].nbr_codes.numpy(), np.asarray(ref[4].nbr_codes))
    assert (got[5], got[6]) == (float(ref[5]), float(ref[6]))


def test_engine_select_one_matches_reference(ref_build):
    from repro.graph.engine import BuildEngine as JEngine
    from repro_torch.graph.engine import BuildEngine

    data, _, jbe, _, _ = ref_build
    tbe = _port_backend(jbe)
    ids = np.arange(100, 140, dtype=np.int32)
    jctx, _ = _ref_ctx(jbe, data[:1])
    d = np.asarray(jbe.query_dists(jax.tree.map(lambda a: a[0], jctx), jnp.asarray(ids)))
    order = np.argsort(d, kind="stable")
    ids, d = ids[order], d[order].astype(np.float32)
    for mode in ("heuristic", "closest"):
        ref = JEngine(JParams(**PARAMS, select_mode=mode)).select_one(
            jbe, jnp.asarray(ids), jnp.asarray(d), r=16)
        got = BuildEngine(BuildParams(**PARAMS, select_mode=mode)).select_one(
            tbe, torch.from_numpy(ids), torch.from_numpy(d), r=16)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
        np.testing.assert_array_equal(got.dists.numpy(), np.asarray(ref.dists))
