"""The paper's own ``flash-ann`` workload in the port (``configs/registry``'s
rest, ``graph/segmented.py``'s single-card programs) against the
reference's, on the CPU at the reduced ``flash-ann`` config (D 64, d_f 32,
M 16, 4-bit, H 8): 2 segments of 1,000 rows and 64 queries.

* Registry: every entry (family, notes, full and reduced configs, shapes),
  ``FLASH_ANN_SHAPES`` and ``assigned_cells()`` equal the reference's; an
  unknown id raises ``KeyError``.
* Segments: from the reference's shared coder (carried by
  ``FlashBackend.from_state``) and the same level and entry plans,
  ``build_segments_vmapped`` and ``build_segment`` are bit-equal to the
  reference's (adj0 and its distances, adj_up and its distances, levels,
  entry, codes).
* Search: ``search_segment`` (with and without rerank vectors) and
  ``search_segments_local`` (with and without ``seg_vectors``) on those
  indexes give the reference's ids; distances within rtol 1e-5.
* Coder fit: the port's own ``fit_shared_coder`` (its own k-means draws)
  reaches a mean reconstruction error within 5% of the reference fit's,
  and its segments' fan-out recall@10 within 0.02 of the reference's.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data.synthetic import vector_dataset
from repro.graph import backends as jbk
from repro.graph import segmented as jseg
from repro.graph.hnsw import HNSWParams, prefix_entries, sample_levels
from repro.graph.knn import exact_knn
from repro_torch.configs import registry as treg
from repro_torch.graph import backends as tbk
from repro_torch.graph import segmented as tseg
from repro_torch.graph.engine import BuildParams
from _threads import one_torch_thread  # noqa: F401 (autouse fixture)

S, NS, Q, K, EF = 2, 1000, 64, 10, 48
PARAMS = dict(r_upper=8, r_base=16, ef=48, batch=32, max_layers=3)
KMEANS_ITERS = 12
RECALL_TOL = 0.02


def _coder_kw():
    cfg = treg.get_arch("flash-ann").make_reduced()
    return {k: cfg[k] for k in ("d_f", "m_f", "l_f", "h")}


@pytest.fixture(scope="module")
def sets():
    dim = treg.get_arch("flash-ann").make_reduced()["dim"]
    x = vector_dataset(0, n=S * NS + Q, d=dim, n_clusters=64)
    base, queries = x[:S * NS], x[S * NS:]
    levels = np.stack([sample_levels(s, NS, r_upper=PARAMS["r_upper"], max_layers=PARAMS["max_layers"])
                       for s in range(S)])
    entries = np.stack([prefix_entries(levels[s], PARAMS["batch"]) for s in range(S)])
    gt = np.asarray(exact_knn(jnp.asarray(queries), jnp.asarray(base), k=K)[0])
    return base.reshape(S, NS, dim), queries, levels, entries, gt


@pytest.fixture(scope="module")
def built(sets):
    """(reference coder, reference stacked build, the port's from the same coder)."""
    segs, _, levels, entries, _ = sets
    jcoder = jseg.fit_shared_coder(jax.random.PRNGKey(0), jnp.asarray(segs.reshape(S * NS, -1)),
                                   kmeans_iters=KMEANS_ITERS, **_coder_kw())
    jb = jseg.build_segments_vmapped(jnp.asarray(segs), jcoder, jnp.asarray(levels), jnp.asarray(entries),
                                     params=HNSWParams(**PARAMS))
    state = {k: np.asarray(v) for k, v in jbk.FlashBackend(jcoder, jb.index.backend.codes[0]).state_dict().items()}
    tcoder = tbk.FlashBackend.from_state(state, device="cpu").coder
    tb = tseg.build_segments_vmapped(torch.from_numpy(segs), tcoder, levels, entries, params=BuildParams(**PARAMS))
    return jcoder, tcoder, jb, tb


def _recall(ids, gt) -> float:
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1] for a, b in zip(np.asarray(ids), gt)]))


def _assert_index_equal(t, j):
    for f in ("adj0", "adj0_d", "adj_up", "adj_up_d", "levels"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    np.testing.assert_array_equal(np.asarray(t.entry), np.asarray(j.entry))


# ---- registry ---------------------------------------------------------------


def _dtype_name(v) -> str:
    return str(v).removeprefix("torch.") if isinstance(v, torch.dtype) else np.dtype(v).name


def _fields(cfg) -> dict:
    """The config's fields, dtypes by name (torch's and jax.numpy's differ)."""
    return {k: _dtype_name(v) if k in ("dtype", "param_dtype") else v for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("arch", list(jreg.REGISTRY))
def test_registry_entry_matches_reference(arch):
    t, j = treg.get_arch(arch), jreg.get_arch(arch)
    assert (t.arch_id, t.family, t.notes) == (j.arch_id, j.family, j.notes)
    for make in ("make_full", "make_reduced"):
        got, want = getattr(t, make)(), getattr(j, make)()
        if isinstance(want, dict):
            assert got == want
        else:
            assert type(got).__name__ == type(want).__name__
            assert _fields(got) == _fields(want)
    assert [(s.name, s.kind, s.dims) for s in t.shapes] == [(s.name, s.kind, s.dims) for s in j.shapes]


def test_registry_ids_shapes_and_cells_match_reference():
    assert list(treg.REGISTRY) == list(jreg.REGISTRY)
    assert [(s.name, s.kind, s.dims) for s in treg.FLASH_ANN_SHAPES] == [
        (s.name, s.kind, s.dims) for s in jreg.FLASH_ANN_SHAPES]
    cells = treg.assigned_cells()
    assert cells == jreg.assigned_cells() and len(cells) == 40
    assert not any(a == "flash-ann" for a, _ in cells)
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_arch("no-such-arch")


# ---- segments ---------------------------------------------------------------


def test_build_segments_vmapped_is_bit_equal(built):
    _, _, jb, tb = built
    assert tb.n_segments == S
    _assert_index_equal(tb.index, jb.index)
    np.testing.assert_array_equal(tb.index.backend.codes.numpy(), np.asarray(jb.index.backend.codes))


def test_build_segment_is_bit_equal(sets, built):
    segs, _, levels, entries, _ = sets
    jcoder, tcoder, _, tb = built
    s = S - 1
    j = jax.jit(lambda d, lv, en: jseg.build_segment(d, jcoder, lv, en, params=HNSWParams(**PARAMS)))(
        jnp.asarray(segs[s]), jnp.asarray(levels[s]), jnp.asarray(entries[s]))
    t = tseg.build_segment(torch.from_numpy(segs[s]), tcoder, levels[s], entries[s], params=BuildParams(**PARAMS))
    _assert_index_equal(t, j)
    _assert_index_equal(tb.segment(s), j)
    np.testing.assert_array_equal(t.backend.codes.numpy(), np.asarray(j.backend.codes))


# ---- search -----------------------------------------------------------------


@pytest.mark.parametrize("rerank", [False, True], ids=["quantized", "reranked"])
def test_search_segment_matches_reference(sets, built, rerank):
    segs, queries, *_ = sets
    _, _, jb, tb = built
    s = S - 1
    jidx = jax.tree_util.tree_map(lambda x: x[s], jb.index)
    vec = dict(rerank_vectors=jnp.asarray(segs[s])) if rerank else {}
    jg, jd = jseg.search_segment(jidx, jnp.asarray(queries), k=K, ef_search=EF, id_offset=jnp.int32(s * NS), **vec)
    vec = dict(rerank_vectors=torch.from_numpy(segs[s])) if rerank else {}
    tg, td = tseg.search_segment(tb.segment(s), torch.from_numpy(queries), k=K, ef_search=EF, id_offset=s * NS,
                                 **vec)
    assert tg.dtype == torch.int32
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    assert int(tg.min()) >= s * NS


@pytest.mark.parametrize("rerank", [False, True], ids=["quantized", "seg_vectors"])
def test_search_segments_local_matches_reference(sets, built, rerank):
    segs, queries, _, _, gt = sets
    _, _, jb, tb = built
    sizes = np.full(S, NS)
    jv = dict(seg_vectors=jnp.asarray(segs)) if rerank else {}
    jg, jd = jseg.search_segments_local(jb, jnp.asarray(queries), sizes, k=K, ef_search=EF, **jv)
    tv = dict(seg_vectors=torch.from_numpy(segs)) if rerank else {}
    tg, td = tseg.search_segments_local(tb, torch.from_numpy(queries), sizes, k=K, ef_search=EF, **tv)
    assert tuple(tg.shape) == (Q, K) and tg.dtype == torch.int32
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    if rerank:
        assert _recall(tg.numpy(), gt) > 0.5


# ---- the coder fit ----------------------------------------------------------


def _recon_error(coder, data: np.ndarray) -> float:
    """Mean L2 error of decode(encode(x)) in the input space, one numpy
    formula for both packages' coders (their ``state_dict`` keys)."""
    state = {k[len("coder."):]: np.asarray(v, np.float64) for k, v in coder.items() if k.startswith("coder.")}
    codes = np.asarray(coder["codes"])
    cb = state["codebooks"]
    z_hat = cb[np.arange(cb.shape[0])[None, :], codes].reshape(len(codes), -1)
    return float(np.linalg.norm(data - (z_hat @ state["rot"].T + state["mean"]), axis=1).mean())


def test_fit_shared_coder_reaches_reference_quality(sets, built):
    segs, queries, levels, entries, gt = sets
    jcoder, _, jb, _ = built
    flat = segs.reshape(S * NS, -1)
    own = tseg.fit_shared_coder(0, flat, kmeans_iters=KMEANS_ITERS, device="cpu", **_coder_kw())
    own_codes = tseg.fl.encode(own, torch.from_numpy(flat))
    err_own = _recon_error(tbk.FlashBackend(own, own_codes).state_dict(), flat)
    ref_codes = jnp.asarray(jb.index.backend.codes).reshape(S * NS, -1)
    err_ref = _recon_error({k: np.asarray(v) for k, v in jbk.FlashBackend(jcoder, ref_codes).state_dict().items()},
                           flat)
    assert err_own <= 1.05 * err_ref, f"port {err_own:.4f} vs reference {err_ref:.4f}"

    tb = tseg.build_segments_vmapped(torch.from_numpy(segs), own, levels, entries, params=BuildParams(**PARAMS))
    tg, _ = tseg.search_segments_local(tb, torch.from_numpy(queries), np.full(S, NS), k=K, ef_search=EF,
                                       seg_vectors=torch.from_numpy(segs))
    jg, _ = jseg.search_segments_local(jb, jnp.asarray(queries), np.full(S, NS), k=K, ef_search=EF,
                                       seg_vectors=jnp.asarray(segs))
    r_own, r_ref = _recall(tg.numpy(), gt), _recall(jg, gt)
    assert abs(r_own - r_ref) <= RECALL_TOL, f"fan-out recall@10: port {r_own:.4f} vs reference {r_ref:.4f}"
