"""The port's index maintenance (``AnnIndex.add``/``delete``/``compact``/
``clone``) against the reference facade's, on the CPU.

The reference builds an index; the port restores it from the reference's
``export_state``. Both sides then ``add`` 300 vectors, ``delete`` 50 ids and
``compact``. After each step the graph (``adj0``/``adj_up``, ``levels``,
``entry``), the blocked mirror and the step's ``n_dists`` must be bit-equal,
and searches must return equal ids with the tombstones struck. The new
vectors' codes and query tables come from each package's own encoder; on
these seeded sets they agree (0 mismatches, ``test_torch_core.py``), which
the bit-equality here depends on.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.engine import BuildParams as JParams
from repro.graph.index import AnnIndex as JIndex
from repro_torch.index import AnnIndex
from conftest import make_clustered

FLASH_KW = dict(d_f=32, m_f=16, l_f=4, h=8, kmeans_iters=8)
PARAMS = dict(r_upper=8, r_base=16, ef=32, batch=16, max_layers=3)
N0, N_ADD, N_DEL = 1000, 300, 50


def _port_of(jidx) -> AnnIndex:
    meta, arrays = jidx.export_state()
    return AnnIndex.restore(meta, {k: np.asarray(v) for k, v in arrays.items()}, device="cpu")


def _assert_same_state(port: AnnIndex, ref_state):
    meta, arrays = port.export_state()
    jmeta, jarrays = ref_state
    assert meta["n_adds"] == jmeta["n_adds"]
    for key in ("adj0", "adj_up", "levels", "entry", "tombs", "retired", "backend.codes",
                "backend.nbr_codes"):
        np.testing.assert_array_equal(arrays[key], np.asarray(jarrays[key]), err_msg=key)
    for key in ("adj0_d", "adj_up_d", "data"):
        np.testing.assert_array_equal(arrays[key], np.asarray(jarrays[key]), err_msg=key)


def _assert_same_search(port: AnnIndex, jidx, queries):
    for width in (1, 4):
        got = port.search(queries, k=10, ef=48, width=width)
        want = jidx.search(jnp.asarray(queries), k=10, ef=48, width=width)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), rtol=1e-5, atol=1e-4)
        dead = np.nonzero(port.tombstones)[0]
        assert not np.isin(got.ids.numpy(), dead).any()


@pytest.fixture(scope="module")
def steps():
    """Both sides after each maintenance step: {step: (port, the
    reference's export_state, (port stats, reference stats))}."""
    x = make_clustered(N0 + N_ADD + 32, 32, seed=11)
    base, new, queries = x[:N0], x[N0:N0 + N_ADD], x[N0 + N_ADD:]
    jidx = JIndex.build(jnp.asarray(base), algo="hnsw", backend="flash_blocked",
                        params=JParams(**PARAMS), backend_kwargs=FLASH_KW, strategy="bulk")
    port = _port_of(jidx)
    out = {"restore": (port.clone(), jidx.export_state(), None)}
    j_add = jidx.add(jnp.asarray(new))
    p_add = port.add(new)
    out["add"] = (port.clone(), jidx.export_state(), (p_add, j_add))
    dead = np.random.default_rng(3).choice(N0 + N_ADD, N_DEL, replace=False)
    assert port.delete(dead) == jidx.delete(dead) == N_DEL
    out["delete"] = (port.clone(), jidx.export_state(), None)
    p_cmp = port.compact()
    j_cmp = jidx.compact()
    out["compact"] = (port, jidx.export_state(), (p_cmp, j_cmp))
    return out, queries


@pytest.mark.parametrize("step", ["add", "delete", "compact"])
def test_state_bit_equal_after_each_step(steps, step):
    out, _ = steps
    port, ref_state, stats = out[step]
    _assert_same_state(port, ref_state)
    if stats is not None:
        p, j = stats
        assert p.n_dists == float(j.n_dists) and p.n_dists > 0
        assert p.n_hops == float(j.n_hops)


@pytest.mark.parametrize("step", ["add", "delete", "compact"])
def test_search_equal_after_each_step(steps, step):
    out, queries = steps
    port, ref_state, _ = out[step]
    _assert_same_search(port, JIndex.restore(*ref_state), queries)


def test_counts_and_growth_state(steps):
    out, _ = steps
    port = out["compact"][0]
    assert port.n == N0 + N_ADD and port.n_active == N0 + N_ADD - N_DEL
    assert port.tombstones.sum() == 0 and port.deleted_ids.size == 0
    assert port.health() == {"healthy": True, "degraded": False, "n": port.n,
                             "n_active": port.n_active}
    deleted = out["delete"][0]
    assert deleted.deleted_ids.size == N_DEL and deleted.n_active == N0 + N_ADD - N_DEL


def test_clone_is_independent(steps):
    out, queries = steps
    src = out["add"][0]
    twin = src.clone()
    before = src.export_state()[1]
    twin.delete(np.arange(20))
    twin.compact()
    twin.add(queries[:5])
    after = src.export_state()[1]
    for key, arr in before.items():
        np.testing.assert_array_equal(after[key], arr, err_msg=key)
    assert twin.n == src.n + 5


def test_port_state_searches_equal_in_the_reference(steps):
    out, queries = steps
    port = out["compact"][0]
    jidx = JIndex.restore(*port.export_state())
    got = port.search(queries, k=10, ef=64, width=4)
    want = jidx.search(jnp.asarray(queries), k=10, ef=64, width=4)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))


def test_restore_then_add_continues_the_level_draws(steps):
    """``n_adds`` rides the state: an add after a restore draws the same
    levels on both sides (seed + 7919·n_adds)."""
    out, queries = steps
    port, ref_state, _ = out["add"]
    jref = JIndex.restore(*ref_state)
    port = port.clone()
    port.add(queries[:16])
    jref.add(jnp.asarray(queries[:16]))
    _assert_same_state(port, jref.export_state())


def test_add_rejects_a_wrong_dim_and_delete_out_of_range(steps):
    port = steps[0]["restore"][0]
    with pytest.raises(ValueError, match="dim mismatch"):
        port.add(np.zeros((2, 7), np.float32))
    with pytest.raises(IndexError):
        port.delete([port.n])
    assert port.add(np.zeros((0, 32), np.float32)).n_dists == 0.0
    assert isinstance(port.data, torch.Tensor)
