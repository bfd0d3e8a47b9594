"""The n = 1,500, 3-layer incremental build (``n1500_l3``) bit-equal to the
reference's, and ``AnnIndex.from_graph`` over that same pair of builds:
the facade wraps a built graph in either package, and the state
round-trips between them with equal search ids. One build of each
package serves both (``_incremental_common.build_pair``; the other cases
are in ``test_torch_incremental.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from repro.graph.hnsw import HNSWParams as JParams
from repro.graph.index import AnnIndex as JIndex
from repro_torch.graph.engine import BuildParams
from repro_torch.index import AnnIndex
from _incremental_common import CASES, build_pair, check_bit_equal, coders, sets  # noqa: F401 (fixtures)
from _threads import one_torch_thread  # noqa: F401 (autouse fixture)

N1500 = [c for c in CASES if c[0] == "n1500_l3"]


@pytest.fixture(scope="module")
def n1500(sets, coders):
    return build_pair(sets, coders, N1500[0])


@pytest.mark.parametrize("name,n,layers,kind,m_f,extra", N1500, ids=[c[0] for c in N1500])
def test_incremental_build_is_bit_equal_to_reference(n1500, name, n, layers, kind, m_f, extra):
    assert n1500.case == (name, n, layers, kind, m_f, extra)
    check_bit_equal(n1500)


@pytest.fixture(scope="module")
def from_graph_pair(sets, n1500):
    """The n1500_l3 graphs of both packages, each wrapped by its own
    ``from_graph``."""
    data, queries = sets
    params = n1500.params
    jidx = JIndex.from_graph(n1500.jidx, jnp.asarray(data), params=JParams(**params),
                             backend_kind="flash_blocked", stats=n1500.jst)
    tidx = AnnIndex.from_graph(n1500.tidx, data, params=BuildParams(**params),
                               backend_kind="flash_blocked", stats=n1500.tst, device="cpu")
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
    with pytest.raises(ValueError, match="FlatIndex"):  # a flat algorithm takes a flat graph
        AnnIndex.from_graph(tidx.graph, data, algo="vamana", device="cpu")
