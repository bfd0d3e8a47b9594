"""The port's HNSW, Vamana and NSG builds over every backend against the
reference's on random float inputs, on the CPU.

Fitted coders are carried across; recall@10 must be within 0.02 of the
reference's (the share of equal adjacency rows is printed: float sums in
another order may flip a near tie and the builds diverge from there). The
shared inputs are in ``_flat_common.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.graph import backends as jbk
from repro.graph.engine import BuildParams as JParams
from repro.graph.index import AnnIndex as JIndex
from repro_torch.graph import backends as tbk
from repro_torch.graph.engine import BuildParams
from repro_torch.index import AnnIndex
from _flat_common import FLOAT_KW, KINDS, PARAMS, _recall, _state, float_sets  # noqa: F401 (fixture)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("algo", ["hnsw", "vamana", "nsg"])
def test_build_recall_on_float_inputs(float_sets, kind, algo):
    data, queries, gt = float_sets
    jb = jbk.make_backend(kind, jnp.asarray(data), jax.random.PRNGKey(0), **FLOAT_KW[kind])
    tb = tbk.CLASSES[type(jb).__name__].from_state(_state(jb), device="cpu")
    params = dict(PARAMS, alpha=1.2 if algo == "vamana" else 1.0)
    jidx = JIndex.build(jnp.asarray(data), algo=algo, backend=jb, params=JParams(**params))
    tidx = AnnIndex.build(data, algo=algo, backend=tb, params=BuildParams(**params), device="cpu")
    key = "adj0" if algo == "hnsw" else "adj"
    same = float((tidx.export_state()[1][key] == np.asarray(jidx.export_state()[1][key])).all(1).mean())
    r_t = _recall(tidx.search(queries, k=10, ef=32).ids.numpy(), gt)
    r_j = _recall(np.asarray(jidx.search(jnp.asarray(queries), k=10, ef=32).ids), gt)
    print(f"{algo}/{kind}: recall@10 port {r_t:.4f} reference {r_j:.4f}, equal rows {same:.4f}")
    assert abs(r_t - r_j) <= 0.02
