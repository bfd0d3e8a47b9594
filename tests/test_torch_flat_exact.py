"""Every algorithm × strategy × backend build of the port against the
reference's, on exactly representable inputs, on the CPU.

Integer rows in [−8, 8] with hand-made coders (PQ with integer codebooks,
SQ with s2 = 1, PCA with a zero mean and identity columns; fp32 as is;
Flash with the reference's coder, whose distances are integer level sums).
Every distance is an exact float32 integer, so HNSW (bulk, incremental),
Vamana (incremental with and without the second pass, bulk) and NSG
(incremental with the reference's k-NN graph carried across, bulk) must
give bit-equal graphs, distances, entries and n_dists over every backend,
and equal search ids and exact rerank distances (reconstruct rerank
distances of decoded, non-integer vectors: allclose at rtol 1e-5). The
shared inputs are in ``_flat_common.py``; the other flat tests in
``test_torch_flat.py`` and ``test_torch_flat_float.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.engine import BuildParams as JParams
from repro.graph.index import AnnIndex as JIndex
from repro.graph.nsg import build_nsg as j_build_nsg
from repro_torch.graph.engine import BuildParams
from repro_torch.graph.nsg import build_nsg
from repro_torch.index import AnnIndex
from _flat_common import CASES, KINDS, PARAMS, _graph_arrays, exact_pair, int_rows  # noqa: F401 (fixture)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("algo,strategy,kw", CASES, ids=[f"{a}-{s}-{k}" for a, s, k in CASES])
def test_build_bit_equal_on_exact_inputs(int_rows, kind, algo, strategy, kw):
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
