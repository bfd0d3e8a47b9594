"""The port's incremental build through the facade against the
reference's (the bit-for-bit builds are in ``test_torch_incremental.py``
and ``test_torch_incremental_graph.py``).

* The facade's own incremental build (its own coder fit) reaches a recall@10
  within 0.02 of the reference facade's.
* ``ShardConfig(strategy="incremental")`` builds every segment that way.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from repro.graph.hnsw import HNSWParams as JParams
from repro.graph.index import AnnIndex as JIndex
from repro_torch.graph.engine import BuildParams
from repro_torch.index import AnnIndex, ShardConfig, ShardedBuilder
from _incremental_common import FLASH_KW, PARAMS, recall, sets  # noqa: F401 (fixture)
from _threads import one_torch_thread  # noqa: F401 (autouse fixture)


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
        r_ref = recall(np.asarray(jidx.search(jnp.asarray(queries), k=10, ef=ef).ids), gt)
        r_port = recall(tidx.search(queries, k=10, ef=ef).ids.numpy(), gt)
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
