"""The incremental build at the size ``chip_smoke.py`` measures it, on the
CPU in both packages: a witness for its recall against the bulk build's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/witness_incremental_scale.py [--n 16000]

The rows are the first ``--n`` of the smoke's draw
(``vector_dataset(0, n=501,000, d=128, n_clusters=64)``), the coder the
smoke's (d_f = 64, M = 16, 4-bit, H = 8), fitted by the reference and
carried to the port with ``FlashBlockedBackend.from_state``, and the
parameters ``BuildParams()`` (batch 32, so ⌈n/32⌉ − 1 insert batches).
It prints, as one JSON line:

* how many query-table levels the two packages' ``query_ctx`` disagree on;
* whether the port's ``build_hnsw(strategy="incremental")`` equals the
  reference's (``adj0``, ``adj_up``, ``levels``, ``entry``, n_dists by
  phase) and both builds' seconds;
* the reference's recall@10 (exact rerank, W = 1, ef ∈ {64, 256}) on the
  smoke's 1,000 held-out queries for its incremental build and for its
  bulk build from the same coder: the gap between the two strategies as
  the reference itself shows it.

Not a pytest module (it takes about four minutes on 8 cores); the
bit-equality it checks at scale is held at small sizes by
``test_torch_incremental.py``. Exits 1 where the two builds differ.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import flash as jflash
from repro.graph import backends as jbk
from repro.graph.hnsw import HNSWParams as JParams
from repro.graph.hnsw import build_hnsw as jbuild
from repro.graph.index import AnnIndex as JIndex
from repro.graph.knn import exact_knn, recall_at_k
from repro_torch.core.flash import query_ctx
from repro_torch.data.synthetic import vector_dataset
from repro_torch.graph import backends as tbk
from repro_torch.graph.engine import PHASE_NAMES, BuildParams
from repro_torch.graph.hnsw import build_hnsw as tbuild

MAIN_N = 500_000  # the smoke's main path: its draw holds these rows and 1,000 queries
QUERIES = 1000


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16000, help="rows of the incremental build")
    n = ap.parse_args().n
    allx = vector_dataset(0, n=MAIN_N + QUERIES, d=128, n_clusters=64)
    data, queries = allx[:n].copy(), allx[MAIN_N:].copy()
    del allx
    jdata = jnp.asarray(data)
    jbe = jbk.make_backend("flash_blocked", jdata, jax.random.PRNGKey(0), r_for_blocked=BuildParams().r_base,
                           d_f=64, m_f=16, l_f=4, h=8)
    tbe = tbk.FlashBlockedBackend.from_state({k: np.asarray(v) for k, v in jbe.state_dict().items()}, device="cpu")
    jctx = jax.vmap(lambda v: jflash.query_ctx(jbe.coder, v))(jdata)
    mismatch = int((query_ctx(tbe.coder, torch.from_numpy(data)).adt_q.numpy() != np.asarray(jctx.adt_q)).sum())

    t0 = time.perf_counter()
    jg, jst = jbuild(jdata, jbe, params=JParams(), seed=0, strategy="incremental")
    jax.block_until_ready(jg.adj0)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tg, tst = tbuild(torch.from_numpy(data), tbe, params=BuildParams(), seed=0, strategy="incremental")
    port_s = time.perf_counter() - t0
    equal = {
        "adj0": bool(np.array_equal(tg.adj0.numpy(), np.asarray(jg.adj0))),
        "adj_up": bool(np.array_equal(tg.adj_up.numpy(), np.asarray(jg.adj_up))),
        "levels": bool(np.array_equal(tg.levels.numpy(), np.asarray(jg.levels))),
        "entry": tg.entry == int(jg.entry),
        "n_dists_by_phase": list(tst.phases) == [float(v) for v in np.asarray(jst.phases)],
    }

    gt = exact_knn(jnp.asarray(queries), jdata, k=10)[0]
    jb, _ = jbuild(jdata, jbe, params=JParams(), seed=0, strategy="bulk")
    recall = {}
    for strategy, graph in (("incremental", jg), ("bulk", jb)):
        index = JIndex.from_graph(graph, jdata, backend_kind="flash_blocked", params=JParams(), strategy=strategy)
        recall[strategy] = {f"ef{ef}": recall_at_k(index.search(queries, k=10, ef=ef, width=1).ids, gt, 10)
                            for ef in (64, 256)}
    print(json.dumps({"n": n, "insert_batches": -(-n // BuildParams().batch) - 1, "adt_level_mismatch": mismatch,
                      "port_equals_reference": equal, "ref_build_s": ref_s, "port_build_s": port_s,
                      "n_dists_by_phase": dict(zip(PHASE_NAMES, tst.phases)),
                      "reference_recall@10_w1": recall}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
