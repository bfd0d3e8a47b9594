"""Flat Vamana over ``flash_blocked`` at the ``generality`` phase's
parameters, on the CPU in both packages: a witness for its recall.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/witness_flat_flash_scale.py [--n 20000 50000]

For each ``--n``, the rows are the first n of ``chip_smoke.py``'s draw
(``vector_dataset(0, n=501,000, d=128, n_clusters=64)``), the queries its
1,000 held-out rows, the coder the smoke's (d_f = 64, M = 16, 4-bit,
H = 8), fitted by the reference and carried to the port with
``FlashBlockedBackend.from_state``, and the parameters
``benchmarks/bench_generality.py``'s (r_upper 8, r_base 24, ef 64,
batch 32, W 4, α 1.2), bulk strategy. It prints one JSON line per n:

* how many query-table levels the two packages' ``query_ctx`` disagree on;
* whether the port's ``build_vamana(strategy="bulk")`` equals the
  reference's (``adj``, ``adj_d``, ``entry``, and n_dists by phase once
  rounded to the reference's float32 counts), both packages' counts, and
  both builds' seconds;
* recall@10 at ef 128, W = 4, exact rerank, of the reference's and of
  the port's search over their graphs;
* recall@10 of a scan of ALL the codes keeping 128 and reranking them
  (``repro_torch.testing.scan.code_scan_recall``): what the coder allows
  a search of 128 candidates at best, with no graph.

Not a pytest module (about a minute and 3 GB at 10,000 rows on 8 cores,
most of it the reference's build); the bit-equality it checks at scale is
held at small sizes by ``test_torch_flat.py``. Exits 1 where the two
builds differ.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.graph import backends as jbk
from repro.graph.engine import BuildParams as JParams
from repro.graph.index import AnnIndex as JIndex
from repro.graph.knn import exact_knn, recall_at_k
from repro.graph.vamana import build_vamana as jbuild
from repro_torch.core.flash import query_ctx
from repro_torch.data.synthetic import vector_dataset
from repro_torch.graph import backends as tbk
from repro_torch.graph.engine import PHASE_NAMES, BuildParams
from repro_torch.graph.vamana import build_vamana as tbuild
from repro_torch.index import AnnIndex as TIndex
from repro_torch.testing.scan import code_scan_recall

MAIN_N = 500_000  # the smoke's main path: its draw holds these rows and 1,000 queries
QUERIES = 1000
#: benchmarks/bench_generality.py:24-26 over benchmarks/common.py:36-38
PARAMS = dict(r_upper=8, r_base=24, ef=64, batch=32, max_layers=3, width=4, alpha=1.2)


def witness(data: np.ndarray, queries: np.ndarray) -> dict:
    n = data.shape[0]
    jdata = jnp.asarray(data)
    jbe = jbk.make_backend("flash_blocked", jdata, jax.random.PRNGKey(0), r_for_blocked=PARAMS["r_base"],
                           d_f=64, m_f=16, l_f=4, h=8)
    tbe = tbk.FlashBlockedBackend.from_state({k: np.asarray(v) for k, v in jbe.state_dict().items()}, device="cpu")
    jctx = jax.vmap(lambda v: jbe.prepare_query(v))(jdata)
    mismatch = int((query_ctx(tbe.coder, torch.from_numpy(data)).adt_q.numpy() != np.asarray(jctx.adt_q)).sum())

    t0 = time.perf_counter()
    jg, jacct = jbuild(jdata, jbe, params=JParams(**PARAMS), strategy="bulk")
    jax.block_until_ready(jg.adj)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tg, tst = tbuild(torch.from_numpy(data), tbe, params=BuildParams(**PARAMS), strategy="bulk")
    port_s = time.perf_counter() - t0
    equal = {
        "adj": bool(np.array_equal(tg.adj.numpy(), np.asarray(jg.adj))),
        "adj_d": bool(np.array_equal(tg.adj_d.numpy(), np.asarray(jg.adj_d))),
        "entry": int(tg.entry) == int(jg.entry),
        # the reference counts in float32 (exact only below 2**24)
        "n_dists_by_phase_f32": np.array_equal(np.float32(tst.phases), np.asarray(jacct.phases)),
    }

    jq = jnp.asarray(queries)
    gt = exact_knn(jq, jdata, k=10)[0]
    gt_t = torch.from_numpy(np.array(gt))
    jidx = JIndex.from_graph(jg, jdata, algo="vamana", backend_kind="flash_blocked", params=JParams(**PARAMS),
                             strategy="bulk")
    tidx = TIndex.from_graph(tg, torch.from_numpy(data), algo="vamana", backend_kind="flash_blocked",
                             params=BuildParams(**PARAMS), strategy="bulk", device="cpu")
    return {
        "n": n, "adt_level_mismatch": mismatch, "port_equals_reference": equal,
        "ref_build_s": ref_s, "port_build_s": port_s, "n_dists_by_phase": dict(zip(PHASE_NAMES, tst.phases)),
        "reference_n_dists_by_phase": dict(zip(PHASE_NAMES, np.asarray(jacct.phases).tolist())),
        "recall@10_ef128_w4": {
            "reference": recall_at_k(jidx.search(jq, k=10, ef=128, width=4).ids, gt, 10),
            "port": recall_at_k(jnp.asarray(tidx.search(torch.from_numpy(queries), k=10, ef=128, width=4)
                                            .ids.numpy()), gt, 10),
            "code_scan_128": code_scan_recall(tbe, torch.from_numpy(data), torch.from_numpy(queries), gt_t, 128),
        },
        "params": dataclasses.asdict(BuildParams(**PARAMS)),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[20000], help="rows of each build")
    sizes = ap.parse_args().n
    allx = vector_dataset(0, n=MAIN_N + QUERIES, d=128, n_clusters=64)
    queries = allx[MAIN_N:].copy()
    ok = True
    for n in sizes:
        out = witness(allx[:n].copy(), queries)
        ok &= all(out["port_equals_reference"].values())
        print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
