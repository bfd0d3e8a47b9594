"""The flash-ann segment build's reachability repair, on the CPU in both
packages: a witness for how many rows the bulk pass leaves unreachable.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/witness_flash_ann_repair.py [--n 5000 10000]

For each ``--n``, the rows are the first n of the flash-ann draw at the
registry's full segment size (``vector_dataset(0, n=2·100,000 + 1,024,
d=768, n_clusters=64)``, its first segment; ``chip_smoke.py`` now draws
2·50,000 + 1,024), the coder the registry's flash-ann one (d_f = 256,
M = 16, 4-bit, H = 8), fitted by the reference over those rows and carried
to the port with ``FlashBlockedBackend.from_state``, and the parameters
the smoke's (``launch/dryrun.py:142``: r_upper 16, r_base 32, ef 128,
batch 64, 3 layers), bulk HNSW over ``flash_blocked``. It prints one JSON
line per n:

* how many query-table levels the two packages' ``query_ctx`` disagree on;
* whether the port's ``build_hnsw(strategy="bulk")`` equals the
  reference's (``adj0``, ``adj_up``, ``levels``, ``entry``);
* the base-layer vertices unreachable from the entry before each of the
  repair's two re-insertion passes and after them (what the force-link
  step starts from), in both packages, read by wrapping each one's
  ``bfs_reachable`` (its first three calls; the two packages' force-link
  steps search components in different ways), and the first count's
  share of n;
* both builds' seconds.

Not a pytest module (minutes at 10,000 rows, most of it the reference's
build); the bit-equality is held at small sizes by
``test_torch_flat_exact.py``. Exits 1 where the two builds differ.
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

import repro.graph.engine as jengine
import repro_torch.graph.engine as tengine
from repro.graph import backends as jbk
from repro.graph.engine import BuildParams as JParams
from repro.graph.hnsw import build_hnsw as jbuild
from repro_torch.core.flash import query_ctx
from repro_torch.data.synthetic import vector_dataset
from repro_torch.graph import backends as tbk
from repro_torch.graph.engine import BuildParams
from repro_torch.graph.hnsw import build_hnsw as tbuild

SEGMENT = 100_000  # the flash-ann segment_build cell's rows
SEGMENTS = 2
QUERIES = 1024
DIM = 768
CODER = dict(d_f=256, m_f=16, l_f=4, h=8)  # the registry's flash-ann coder
PARAMS = dict(r_upper=16, r_base=32, ef=128, batch=64, max_layers=3)  # src/repro/launch/dryrun.py:142
REPAIR_BFS = 3  # the BFS before each of the repair's two passes, and the one after them


def count_unreachable(module) -> tuple[list, object]:
    """Wrap ``module.bfs_reachable`` so that each call's count of
    unreachable vertices is recorded; returns the list and the original."""
    counts: list = []
    orig = module.bfs_reachable

    def counting(adj, entry):
        seen = orig(adj, entry)
        counts.append(int((~seen).sum()))
        return seen

    module.bfs_reachable = counting
    return counts, orig


def witness(data: np.ndarray) -> dict:
    n = data.shape[0]
    jdata = jnp.asarray(data)
    jbe = jbk.make_backend("flash_blocked", jdata, jax.random.PRNGKey(0), r_for_blocked=PARAMS["r_base"], **CODER)
    tbe = tbk.FlashBlockedBackend.from_state({k: np.asarray(v) for k, v in jbe.state_dict().items()}, device="cpu")
    jctx = jax.vmap(lambda v: jbe.prepare_query(v))(jdata)
    mismatch = int((query_ctx(tbe.coder, torch.from_numpy(data)).adt_q.numpy() != np.asarray(jctx.adt_q)).sum())

    ref_bfs, orig = count_unreachable(jengine)
    try:
        t0 = time.perf_counter()
        jg, _ = jbuild(jdata, jbe, params=JParams(**PARAMS), strategy="bulk")
        jax.block_until_ready(jg.adj0)
        ref_s = time.perf_counter() - t0
    finally:
        jengine.bfs_reachable = orig
    port_bfs, orig = count_unreachable(tengine)
    try:
        t0 = time.perf_counter()
        tg, _ = tbuild(torch.from_numpy(data), tbe, params=BuildParams(**PARAMS), strategy="bulk")
        port_s = time.perf_counter() - t0
    finally:
        tengine.bfs_reachable = orig
    equal = {
        "adj0": bool(np.array_equal(tg.adj0.numpy(), np.asarray(jg.adj0))),
        "adj_up": bool(np.array_equal(tg.adj_up.numpy(), np.asarray(jg.adj_up))),
        "levels": bool(np.array_equal(tg.levels.numpy(), np.asarray(jg.levels))),
        "entry": int(tg.entry) == int(jg.entry),
    }
    ref_unreach, port_unreach = ref_bfs[:REPAIR_BFS], port_bfs[:REPAIR_BFS]
    return {
        "n": n, "adt_level_mismatch": mismatch, "port_equals_reference": equal,
        "reference_unreachable": ref_unreach, "port_unreachable": port_unreach,
        "reference_first_share": ref_unreach[0] / n, "port_first_share": port_unreach[0] / n,
        "ref_build_s": ref_s, "port_build_s": port_s, "coder": CODER, "params": PARAMS,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[5000], help="rows of each build (a prefix of segment 0)")
    sizes = ap.parse_args().n
    allx = vector_dataset(0, n=SEGMENTS * SEGMENT + QUERIES, d=DIM, n_clusters=64)
    ok = True
    for n in sizes:
        out = witness(allx[:n].copy())
        ok &= all(out["port_equals_reference"].values())
        print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
