"""Witness: what the float64 query tables of ``core/flash.query_ctx`` cost
on the card (not collected by pytest).

Times, on one tree of the port, ``prepare_query`` over an insert batch (32
rows) and over all n rows (one bulk round's tables), and the paper's
incremental build of ``chip_smoke.py``'s phase 6 (``AnnIndex.build(
strategy="incremental")`` with ``BuildParams()``, Flash d_f 64, M 16) over
the first n rows of ``vector_dataset(0, d=128)``, and prints one JSON line.
To compare two trees of the port, run it from each in turns in one session
on one card (parent, change, change, parent):

    PYTHONPATH=src python tests/witness_query_table_cost.py --n 10000

It needs a card. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.data.synthetic import vector_dataset  # noqa: E402
from repro_torch.graph import backends as bk  # noqa: E402
from repro_torch.graph.engine import BuildParams  # noqa: E402
from repro_torch.index import AnnIndex  # noqa: E402

CODER = dict(d_f=64, m_f=16, l_f=4, h=8)  # chip_smoke.py's main and incremental paths


def ms_per_call(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10_000, help="rows of the incremental build")
    n = ap.parse_args().n
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py sets it
    torch.backends.cudnn.allow_tf32 = False
    x = torch.from_numpy(vector_dataset(0, n=n, d=128)).cuda()
    be = bk.make_backend("flash_blocked", x, seed=0, r_for_blocked=BuildParams().r_base, device="cuda", **CODER)
    out = {"n": n, "prepare_query_ms_32_rows": ms_per_call(lambda: be.prepare_query(x[:32]), 500),
           f"prepare_query_ms_{n}_rows": ms_per_call(lambda: be.prepare_query(x), 20)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = AnnIndex.build(x, algo="hnsw", backend="flash_blocked", strategy="incremental", params=BuildParams(),
                         backend_kwargs=CODER, device="cuda")
    torch.cuda.synchronize()
    out["incremental_build_s"] = time.perf_counter() - t0
    out["n_dists"] = idx.last_stats.n_dists
    out["seconds"] = idx.last_stats.seconds
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
