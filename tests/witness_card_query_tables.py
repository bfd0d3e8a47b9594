"""Witness: the flat incremental Vamana over ``flash_blocked`` on the card
against the CPU, insert batch by insert batch (not collected by pytest).

Draws the rows ``chip_smoke.py --n N_ALL`` draws, fits the coder of its
phase-5 check on the first N rows on the card, and prints two JSON lines:

1. the query tables (``prepare_query(...).adt_q``) of those rows computed
   on each device over the whole set, in insert batches of 32 (what the
   build computes) and one row at a time: how many rows differ between
   the devices and between batch sizes, and the first differing entries
   with their float tables and the quantizer;
2. both builds (the check's parameters, r_base 24, W 4, α 1.2), recording
   every insert batch's beam, selection and adjacency: the first record
   where the devices part (which batch, which pass's α, what differed) and
   the fraction of adjacency rows equal at the end.

    PYTHONPATH=src python tests/witness_card_query_tables.py 100000 4000

On a machine without a card both sides run on the CPU. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.data.synthetic import vector_dataset  # noqa: E402
from repro_torch.graph import backends as bk  # noqa: E402
from repro_torch.graph import engine as eng  # noqa: E402
from repro_torch.graph.engine import BuildParams  # noqa: E402
from repro_torch.index import AnnIndex  # noqa: E402

FLAT = dict(r_upper=8, r_base=24, ef=64, batch=32, max_layers=3, width=4, alpha=1.2)  # chip_smoke.FLAT_PARAMS


def tables(state: dict, rows: np.ndarray, dev: str) -> dict:
    """The rows' query tables on ``dev``: whole, in batches of 32, and the
    first 32 one row at a time (the exact seed batch)."""
    b = bk.FlashBlockedBackend.from_state(state, device=dev)
    x = torch.from_numpy(rows).to(dev)
    whole = b.prepare_query(x)
    bat = [b.prepare_query(x[s:s + 32]) for s in range(0, len(rows), 32)]
    return {"whole": whole.adt_q.cpu(), "batch32": torch.cat([q.adt_q for q in bat]).cpu(),
            "row1": torch.cat([b.prepare_query(x[i:i + 1]).adt_q for i in range(32)]).cpu(),
            "whole_f": whole.adt_f.cpu(), "batch32_f": torch.cat([q.adt_f for q in bat]).cpu()}


def recorded_build(state: dict, rows: np.ndarray, dev: str) -> tuple[list, dict, float]:
    """The incremental Vamana build on ``dev`` with every insert batch's
    beam, selection and resulting adjacency recorded (on the host)."""
    rec: list = []
    orig = eng.BuildEngine.insert_batch, eng.BuildEngine.acquire, eng.BuildEngine.select

    def insert_batch(self, data, adj0, adj0_d, *a, **kw):
        rec.append({"kind": "batch", "alpha": self.params.alpha})
        out = orig[0](self, data, adj0, adj0_d, *a, **kw)
        rec.append({"kind": "adj", "adj": adj0.cpu().clone(), "adj_d": adj0_d.cpu().clone()})
        return out

    def acquire(self, backend, qctx, adjacency, entries):
        res = orig[1](self, backend, qctx, adjacency, entries)
        rec.append({"kind": "beam", "adt": qctx.adt_q.cpu().clone(), "ids": res.ids.cpu().clone(),
                    "d": res.dists.cpu().clone()})
        return res

    def select(self, backend, cand_ids, cand_d, *, r):
        sel = orig[2](self, backend, cand_ids, cand_d, r=r)
        rec.append({"kind": "sel", "cand": cand_ids.cpu().clone(), "cand_d": cand_d.cpu().clone(),
                    "ids": sel.ids.cpu().clone()})
        return sel

    eng.BuildEngine.insert_batch, eng.BuildEngine.acquire, eng.BuildEngine.select = insert_batch, acquire, select
    try:
        idx = AnnIndex.build(torch.from_numpy(rows).to(dev), algo="vamana",
                             backend=bk.FlashBlockedBackend.from_state(state, device=dev),
                             params=BuildParams(**FLAT), strategy="incremental", device=dev)
        return rec, idx.export_state()[1], idx.last_stats.n_dists
    finally:
        eng.BuildEngine.insert_batch, eng.BuildEngine.acquire, eng.BuildEngine.select = orig


def main() -> None:
    n_all = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 4000
    card = "cuda" if torch.cuda.is_available() else "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py sets it
    torch.backends.cudnn.allow_tf32 = False
    rows = vector_dataset(0, n=n_all + 1000, d=128, n_clusters=64)[:n]
    be = bk.make_backend("flash_blocked", torch.from_numpy(rows).to(card), seed=0, r_for_blocked=24, device=card,
                         d_f=64, m_f=16, l_f=4, h=8, kmeans_iters=8)
    state = {k: v.cpu() if hasattr(v, "cpu") else v for k, v in be.state_dict().items()}

    tc, tp = tables(state, rows, card), tables(state, rows, "cpu")
    out = {"n_all": n_all, "n": n, "card": card}
    for key in ("whole", "batch32", "row1"):
        out[f"{key}_rows_card_vs_cpu"] = int((tc[key] != tp[key]).flatten(1).any(1).sum())
    out["whole_vs_batch32_rows_card"] = int((tc["whole"] != tc["batch32"]).flatten(1).any(1).sum())
    out["whole_vs_batch32_rows_cpu"] = int((tp["whole"] != tp["batch32"]).flatten(1).any(1).sum())
    tq = be.coder.table_quant
    out["batch32_mismatches"] = [
        {"row": r, "m": m, "k": k, "card_level": int(tc["batch32"][r, m, k]), "cpu_level": int(tp["batch32"][r, m, k]),
         "card_adt_f": float(tc["batch32_f"][r, m, k]), "cpu_adt_f": float(tp["batch32_f"][r, m, k]),
         "card_whole_adt_f": float(tc["whole_f"][r, m, k]), "dist_min": float(tq.dist_min), "delta": float(tq.delta)}
        for r, m, k in (tc["batch32"] != tp["batch32"]).nonzero()[:10].tolist()]
    print(json.dumps(out), flush=True)

    rc, ac, nc = recorded_build(state, rows, card)
    rp, ap, np_ = recorded_build(state, rows, "cpu")
    res = {"n_dists": [nc, np_], "adj_rows_equal": float((ac["adj"] == ap["adj"]).all(1).mean()),
           "first_difference": None}
    batches, alpha = 0, None
    for a, b in zip(rc, rp):
        if a["kind"] == "batch":
            batches, alpha = batches + 1, a["alpha"]
            continue
        differ = [k for k in a if isinstance(a[k], torch.Tensor) and not torch.equal(a[k], b[k])]
        if differ:
            first_rows = {k: (a[k] != b[k]).flatten(1).any(1).nonzero().flatten()[:8].tolist() for k in differ}
            res["first_difference"] = {"record": a["kind"], "insert_batch_call": batches, "alpha": alpha,
                                       "differ": differ, "rows_in_batch": first_rows}
            break
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
