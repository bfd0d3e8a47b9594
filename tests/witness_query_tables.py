"""How often the port's query tables part from the reference's, on the CPU
in both packages: a witness for the open query-table fault.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/witness_query_tables.py \
        [--d768 2000 5000 10000 20000] [--d128 2000 10000 50000 100000]

For each size n the rows are the first n of a draw: at D 768 the flash-ann
draw of ``tests/witness_flash_ann_repair.py`` (``vector_dataset(0,
n=2·100,000 + 1,024, d=768)``) with the registry's flash-ann coder (d_f
256, M 16, 4-bit, H 8); at D 128 the main path's draw of ``chip_smoke.py``
(``vector_dataset(0, n=100,000 + 1,000, d=128)``) with its coder (d_f 64,
M 16, 4-bit, H 8). The reference fits the coder over those rows
(``make_backend("flash_blocked", ...)``); the port takes it by
``FlashBlockedBackend.from_state``. Every row is then a query: it prints
one JSON line per (D, n) with the (n, M, K) quantized query-table levels
on which

* the port's ``query_ctx`` (float64, rounded to float32 once) and the
  reference's (float32 throughout) disagree, and the rows holding any;
* the port's arithmetic in float32 throughout (``query_ctx`` without its
  float64 casts, the reference's order of operations) and the reference's
  disagree: whether reproducing the reference's rounding on the CPU would
  make the tables equal.

Not a pytest module (a coder fit in JAX per size, ~1 min at 20,000 × 768).
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

from repro.graph import backends as jbk
from repro_torch.core import flash as fl
from repro_torch.core import quantize as qz
from repro_torch.data.synthetic import vector_dataset
from repro_torch.graph import backends as tbk

DRAWS = {768: (2 * 100_000 + 1024, dict(d_f=256, m_f=16, l_f=4, h=8)),
         128: (100_000 + 1000, dict(d_f=64, m_f=16, l_f=4, h=8))}
R_BASE = 32  # the blocked mirror's width, which the coder's fit does not read


def query_ctx_f32(coder: fl.FlashCoder, q: torch.Tensor) -> torch.Tensor:
    """``query_ctx``'s quantized tables with every step in float32, as the
    reference computes them."""
    z = (q - coder.mean) @ coder.rot
    subs = fl._split_subspaces(z, coder.m_f, coder.ds).contiguous()
    adt_f = fl._partial_dists(subs, coder.codebooks).permute(1, 0, 2).contiguous()
    return qz.quantize_table(coder.table_quant, adt_f)


def witness(data: np.ndarray, coder_kw: dict) -> dict:
    n, d = data.shape
    t0 = time.perf_counter()
    jdata = jnp.asarray(data)
    jbe = jbk.make_backend("flash_blocked", jdata, jax.random.PRNGKey(0), r_for_blocked=R_BASE, **coder_kw)
    fit_s = time.perf_counter() - t0
    tbe = tbk.FlashBlockedBackend.from_state({k: np.asarray(v) for k, v in jbe.state_dict().items()}, device="cpu")
    want = np.asarray(jax.vmap(lambda v: jbe.prepare_query(v))(jdata).adt_q)
    q = torch.from_numpy(data)
    port = fl.query_ctx(tbe.coder, q).adt_q.numpy() != want
    f32 = query_ctx_f32(tbe.coder, q).numpy() != want
    return {"d": d, "n": n, "coder": coder_kw, "levels": int(want.size),
            "port_levels_differ": int(port.sum()), "port_rows_differ": int(port.any((1, 2)).sum()),
            "float32_levels_differ": int(f32.sum()), "float32_rows_differ": int(f32.any((1, 2)).sum()),
            "coder_fit_s": fit_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d768", type=int, nargs="*", default=[2000, 5000, 10000, 20000])
    ap.add_argument("--d128", type=int, nargs="*", default=[2000, 10000, 50000, 100000])
    args = ap.parse_args()
    for d, sizes in ((768, args.d768), (128, args.d128)):
        if not sizes:
            continue
        rows, coder_kw = DRAWS[d]
        allx = vector_dataset(0, n=rows, d=d, n_clusters=64)
        for n in sizes:
            print(json.dumps(witness(allx[:n].copy(), coder_kw)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
