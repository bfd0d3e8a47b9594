"""Witness: what the bfloat16 cases of ``tests/test_torch_transformer.py``
can tell apart (not collected by pytest).

For each of the test's bf16 configs (reduced llama3.2-3b and moonshot) it
runs the test's own ``_run`` three ways against the reference in bf16 and
prints one JSON line per (config, variant):

* ``sound``: the port as it is;
* ``float32_compute``: the port computing in float32 from the same
  masters (no rounding of the weights or activations);
* ``router_float32``: the port with ``_cast_block`` leaving the MoE
  router in float32.

Each line holds the largest |Δ| of the logits (forward, prefill, 3 decode
steps), of the caches, the MoE aux's relative error, and the share of the
first layer's prefill cache elements equal to the reference's bits.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/witness_bf16_control.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_transformer as T  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402


def readings(run: dict) -> dict:
    logits = [(run["t_forward"][0], run["forward"][0])]
    caches = 0.0
    for (got, got_c), (want, want_c) in [(run["t_prefill"], run["prefill"]), *zip(run["t_decode"], run["decode"])]:
        logits.append((got, want))
        caches = max(caches, *(float(np.abs(got_c[k] - want_c[k]).max()) for k in want_c))
    aux = [abs(run["t_forward"][1][k] - v) / abs(v) for k, v in run["forward"][1].items()]
    g0, w0 = run["t_prefill"][1], run["prefill"][1]
    return {"logits_max_abs": max(float(np.abs(g - w).max()) for g, w in logits), "caches_max_abs": caches,
            "aux_max_rel": max(aux, default=0.0),
            "layer0_caches_equal_share": {k: float(np.mean(g0[k][0] == w0[k][0])) for k in w0}}


def main() -> None:
    configs, cast_block = T._configs, tt._cast_block

    def float32_compute(arch, bf16):
        jcfg, tcfg = configs(arch, bf16)
        return jcfg, dataclasses.replace(tcfg, dtype=torch.float32)

    def router_float32(blk, dtype):
        out = cast_block(blk, dtype)
        if "router" in out.get("ffn", {}):
            out["ffn"] = dict(out["ffn"], router=blk["ffn"]["router"])
        return out

    variants = {"sound": (configs, cast_block), "float32_compute": (float32_compute, cast_block),
                "router_float32": (configs, router_float32)}
    for arch in ("llama3.2-3b", "moonshot-v1-16b-a3b"):
        for name, (make_configs, cast) in variants.items():
            T._configs, tt._cast_block = make_configs, cast
            try:
                out = readings(T._run({}, arch, bf16=True))
            finally:
                T._configs, tt._cast_block = configs, cast_block
            print(json.dumps({"arch": arch, "variant": name, **out}), flush=True)


if __name__ == "__main__":
    main()
