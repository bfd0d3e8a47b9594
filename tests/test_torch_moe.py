"""The port's Mixture-of-Experts layer against the reference's
``repro.models.moe``, on the CPU, from the same numpy inputs.

* ``_route``: softmax and sigmoid gating give the reference's expert ids,
  weights (atol 1e-6) and aux losses (load balance, router z; rtol 1e-5).
  The router inputs are random floats, so no two scores tie (``torch.topk``
  and ``lax.top_k`` order ties apart; the port's ``topk_first`` follows
  ``lax.top_k``).
* ``_positions_by_expert`` equals the reference's on ids with long runs.
* ``moe_forward`` with scatter, einsum and ``ep`` without a process group
  (the reference's own no-mesh branch) equals the reference's (atol 2e-5),
  with shared experts, and at a capacity factor that drops assignments:
  the stable sort drops the reference's ones. ``ep`` on a mesh of more
  than one rank (the ambient one) takes the expert-parallel branch at the
  per-device capacity (``tests/test_torch_mesh_moe.py`` runs it on ranks).
* ``init_moe``'s leaves have the reference's shapes.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import moe as jm
from repro_torch.distributed.context import mesh_context
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe as tm
from _lm_common import draw_like, jit_ref

D = 16
CFG = dict(n_experts=8, top_k=2, d_ff=24)


def _cfgs(**kw):
    return jm.MoEConfig(**{**CFG, **kw}), tm.MoEConfig(**{**CFG, **kw})


def _params(jcfg, seed: int = 0):
    p = draw_like(lambda: jm.init_moe(jax.random.PRNGKey(0), d_model=D, cfg=jcfg), seed)
    return p, jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), p)


def _x(n_tokens: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(2, n_tokens // 2, D)).astype(np.float32)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_route_matches_reference(router):
    jcfg, tcfg = _cfgs(router=router)
    p, pt = _params(jcfg)
    flat = _x(64).reshape(-1, D)
    w, idx, aux = jit_ref(lambda p, x: jm._route(p, x, jcfg))(p, flat)
    tw, tidx, taux = tm._route(pt, torch.from_numpy(flat), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[k]), float(aux[k]), rtol=1e-5)


def test_positions_by_expert_matches_reference():
    e_flat = np.random.default_rng(2).integers(0, 5, 300).astype(np.int32)
    want = np.asarray(jit_ref(lambda e: jm._positions_by_expert(e, 8))(e_flat))
    np.testing.assert_array_equal(tm._positions_by_expert(torch.from_numpy(e_flat).long(), 8).numpy(), want)


@pytest.mark.parametrize("impl", ["scatter", "einsum", "ep"])
@pytest.mark.parametrize("case", [
    dict(),
    dict(router="sigmoid", n_shared=2),
    dict(capacity_factor=0.5),  # drops: capacity 4 of 16 tokens' 32 assignments
    dict(top_k=3, capacity_factor=0.7, n_shared=1),
], ids=["softmax", "sigmoid_shared", "drops", "top3_drops_shared"])
def test_moe_forward_matches_reference(impl, case):
    jcfg, tcfg = _cfgs(impl=impl, **case)
    p, pt = _params(jcfg, seed=3)
    x = _x(16, seed=4)
    want, aux = jit_ref(lambda p, x: jm.moe_forward(p, x, jcfg))(p, x)
    got, taux = tm.moe_forward(pt, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    for k in aux:
        np.testing.assert_allclose(float(taux[k]), float(aux[k]), rtol=1e-5)
    if "capacity_factor" in case:  # the case drops assignments: the drop-free output differs
        free_cfg = dataclasses.replace(jcfg, capacity_factor=8.0)
        free, _ = jit_ref(lambda p, x: jm.moe_forward(p, x, free_cfg))(p, x)
        assert np.abs(np.asarray(free) - np.asarray(want)).max() > 1e-3


def test_ep_across_ranks_raises(monkeypatch):
    """``impl="ep"`` on a mesh of two ranks raises no more: it takes the
    expert-parallel branch, each rank's chunk of 4 of the 8 tokens at the
    per-device capacity ⌈4·2/8·1.25⌉ = 2 over its 4 experts. A spy stands
    in for the exchange and the gather, so no ranks run."""
    _, tcfg = _cfgs(impl="ep")
    _, pt = _params(_cfgs()[0])
    mesh = Mesh({"data": 1, "model": 2}, range(2), "cpu")  # rank 0 of two, no process group
    mine = {k: v if k == "router" else v[:4] for k, v in pt.items()}
    calls = []

    def spy(flat, w, idx, p, cfg, c_dev, ep):
        calls.append((flat.shape[0], c_dev, ep.size, p["wg"].shape[0]))
        return torch.zeros_like(flat)

    monkeypatch.setattr(tm, "_dispatch_ep", spy)
    monkeypatch.setattr(mesh, "all_gather", lambda t, axes: [t, t])
    with mesh_context(mesh):
        out, _ = tm.moe_forward(mine, torch.from_numpy(_x(8)), tcfg)
    assert calls == [(4, 2, 2, 4)] and out.shape == (2, 4, D)


def test_init_moe_leaves_match_reference():
    jcfg, tcfg = _cfgs(n_shared=2)
    want = jax.eval_shape(lambda: jm.init_moe(jax.random.PRNGKey(0), d_model=D, cfg=jcfg))
    want = jax.tree_util.tree_map(lambda a: a.shape, want)
    got = tm.init_moe(torch.Generator().manual_seed(0), d_model=D, cfg=tcfg, device="cpu", dtype=torch.bfloat16)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == want
    assert all(t.dtype == torch.bfloat16 for t in jax.tree_util.tree_leaves(got))
