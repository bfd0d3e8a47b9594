"""The rank functions of ``tests/test_torch_mesh_lm_train.py`` and of its
card test in ``tests/test_torch_cuda.py`` (not collected by pytest).
``run_ranks`` pickles them by import path; this module imports no JAX.

``train_cells`` reads the reference's weights and batches from a pickle of
plain numpy trees and runs ``launch/steps``' LM train cell under every
mesh the world holds: on four ranks (2, 2) over every rank, (1, 2) and
(2, 1) over ranks {0, 1} and, as a second replica, {2, 3}; on two ranks
(1, 2) and (2, 1). Rank 0 adds the one-process steps and a (1, 1) mesh
beside them. Every state is put back together with ``gather_from_mesh``;
every rank's outputs come back (``all_gather_object``).

``collective_grads`` holds the gradients of ``MeshAxes.all_to_all``, both
kinds of ``MeshAxes.gather`` and the expert-parallel MoE on two ranks
against a one-process computation of the same function."""

from __future__ import annotations

import dataclasses
import math
import pickle
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from _mesh_lm_ranks import MOE_SPECS, _gathered, _same, _tensors, lm_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.distributed.collectives import MeshAxes
from repro_torch.distributed.context import mesh_context
from repro_torch.launch import steps
from repro_torch.launch.mesh import COMM, Mesh, reset_comm
from repro_torch.models import moe as tm
from repro_torch.models.layers import mlp_forward
from repro_torch.train.elastic import gather_from_mesh, reshard_for_mesh
from repro_torch.train.optimizer import adamw_init
from repro_torch.utils import tree_map

#: the train cell's global batch: B rows of S tokens, STEPS steps
B, S, STEPS = 8, 8, 2
FOUR = {"2x2": ({"data": 2, "model": 2}, (0, 1, 2, 3)), "1x2": ({"data": 1, "model": 2}, None),
        "2x1": ({"data": 2, "model": 1}, None)}


def _np(x):
    """A tensor as numpy (bfloat16 as float32, which holds it exactly)."""
    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _meshes(dev) -> dict:
    """The meshes this rank is in: name -> Mesh (the (2, 2) one on four
    ranks only)."""
    me, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for name, (shape, ranks) in FOUR.items():
        if ranks is not None and world != len(ranks):
            continue
        out[name] = Mesh(shape, ranks or ((0, 1) if me < 2 else (2, 3)), dev)
    return out


# ---- the train cell ------------------------------------------------------------


def train_run(cfg, params_np: dict, batches: list, dev, mesh=None) -> dict:
    """STEPS steps of ``lm_train_bundle`` from the given weights (on
    ``mesh``, each rank over its shards; one process without): every
    step's metrics and ``COMM`` (``all_to_all`` bytes whole and of the
    backward), and the final parameters and moments whole, as tensors."""
    bundle = steps.lm_train_bundle(cfg, ShapeSpec("train_4k", "train", {"seq_len": S, "global_batch": B}), mesh)
    params = _tensors(params_np, dev)
    opt = adamw_init(params, state_dtype=steps.lm_opt_cfg(cfg).state_dtype)
    if mesh is not None:
        params, opt = (reshard_for_mesh(t, spec, mesh) for t, spec in zip((params, opt), bundle.in_specs))
    rows = []
    for tokens, labels in batches:
        batch = [torch.from_numpy(np.asarray(t)).to(dev) for t in (tokens, labels)]
        if mesh is not None:
            batch = [reshard_for_mesh(t, spec, mesh) for t, spec in zip(batch, bundle.in_specs[2:])]
        reset_comm()
        params, opt, metrics = bundle.fn(params, opt, *batch)
        rows.append({**{k: float(v) for k, v in metrics.items()},
                     "comm": {k: COMM[k] for k in ("all_to_alls", "all_to_all_bytes", "all_to_all_grad_bytes")}})
    if mesh is not None:
        params, mu, nu = (gather_from_mesh(t, bundle.in_specs[0], mesh) for t in (params, opt.mu, opt.nu))
    else:
        mu, nu = opt.mu, opt.nu
    return {"steps": rows, "params": params, "mu": mu, "nu": nu}


def _numpy_run(run: dict) -> dict:
    return {"steps": run["steps"], **{k: tree_map(_np, run[k]) for k in ("params", "mu", "nu")}}


def train_cells(mesh, path: str) -> list:
    """Every case of the pickle on every mesh; rank 0 adds the one-process
    steps, the (1, 1) mesh's and whether the two are equal bit for bit."""
    with open(path, "rb") as f:
        ref = pickle.load(f)
    dev = mesh.device
    out = {"rank": dist.get_rank(), "meshes": {}}
    for name, m in _meshes(dev).items():
        out["meshes"][name] = {case: _numpy_run(train_run(lm_config(r["arch"], r["override"]), r["params"],
                                                          r["batches"], dev, m))
                               for case, r in ref["cases"].items()}
    if dist.get_rank() == 0:
        out["one_process"], out["unit"], out["unit_equal"] = {}, {}, {}
        for case, r in ref["cases"].items():
            cfg = lm_config(r["arch"], r["override"])
            one = train_run(cfg, r["params"], r["batches"], dev)
            unit = train_run(cfg, r["params"], r["batches"], dev, Mesh({"data": 1, "model": 1}, [0], dev))
            out["one_process"][case], out["unit"][case] = _numpy_run(one), _numpy_run(unit)
            out["unit_equal"][case] = _same([one[k] for k in ("params", "mu", "nu")],
                                            [unit[k] for k in ("params", "mu", "nu")]) and all(
                {k: v for k, v in a.items() if k != "comm"} == {k: v for k, v in b.items() if k != "comm"}
                for a, b in zip(one["steps"], unit["steps"]))
    return _gathered(out)


# ---- gradients through the collectives --------------------------------------------


def _draw(seed: int, *shape) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _grads(loss, leaves: dict) -> dict:
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: None if g is None else g.detach() for k, g in zip(leaves, got)}


def moe_on_chunks(p: dict, x: torch.Tensor, cfg, n_dev: int, ep: int):
    """``moe_forward``'s ep branch as ``n_dev`` ranks (``ep`` of them on the
    expert axis) compute it, in one process: each chunk of the tokens
    routed and scattered at the per-device capacity, the aux losses over
    every token."""
    flat = x.reshape(-1, x.shape[-1])
    n_loc = flat.shape[0] // n_dev
    c = -(-max(math.ceil(n_loc * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1) // ep) * ep
    outs = []
    for i in range(n_dev):
        chunk = flat[i * n_loc:(i + 1) * n_loc]
        w, idx, _ = tm._route(p, chunk, cfg)
        outs.append(tm._dispatch_scatter(chunk, w, idx, p, cfg, c))
    out = torch.cat(outs) + mlp_forward(p["shared"], flat)
    return out.reshape(x.shape), tm._route(p, flat, cfg)[2]


def _moe_loss(out, aux, weight):
    return (out * weight).sum() + 0.01 * aux["load_balance"] + 1e-4 * aux["router_z"]


def collective_grads(mesh, _unused=None) -> list:
    """On a (1, 2) mesh of two ranks: the gradients of ``all_to_all``, of
    ``gather`` (consumers replicated) and of ``gather(per_rank=True)``
    (consumers that differ per rank), and of ``moe_forward`` with
    ``impl="ep"`` (the ep branch) and ``"scatter"`` (the fallback at the
    global capacity), each with the one-process gradients of the same
    function; and the ep branch's gradients with the forward-only exchange
    ``Mesh.all_to_all`` in place of ``MeshAxes.all_to_all``."""
    dev = mesh.device
    me = dist.get_rank()
    m = Mesh({"data": 1, "model": 2}, (0, 1), dev)
    ax = MeshAxes(m, "model")
    out = {"rank": me, "got": {}, "want": {}}
    xs = [_draw(10 + r, 2, 3, 4) for r in range(2)]
    cs = [_draw(20 + r, 2, 3, 4) for r in range(2)]
    common = _draw(30, 4, 3, 4)

    # all_to_all: each rank's loss over what it received, the losses summed
    x = xs[me].clone().requires_grad_(True)
    out["got"]["all_to_all"] = _grads((ax.all_to_all(x) * cs[me]).sum(), {"x": x})["x"]
    whole = torch.stack(xs).requires_grad_(True)
    loss = sum((whole[:, r] * cs[r]).sum() for r in range(2))
    out["want"]["all_to_all"] = _grads(loss, {"x": whole})["x"][me]

    # gather, replicated consumers: every rank computes the same loss
    x = xs[me].clone().requires_grad_(True)
    out["got"]["gather"] = _grads((ax.gather(x, 0) ** 2 * common).sum(), {"x": x})["x"]
    whole = torch.cat(xs).requires_grad_(True)
    out["want"]["gather"] = _grads((whole ** 2 * common).sum(), {"x": whole})["x"][me * 2:(me + 1) * 2]

    # gather, consumers that differ per rank: each rank its own loss, summed
    x = xs[me].clone().requires_grad_(True)
    wide = [_draw(40 + r, 2, 3, 8) for r in range(2)]
    out["got"]["gather_per_rank"] = _grads((ax.gather(x, -1, per_rank=True) ** 2 * wide[me]).sum(), {"x": x})["x"]
    whole = torch.cat(xs, -1).requires_grad_(True)
    loss = sum((whole ** 2 * wide[r]).sum() for r in range(2))
    out["want"]["gather_per_rank"] = _grads(loss, {"x": whole})["x"][..., me * 4:(me + 1) * 4]

    # the MoE: the reduced moonshot's layer over 32 tokens, experts split
    moe = lm_config("moonshot-v1-16b-a3b", {}).moe
    gen = torch.Generator().manual_seed(5)
    p_whole = tm.init_moe(gen, d_model=16, cfg=moe, device="cpu")
    x_np = _draw(50, 2, 16, 16)
    weight = _draw(51, 2, 16, 16)
    for impl, cf in (("ep", 1.0), ("scatter", 1.0)):
        cfg = dataclasses.replace(moe, impl=impl, capacity_factor=cf)
        p = {k: v.requires_grad_(True) for k, v in
             tree_map(lambda t: t.clone(), reshard_for_mesh(p_whole, MOE_SPECS, m)).items() if k != "shared"}
        p["shared"] = {k: v.requires_grad_(True) for k, v in reshard_for_mesh(p_whole["shared"], MOE_SPECS["shared"],
                                                                              m).items()}
        x = x_np.clone().requires_grad_(True)
        leaves = {"x": x, **{k: v for k, v in p.items() if k != "shared"},
                  **{f"shared/{k}": v for k, v in p["shared"].items()}}
        reset_comm()
        with mesh_context(m):
            y, aux = tm.moe_forward(p, x, cfg, global_aux=True)
        got = _grads(_moe_loss(y, aux, weight), leaves)
        # a rank's expert shard and hidden columns, whole again (no grad)
        got = {k: (g if g is None or k in ("x", "router") else
                   gather_from_mesh(g, MOE_SPECS[k] if "/" not in k else MOE_SPECS["shared"][k[7:]], m))
               for k, g in got.items()}
        out["got"][f"moe_{impl}"] = got
        out["got"][f"moe_{impl}_grad_bytes"] = COMM["all_to_all_grad_bytes"]
        p1 = tree_map(lambda t: t.clone().requires_grad_(True), p_whole)
        x1 = x_np.clone().requires_grad_(True)
        if impl == "ep":
            y1, aux1 = moe_on_chunks(p1, x1, cfg, 2, 2)
        else:
            y1, aux1 = tm.moe_forward(p1, x1, cfg)
        leaves1 = {"x": x1, **{k: v for k, v in p1.items() if k != "shared"},
                   **{f"shared/{k}": v for k, v in p1["shared"].items()}}
        out["want"][f"moe_{impl}"] = _grads(_moe_loss(y1, aux1, weight), leaves1)
        out["got"][f"moe_{impl}_aux"] = {k: float(v) for k, v in aux.items()}
        out["want"][f"moe_{impl}_aux"] = {k: float(v) for k, v in aux1.items()}

    # the exchange without a backward (as it was before LM training across ranks)
    cfg = dataclasses.replace(moe, impl="ep", capacity_factor=1.0)
    p = tree_map(lambda t: t.clone(), reshard_for_mesh(p_whole, MOE_SPECS, m))
    for k in ("wg", "wu", "wd"):
        p[k].requires_grad_(True)
    x = x_np.clone().requires_grad_(True)
    with mesh_context(m), mock.patch.object(MeshAxes, "all_to_all", lambda self, t: self.mesh.all_to_all(t, self.axes)):
        y, aux = tm.moe_forward(p, x, cfg, global_aux=True)
    out["forward_only_expert_grads"] = _grads(_moe_loss(y, aux, weight), {k: p[k] for k in ("wg", "wu", "wd")})
    return _gathered(tree_map(_np, out))
