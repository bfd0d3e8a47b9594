"""The rank functions of ``tests/test_torch_mesh_moe.py`` and
``tests/test_torch_mesh_lm.py`` (not collected by pytest). ``run_ranks``
pickles them by import path; this module imports no JAX.

Each reads the reference's weights and inputs from a pickle of plain
numpy trees that the reference's subprocess wrote, and on a world of four
ranks runs the port under four meshes: (2, 2) over every rank, (1, 2) and
(2, 1) over ranks {0, 1} and, as a second replica, {2, 3}; rank 0 adds the
one-process run and a (1, 1) mesh beside it. Every output is whole (put
back together with ``gather_from_mesh``); every rank's outputs come back
(``all_gather_object``)."""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import ShapeSpec, get_arch
from repro_torch.distributed.collectives import MeshAxes
from repro_torch.distributed.context import mesh_context
from repro_torch.launch import steps
from repro_torch.launch.mesh import COMM, Mesh, reset_comm
from repro_torch.models import moe as tm
from repro_torch.train.elastic import gather_from_mesh, reshard_for_mesh

MESHES = {"2x2": ({"data": 2, "model": 2}, (0, 1, 2, 3)), "1x2": ({"data": 1, "model": 2}, None),
          "2x1": ({"data": 2, "model": 1}, None)}
#: the serving cells' sizes: a prefill of B × S, then a batched decode (B
#: rows) and a long-context one (the first LONG_B rows) at position S of
#: caches S_MAX long
B, S, S_MAX, LONG_B = 8, 8, 16, 2
#: the expert weights' specs on one layer (``lm_param_specs``' MoE block
#: without its layer axis)
MOE_SPECS = {"router": (None, None), "wg": ("model", None, None), "wu": ("model", None, None),
             "wd": ("model", None, None), "shared": {"wg": (None, "model"), "wu": (None, "model"),
                                                     "wd": ("model", None)}}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_np(v) for v in tree)
    return _np(tree)


def _tensors(tree, dev):
    """Numpy trees as tensors on ``dev``, bit for bit (bfloat16 arrays, as
    ``ml_dtypes`` holds them, through an int16 view)."""
    if isinstance(tree, dict):
        return {k: _tensors(v, dev) for k, v in tree.items()}
    if tree is None:
        return None
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def _meshes(dev) -> dict:
    me = dist.get_rank()
    return {name: Mesh(shape, ranks or ((0, 1) if me < 2 else (2, 3)), dev)
            for name, (shape, ranks) in MESHES.items()}


def _gathered(out: dict) -> list:
    box = [None] * dist.get_world_size()
    dist.all_gather_object(box, out)
    return box


def _same(a, b) -> bool:
    """Whether two trees of tensors are equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None:  # an absent subtree (a dense model's blocks_moe)
        return a is b
    return torch.equal(a, b)


# ---- all_to_all ----------------------------------------------------------------


def exchange_blocks(mesh, _unused=None) -> list:
    """``MeshAxes.all_to_all`` over each axis group of a (2, 2) mesh and a
    (1, 2) one (float32 and bfloat16 blocks whose values name their sender
    and block), and what a plain loop over the senders wants."""
    dev = mesh.device
    me = dist.get_rank()
    out = {"rank": me, "got": {}, "want": {}}
    for name, shape in (("2x2", {"data": 2, "model": 2}), ("1x2", {"data": 1, "model": 2})):
        m = Mesh(shape, (0, 1, 2, 3) if name == "2x2" else ((0, 1) if me < 2 else (2, 3)), dev)
        for axes in (("model",), ("data",), ("data", "model")):
            ax = MeshAxes(m, axes)
            for dt in (torch.float32, torch.bfloat16):
                # block j of rank r: r·16 + j·4 + [0, 1, 2] (exact in bfloat16)
                t = (me * 16 + torch.arange(ax.size)[:, None] * 4 + torch.arange(3)[None]).to(dt).to(dev)
                key = f"{name} {'+'.join(axes)} {dt}"
                out["got"][key] = _np(ax.all_to_all(t).to(torch.float32))
                members = m.members(axes)
                out["want"][key] = np.stack([r * 16 + ax.index * 4 + np.arange(3) for r in members]).astype(
                    np.float32)
    return _gathered(out)


# ---- moe_forward -------------------------------------------------------------


def moe_config(cf: float, impl: str = "ep") -> tm.MoEConfig:
    """The reduced moonshot MoE (8 experts, top 2, 2 shared) at ``cf``."""
    moe = get_arch("moonshot-v1-16b-a3b").make_reduced().moe
    return dataclasses.replace(moe, impl=impl, capacity_factor=cf)


def moe_cases(mesh, path: str) -> list:
    """``moe_forward`` of every case of the reference's pickle on every
    mesh, the mesh ambient and the experts a rank's shard: given every
    token ("whole"), and given its ``"data"`` group's rows alone with
    ``token_axes=("data",)`` ("rows", where the rows divide; the rows
    gathered back after); the ``all_to_all`` count of each call. Rank 0
    adds the one-process outputs."""
    with open(path, "rb") as f:
        ref = pickle.load(f)
    dev = mesh.device
    out = {"rank": dist.get_rank(), "meshes": {}, "exchanges": {}}
    whole_params = _tensors(ref["params"], dev)
    for name, m in _meshes(dev).items():
        rows = MeshAxes(m, "data")
        params = reshard_for_mesh(whole_params, MOE_SPECS, m)
        res, counts = {"whole": {}, "rows": {}}, {"whole": {}, "rows": {}}
        for key, case in ref["cases"].items():
            cfg = moe_config(case["cf"], case["impl"])
            x = torch.from_numpy(case["x"]).to(dev)
            layouts = {"whole": (x, ())}
            if x.shape[0] % rows.size == 0:
                layouts["rows"] = (reshard_for_mesh(x, ("data",), m), ("data",))
            for layout, (xl, axes) in layouts.items():
                reset_comm()
                with mesh_context(m), torch.no_grad():
                    got, _ = tm.moe_forward(params, xl, cfg, token_axes=axes)
                n = COMM["all_to_alls"]
                res[layout][key], counts[layout][key] = _np(rows.gather(got, 0) if axes else got), n
        out["meshes"][name], out["exchanges"][name] = res, counts
    if dist.get_rank() == 0:
        with torch.no_grad():
            out["one_process"] = {
                key: _np(tm.moe_forward(whole_params, torch.from_numpy(case["x"]).to(dev),
                                        moe_config(case["cf"], case["impl"]))[0]) for key, case in ref["cases"].items()}
    return _gathered(out)


# ---- the LM serving cells ---------------------------------------------------


def lm_config(arch: str, override: dict):
    cfg = get_arch(arch).make_reduced()
    if "moe" in override:
        override = dict(override, moe=dataclasses.replace(cfg.moe, **override["moe"]))
    return dataclasses.replace(cfg, **override)


def _shape(kind: str, b: int, s: int) -> ShapeSpec:
    name = {"prefill": "prefill_32k", "decode": "decode_32k" if b >= 8 else "long_500k"}[kind]
    return ShapeSpec(name, kind, {"global_batch": b, "seq_len": s})


def lm_run(cfg, params_np: dict, tokens_np: np.ndarray, dev, mesh=None) -> dict:
    """The prefill of B × S, then from its caches (gathered, padded to
    S_MAX) a batched decode of every row and a long-context one of the
    first LONG_B rows at position S: whole logits and caches as tensors on
    ``dev``, and each cell's ``all_to_all`` count on this rank."""
    def place(x, spec):
        return x if mesh is None else reshard_for_mesh(x, spec, mesh)

    def whole(x, spec):
        return x if mesh is None else gather_from_mesh(x, spec, mesh)

    def spec(bundle, i, out=False):
        return None if mesh is None else (bundle.out_specs if out else bundle.in_specs)[i]

    params = _tensors(params_np, dev)
    tokens = torch.from_numpy(tokens_np).to(dev)
    pre = steps.lm_prefill_bundle(cfg, _shape("prefill", B, S), mesh)
    local = place(params, spec(pre, 0))
    reset_comm()
    logits, caches = pre.fn(local, place(tokens, spec(pre, 1)))
    res = {"prefill": (logits, whole(caches, spec(pre, 1, True)))}
    exchanges = {"prefill": COMM["all_to_alls"]}
    padded = {k: torch.cat([c, c.new_zeros((*c.shape[:2], S_MAX - S, *c.shape[3:]))], 2)
              for k, c in res["prefill"][1].items()}
    for cell, rows in (("decode", B), ("long", LONG_B)):
        bundle = steps.lm_decode_bundle(cfg, _shape("decode", rows, S_MAX), mesh)
        reset_comm()
        # a copy: the step writes its caches in place
        lg, c = bundle.fn(local, place({k: v[:, :rows].clone() for k, v in padded.items()}, spec(bundle, 1)),
                          place(tokens[:rows, -1], spec(bundle, 2)), torch.tensor(S))
        res[cell] = (lg, whole(c, spec(bundle, 1, True)))
        exchanges[cell] = COMM["all_to_alls"]
    return {"cells": res, "exchanges": exchanges}


def lm_cells(mesh, path: str) -> list:
    """Every LM case of the reference's pickle on every mesh; rank 0 adds
    the one-process cells and the (1, 1) mesh's, and whether the two are
    equal bit for bit."""
    with open(path, "rb") as f:
        ref = pickle.load(f)
    dev = mesh.device
    out = {"rank": dist.get_rank(), "meshes": {}}
    with torch.no_grad():
        for name, m in _meshes(dev).items():
            out["meshes"][name] = {}
            for case, r in ref["cases"].items():
                run = lm_run(lm_config(r["arch"], r["override"]), r["params"], r["tokens"], dev, m)
                out["meshes"][name][case] = _tree_np(run)
        if dist.get_rank() == 0:
            out["one_process"], out["unit"], out["unit_equal"] = {}, {}, {}
            for case, r in ref["cases"].items():
                cfg = lm_config(r["arch"], r["override"])
                one = lm_run(cfg, r["params"], r["tokens"], dev)
                unit = lm_run(cfg, r["params"], r["tokens"], dev, Mesh({"data": 1, "model": 1}, [0], dev))
                out["one_process"][case], out["unit"][case] = _tree_np(one), _tree_np(unit)
                out["unit_equal"][case] = _same(one["cells"], unit["cells"])
    return _gathered(out)
