"""The rank functions of ``tests/test_torch_mesh_recsys.py``,
``tests/test_torch_mesh_gnn.py`` and of their card test in
``tests/test_torch_cuda.py`` (not collected by pytest). ``run_ranks``
pickles them by import path; this module imports no JAX.

Each takes the reference's inputs and weights from a pickle of plain
numpy trees (the reference's subprocess wrote it, or the card test), and
on a world of four ranks runs ``launch/steps``' cells under four meshes:
(2, 2) over every rank, (1, 2) and (2, 1) over ranks {0, 1} and, as a
second replica, {2, 3}, and (1, 1) on rank 0 alone beside the one-process
step there (bit for bit). Every output is put back together with
``gather_from_mesh``; every rank's outputs come back
(``all_gather_object``)."""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import ShapeSpec, get_arch
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models.gnn import common as gc
from repro_torch.train.elastic import gather_from_mesh, reshard_for_mesh
from repro_torch.train.optimizer import adamw_init
from repro_torch.utils import tree_map

#: the recsys cells' sizes: a 2^12-row table divides every mesh; the
#: candidate codes (3,000 rows) split otherwise than the table does
N_ITEMS, B, N_CAND = 2**12 - 1, 8, 3000
BULK_CHUNK = 256  # below a rank's 2,048 table rows: the per-rank chunk merge runs 8 times
MESHES = {"2x2": ({"data": 2, "model": 2}, (0, 1, 2, 3)), "1x2": ({"data": 1, "model": 2}, None),
          "2x1": ({"data": 2, "model": 1}, None)}
#: the GNN cells' graph: 512 nodes in 128 molecules (the molecule cell's count), 1,500
#: edges padded to 2,048 (a multiple of every mesh's edge shards)
GNN_NODES, GNN_EDGES, GNN_EDGE_PAD, GNN_GRAPHS = 512, 1500, 2048, 128
GNN_ARCHS = ("gatedgcn", "egnn", "nequip", "equiformer-v2")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _tensors(tree, dev):
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def _meshes(dev) -> dict:
    """The meshes this rank is in: name -> Mesh."""
    me = dist.get_rank()
    out = {}
    for name, (shape, ranks) in MESHES.items():
        out[name] = Mesh(shape, ranks or ((0, 1) if me < 2 else (2, 3)), dev)
    return out


def _gathered(out: dict) -> list:
    box = [None] * dist.get_world_size()
    dist.all_gather_object(box, out)
    return box


def _train_out(params, opt, metrics) -> dict:
    return {"params": tree_map(_np, params), "mu": tree_map(_np, opt.mu), "nu": tree_map(_np, opt.nu),
            **{k: float(v) for k, v in metrics.items()}}


def _same(a, b) -> bool:
    """Whether two trees of tensors (or tuples of them) are equal bit for bit."""
    la, lb = [x for x in _flat(a)], [x for x in _flat(b)]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _flat(t):
    if isinstance(t, torch.Tensor):
        yield t
    elif isinstance(t, dict):
        for k in sorted(t):
            yield from _flat(t[k])
    elif isinstance(t, (list, tuple)):
        for x in t:
            yield from _flat(x)


# ---- BERT4Rec --------------------------------------------------------------


def recsys_config():
    return dataclasses.replace(get_arch("bert4rec").make_reduced(), n_items=N_ITEMS)


def recsys_bundles(mesh=None) -> dict:
    """The four cells at the reduced config (``retrieval_cand`` over
    ``N_CAND`` candidates)."""
    cfg = recsys_config()
    shapes = {s.name: s for s in get_arch("bert4rec").shapes}
    shapes["retrieval_cand"] = ShapeSpec("retrieval_cand", "retrieval", {"global_batch": 1, "n_candidates": N_CAND})
    return {name: steps.bert4rec_bundle(cfg, shapes[name], mesh) for name in shapes}


def recsys_run(ref: dict, dev, mesh=None) -> dict:
    """The four cells on ``mesh`` (one process without): whole outputs as
    tensors on ``dev``."""
    bundles = recsys_bundles(mesh)
    params = _tensors(ref["params"], dev)

    def place(x, spec):
        return x if mesh is None else reshard_for_mesh(x, spec, mesh)

    def whole(x, spec):
        return x if mesh is None else gather_from_mesh(x, spec, mesh)

    def specs(name, i, out=False):
        b = bundles[name]
        return None if mesh is None else (b.out_specs if out else b.in_specs)[i]

    items, mask, serve_items = (torch.from_numpy(ref[k]).to(dev) for k in ("items", "mask", "serve_items"))
    res = {}
    b = bundles["train_batch"]
    p, o, m = b.fn(place(tree_map(torch.clone, params), specs("train_batch", 0)),
                   place(adamw_init(params), specs("train_batch", 1)),
                   place(items, specs("train_batch", 2)), place(mask, specs("train_batch", 3)))
    res["train_batch"] = (whole(p, specs("train_batch", 0, True)), whole(o, specs("train_batch", 1, True)), m)
    res["serve_p99"] = whole(bundles["serve_p99"].fn(place(params, specs("serve_p99", 0)),
                                                     place(serve_items, specs("serve_p99", 1))),
                             bundles["serve_p99"].out_specs)  # one output: its spec
    ids, scores = bundles["serve_bulk"].fn(place(params, specs("serve_bulk", 0)),
                                           place(serve_items, specs("serve_bulk", 1)), chunk=BULK_CHUNK)
    res["serve_bulk"] = (whole(ids, specs("serve_bulk", 0, True)), whole(scores, specs("serve_bulk", 1, True)))
    codes, adt = torch.from_numpy(ref["codes"]).to(dev), torch.from_numpy(ref["adt"]).to(dev)
    res["retrieval_cand"] = bundles["retrieval_cand"].fn(
        place(params, specs("retrieval_cand", 0)), serve_items[:1], place(codes, specs("retrieval_cand", 2)), adt)
    return res


def recsys_numpy(res: dict) -> dict:
    p, o, m = res["train_batch"]
    return {"train_batch": _train_out(p, o, m), "serve_p99": _np(res["serve_p99"]),
            "serve_bulk": tuple(_np(t) for t in res["serve_bulk"]),
            "retrieval_cand": tuple(_np(t) for t in res["retrieval_cand"])}


def recsys_cells(mesh, path: str) -> list:
    """The four cells on every mesh; rank 0 adds the one-process cells and
    whether the (1, 1) mesh equals them bit for bit."""
    with open(path, "rb") as f:
        ref = pickle.load(f)
    dev = mesh.device
    out = {"rank": dist.get_rank(), "meshes": {}}
    for name, m in _meshes(dev).items():
        out["meshes"][name] = {"coords": m.coords, **recsys_numpy(recsys_run(ref, dev, m))}
    if dist.get_rank() == 0:
        one = recsys_run(ref, dev)
        unit = recsys_run(ref, dev, Mesh({"data": 1, "model": 1}, [0], dev))
        out["one_process"] = recsys_numpy(one)
        out["unit_equal"] = {k: _same(one[k], unit[k]) for k in one}
    return _gathered(out)


# ---- the GNN family ----------------------------------------------------------


def gnn_config(arch: str):
    shape = next(s for s in get_arch(arch).shapes if s.name == "molecule")
    return steps.gnn_adapt_config(get_arch(arch).make_reduced(), shape)


def gnn_run(arch: str, ref: dict, dev, mesh=None):
    """One train step of ``arch`` from the reference's weights and graph
    (one process without a mesh): (params, opt_state, metrics), the state
    whole on ``dev``."""
    bundle = steps.build_bundle(arch, "molecule", reduced=True, device=dev, mesh=mesh)
    params = _tensors(ref[arch]["params"], dev)
    graph = gc.GraphBatch(**{k: None if v is None else torch.from_numpy(np.array(v)).to(dev)
                             for k, v in ref[arch]["graph"].items()}, n_graphs=GNN_GRAPHS)
    labels = torch.from_numpy(ref[arch]["labels"]).to(dev)
    if mesh is not None:
        graph = steps.shard_graph(graph, mesh)
    p, o, m = bundle.fn(params, adamw_init(params), graph, labels)
    return p, o, m


def gnn_cells(mesh, path: str) -> list:
    """One train step of every GNN arch on every mesh; rank 0 adds the
    one-process steps and whether the (1, 1) mesh equals them bit for
    bit."""
    with open(path, "rb") as f:
        ref = pickle.load(f)
    dev = mesh.device
    out = {"rank": dist.get_rank(), "meshes": {}}
    for name, m in _meshes(dev).items():
        out["meshes"][name] = {arch: _train_out(*gnn_run(arch, ref, dev, m)) for arch in GNN_ARCHS}
    if dist.get_rank() == 0:
        out["one_process"], out["unit_equal"] = {}, {}
        for arch in GNN_ARCHS:
            one = gnn_run(arch, ref, dev)
            unit = gnn_run(arch, ref, dev, Mesh({"data": 1, "model": 1}, [0], dev))
            out["one_process"][arch] = _train_out(*one)
            out["unit_equal"][arch] = _same((one[0], one[1].mu, one[1].nu, one[2]),
                                            (unit[0], unit[1].mu, unit[1].nu, unit[2]))
    return _gathered(out)

