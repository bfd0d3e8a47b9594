"""The rank functions of ``tests/test_torch_mesh.py`` and of the card test
in ``tests/test_torch_cuda.py`` (not collected by pytest). ``launch.mesh.run_ranks`` pickles them by
import path; this module imports no JAX, so each spawned rank starts in a
few seconds. Each takes its inputs from an npz (the reference's own mesh
programs wrote it, or the card test), runs the port's programs on its rank
and returns what every rank saw (``all_gather_object``), so the test can
hold each rank to the reference."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.graph.backends import FlashBackend
from repro_torch.graph.engine import BuildParams
from repro_torch.graph.segmented import SegmentedIndexes, make_segmented_build_fn, make_segmented_search_fn
from repro_torch.graph.sharded import ShardConfig, ShardedBuilder
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.elastic import reshard_for_mesh

#: the reference test's sizes and build (tests/test_sharded.py's MESH_SCRIPT)
S, NS, D, Q, K, EF = 2, 300, 32, 16, 5, 32
PARAMS = dict(r_upper=8, r_base=16, ef=32, batch=32, max_layers=2)
CODER_KW = dict(d_f=16, m_f=8, kmeans_iters=5)
FIELDS = ("adj0", "adj0_d", "adj_up", "adj_up_d", "levels", "entry")

#: the tree and specs the reference's ``reshard_for_mesh`` placed
TREE = {"w": np.arange(48, dtype=np.float32).reshape(8, 6),
        "b": {"x": np.arange(4, dtype=np.int32), "y": np.arange(12, dtype=np.float32).reshape(2, 6)}}
SPECS = {"w": ("data", None), "b": {"x": (), "y": (None, ("data",))}}


def ref_coder(ref: dict, device):
    """The reference's coder, carried by ``FlashBackend.from_state``."""
    state = {k[len("coder_state."):]: ref[k] for k in ref if k.startswith("coder_state.")}
    return FlashBackend.from_state(state, device=device).coder


def graph_arrays(index) -> dict:
    """An ``HNSWIndex``'s (or a stack's) tensors and codes as numpy."""
    out = {f: np.asarray(torch.as_tensor(getattr(index, f)).cpu()) for f in FIELDS}
    out["codes"] = index.backend.codes.cpu().numpy()
    return out


def _gathered(out: dict) -> list:
    box = [None] * dist.get_world_size()
    dist.all_gather_object(box, out)
    return box


def _value_error(fn) -> str | None:
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


def _programs(mesh, ref: dict, seg_axes) -> dict:
    """The build and search programs on ``mesh`` from the reference's coder
    and plans."""
    segs = torch.from_numpy(ref["data"].reshape(S, NS, D)).to(mesh.device)
    coder = ref_coder(ref, mesh.device)
    params = BuildParams(**PARAMS)
    built = make_segmented_build_fn(mesh, params=params, seg_axes=seg_axes)(
        segs, coder, ref["plan_levels"], ref["plan_entries"])
    ids, dists = make_segmented_search_fn(mesh, k=K, ef_search=EF, seg_axes=seg_axes)(
        built, torch.from_numpy(ref["queries"]), ref["offsets"], segs)
    return {"coords": mesh.coords, "device": str(built.index.adj0.device), "build": graph_arrays(built.index),
            "ids": ids.cpu().numpy(), "dists": dists.cpu().numpy(), "built": built}


def two_ranks(mesh, npz: str, workdir: str) -> list:
    """The 1-D mesh: the programs, ``reshard_for_mesh``, ``ShardedBuilder``'s
    mesh mode over the 600 rows, and the reference's ``ValueError``s."""
    torch.set_num_threads(1)
    ref = dict(np.load(npz))
    out = _programs(mesh, ref, ("pod", "data"))
    built = out.pop("built")
    out["shards"] = _shards(mesh)

    def builder(name: str, **kw):
        cfg = dict(n_segments=S, chunk_size=256, params=BuildParams(**PARAMS), sample_size=512, seed=0,
                   backend_kwargs=CODER_KW) | kw
        return ShardedBuilder(ShardConfig(**cfg), mesh=mesh, workdir=os.path.join(workdir, name), device=mesh.device)

    res = builder("mesh").build(ref["data"])
    r = res.index.search(ref["queries"], k=K)
    out["sharded"] = {"mode": res.mode, "n_workers": res.n_workers, "spill_dir": res.plan.spill_dir,
                      "seg_sizes": list(res.plan.seg_sizes), "ids": r.ids.numpy(),
                      "segments": [graph_arrays(s.graph) for s in res.index.segments],
                      "coder": [t.numpy() for t in res.index.segments[0].backend.coder]}
    four = SegmentedIndexes(index=built.index._replace(adj0=torch.cat([built.index.adj0] * 2)))
    out["errors"] = {
        "algo": _value_error(lambda: builder("algo", algo="vamana").build(ref["data"])),
        "uniform": _value_error(lambda: builder("uniform").build(ref["data"][:-1])),
        "tile": _value_error(lambda: builder("tile", n_segments=3).build(ref["data"])),
        "search_segments": _value_error(lambda: make_segmented_search_fn(mesh, k=K, ef_search=EF)(
            four, torch.from_numpy(ref["queries"]), ref["offsets"], torch.zeros(4, NS, D))),
    }
    return _gathered(out)


def _shards(mesh) -> dict:
    placed = reshard_for_mesh(TREE, SPECS, mesh)
    return {"w": placed["w"].cpu().numpy(), "b.x": placed["b"]["x"].cpu().numpy(),
            "b.y": placed["b"]["y"].cpu().numpy()}


def segment_programs(mesh, npz: str) -> list:
    """The build and search programs alone on the 1-D mesh."""
    ref = dict(np.load(npz))
    out = _programs(mesh, ref, ("pod", "data"))
    out.pop("built")
    return _gathered(out)


def host_mesh_2x2(mesh, npz: str) -> list:
    """Four ranks as ``make_host_mesh(model=2)``: segments along "data",
    replicas along "model"."""
    torch.set_num_threads(1)
    ref = dict(np.load(npz))
    out = _programs(make_host_mesh(model=2, device=mesh.device), ref, ("data",))
    out.pop("built")
    return _gathered(out)


def fail_on_last(mesh) -> None:
    """Every rank but the last waits in a collective; the last raises."""
    if mesh.index == mesh.size - 1:
        raise RuntimeError("the last rank failed on purpose")
    mesh.barrier()
