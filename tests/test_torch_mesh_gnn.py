"""The GNN family's train step with its edges sharded across ranks
(``launch/steps.py``'s GNN cell under a mesh: ``shard_graph``, the models'
``to_edges`` / ``over=`` reductions, Equiformer's softmax across ranks,
the edge parameters' gradients summed over the edge shards) against the
reference's GSPMD program and the port's one-process step, on the CPU.

* The reference: one subprocess on four forced host devices runs
  ``build_bundle(arch, "molecule", mesh (2, 2), reduced=True).fn`` for the
  four archs, jitted with its ``in_shardings`` / ``out_shardings`` (edges
  over ("data", "model"), the rest replicated), on a 512-node graph of 128
  molecules with 1,500 edges padded to 2,048 (masked padding edges, every
  edge of node 0 masked too, so a receiver's edges are all masked) drawn
  by the reference's ``random_graph_batch``, from its weights.
* The port: four ``gloo`` ranks (``tests/_mesh_steps_ranks.py``) from the
  same weights and graph on (2, 2), (1, 2) and (2, 1) meshes (two
  replicas of each of the last two). Every rank's step is held to the
  reference and to the one-process step at the bounds of
  ``tests/test_torch_gnn_train.py``: loss within rtol 1e-5, grad_norm and
  lr within 1e-4, every moment leaf within 1e-4 of its largest magnitude
  (Equiformer's last attention bias, whose gradient is float noise, of the
  largest in its tree) and every parameter within that plus 2·lr.
* A (1, 1) mesh gives the one-process step bit for bit (on rank 0).
* Which parameters act on edges (``EDGE_PARAMS``: their gradients are
  partial sums on a rank's edge slice) is held by the gradients above: an
  edge leaf left out of an arch's list stays a partial sum, a node leaf put
  in is counted once a rank, and either breaks the reference's bound.
* A graph whose edges do not divide over the mesh raises ``ValueError``;
  the mesh step refuses a graph that ``shard_graph`` did not place.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import _mesh_steps_ranks as msr
from repro_torch.distributed.collectives import MeshAxes
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.utils import tree_paths
from _threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-4
NOISE_LEAF = "['layers']/['attn']/['b1']"

REF_SCRIPT = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from repro.configs import registry as jreg
from repro.launch import steps as js
from repro.models.gnn import common as jc
from repro.train.optimizer import adamw_init

out_path, n_nodes, n_edges, e_pad, n_graphs = sys.argv[1], *map(int, sys.argv[2:6])
assert len(jax.devices()) == 4
mesh = jax.make_mesh((2, 2), ("data", "model"))
molecule = next(s for s in jreg.GNN_SHAPES if s.name == "molecule")
host = lambda t: jax.tree_util.tree_map(np.asarray, t)
out = {}
for i, arch in enumerate(("gatedgcn", "egnn", "nequip", "equiformer-v2")):
    cfg = js._gnn_adapt_config(jreg.get_arch(arch).make_reduced(), molecule)
    geometric = arch != "gatedgcn"
    g = jc.random_graph_batch(jax.random.PRNGKey(7 + i), n_nodes=n_nodes, n_edges=n_edges,
                              d_feat=molecule.dims["d_feat"], with_positions=geometric, n_graphs=n_graphs)
    nodes = np.array(g.nodes)
    nodes[:, 0] = np.abs(nodes[:, 0]) * 3  # species in [0, 8)
    extra = e_pad - n_edges
    receivers = np.concatenate([np.asarray(g.receivers), np.zeros(extra, np.int32)])
    edge_mask = np.concatenate([np.asarray(g.edge_mask), np.zeros(extra, bool)]) & (receivers != 0)
    graph = dict(nodes=nodes, positions=None if g.positions is None else np.asarray(g.positions) * 0.3,
                 edges=None, senders=np.concatenate([np.asarray(g.senders), np.zeros(extra, np.int32)]),
                 receivers=receivers, node_mask=np.asarray(g.node_mask), edge_mask=edge_mask,
                 graph_id=np.asarray(g.graph_id))
    rng = np.random.default_rng(1 + i)
    labels = (rng.integers(0, cfg.n_classes, n_nodes).astype(np.int32) if arch == "gatedgcn"
              else rng.normal(size=(n_graphs, 1)).astype(np.float32))
    params = js._GNN_FNS[type(cfg)][0](jax.random.PRNGKey(i), cfg)
    bundle = js.build_bundle(arch, "molecule", mesh, reduced=True)
    fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings, out_shardings=bundle.out_shardings)
    p, o, m = fn(params, adamw_init(params), jc.GraphBatch(**graph, n_graphs=n_graphs), labels)
    out[arch] = dict(params=host(params), graph=graph, labels=labels,
                     step=dict(params=host(p), mu=host(o.mu), nu=host(o.nu), **{k: float(v) for k, v in m.items()}))
with open(out_path, "wb") as f:
    pickle.dump(out, f)
print("REF-OK")
"""


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory) -> str:
    path = str(tmp_path_factory.mktemp("mesh_gnn") / "ref.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    args = [str(x) for x in (msr.GNN_NODES, msr.GNN_EDGES, msr.GNN_EDGE_PAD, msr.GNN_GRAPHS)]
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, path, *args], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and "REF-OK" in proc.stdout, proc.stderr[-2000:]
    return path


@pytest.fixture(scope="module")
def ref(ref_path) -> dict:
    with open(ref_path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(ref_path) -> list:
    return tmesh.run_ranks(msr.gnn_cells, 4, ref_path, device="cpu", timeout=240)


def _check_step(got: dict, want: dict, label: str) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL, err_msg=label)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(got[key], want[key], rtol=STATE_RTOL, err_msg=f"{label}: {key}")
    lr = want["lr"]
    for tree, atol in (("params", 2 * lr), ("mu", 0.0), ("nu", 0.0)):
        wanted = dict(tree_paths(want[tree]))
        largest = max(float(np.abs(w).max()) for w in wanted.values())
        for path, a in tree_paths(got[tree]):
            w = np.asarray(wanted[path], np.float64)
            scale = largest if path == NOISE_LEAF else float(np.abs(w).max())
            assert a.shape == w.shape and np.isfinite(a).all(), (label, tree, path)
            assert float(np.abs(a - w).max()) <= STATE_RTOL * scale + atol, (label, tree, path)


@pytest.mark.parametrize("arch", msr.GNN_ARCHS)
def test_step_across_ranks_matches_the_reference(ranks, ref, arch):
    for out in ranks:
        for name, cells in out["meshes"].items():
            _check_step(cells[arch], ref[arch]["step"], f"{arch} rank {out['rank']} {name}")


@pytest.mark.parametrize("arch", msr.GNN_ARCHS)
def test_step_across_ranks_matches_one_process(ranks, ref, arch):
    one = ranks[0]["one_process"][arch]
    _check_step(one, ref[arch]["step"], f"{arch} one process")
    for out in ranks:
        for name, cells in out["meshes"].items():
            _check_step(cells[arch], one, f"{arch} rank {out['rank']} {name}")


@pytest.mark.parametrize("arch", msr.GNN_ARCHS)
def test_one_by_one_mesh_is_bit_equal_to_one_process(ranks, arch):
    assert ranks[0]["unit_equal"][arch]


def test_graph_that_does_not_divide_raises():
    mesh = tmesh.Mesh({"data": 1, "model": 3}, range(3), "cpu")
    cfg = msr.gnn_config("gatedgcn")
    shape = next(s for s in tsteps.get_arch("gatedgcn").shapes if s.name == "molecule")
    with pytest.raises(ValueError, match="does not divide"):
        tsteps.gnn_batch(cfg, shape, torch.Generator().manual_seed(0), device="cpu", mesh=mesh)
    bundle = tsteps.build_bundle("gatedgcn", "molecule", reduced=True, device="cpu", mesh=mesh)
    assert bundle.in_specs[2]["senders"] == (("data", "model"),) and bundle.in_specs[0] == ()
    batch = tsteps.gnn_batch(cfg, shape, torch.Generator().manual_seed(0), device="cpu")
    params = tsteps.gnn_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="shard_graph"):
        bundle.fn(params, tsteps.adamw_init(params), batch["graph"], batch["labels"])


def test_shard_graph_slices_the_edges_alone():
    mesh = tmesh.Mesh({"data": 2, "model": 2}, range(4), "cpu")  # rank 0's view: no group needed to place
    cfg = msr.gnn_config("egnn")
    shape = next(s for s in tsteps.get_arch("egnn").shapes if s.name == "molecule")
    whole = tsteps.gnn_batch(cfg, shape, torch.Generator().manual_seed(0), device="cpu")["graph"]
    mine = tsteps.shard_graph(whole, mesh)
    e = whole.senders.shape[0] // 4
    assert torch.equal(mine.senders, whole.senders[:e]) and torch.equal(mine.edge_mask, whole.edge_mask[:e])
    assert torch.equal(mine.nodes, whole.nodes) and torch.equal(mine.positions, whole.positions)
    assert isinstance(mine.edge_axes, MeshAxes) and mine.edge_axes.axes == ("data", "model")
    assert mine.edge_axes.size == 4 and whole.edge_axes is None
