"""GNN training in the port (``data.synthetic.random_csr_graph``,
``data.sampler``, the registry's GNN entries, ``launch.steps``'s GNN part,
``examples/torch_gnn_graph_build.py``) against the reference's, on the CPU.

* ``random_csr_graph``, ``sample_subgraph`` (a CSR with empty rows too)
  and 3 batches of ``minibatch_stream`` are bit-equal to the reference's:
  the same numpy draws in the same order.
* The registry's four GNN entries equal the reference's dataclasses field
  by field, full and reduced, and ``GNN_SHAPES`` equals the reference's;
  ``flash-ann`` resolves and ``assigned_cells()`` has the 40 graded cells.
* One ``gnn_train_step`` against the reference's ``build_bundle(arch,
  "molecule", mesh (1, 1), reduced=True).fn``, jitted without shardings,
  on the same arrays: the reference's weights carried by
  ``params_from_jax``, its ``random_graph_batch`` padded by the port's
  ``pad_graph`` to the bundle's input shapes, for all four archs. The loss
  within ``LOSS_RTOL``; grad_norm, lr and every moment leaf within
  ``STATE_RTOL`` of its largest magnitude (Equiformer's last attention
  bias, whose gradient is float noise, of the largest in its tree); every
  parameter within that plus 2·lr (an element whose gradient is noise
  beside nothing moves by lr either way on a first AdamW step).
* ``gnn_batch`` and ``gnn_minibatch`` give the bundle's padded shapes and
  label shapes; ``gnn_train_flops`` equals the bundle's ``model_flops`` for
  every arch and shape at the full configs.
* ``examples/torch_gnn_graph_build.py`` on the CPU at 500 atoms: edge
  agreement with exact kNN at least half a scan of the same codes
  (``code_scan_recall``), a finite energy equal to a second forward.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import sampler as jsamp
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.models.gnn import common as jc
from repro.train import optimizer as jopt
from repro_torch.configs import registry as treg
from repro_torch.data import sampler as tsamp
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import steps as tsteps
from repro_torch.models.gnn import common as tc
from repro_torch.testing.scan import code_scan_recall
from repro_torch.train.train_loop import init_train_state
from repro_torch.utils import tree_leaves, tree_paths

ARCHS = ("gatedgcn", "egnn", "nequip", "equiformer-v2")
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-4
NOISE_LEAF = "['layers']/['attn']/['b1']"


def _equal_dicts(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_random_csr_graph_and_sampler_bit_equal():
    got, want = tsyn.random_csr_graph(3, n_nodes=5000, avg_degree=12), jsyn.random_csr_graph(
        3, n_nodes=5000, avg_degree=12)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    indptr, indices = want
    csr_with_holes = (np.array([0, 2, 2, 5, 5, 6]), np.array([1, 3, 0, 4, 2, 1], np.int32))
    for (ip, ix), seeds, fanouts in (((indptr, indices), np.arange(0, 400, 7), [15, 10]),
                                     (csr_with_holes, np.array([1, 0, 3]), [2, 3])):
        _equal_dicts(tsamp.sample_subgraph(ip, ix, seeds, fanouts=fanouts, rng=np.random.default_rng(5)),
                     jsamp.sample_subgraph(ip, ix, seeds, fanouts=fanouts, rng=np.random.default_rng(5)))
    rng = np.random.default_rng(0)
    features = rng.normal(size=(5000, 6)).astype(np.float32)
    labels = rng.integers(0, 7, 5000)
    streams = [mod.minibatch_stream(indptr, indices, features, labels, batch_nodes=64, fanouts=[5, 3], seed=2)
               for mod in (tsamp, jsamp)]
    for _ in range(3):
        _equal_dicts(next(streams[0]), next(streams[1]))


def test_registry_matches_reference():
    for arch in ARCHS:
        t, j = treg.get_arch(arch), jreg.get_arch(arch)
        assert (t.family, t.notes) == (j.family, j.notes)
        for make in ("make_full", "make_reduced"):
            got, want = getattr(t, make)(), getattr(j, make)()
            assert type(got).__name__ == type(want).__name__
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert [(s.name, s.kind, s.dims) for s in t.shapes] == [(s.name, s.kind, s.dims) for s in j.shapes]
    assert [(s.name, s.kind, s.dims) for s in treg.GNN_SHAPES] == [
        (s.name, s.kind, s.dims) for s in jreg.GNN_SHAPES]
    assert treg.get_arch("flash-ann").family == "ann"
    assert len(treg.assigned_cells()) == 40


def _shape(name: str):
    return next(s for s in treg.GNN_SHAPES if s.name == name)


def _np_graph(g: tc.GraphBatch) -> jc.GraphBatch:
    def n(x):
        return None if x is None else x.numpy()

    return jc.GraphBatch(nodes=n(g.nodes), positions=n(g.positions), edges=n(g.edges), senders=n(g.senders),
                         receivers=n(g.receivers), node_mask=n(g.node_mask), edge_mask=n(g.edge_mask),
                         graph_id=n(g.graph_id), n_graphs=g.n_graphs)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference_bundle(arch):
    bundle = jsteps.build_bundle(arch, "molecule", jax.make_mesh((1, 1), ("data", "model")), reduced=True)
    shape = _shape("molecule")
    tcfg = tsteps.gnn_adapt_config(treg.get_arch(arch).make_reduced(), shape)
    jcfg = jsteps._gnn_adapt_config(jreg.get_arch(arch).make_reduced(), jreg.GNN_SHAPES[-1])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    d = shape.dims
    geometric = arch != "gatedgcn"
    g = jc.random_graph_batch(jax.random.PRNGKey(7), n_nodes=d["n_nodes"], n_edges=d["n_edges"],
                              d_feat=d["d_feat"], with_positions=geometric, n_graphs=d["n_graphs"])
    nodes = np.array(g.nodes)
    nodes[:, 0] = np.abs(nodes[:, 0]) * 3  # species in [0, 8)
    graph = tc.pad_graph(tc.GraphBatch(**{k: None if v is None else torch.from_numpy(np.array(v)) for k, v in (
        ("nodes", nodes), ("positions", g.positions), ("edges", g.edges), ("senders", g.senders),
        ("receivers", g.receivers), ("node_mask", g.node_mask), ("edge_mask", g.edge_mask),
        ("graph_id", g.graph_id))}, n_graphs=g.n_graphs), *tsteps.gnn_padded_sizes(d["n_nodes"], d["n_edges"]))
    rng = np.random.default_rng(1)
    labels = (rng.integers(0, tcfg.n_classes, graph.nodes.shape[0]).astype(np.int32) if arch == "gatedgcn"
              else rng.normal(size=(d["n_graphs"], 1)).astype(np.float32))
    jgraph = _np_graph(graph)
    for got, want in zip(jax.tree_util.tree_leaves(jgraph), jax.tree_util.tree_leaves(bundle.args[2])):
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert (labels.shape, labels.dtype) == (bundle.args[3].shape, bundle.args[3].dtype)

    params_np = jax.tree_util.tree_map(np.asarray, jsteps._GNN_FNS[type(jcfg)][0](jax.random.PRNGKey(0), jcfg))
    opt = jopt.adamw_init(params_np)
    new_p, new_o, metrics = jax.jit(bundle.fn)(params_np, opt, jgraph, labels)

    state = init_train_state(tc.params_from_jax(params_np, device="cpu"), tsteps.TrainConfig())
    tree, tmetrics = tsteps.gnn_train_step(tcfg)(state.tree(), {"graph": graph, "labels": torch.from_numpy(labels)})
    assert sorted(tmetrics) == sorted(metrics) == ["grad_norm", "loss", "lr"]
    np.testing.assert_allclose(float(tmetrics["loss"]), float(metrics["loss"]), rtol=LOSS_RTOL)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmetrics[k]), float(metrics[k]), rtol=STATE_RTOL)
    lr = float(metrics["lr"])
    opt_t = tree["opt_state"]
    assert int(opt_t.step) == int(new_o.step) == 1
    for name, got_tree, want_tree, atol in (("params", tree["params"], new_p, 2 * lr), ("mu", opt_t.mu, new_o.mu, 0.0),
                                            ("nu", opt_t.nu, new_o.nu, 0.0)):
        want_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(want_tree)]
        largest = max(float(np.abs(w).max()) for w in want_leaves)
        for (path, a), b in zip(tree_paths(got_tree), want_leaves, strict=True):
            a = a.numpy()
            scale = largest if path == NOISE_LEAF else float(np.abs(b).max())
            assert a.shape == b.shape and np.isfinite(a).all(), (name, path)
            assert float(np.abs(a - b).max()) <= STATE_RTOL * scale + atol, (name, path)


def test_batches_have_the_bundle_shapes_and_flops():
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    for arch in ARCHS:
        for shape in treg.GNN_SHAPES:
            bundle = jsteps.build_bundle(arch, shape.name, mesh)
            cfg = tsteps.gnn_adapt_config(treg.get_arch(arch).make_full(), shape)
            assert tsteps.gnn_train_flops(cfg, shape.dims["n_edges"]) == bundle.model_flops
            want = [x.shape for x in jax.tree_util.tree_leaves(bundle.args[2])] + [bundle.args[3].shape]
            assert tsteps.gnn_padded_sizes(shape.dims["n_nodes"], shape.dims["n_edges"]) == (
                want[0][0], bundle.args[2].senders.shape[0])
            if shape.name == "molecule":
                batch = tsteps.gnn_batch(cfg, shape, torch.Generator().manual_seed(0), device="cpu")
                got = [x.shape for x in tree_leaves([getattr(batch["graph"], f) for f in (
                    "nodes", "positions", "edges", "senders", "receivers", "node_mask", "edge_mask", "graph_id")])]
                assert [tuple(s) for s in got] + [tuple(batch["labels"].shape)] == [tuple(s) for s in want]
    # a sampled subgraph, as minibatch_lg's bundle pads it (at 64 seeds, fanout 15-10)
    indptr, indices = tsyn.random_csr_graph(0, n_nodes=3000, avg_degree=20)
    rng = np.random.default_rng(0)
    feats, labels, pos = rng.normal(size=(3000, 6)).astype(np.float32), rng.integers(0, 5, 3000), \
        rng.normal(size=(3000, 3)).astype(np.float32)
    sub = next(tsamp.minibatch_stream(indptr, indices, feats, labels, batch_nodes=64, fanouts=[15, 10]))
    for arch in ("gatedgcn", "nequip"):
        cfg = treg.get_arch(arch).make_reduced()
        b = tsteps.gnn_minibatch(cfg, sub, node_labels=labels, positions=pos, device="cpu")
        g = b["graph"]
        n_pad, e_pad = tsteps.gnn_padded_sizes(64 * 166, 64 * 165)
        assert (g.nodes.shape[0], g.senders.shape[0]) == (n_pad, e_pad)
        assert int(g.edge_mask.sum()) == int(sub["edge_mask"].sum())
        assert tuple(b["labels"].shape) == ((n_pad,) if arch == "gatedgcn" else (1, 1))


def test_example_on_the_cpu():
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "torch_gnn_graph_build.py")
    spec = importlib.util.spec_from_file_location("torch_gnn_graph_build", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.knn_graph_energy(500, device="cpu")
    index, desc = out["index"], out["desc"]
    scan = code_scan_recall(index.backend, index.data, desc, out["exact_ids"][:, :9], 64)
    assert out["overlap"] >= 0.5 * scan
    assert bool(torch.isfinite(out["energy"]).all()) and out["energy"].shape == (1, 1)
    with torch.no_grad():
        again, _ = example.egnn_forward(out["params"], out["graph"], example.EGNN_CFG)
    torch.testing.assert_close(again, out["energy"], rtol=0, atol=0)
