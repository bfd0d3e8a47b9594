"""The GNN family in the port (``repro_torch.models.gnn``) against the
reference's ``repro.models.gnn``, on the CPU.

* ``common``: the segment sums, means and maxima (an empty segment −inf),
  ``degree``, ``mlp_apply`` and ``radial_basis`` allclose to the
  reference's.
* ``so3``: ``real_sph_harm(xp=np)``, ``_projection_basis`` and
  ``gaunt_tensor`` equal the reference's bit for bit (the same numpy
  arithmetic); the torch ``real_sph_harm``, ``wigner_d_from_rot``,
  ``rotate_coeffs`` and ``edge_rotation`` are allclose to the reference's
  (``SO3_ATOL``), at the poles (±z, within the 0.99 fallback band) and
  at a zero vector too.
* Each of the four models at its reduced registry config (and Equiformer
  at 3 layers, the depth at which its m ≥ 1 weights get a gradient: the
  first layer's input is scalars alone and the last layer's m ≥ 1 output
  never reaches the energy), fed one reference ``random_graph_batch``
  with masked edges, a receiver whose incoming edges are all masked
  (self-loops at r = 0) and species in [0, 8), with the reference's
  weights carried by ``params_from_jax``: the forward's outputs and the
  loss within ``FWD_RTOL`` of their largest magnitude, and every gradient
  leaf within ``GRAD_RTOL`` of its largest magnitude, or, for a leaf the
  loss does not depend on (Equiformer's last attention bias: the softmax
  is shift-invariant per head, so both sides hold float noise), within
  ``GRAD_RTOL`` of the largest gradient in the tree. Every gradient is
  finite on both sides.
* The reference's equivariance properties (``tests/test_models.py``,
  ``TestEquivariance``) re-asserted on the port's EGNN, NequIP and
  Equiformer, with the port's own weights and graph.
* ``params_to_jax(params_from_jax(t))`` returns every leaf bit for bit and
  the tree's paths in the reference's flatten order.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.gnn import common as jc
from repro.models.gnn import egnn as je
from repro.models.gnn import equiformer_v2 as jq
from repro.models.gnn import gatedgcn as jg
from repro.models.gnn import nequip as jn
from repro.models.gnn import so3 as jso3
from repro_torch.models.gnn import common as tc
from repro_torch.models.gnn import egnn as te
from repro_torch.models.gnn import equiformer_v2 as tq
from repro_torch.models.gnn import gatedgcn as tg
from repro_torch.models.gnn import nequip as tn
from repro_torch.models.gnn import so3 as tso3
from repro_torch.utils import tree_paths
from _lm_common import jit_ref

SO3_ATOL = 1e-5
FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
N, E, G = 40, 120, 3

#: case -> (arch, reference init/forward/loss, port forward/loss, config fields replaced)
CASES = {
    "gatedgcn": ("gatedgcn", jg.init_gatedgcn, jg.gatedgcn_forward, jg.gatedgcn_loss,
                 tg.gatedgcn_forward, tg.gatedgcn_loss, {}),
    "egnn": ("egnn", je.init_egnn, je.egnn_forward, je.egnn_loss, te.egnn_forward, te.egnn_loss, {}),
    "nequip": ("nequip", jn.init_nequip, jn.nequip_forward, jn.nequip_loss,
               tn.nequip_forward, tn.nequip_loss, {}),
    "equiformer-v2": ("equiformer-v2", jq.init_equiformer_v2, jq.equiformer_v2_forward, jq.equiformer_v2_loss,
                      tq.equiformer_v2_forward, tq.equiformer_v2_loss, {}),
    "equiformer-v2@3": ("equiformer-v2", jq.init_equiformer_v2, jq.equiformer_v2_forward, jq.equiformer_v2_loss,
                        tq.equiformer_v2_forward, tq.equiformer_v2_loss, {"n_layers": 3}),
}


def _random_rotation(seed: int) -> np.ndarray:
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


def _graph_np(d_feat: int, seed: int = 1) -> jc.GraphBatch:
    """The reference's random batch with edges masked, node N−1 receiving
    only self-loops (r = 0, so all its incoming edges are masked in the
    geometric models) and species ids in [0, 8) in column 0."""
    g = jc.random_graph_batch(jax.random.PRNGKey(seed), n_nodes=N, n_edges=E, d_feat=d_feat,
                              with_positions=True, n_graphs=G)
    nodes = np.array(g.nodes)
    nodes[:, 0] = np.abs(nodes[:, 0]) * 3
    snd, rcv, emask = np.array(g.senders), np.array(g.receivers), np.array(g.edge_mask)
    rcv[rcv == N - 1] = N - 2
    emask[-12:-3] = False
    snd[-3:] = rcv[-3:] = N - 1
    return g._replace(nodes=jnp.asarray(nodes), senders=jnp.asarray(snd), receivers=jnp.asarray(rcv),
                      edge_mask=jnp.asarray(emask))


def _to_torch(g: jc.GraphBatch) -> tc.GraphBatch:
    def t(x):
        return None if x is None else torch.from_numpy(np.array(x))

    return tc.GraphBatch(nodes=t(g.nodes), positions=t(g.positions), edges=t(g.edges), senders=t(g.senders),
                         receivers=t(g.receivers), node_mask=t(g.node_mask), edge_mask=t(g.edge_mask),
                         graph_id=t(g.graph_id), n_graphs=g.n_graphs)


def _config(case: str):
    arch, *_, fields = CASES[case]
    cfg = jreg.get_arch(arch).make_reduced()
    return dataclasses.replace(cfg, **fields)


def _labels(cfg, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if isinstance(cfg, jg.GatedGCNConfig):
        return rng.integers(0, cfg.n_classes, N).astype(np.int32)
    return rng.normal(size=(G, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def reference() -> dict:
    """case -> (weights, graph, labels, loss, forward outputs, gradients)
    from one jitted reference call each."""
    out = {}
    for case, (arch, init, fwd, loss, *_rest) in CASES.items():
        cfg = _config(case)
        g = _graph_np(getattr(cfg, "d_in", 6))
        labels = jnp.asarray(_labels(cfg))
        params = init(jax.random.PRNGKey(0), cfg)

        def loss_and_out(p, g, labels, fwd=fwd, loss=loss, cfg=cfg):
            return loss(p, g, labels, cfg), fwd(p, g, cfg)

        (lv, fo), grads = jit_ref(jax.value_and_grad(loss_and_out, has_aux=True))(params, g, labels)
        out[case] = (jax.tree_util.tree_map(np.asarray, params), g, np.asarray(labels), float(lv),
                     jax.tree_util.tree_map(np.asarray, fo), jax.tree_util.tree_map(np.asarray, grads))
    return out


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------


def test_segment_ops_match_the_reference():
    """Sums, means, maxima (an empty segment gives −inf in both), degrees,
    the MLP and the radial basis on the same numpy inputs."""
    rng = np.random.default_rng(5)
    data = rng.normal(size=(50, 3, 4)).astype(np.float32)
    ids = rng.integers(0, 9, 50).astype(np.int32)
    ids[ids == 4] = 5  # segment 4 stays empty
    mask = rng.random(50) < 0.7
    for reduce in ("sum", "mean", "max"):
        got = tc.scatter_edges_to_nodes(torch.from_numpy(data), torch.from_numpy(ids), 9, reduce=reduce).numpy()
        want = np.asarray(jc.scatter_edges_to_nodes(jnp.asarray(data), jnp.asarray(ids), 9, reduce=reduce))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=reduce)
    np.testing.assert_array_equal(tc.degree(torch.from_numpy(ids), torch.from_numpy(mask), 9).numpy(),
                                  np.asarray(jc.degree(jnp.asarray(ids), jnp.asarray(mask), 9)))
    p = jax.tree_util.tree_map(np.asarray, jc.mlp_init(jax.random.PRNGKey(3), (4, 8, 2)))
    x = data[:, 0, :]
    np.testing.assert_allclose(tc.mlp_apply(tc.params_from_jax(p, device="cpu"), torch.from_numpy(x)).numpy(),
                               np.asarray(jc.mlp_apply(p, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    r = np.abs(rng.normal(size=(40,)) * 3).astype(np.float32)
    r[:2] = (0.0, 7.5)  # at the clip and beyond the cutoff
    np.testing.assert_allclose(tc.radial_basis(torch.from_numpy(r), n_rbf=8, cutoff=5.0).numpy(),
                               np.asarray(jc.radial_basis(jnp.asarray(r), n_rbf=8, cutoff=5.0)), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# so3
# ---------------------------------------------------------------------------


def _points() -> np.ndarray:
    pts = np.random.default_rng(0).normal(size=(64, 3))
    poles = [[0, 0, 1], [0, 0, -1], [0.05, 0.0, 1.0], [0.0, -0.1, -1.0], [0.2, 0.0, 1.0], [1, 0, 0], [0, 0, 0]]
    return np.concatenate([pts, np.asarray(poles, float)]).astype(np.float32)


def test_so3_numpy_constants_bit_equal():
    pts = np.random.default_rng(3).normal(size=(200, 3))
    np.testing.assert_array_equal(tso3.real_sph_harm(6, pts, xp=np), jso3.real_sph_harm(6, pts, xp=np))
    for l_max in (2, 3, 4, 6):
        got, want = tso3._projection_basis(l_max), jso3._projection_basis(l_max)
        np.testing.assert_array_equal(got[0], want[0])
        assert len(got[1]) == len(want[1]) == l_max + 1
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)
    paths = tn.NequIPConfig(l_max=3).paths
    assert paths == jn.NequIPConfig(l_max=3).paths
    for path in paths:
        np.testing.assert_array_equal(tso3.gaunt_tensor(*path), jso3.gaunt_tensor(*path))


def test_so3_torch_functions_match_the_reference():
    pts = _points()
    np.testing.assert_allclose(tso3.real_sph_harm(6, torch.from_numpy(pts)).numpy(),
                               np.asarray(jso3.real_sph_harm(6, jnp.asarray(pts))), rtol=0, atol=SO3_ATOL)
    rot_t = tso3.edge_rotation(torch.from_numpy(pts))
    rot_j = jso3.edge_rotation(jnp.asarray(pts))
    np.testing.assert_allclose(rot_t.numpy(), np.asarray(rot_j), rtol=0, atol=SO3_ATOL)
    for got, want in zip(tso3.wigner_d_from_rot(6, rot_t), jso3.wigner_d_from_rot(6, rot_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=SO3_ATOL)
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(len(pts), 49, 5)).astype(np.float32)
    vec = rng.normal(size=(len(pts), 49)).astype(np.float32)
    for c in (feats, vec):
        got = tso3.rotate_coeffs(6, torch.from_numpy(c), rot_t).numpy()
        want = np.asarray(jso3.rotate_coeffs(6, jnp.asarray(c), rot_j))
        np.testing.assert_allclose(got, want, rtol=0, atol=SO3_ATOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# The four models against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_forward_loss_and_grads_match_the_reference(reference, case):
    _, _, _, _, tfwd, tloss, _ = CASES[case]
    cfg = _config(case)
    params_np, g, labels, want_loss, want_out, want_grads = reference[case]
    params = tc.params_from_jax(params_np, device="cpu")
    leaves = [p.requires_grad_(True) for _, p in tree_paths(params)]
    graph = _to_torch(g)
    loss = tloss(params, graph, torch.from_numpy(labels.copy()), cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with torch.no_grad():
        out = tfwd(params, graph, cfg)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=FWD_RTOL)
    got_out = [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]
    want_out = list(want_out) if isinstance(want_out, tuple) else [want_out]
    for a, b in zip(got_out, want_out, strict=True):
        assert np.isfinite(a).all()
        assert float(np.abs(a - b).max()) <= FWD_RTOL * float(np.abs(b).max())
    want_leaves = jax.tree_util.tree_leaves(want_grads)
    largest = max(float(np.abs(b).max()) for b in want_leaves)
    for (path, p), a, b in zip(tree_paths(params), grads, want_leaves, strict=True):
        a = torch.zeros_like(p) if a is None else a
        a = a.numpy()
        assert a.shape == b.shape and np.isfinite(a).all() and np.isfinite(b).all(), path
        noise = case.startswith("equiformer") and path == "['layers']/['attn']/['b1']"
        scale = largest if noise else float(np.abs(b).max())
        assert float(np.abs(a - b).max()) <= GRAD_RTOL * scale, path
    if case == "equiformer-v2@3":  # the m ≥ 1 weights matter at this depth
        assert all(float(np.abs(b).max()) > 0 for b in want_grads["layers"]["w_mr"])


def test_params_round_trip_bit_for_bit(reference):
    for case, (params_np, *_rest) in reference.items():
        back = tc.params_to_jax(tc.params_from_jax(params_np, device="cpu"))
        want = jax.tree_util.tree_flatten_with_path(params_np)[0]
        got = tree_paths(back)
        assert [p for p, _ in got] == ["/".join(str(k) for k in kp) for kp, _ in want], case
        for (_, a), (_, b) in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Equivariance on the port (tests/test_models.py::TestEquivariance)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graph() -> tc.GraphBatch:
    return tc.random_graph_batch(torch.Generator().manual_seed(0), n_nodes=24, n_edges=64, d_feat=6,
                                 with_positions=True, n_graphs=2, device="cpu")


def _rotated(g: tc.GraphBatch, rot: np.ndarray) -> tc.GraphBatch:
    return g._replace(positions=g.positions @ torch.from_numpy(rot).T)


@torch.no_grad()
def test_egnn_equivariance(graph):
    cfg = te.EGNNConfig(n_layers=2, d_hidden=16, d_in=6)
    p = te.init_egnn(torch.Generator().manual_seed(1), cfg, device="cpu")
    rot = _random_rotation(1)
    o1, x1 = te.egnn_forward(p, graph, cfg)
    o2, x2 = te.egnn_forward(p, _rotated(graph, rot), cfg)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-3)
    np.testing.assert_allclose((x1 @ torch.from_numpy(rot).T).numpy(), x2.numpy(), atol=1e-2)


@torch.no_grad()
def test_nequip_equivariance_and_translation(graph):
    cfg = tn.NequIPConfig(n_layers=2, channels=8, l_max=2, n_rbf=4)
    p = tn.init_nequip(torch.Generator().manual_seed(2), cfg, device="cpu")
    rot = _random_rotation(2)
    e1, h1 = tn.nequip_forward(p, graph, cfg)
    e2, h2 = tn.nequip_forward(p, _rotated(graph, rot), cfg)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), atol=1e-4)
    np.testing.assert_allclose(tso3.rotate_coeffs(2, h1, torch.from_numpy(rot)[None]).numpy(), h2.numpy(), atol=1e-4)
    e3, _ = tn.nequip_forward(p, graph._replace(positions=graph.positions + torch.tensor([1.5, -2.0, 0.7])), cfg)
    np.testing.assert_allclose(e1.numpy(), e3.numpy(), atol=1e-4)


@torch.no_grad()
def test_equiformer_v2_equivariance(graph):
    cfg = tq.EquiformerV2Config(n_layers=2, channels=16, l_max=4, m_max=2, n_heads=4, n_rbf=4)
    p = tq.init_equiformer_v2(torch.Generator().manual_seed(4), cfg, device="cpu")
    rot = _random_rotation(4)
    e1, h1 = tq.equiformer_v2_forward(p, graph, cfg)
    e2, h2 = tq.equiformer_v2_forward(p, _rotated(graph, rot), cfg)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), atol=1e-4)
    np.testing.assert_allclose(tso3.rotate_coeffs(4, h1, torch.from_numpy(rot)[None]).numpy(), h2.numpy(), atol=1e-3)
