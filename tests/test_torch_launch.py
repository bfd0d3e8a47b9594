"""The port's per-cell steps (``launch/steps.py``: ``StepBundle``,
``build_bundle`` and BERT4Rec's steps) and ``data.synthetic.recsys_batch``
against the reference's, on the CPU.

* Steps: the four BERT4Rec bundles' ``fn`` at the reduced config with a
  70,000-row table (two of ``serve_bulk``'s 65,536-row chunks) equal the
  reference's bundle functions, jitted without shardings, on the same
  weights and inputs: scores within atol 2e-5, top-k ids equal (the
  ``retrieval_cand`` scan sums tie at the 400-row cut: the lower id is
  kept, as ``jax.lax.top_k`` keeps it), one train step's loss, grad_norm,
  lr and every parameter and moment leaf within 1e-4 of the leaf's largest
  magnitude (a parameter within 2·lr more: an element whose gradient is
  noise moves by lr either way on a first AdamW step). ``serve_bulk`` in
  blocks of 3 sessions equals one block.
* FLOPs: every cell of ``assigned_cells()`` has the reference bundle's
  ``model_flops``; ``flash-ann``'s cells raise ``ValueError``.
* Meta args: one cell per family and kind (dense and MLA decode), the
  port's ``args`` are meta tensors with the reference's
  ``ShapeDtypeStruct`` shapes and dtypes, path by path.
* ``recsys_batch``: shapes, dtypes, range, the last position masked, a
  mask share near ``mask_prob``, and a pure function of (seed, step,
  shard). The reference draws from ``jax.random``; the port's draw has its
  distribution, not its bits.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.models.gnn import common as jc
from repro.models.recsys import bert4rec as jb
from repro.train.optimizer import adamw_init as j_adamw_init
from repro_torch.configs import registry as treg
from repro_torch.data.synthetic import recsys_batch
from repro_torch.launch import steps as tsteps
from repro_torch.models.gnn import common as tc
from repro_torch.models.recsys import bert4rec as tb
from repro_torch.utils import tree_map, tree_paths
from _threads import one_torch_thread  # noqa: F401 (autouse fixture)

N_ITEMS = 70_000  # two serve_bulk chunks at the reduced widths
B = 8
SCORE_ATOL = 2e-5
STATE_RTOL = 1e-4


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def recsys():
    """Both packages' configs, the reference's weights and both trees of them."""
    jcfg = dataclasses.replace(jreg.get_arch("bert4rec").make_reduced(), n_items=N_ITEMS)
    tcfg = dataclasses.replace(treg.get_arch("bert4rec").make_reduced(), n_items=N_ITEMS)
    jparams = jb.init_bert4rec(jax.random.PRNGKey(0), jcfg)
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = tb.params_tree(tb.params_from_jax(np_tree, tcfg, device="cpu"))
    rng = np.random.default_rng(1)
    items = rng.integers(0, N_ITEMS, (B, tcfg.seq_len)).astype(np.int32)
    items[:, -1] = tcfg.mask_id
    return jcfg, tcfg, jparams, tparams, items


def _bundles(shape: str):
    j = jsteps.build_bundle("bert4rec", shape, _mesh(), reduced=True, cfg_override={"n_items": N_ITEMS})
    t = tsteps.build_bundle("bert4rec", shape, reduced=True, cfg_override={"n_items": N_ITEMS}, device="cpu")
    return j, t


def _close(got: torch.Tensor, want, atol: float = SCORE_ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


# ---- the recsys steps -------------------------------------------------------


def test_serve_p99_matches_reference(recsys):
    _, _, jparams, tparams, items = recsys
    j, t = _bundles("serve_p99")
    _close(t.fn(tparams, torch.from_numpy(items)), jax.jit(j.fn)(jparams, jnp.asarray(items)))


def test_serve_bulk_matches_reference(recsys):
    _, _, jparams, tparams, items = recsys
    j, t = _bundles("serve_bulk")
    ji, js = jax.jit(j.fn)(jparams, jnp.asarray(items))
    ti, ts = t.fn(tparams, torch.from_numpy(items))
    assert tuple(ti.shape) == (B, tsteps.BULK_K) and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(ts, js)
    bi, bs = t.fn(tparams, torch.from_numpy(items), block=3)
    assert torch.equal(bi, ti) and torch.equal(bs, ts)


def test_retrieval_cand_matches_reference(recsys):
    _, tcfg, jparams, tparams, items = recsys
    j, t = _bundles("retrieval_cand")
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 16, (N_ITEMS + 1, 16)).astype(np.int32)
    adt = rng.integers(0, 256, (16, 16)).astype(np.int32)
    want = jax.jit(j.fn)(jparams, jnp.asarray(items[:1]), jnp.asarray(codes), jnp.asarray(adt))
    got = t.fn(tparams, torch.from_numpy(items[:1]), torch.from_numpy(codes), torch.from_numpy(adt))
    for g, w, shape in zip(got, want, [(1, 100), (1, 100), (100,), (100,)]):
        assert tuple(g.shape) == shape
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[1], want[1])
    _close(got[3], want[3])
    assert got[0].dtype == got[2].dtype == torch.int32


def test_train_step_matches_reference(recsys):
    jcfg, tcfg, jparams, tparams, items = recsys
    j, t = _bundles("train_batch")
    mask = np.random.default_rng(3).random(items.shape) < tcfg.mask_prob
    mask[:, -1] = True
    plain = items.copy()
    plain[:, -1] = 7
    jopt = j_adamw_init(jparams)
    new_jp, new_jo, jm = jax.jit(j.fn)(jparams, jopt, jnp.asarray(plain), jnp.asarray(mask))
    tp = tree_map(torch.clone, tparams)
    new_tp, new_to, tm = t.fn(tp, tsteps.adamw_init(tp), torch.from_numpy(plain), torch.from_numpy(mask))
    assert t.donate == (0, 1) and new_tp is tp  # the donated step writes the state in place
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=STATE_RTOL)
    lr = float(jm["lr"])
    for tree_t, tree_j, extra in ((new_tp, new_jp, 2 * lr), (new_to.mu, new_jo.mu, 0.0), (new_to.nu, new_jo.nu, 0.0)):
        want = dict(_jax_paths(tree_j))
        for path, got in tree_paths(tree_t):
            w = np.asarray(want[path], np.float64)
            err = float(np.abs(got.double().numpy() - w).max())
            assert err <= STATE_RTOL * float(np.abs(w).max()) + extra, (path, err)


# ---- FLOPs and meta args ----------------------------------------------------


@pytest.mark.parametrize("arch,shape", jreg.assigned_cells(), ids=[f"{a}:{s}" for a, s in jreg.assigned_cells()])
def test_model_flops_match_reference(arch, shape):
    want = jsteps.build_bundle(arch, shape, _mesh()).model_flops
    got = tsteps.build_bundle(arch, shape, device="cpu")
    assert got.model_flops == want


def test_flash_ann_cells_are_not_steps():
    for shape in jreg.get_arch("flash-ann").shapes:
        with pytest.raises(ValueError):
            tsteps.build_bundle("flash-ann", shape.name, device="cpu")


def _jax_paths(tree):
    return [("/".join(str(k) for k in kp), x) for kp, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _spec(arg, jax_side: bool) -> dict:
    """{path: (shape, dtype name)} of one argument; a graph batch field by field."""
    if isinstance(arg, (tc.GraphBatch, jc.GraphBatch)):
        return {f: _spec(getattr(arg, f), jax_side) for f in ("nodes", "positions", "edges", "senders", "receivers",
                                                               "node_mask", "edge_mask", "graph_id")}
    if jax_side:
        return {p: (tuple(x.shape), str(x.dtype)) for p, x in _jax_paths(arg)}
    for _, x in tree_paths(arg):
        assert x.device.type == "meta"
    return {p: (tuple(x.shape), str(x.dtype).removeprefix("torch.")) for p, x in tree_paths(arg)}


META_CELLS = [("qwen1.5-0.5b", "train_4k"), ("qwen1.5-0.5b", "prefill_32k"), ("qwen1.5-0.5b", "decode_32k"),
              ("deepseek-v3-671b", "decode_32k"), ("gatedgcn", "full_graph_sm"), ("egnn", "molecule"),
              ("bert4rec", "train_batch"), ("bert4rec", "serve_p99"), ("bert4rec", "serve_bulk"),
              ("bert4rec", "retrieval_cand")]


@pytest.mark.parametrize("arch,shape", META_CELLS, ids=[f"{a}:{s}" for a, s in META_CELLS])
def test_meta_args_match_reference_shapes(arch, shape):
    j = jsteps.build_bundle(arch, shape, _mesh())
    t = tsteps.build_bundle(arch, shape, device="cpu")
    assert len(t.args) == len(j.args) and t.donate == j.donate
    for got, want in zip(t.args, j.args):
        assert _spec(got, False) == _spec(want, True)
    if isinstance(t.args[2] if len(t.args) > 2 else None, tc.GraphBatch):
        assert t.args[2].n_graphs == j.args[2].n_graphs


# ---- recsys_batch -----------------------------------------------------------


def test_recsys_batch_form():
    kw = dict(batch=64, seq=200, n_items=5000, device="cpu")
    b = recsys_batch(0, 3, 1, **kw)
    assert set(b) == {"items", "mask_positions"}
    items, mask = b["items"], b["mask_positions"]
    assert tuple(items.shape) == tuple(mask.shape) == (64, 200)
    assert items.dtype == torch.int32 and mask.dtype == torch.bool
    assert int(items.min()) >= 0 and int(items.max()) <= 4999
    assert bool(mask[:, -1].all())
    assert abs(float(mask[:, :-1].float().mean()) - 0.2) < 0.02
    want = jax.tree_util.tree_map(np.asarray, jsyn.recsys_batch(0, 3, 1, batch=64, seq=200, n_items=5000))
    assert want["items"].shape == tuple(items.shape) and str(want["items"].dtype) == "int32"
    assert abs(float((items == 0).float().mean()) - float((want["items"] == 0).mean())) < 0.02
    again = recsys_batch(0, 3, 1, **kw)
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(recsys_batch(0, 4, 1, **kw)["items"], items)
