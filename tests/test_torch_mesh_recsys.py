"""BERT4Rec's four cells across ranks (``launch/steps.py``'s mesh cells:
``bert4rec_param_specs``, the tensor-parallel model, the vocabulary-
parallel cloze loss, the per-rank top-k merges, ``retrieval_cand``'s
``flash_scan`` on each rank's code rows; ``distributed.collectives``,
``Mesh.all_reduce``, the global clipping norm, ``gather_from_mesh``)
against the reference's GSPMD programs and the port's one-process cells,
on the CPU.

* The reference: one subprocess on four forced host devices runs
  ``build_bundle("bert4rec", cell, mesh (2, 2), reduced=True,
  cfg_override={"n_items": 2**12 - 1})`` jitted with its
  ``in_shardings`` / ``out_shardings`` (``retrieval_cand`` through
  ``bert4rec_bundle`` at 3,000 candidates, so that the code rows split
  otherwise than the 4,096 table rows) from numpy inputs made from a
  seed; its ``serve_bulk`` merges one 65,536-row chunk (the reference
  fixes it).
* The port: four ``gloo`` ranks (``tests/_mesh_steps_ranks.py``) from the
  reference's weights on (2, 2), (1, 2) and (2, 1) meshes (two replicas of
  each of the last two), ``serve_bulk`` in 256-row chunks (eight merges a
  rank). Every rank's outputs, put back together by ``gather_from_mesh``,
  are held to the reference and to the one-process cells at the bounds of
  ``tests/test_torch_launch.py``: scores within atol 2e-5 and top-k ids
  equal; one train step's loss within rtol 1e-5, grad_norm and lr within
  1e-4, every moment leaf within 1e-4 of its largest magnitude and every
  parameter within that plus 2·lr.
* A (1, 1) mesh gives the one-process cells bit for bit (on rank 0).
* Specs that do not divide raise ``ValueError``; the LM cells still
  outside the mesh (an MLA model's, its train cell too) raise
  ``NotImplementedError`` naming their ROADMAP item; the specs are the
  reference's ``_b4r_specs``.
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
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.train.elastic import reshard_for_mesh
from repro_torch.utils import tree_paths
from _threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_ATOL = 2e-5
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-4

REF_SCRIPT = """
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from repro.configs.registry import ShapeSpec, get_arch
from repro.launch import steps as js
from repro.models.recsys import bert4rec as jb
from repro.train.optimizer import adamw_init

out_path, n_items, b, n_cand = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
assert len(jax.devices()) == 4
mesh = jax.make_mesh((2, 2), ("data", "model"))
cfg = dataclasses.replace(get_arch("bert4rec").make_reduced(), n_items=n_items)
params = jb.init_bert4rec(jax.random.PRNGKey(0), cfg)
rng = np.random.default_rng(1)
items = rng.integers(0, n_items, (b, cfg.seq_len)).astype(np.int32)
serve_items = items.copy()
serve_items[:, -1] = cfg.mask_id
mask = rng.random(items.shape) < cfg.mask_prob
mask[:, -1] = True
codes = rng.integers(0, 16, (n_cand, 16)).astype(np.int32)
adt = rng.integers(0, 256, (16, 16)).astype(np.int32)
host = lambda t: jax.tree_util.tree_map(np.asarray, t)
out = dict(params=host(params), items=items, serve_items=serve_items, mask=mask, codes=codes, adt=adt)

def run(bundle, *args):
    return jax.jit(bundle.fn, in_shardings=bundle.in_shardings, out_shardings=bundle.out_shardings)(*args)

bundle = lambda cell: js.build_bundle("bert4rec", cell, mesh, reduced=True, cfg_override={"n_items": n_items})
p, o, m = run(bundle("train_batch"), params, adamw_init(params), items, mask)
out["train_batch"] = dict(params=host(p), mu=host(o.mu), nu=host(o.nu), **{k: float(v) for k, v in m.items()})
out["serve_p99"] = np.asarray(run(bundle("serve_p99"), params, serve_items))
out["serve_bulk"] = host(run(bundle("serve_bulk"), params, serve_items))
cand = js.bert4rec_bundle(cfg, ShapeSpec("retrieval_cand", "retrieval", {"global_batch": 1, "n_candidates": n_cand}),
                          mesh)
out["retrieval_cand"] = host(run(cand, params, serve_items[:1], codes, adt))
with open(out_path, "wb") as f:
    pickle.dump(out, f)
print("REF-OK")
"""


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory) -> str:
    path = str(tmp_path_factory.mktemp("mesh_recsys") / "ref.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, path, str(msr.N_ITEMS), str(msr.B), str(msr.N_CAND)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "REF-OK" in proc.stdout, proc.stderr[-2000:]
    return path


@pytest.fixture(scope="module")
def ref(ref_path) -> dict:
    with open(ref_path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(ref_path) -> list:
    return tmesh.run_ranks(msr.recsys_cells, 4, ref_path, device="cpu", timeout=240)


def _results(ranks) -> list:
    """(label, cells) for every rank's every mesh."""
    return [(f"rank {out['rank']} {name}", cells) for out in ranks for name, cells in out["meshes"].items()]


def _against(ranks, ref) -> list:
    """(label, cells, wanted): every mesh's cells against the reference and
    against the one-process cells."""
    one = ranks[0]["one_process"]
    return [(f"{label} vs {what}", cells, want) for label, cells in _results(ranks)
            for what, want in (("the reference", ref), ("one process", one))]


def _close(got, want, what: str):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=SCORE_ATOL, err_msg=what)


def _leaves(tree) -> dict:
    return {path: np.asarray(x) for path, x in tree_paths(tree)}


def test_mesh_coordinates(ranks):
    assert [out["rank"] for out in ranks] == [0, 1, 2, 3]
    assert [out["meshes"]["2x2"]["coords"] for out in ranks] == [{"data": d, "model": m} for d in (0, 1)
                                                                 for m in (0, 1)]
    assert [out["meshes"]["1x2"]["coords"] for out in ranks] == [{"data": 0, "model": m} for m in (0, 1)] * 2


def test_one_by_one_mesh_is_bit_equal_to_one_process(ranks):
    assert ranks[0]["unit_equal"] == {"train_batch": True, "serve_p99": True, "serve_bulk": True,
                                      "retrieval_cand": True}


def test_one_process_cells_match_the_reference(ranks, ref):
    one = ranks[0]["one_process"]
    _close(one["serve_p99"], ref["serve_p99"], "serve_p99")
    np.testing.assert_array_equal(one["serve_bulk"][0], ref["serve_bulk"][0])


def test_serve_p99_across_ranks(ranks, ref):
    for label, cells, want in _against(ranks, ref):
        assert cells["serve_p99"].shape == (msr.B, msr.N_ITEMS + 1)
        _close(cells["serve_p99"], want["serve_p99"], label)


def test_serve_bulk_across_ranks(ranks, ref):
    for label, cells, want in _against(ranks, ref):
        ids, scores = cells["serve_bulk"]
        assert ids.shape == (msr.B, tsteps.BULK_K) and ids.dtype == np.int32, label
        np.testing.assert_array_equal(ids, want["serve_bulk"][0], err_msg=label)
        _close(scores, want["serve_bulk"][1], label)


def test_retrieval_cand_across_ranks(ranks, ref):
    for label, cells, want in _against(ranks, ref):
        got = cells["retrieval_cand"]
        assert [g.shape for g in got] == [(1, 100), (1, 100), (100,), (100,)], label
        assert got[0].dtype == got[2].dtype == np.int32
        np.testing.assert_array_equal(got[0], want["retrieval_cand"][0], err_msg=label)
        np.testing.assert_array_equal(got[2], want["retrieval_cand"][2], err_msg=label)
        _close(got[1], want["retrieval_cand"][1], label)
        _close(got[3], want["retrieval_cand"][3], label)


def test_train_step_across_ranks(ranks, ref):
    for label, cells, want in _against(ranks, ref):
        got, exp = cells["train_batch"], want["train_batch"]
        np.testing.assert_allclose(got["loss"], exp["loss"], rtol=LOSS_RTOL, err_msg=label)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(got[key], exp[key], rtol=STATE_RTOL, err_msg=f"{label}: {key}")
        lr = exp["lr"]
        for tree, extra in (("params", 2 * lr), ("mu", 0.0), ("nu", 0.0)):
            wanted = _leaves(exp[tree])
            for path, a in _leaves(got[tree]).items():
                w = wanted[path].astype(np.float64)
                assert a.shape == w.shape, (label, tree, path)
                err = float(np.abs(a - w).max())
                assert err <= STATE_RTOL * float(np.abs(w).max()) + extra, (label, tree, path, err)


def test_specs_are_the_references():
    specs = tsteps.bert4rec_param_specs()
    assert specs["item_embed"] == ("model", None) and specs["out_bias"] == ("model",)
    assert specs["blocks"]["attn"]["wq"] == (None, None, "model") and specs["blocks"]["attn"]["wo"] == (
        None, "model", None)
    assert specs["blocks"]["mlp"] == {"wg": (None, None, "model"), "wu": (None, None, "model"),
                                      "wd": (None, "model", None)}
    mesh = tmesh.Mesh({"data": 2, "model": 2}, range(4), "cpu")  # no group: specs and shapes alone
    b = tsteps.build_bundle("bert4rec", "serve_bulk", reduced=True, device="cpu", mesh=mesh)
    assert b.in_specs == (specs, (("data",), None)) and b.out_specs == ((("data",), None),) * 2
    assert tsteps.build_bundle("bert4rec", "serve_p99", reduced=True, device="cpu", mesh=mesh).out_specs == (
        ("data",), "model")
    assert tsteps.build_bundle("bert4rec", "retrieval_cand", reduced=True, device="cpu",
                               mesh=mesh).in_specs[2] == ("model", None)
    assert tsteps.build_bundle("bert4rec", "serve_p99", reduced=True, device="cpu").in_specs is None


def test_specs_that_do_not_divide_raise():
    mesh = tmesh.Mesh({"data": 1, "model": 3}, range(3), "cpu")
    b = tsteps.build_bundle("bert4rec", "serve_p99", reduced=True, device="cpu", mesh=mesh)
    params = tsteps.b4r.params_tree(tsteps.b4r.Bert4Rec(msr.recsys_config(), device="cpu"))  # 4,096 rows
    with pytest.raises(ValueError, match="does not divide"):
        reshard_for_mesh(params, b.in_specs[0], mesh)
    with pytest.raises(ValueError, match="does not divide"):
        reshard_for_mesh(torch.zeros(1000, 16, dtype=torch.int32), ("model", None), mesh)


#: the LM cells that still raise under a mesh: the MLA model's (item 7.8)
LM_RAISES = {"train_4k": ("deepseek-v3-671b", "item 7.8"), "prefill_32k": ("deepseek-v3-671b", "item 7.8"),
             "decode_32k": ("deepseek-v3-671b", "item 7.8")}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_lm_cells_under_a_mesh_raise(shape):
    arch, label = LM_RAISES[shape]
    mesh = tmesh.Mesh({"data": 1, "model": 2}, range(2), "cpu")
    with pytest.raises(NotImplementedError, match=label):
        tsteps.build_bundle(arch, shape, reduced=True, device="cpu", mesh=mesh)
