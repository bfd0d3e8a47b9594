"""LM training across ranks for the GQA models (``launch/steps.py``'s train
cell under a mesh: ``lm_train_bundle(mesh=)``, ``lm_state_specs``,
``transformer.lm_loss(shards=)`` with the vocabulary-parallel
``layers.vocab_log_prob`` and the MoE aux losses over every token; the
gradients of ``distributed.collectives``) against the reference's GSPMD
program, on the CPU.

* The reference: one subprocess on four forced host devices
  (``jax.make_mesh`` with ``AxisType.Auto`` axes, ``mesh_context``) jits
  ``lm_train_bundle`` with its shardings and runs 2 steps (B 8 × S 8, two
  batches) from numpy weights. Cases: the reduced moonshot with
  ``impl="ep"`` at capacity factor 1.0 (per-device capacity drops) and
  remat on, on (2, 2), (1, 2) and (2, 1) meshes; on (2, 2) the reduced
  qwen1.5 (the Kv heads divide), the reduced qwen2 (Kv 1 with QKV biases,
  bfloat16 parameters) and the reduced llama with 6 heads and Kv 3 (a
  rank's query heads read Kv heads of both ranks' columns).
* The port: four ``gloo`` ranks (``tests/_mesh_lm_train_ranks.py``) run
  every case on the three meshes (two replicas of each two-rank one) from
  the reference's weights and batches. Dense cases are held to the
  reference's (2, 2) program on every mesh (their result does not depend
  on the mesh), moonshot to the reference's program on the same mesh.
  Bounds: every step's loss, ``ce``, ``moe/load_balance``,
  ``moe/router_z`` and ``grad_norm`` within 1e-5 relative; every gathered
  parameter and moment within 1e-4 of its tensor's largest magnitude
  (parameters 2·steps·lr more); a bfloat16 parameter's within a bfloat16
  step of it (its second moment two), since its gradient is bfloat16.
* A (1, 1) mesh gives the one-process steps bit for bit on the dense
  cases (moonshot within the bounds), and one process the reference's
  dense steps.
* The backward's ``all_to_all`` bytes equal the forward's, a pair a MoE
  layer, wherever ``"model"`` is wider than one rank; with remat the
  recomputation sends the forward's again.
* The collectives' gradients, on two ranks against one process:
  ``all_to_all``, ``gather`` (consumers replicated: a rank's own block of
  the gradient), ``gather(per_rank=True)`` (consumers that differ: summed,
  then a rank's block), the MoE's ep branch and its fallback; the ep
  branch with the exchange that carried no gradient leaves the expert
  weights none.
* ``lm_state_specs`` equals the reference's ``_lm_state_specs`` for the
  five LM configs, and the train bundle's ``in_specs`` / ``out_specs`` the
  reference bundle's shardings for the four GQA models; deepseek-v3 raises
  naming item 7.8.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import _mesh_lm_ranks as mlr
import _mesh_lm_train_ranks as mtr
from repro_torch.configs.registry import get_arch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.utils import tree_paths
from _threads import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_mesh_lm import LM_ARCHS, _norm_tree, _pspec_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5
STATE_REL = 1e-4
BF16_STEP = 2.0 ** -7
METRICS = ("loss", "ce", "moe/load_balance", "moe/router_z", "grad_norm")
#: case -> (arch, config override, meshes the reference runs on)
CASES = {
    "moonshot-ep": ("moonshot-v1-16b-a3b", {"moe": {"impl": "ep", "capacity_factor": 1.0}, "remat": True},
                    ("2x2", "1x2", "2x1")),
    "qwen1.5": ("qwen1.5-0.5b", {}, ("2x2",)),
    "qwen2-kv1": ("qwen2-72b", {}, ("2x2",)),
    "llama-kv3": ("llama3.2-3b", {"n_heads": 6, "n_kv_heads": 3}, ("2x2",)),
}
GQA = tuple(a for a in LM_ARCHS if a != "deepseek-v3-671b")

REF_SCRIPT = """
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from jax.sharding import AxisType
from repro.configs.registry import ShapeSpec, get_arch
from repro.distributed.context import mesh_context
from repro.launch import steps as js
from repro.models import transformer as jt
from repro.train.optimizer import adamw_init

out_path, cases, archs, (B, S, STEPS) = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3]), eval(sys.argv[4])
assert len(jax.devices()) == 4
host = lambda t: jax.tree_util.tree_map(np.asarray, t)
specs = lambda sh: jax.tree_util.tree_map(lambda s: tuple(s.spec) if s is not None else None, sh,
                                          is_leaf=lambda s: s is None or hasattr(s, "spec"))
pspecs = lambda t: jax.tree_util.tree_map(tuple, t, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
meshes = {name: jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                              devices=jax.devices()[:shape[0] * shape[1]])
          for name, shape in (("2x2", (2, 2)), ("1x2", (1, 2)), ("2x1", (2, 1)))}
shape = ShapeSpec("train_4k", "train", {"seq_len": S, "global_batch": B})
out = {"cases": {}, "specs": {}, "state_specs": {}}
for i, (case, (arch, override, names)) in enumerate(cases.items()):
    cfg = get_arch(arch).make_reduced()
    if "moe" in override:
        override = dict(override, moe=dataclasses.replace(cfg.moe, **override["moe"]))
    cfg = dataclasses.replace(cfg, **override)
    params = jt.init_lm(jax.random.PRNGKey(i), cfg)
    rng = np.random.default_rng(20 + i)
    batches = [tuple(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32) for _ in range(2)) for _ in range(STEPS)]
    r = {"arch": arch, "override": cases[case][1], "params": host(params), "batches": batches, "want": {}}
    for name in names:
        mesh = meshes[name]
        with mesh_context(mesh):
            bundle = js.lm_train_bundle(cfg, shape, mesh)
            fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings, out_shardings=bundle.out_shardings)
            p, o = params, adamw_init(params, state_dtype=js._lm_opt_cfg(cfg).state_dtype)
            rows = []
            for tokens, labels in batches:
                p, o, m = fn(p, o, tokens, labels)
                rows.append({k: float(v) for k, v in m.items()})
        r["want"][name] = {"steps": rows, "params": host(p), "mu": host(o.mu), "nu": host(o.nu)}
    out["cases"][case] = r
mesh = meshes["2x2"]
for arch in archs:
    cfg = get_arch(arch).make_full()
    params_s, opt_s = js._lm_state_shapes(cfg, js._lm_opt_cfg(cfg))
    ps, os_ = js._lm_state_specs(cfg, params_s, opt_s)
    out["state_specs"][arch] = (pspecs(ps), {"step": tuple(os_.step), "mu": pspecs(os_.mu), "nu": pspecs(os_.nu)})
    if cfg.attn != "mla":
        b = js.lm_train_bundle(cfg, get_arch(arch).shapes[0], mesh)
        out["specs"][arch] = {"in": specs(b.in_shardings[2:]), "out": specs(b.out_shardings[2:]),
                              "opt_in": specs(b.in_shardings[1]), "params_in": specs(b.in_shardings[0])}
with open(out_path, "wb") as f:
    pickle.dump(out, f)
print("REF-OK")
"""


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory) -> str:
    path = str(tmp_path_factory.mktemp("mesh_lm_train") / "ref.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, path, repr(CASES), repr(LM_ARCHS),
                           repr((mtr.B, mtr.S, mtr.STEPS))], env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0 and "REF-OK" in proc.stdout, proc.stderr[-3000:]
    return path


@pytest.fixture(scope="module")
def ref(ref_path) -> dict:
    with open(ref_path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(ref_path) -> list:
    return tmesh.run_ranks(mtr.train_cells, 4, ref_path, device="cpu", timeout=300)


@pytest.fixture(scope="module")
def grads() -> list:
    return tmesh.run_ranks(mtr.collective_grads, 2, device="cpu", timeout=120)


def _wanted(ref, case: str, mesh: str) -> dict:
    want = ref["cases"][case]["want"]
    return want.get(mesh, want["2x2"])


def _leaves(tree) -> dict:
    return {path: np.asarray(x, np.float64) for path, x in tree_paths(tree)}


def _hold(got: dict, want: dict, label: str) -> None:
    """Every step's metrics within REL relative; the final parameters and
    moments within STATE_REL of each tensor's largest magnitude
    (parameters 2·steps·lr more). A bfloat16 parameter (the reduced qwen2
    stores bfloat16) has a bfloat16 gradient, which float32 sums in
    another order move by a bfloat16 step: its parameter and first moment
    are held within one bfloat16 step of the tensor's largest magnitude
    (``BF16_STEP``, as ``tests/test_torch_lm_train.py`` holds bfloat16
    gradients), its second moment, a square, within two."""
    assert len(got["steps"]) == len(want["steps"]) == mtr.STEPS
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        for k in METRICS:
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=REL, atol=0, err_msg=f"{label} step {i}: {k}")
    lr = max(w["lr"] for w in want["steps"])
    bf16 = {path for path, x in tree_paths(want["params"]) if np.asarray(x).dtype.name == "bfloat16"}
    for tree, extra, steps in (("params", 2 * mtr.STEPS * lr, 1), ("mu", 0.0, 1), ("nu", 0.0, 2)):
        wanted = _leaves(want[tree])
        have = _leaves(got[tree])
        assert have.keys() == wanted.keys(), (label, tree)
        for path, a in have.items():
            w = wanted[path]
            assert a.shape == w.shape, (label, tree, path)
            err = float(np.abs(a - w).max())
            rel = steps * BF16_STEP if path in bf16 else STATE_REL
            assert err <= rel * float(np.abs(w).max()) + extra, (label, tree, path, err)


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_across_ranks_match_reference(ranks, ref, case):
    for out in ranks:
        for mesh, runs in out["meshes"].items():
            _hold(runs[case], _wanted(ref, case, mesh), f"rank {out['rank']} {mesh} {case}")


@pytest.mark.parametrize("case", [c for c in CASES if c != "moonshot-ep"])
def test_one_process_matches_reference(ranks, ref, case):
    _hold(ranks[0]["one_process"][case], _wanted(ref, case, "2x2"), f"one process {case}")


def test_unit_mesh_is_one_process(ranks):
    """The (1, 1) mesh: bit for bit on the dense cases; moonshot's ep branch
    on one device (its per-device capacity the global one) within the
    bounds of the one-process steps."""
    for case in CASES:
        if case == "moonshot-ep":
            _hold(ranks[0]["unit"][case], ranks[0]["one_process"][case], "(1, 1) moonshot")
        else:
            assert ranks[0]["unit_equal"][case], case


def test_backward_exchanges(ranks):
    """Each step's ``all_to_all`` bytes: the backward sends what the forward
    sent (two exchanges a MoE layer), and remat's recomputation sends the
    forward's again; none where ``"model"`` is one rank wide."""
    cfg = mlr.lm_config(*CASES["moonshot-ep"][:2])
    for out in ranks:
        for mesh, runs in out["meshes"].items():
            tp = mlr.MESHES[mesh][0]["model"]
            for case, run in runs.items():
                for step in run["steps"]:
                    comm = step["comm"]
                    if case != "moonshot-ep" or tp == 1:
                        assert comm["all_to_all_bytes"] == 0, (out["rank"], mesh, case, comm)
                        continue
                    grad = comm["all_to_all_grad_bytes"]
                    assert grad > 0 and comm["all_to_alls"] == 3 * 2 * cfg.n_moe_layers, (out["rank"], mesh, comm)
                    assert comm["all_to_all_bytes"] == 3 * grad, (out["rank"], mesh, comm)


@pytest.mark.parametrize("kind", ["all_to_all", "gather", "gather_per_rank"])
def test_collective_gradients(grads, kind):
    for out in grads:
        np.testing.assert_allclose(out["got"][kind], out["want"][kind], rtol=1e-6, atol=1e-6,
                                   err_msg=f"rank {out['rank']} {kind}")


@pytest.mark.parametrize("impl", ["ep", "scatter"])
def test_moe_gradients_across_ranks(grads, impl):
    """The ep branch (its exchanges' backward, the router entering through
    ``copy_to``, the chunks' gather) and the fallback (tokens and combine
    weights through ``copy_to``) give one process's gradients and global
    aux losses on two ranks."""
    for out in grads:
        got, want = out["got"][f"moe_{impl}"], out["want"][f"moe_{impl}"]
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k] is not None and float(np.abs(w).max()) > 0, (impl, k)
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()),
                                       err_msg=f"rank {out['rank']} {impl} {k}")
        np.testing.assert_allclose(list(out["got"][f"moe_{impl}_aux"].values()),
                                   list(out["want"][f"moe_{impl}_aux"].values()), rtol=1e-6)
    assert (grads[0]["got"]["moe_ep_grad_bytes"] > 0) and grads[0]["got"]["moe_scatter_grad_bytes"] == 0


def test_forward_only_exchange_left_experts_without_gradient(grads):
    """With the exchange that carried no backward, the expert weights of
    the ep branch got no gradient, and nothing said so."""
    for out in grads:
        assert all(g is None for g in out["forward_only_expert_grads"].values())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_state_specs_are_the_references(ref, arch):
    pspecs, ospecs = tsteps.lm_state_specs(get_arch(arch).make_full())
    want_p, want_o = ref["state_specs"][arch]
    assert pspecs == _pspec_tree(want_p)
    assert ospecs.step == want_o["step"] and ospecs.mu == _pspec_tree(want_o["mu"]) == ospecs.nu


@pytest.mark.parametrize("arch", GQA)
def test_train_bundle_specs_are_the_references(ref, arch):
    """The bundle's shardings on a (2, 2) mesh (the reference's replicated
    metrics output, None, as None); deepseek-v3 raises naming item 7.8."""
    mesh = tmesh.Mesh({"data": 2, "model": 2}, range(4), "cpu")  # no group: specs and shapes alone
    b = tsteps.build_bundle(arch, "train_4k", device="cpu", mesh=mesh)
    want = ref["specs"][arch]
    assert b.in_specs[0] == _pspec_tree(want["params_in"]) == b.out_specs[0]
    assert _norm_tree(tuple(b.in_specs[2:])) == _norm_tree(tuple(want["in"]))
    assert b.out_specs[2] is None and want["out"] == (None,)
    assert b.in_specs[1].mu == _pspec_tree(want["opt_in"].mu) == b.in_specs[1].nu
    assert b.in_specs[1].step == tuple(want["opt_in"].step) == ()
    with pytest.raises(NotImplementedError, match="item 7.8"):
        tsteps.build_bundle("deepseek-v3-671b", "train_4k", device="cpu", mesh=mesh)
