"""LM serving across ranks for the GQA models (``launch/steps.py``'s
prefill and decode bundles under a mesh, ``transformer.LMShards``,
``lm_param_specs``, ``cache_specs``, ``fix_axes``, the tensor-parallel
``gqa_prefill`` / ``gqa_decode``, the vocabulary-parallel embedding and
head, the expert-parallel MoE) against the reference's GSPMD programs, on
the CPU.

* The reference: one subprocess on four forced host devices
  (``jax.make_mesh`` with ``AxisType.Auto`` axes, ``mesh_context``) jits
  ``lm_prefill_bundle`` and ``lm_decode_bundle`` with their shardings, at
  a prefill of B 8 × S 8 and, from its caches padded to 16 slots, a
  batched decode of the 8 rows (``decode_32k``'s layout) and a
  long-context one of the first 2 (``long_500k``'s) at position 8. Cases:
  the reduced moonshot with ``impl="ep"`` at capacity factor 1.0 (per-device
  capacity drops) on (2, 2), (1, 2) and (2, 1) meshes; on (2, 2) the
  reduced qwen1.5 (Kv 4: the prefill's caches by one ``all_to_all``), the
  reduced qwen2 (Kv 1 with QKV biases, which do not divide over
  ``"model"``: the k/v projections are gathered before RoPE) and the
  reduced llama with 6 heads and Kv 3 (a rank's k/v columns split a head,
  and its query heads read Kv heads of both ranks' columns).
* The port: four ``gloo`` ranks (``tests/_mesh_lm_ranks.py``) from the
  reference's weights and tokens run every case on the three meshes (two
  replicas of each two-rank one); each decode starts from the port's own
  prefill caches, gathered and padded. Dense cases are held to the
  reference's (2, 2) program on every mesh (their result does not depend
  on the mesh), moonshot to the reference's program on the same mesh.
  Bounds: logits within 1e-4 of the largest |logit|, every cache within
  1e-4 of its largest |value|, argmax equal except at near ties (a top-2
  margin below 1e-4), counted and printed.
* A (1, 1) mesh gives the one-process cells: bit for bit on the dense
  cases, within the bounds above on moonshot (the ep branch keeps the
  reference's per-device buffers).
* ``all_to_all`` counts: one a layer in the prefill where the Kv heads
  divide, none where they do not; one pair a MoE layer wherever the ep
  branch runs with ``"model"`` wider than one rank.
* The specs equal the reference's ``lm_param_specs``, ``cache_specs`` and
  ``_fix_axes`` for the five LM configs, and the bundles' ``in_specs`` /
  ``out_specs`` the reference bundles' shardings.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _mesh_lm_ranks as mlr
from repro.configs.registry import get_arch as jget_arch
from repro.launch import steps as js
from repro.models import transformer as jt
from repro_torch.configs.registry import ShapeSpec, get_arch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tfm
from _threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4
TIE = 1e-4
CELLS = ("prefill", "decode", "long")
#: case -> (arch, config override, meshes the reference runs on)
CASES = {
    "moonshot-ep": ("moonshot-v1-16b-a3b", {"moe": {"impl": "ep", "capacity_factor": 1.0}}, ("2x2", "1x2", "2x1")),
    "qwen1.5": ("qwen1.5-0.5b", {}, ("2x2",)),
    "qwen2-kv1": ("qwen2-72b", {}, ("2x2",)),
    "llama-kv3": ("llama3.2-3b", {"n_heads": 6, "n_kv_heads": 3}, ("2x2",)),
}
LM_ARCHS = ("qwen2-72b", "qwen1.5-0.5b", "llama3.2-3b", "deepseek-v3-671b", "moonshot-v1-16b-a3b")

REF_SCRIPT = """
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from jax.sharding import AxisType
from repro.configs.registry import ShapeSpec, get_arch
from repro.distributed.context import mesh_context
from repro.launch import steps as js
from repro.models import transformer as jt

out_path, cases, (B, S, S_MAX, LONG_B) = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3])
assert len(jax.devices()) == 4
host = lambda t: jax.tree_util.tree_map(np.asarray, t)
specs = lambda sh: jax.tree_util.tree_map(lambda s: tuple(s.spec) if s is not None else None, sh,
                                          is_leaf=lambda s: s is None or hasattr(s, "spec"))
meshes = {name: jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                              devices=jax.devices()[:shape[0] * shape[1]])
          for name, shape in (("2x2", (2, 2)), ("1x2", (1, 2)), ("2x1", (2, 1)))}
out = {"cases": {}, "specs": {}}
for i, (case, (arch, override, names)) in enumerate(cases.items()):
    cfg = get_arch(arch).make_reduced()
    if "moe" in override:
        override = dict(override, moe=dataclasses.replace(cfg.moe, **override["moe"]))
    cfg = dataclasses.replace(cfg, **override)
    params = jt.init_lm(jax.random.PRNGKey(i), cfg)
    tokens = np.random.default_rng(10 + i).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    r = {"arch": arch, "override": cases[case][1], "params": host(params), "tokens": tokens, "want": {}}
    for name in names:
        mesh = meshes[name]
        with mesh_context(mesh):
            pre = js.lm_prefill_bundle(cfg, ShapeSpec("prefill_32k", "prefill", {"seq_len": S, "global_batch": B}),
                                       mesh)
            logits, caches = jax.jit(pre.fn, in_shardings=pre.in_shardings, out_shardings=pre.out_shardings)(
                params, tokens)
            want = {"prefill": host((logits, caches))}
            padded = {k: np.pad(np.asarray(v), ((0, 0), (0, 0), (0, S_MAX - S), (0, 0), (0, 0)))
                      for k, v in caches.items()}
            for cell, rows in (("decode", B), ("long", LONG_B)):
                shape = ShapeSpec("decode_32k" if rows >= 8 else "long_500k", "decode",
                                  {"seq_len": S_MAX, "global_batch": rows})
                d = js.lm_decode_bundle(cfg, shape, mesh)
                lg, c = jax.jit(d.fn, in_shardings=d.in_shardings, out_shardings=d.out_shardings)(
                    params, {k: v[:, :rows] for k, v in padded.items()}, tokens[:rows, -1], np.int32(S))
                want[cell] = host((lg, c))
                if name == "2x2" and i == 0:
                    out["specs"][cell] = {"in": specs(d.in_shardings[1:]), "out": specs(d.out_shardings)}
            if name == "2x2" and i == 0:
                out["specs"]["prefill"] = {"in": specs(pre.in_shardings[1:]), "out": specs(pre.out_shardings)}
        r["want"][name] = want
    out["cases"][case] = r
with open(out_path, "wb") as f:
    pickle.dump(out, f)
print("REF-OK")
"""


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory) -> str:
    path = str(tmp_path_factory.mktemp("mesh_lm") / "ref.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    sizes = (mlr.B, mlr.S, mlr.S_MAX, mlr.LONG_B)
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, path, repr(CASES), repr(sizes)], env=env,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0 and "REF-OK" in proc.stdout, proc.stderr[-2000:]
    return path


@pytest.fixture(scope="module")
def ref(ref_path) -> dict:
    with open(ref_path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(ref_path) -> list:
    return tmesh.run_ranks(mlr.lm_cells, 4, ref_path, device="cpu", timeout=300)


def _wanted(ref, case: str, mesh: str) -> dict:
    """The reference's cells for ``case`` on ``mesh``: its own program
    there, or (a dense case) the (2, 2) one."""
    want = ref["cases"][case]["want"]
    return want.get(mesh, want["2x2"])


def _near_ties(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, -1)[:, -2:]
    return top2[:, 1] - top2[:, 0] < TIE


def _hold(got: tuple, want: tuple, label: str) -> int:
    """Logits within REL of the largest |logit|, every cache within REL of
    its largest |value|, argmax equal but at near ties; returns the near
    ties where the argmax differs."""
    (logits, caches), (w_logits, w_caches) = got, want
    assert logits.shape == w_logits.shape, label
    bound = REL * float(np.abs(w_logits).max())
    err = float(np.abs(logits - w_logits).max())
    assert err <= bound, (label, "logits", err, bound)
    for k, w in w_caches.items():
        assert caches[k].shape == w.shape, (label, k)
        err = float(np.abs(caches[k].astype(np.float64) - w).max())
        assert err <= REL * float(np.abs(w).max()), (label, k, err)
    differ = logits.argmax(-1) != w_logits.argmax(-1)
    assert not (differ & ~_near_ties(w_logits)).any(), (label, "argmax")
    return int(differ.sum())


@pytest.mark.parametrize("cell", CELLS)
def test_cells_across_ranks_match_reference(ranks, ref, cell):
    ties = 0
    for out in ranks:
        for mesh, cases in out["meshes"].items():
            for case, run in cases.items():
                ties += _hold(run["cells"][cell], _wanted(ref, case, mesh)[cell], f"rank {out['rank']} {mesh} {case}")
    print(f"{cell}: argmax differs at {ties} near ties")


@pytest.mark.parametrize("cell", CELLS)
def test_unit_mesh_is_one_process(ranks, cell):
    """The (1, 1) mesh: bit for bit on the dense cases, within the bounds
    on moonshot; one process is held to the (2, 2) mesh there too."""
    out = ranks[0]
    for case in CASES:
        one, unit = out["one_process"][case]["cells"][cell], out["unit"][case]["cells"][cell]
        _hold(unit, one, f"(1, 1) {case}")
        if case != "moonshot-ep":
            assert out["unit_equal"][case], case
            _hold(one, out["meshes"]["2x2"][case]["cells"][cell], f"one process {case}")


def test_exchanges(ranks):
    """``all_to_all`` a rank made in each cell: the prefill's caches (one a
    layer where the Kv heads divide over ``"model"``) and the ep branch's
    pair a MoE layer (the prefill's 64 tokens and the batched decode's 8
    divide over every mesh; the long-context decode's 2 go the ep way only
    on the two-rank meshes)."""
    for out in ranks:
        for mesh, cases in out["meshes"].items():
            shape = mlr.MESHES[mesh][0]
            n_dev, tp = shape["data"] * shape["model"], shape["model"]
            for case, run in cases.items():
                cfg = mlr.lm_config(CASES[case][0], CASES[case][1])
                moe_layers = cfg.n_moe_layers if tp > 1 else 0
                caches = cfg.n_layers if tp > 1 and cfg.n_kv_heads % tp == 0 else 0
                want = {"prefill": caches + 2 * moe_layers, "decode": 2 * moe_layers,
                        "long": 2 * moe_layers if mlr.LONG_B >= n_dev else 0}
                assert run["exchanges"] == want, (out["rank"], mesh, case, run["exchanges"])
    for case in ("qwen2-kv1", "llama-kv3"):
        assert ranks[0]["meshes"]["2x2"][case]["exchanges"]["prefill"] == 0


def _norm(spec):
    """A spec with one-name tuples as the name (``PartitionSpec`` writes
    them so; the two shard alike)."""
    if spec is None or not isinstance(spec, tuple):
        return spec
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _norm_tree(tree):
    if isinstance(tree, dict):
        return {k: _norm_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and any(isinstance(e, (dict, tuple)) and not _is_spec(e) for e in tree):
        return tuple(_norm_tree(e) for e in tree)
    return _norm(tree)


def _is_spec(t) -> bool:
    return isinstance(t, tuple) and all(e is None or isinstance(e, str) for e in t)


def _pspec_tree(tree):
    """A reference spec tree with every ``PartitionSpec`` as a tuple."""
    if isinstance(tree, dict):
        return {k: _pspec_tree(v) for k, v in tree.items()}
    return None if tree is None else tuple(tree)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_specs_are_the_references(arch):
    jcfg, tcfg = jget_arch(arch).make_full(), get_arch(arch).make_full()
    assert tfm.lm_param_specs(tcfg) == _pspec_tree(jt.lm_param_specs(jcfg))
    for seq_shard in (True, False):
        assert tfm.cache_specs(tcfg, seq_shard=seq_shard) == _pspec_tree(jt.cache_specs(jcfg, seq_shard=seq_shard))


def test_fix_axes_is_the_references():
    class Axes:  # the reference reads only ``axis_names``
        def __init__(self, names):
            self.axis_names = names

    specs = [(None, ("pod", "data"), "model", None), (("pod",), None), ("pod", "model"), (("data", "model"),), ()]
    for names in (("data", "model"), ("pod", "data", "model"), ("model",)):
        mesh = Axes(names)
        for spec in specs:
            assert _norm(tsteps.fix_axes(spec, mesh)) == tuple(js._fix_axes(P(*spec), mesh)), (names, spec)
    cache = tfm.cache_specs(get_arch("qwen1.5-0.5b").make_full(), seq_shard=True)["k"]
    assert tsteps.fix_axes(cache, Axes(("data", "model"))) == (None, ("data",), "model", None, None)


def test_bundle_specs_are_the_references(ref):
    """``in_specs`` past the parameters and ``out_specs`` of the three
    cells on a (2, 2) mesh equal the reference bundles' shardings (its
    replicated output, None, is ``()`` here); the parameters' are
    ``lm_param_specs``."""
    cfg = mlr.lm_config(*CASES["moonshot-ep"][:2])
    mesh = tmesh.Mesh({"data": 2, "model": 2}, range(4), "cpu")  # no group: specs and shapes alone
    bundles = {"prefill": tsteps.lm_prefill_bundle(cfg, ShapeSpec("prefill_32k", "prefill", {
        "global_batch": mlr.B, "seq_len": mlr.S}), mesh)}
    for cell, rows in (("decode", mlr.B), ("long", mlr.LONG_B)):
        shape = ShapeSpec("decode_32k", "decode", {"global_batch": rows, "seq_len": mlr.S_MAX})
        bundles[cell] = tsteps.lm_decode_bundle(cfg, shape, mesh)
    for cell, b in bundles.items():
        want = ref["specs"][cell]
        assert b.in_specs[0] == tfm.lm_param_specs(cfg)
        assert _norm_tree(tuple(b.in_specs[1:])) == _norm_tree(tuple(want["in"])), cell
        assert _norm_tree(tuple(() if s is None else s for s in want["out"])) == _norm_tree(b.out_specs), cell
    full = tsteps.build_bundle("moonshot-v1-16b-a3b", "long_500k", device="cpu", mesh=mesh)
    assert full.in_specs[1]["k"] == (None, None, ("data", "model"), None, None) and full.in_specs[2] == ()
    assert tsteps.build_bundle("qwen1.5-0.5b", "decode_32k", device="cpu", mesh=mesh).in_specs[2] == (("data",),)
