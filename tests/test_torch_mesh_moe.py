"""Expert-parallel MoE across ranks (``models/moe.py``'s ``impl="ep"``:
``_dispatch_ep`` and the reference's fallback to the capacity-scatter at
the global capacity, each rank over its own experts) and the collective
it needs, ``Mesh.all_to_all`` / ``MeshAxes.all_to_all``, against the
reference's ``shard_map`` MoE, on the CPU.

* The reference: one subprocess on four forced host devices runs
  ``moe_forward`` jitted under ``mesh_context`` on (2, 2), (1, 2) and
  (2, 1) meshes (``jax.make_mesh`` with ``AxisType.Auto`` axes), for the
  reduced moonshot MoE (8 experts, top 2, 2 shared, sigmoid routing) with
  ``impl="ep"`` at capacity factors 1.0 and 4.0, at 32 tokens (divisible
  by every mesh: the ep branch), 6 in two rows (the ep branch on the
  two-rank meshes, the fallback on (2, 2)), 7 (divisible by none) and 1
  (fewer than any mesh's devices): the fallback; and ``impl="scatter"``
  and ``"einsum"`` at 1.0 (the global capacity under a mesh too).
* The port: four ``gloo`` ranks (``tests/_mesh_lm_ranks.py``) on the same
  meshes (two replicas of each two-rank one), the mesh ambient, every
  rank holding its experts' shard, given every token, and again given its
  ``"data"`` group's rows alone (``token_axes=("data",)``, the rows put
  back together after); every output is held to the reference's on that
  mesh within atol 2e-5, and the one-process output to the reference's
  without a mesh.
* At capacity factor 1.0 the ep output differs from the global scatter's
  (per-device capacity drops other assignments): a port that ignored it
  would fail.
* The ep branch makes one ``all_to_all`` pair on every rank where the
  expert axis is wider than one rank; the fallback none.
* ``all_to_all`` against a plain loop over the senders, on 2 and 4 ranks,
  over each axis group, float32 and bfloat16.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import _mesh_lm_ranks as mlr
from repro_torch.launch import mesh as tmesh
from _threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5
#: x shapes: 32 tokens (the ep branch on every mesh), 6 (the ep branch on two ranks only), 7 (divides no
#: mesh), 1 (fewer than the devices)
SHAPES = {"n32": (2, 16), "n6": (2, 3), "n7": (1, 7), "n1": (1, 1)}
#: (impl, capacity factor, shapes)
CASES = [("ep", 1.0, tuple(SHAPES)), ("ep", 4.0, tuple(SHAPES)), ("scatter", 1.0, ("n32", "n6")),
         ("einsum", 1.0, ("n32", "n6"))]

REF_SCRIPT = """
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from jax.sharding import AxisType
from repro.configs.registry import get_arch
from repro.distributed.context import mesh_context
from repro.models import moe as jm

out_path, shapes, cases = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3])
assert len(jax.devices()) == 4
moe = get_arch("moonshot-v1-16b-a3b").make_reduced().moe
d = get_arch("moonshot-v1-16b-a3b").make_reduced().d_model
host = lambda t: jax.tree_util.tree_map(np.asarray, t)
rng = np.random.default_rng(5)
out = {"params": {}, "cases": {}, "want": {}, "scatter": {}}
meshes = {name: jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                              devices=jax.devices()[:shape[0] * shape[1]])
          for name, shape in (("2x2", (2, 2)), ("1x2", (1, 2)), ("2x1", (2, 1)))}
params = jm.init_moe(jax.random.PRNGKey(3), d_model=d, cfg=moe)
out["params"] = host(params)
xs = {n: rng.normal(size=(b, s, d)).astype(np.float32) for n, (b, s) in shapes.items()}
for impl, cf, names in cases:
    cfg = dataclasses.replace(moe, impl=impl, capacity_factor=cf)
    for n in names:
        key, x = f"{impl}-cf{cf}-{n}", xs[n]
        out["cases"][key] = {"impl": impl, "cf": cf, "x": x}
        out["scatter"][key] = np.asarray(jm.moe_forward(params, x, dataclasses.replace(cfg, impl="scatter"))[0])
        for name, mesh in meshes.items():
            with mesh_context(mesh):
                got = jax.jit(lambda p, x: jm.moe_forward(p, x, cfg)[0])(params, x)
            out["want"].setdefault(name, {})[key] = np.asarray(got)
with open(out_path, "wb") as f:
    pickle.dump(out, f)
print("REF-OK")
"""


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory) -> str:
    path = str(tmp_path_factory.mktemp("mesh_moe") / "ref.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, path, repr(SHAPES), repr(CASES)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "REF-OK" in proc.stdout, proc.stderr[-2000:]
    return path


@pytest.fixture(scope="module")
def ref(ref_path) -> dict:
    with open(ref_path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(ref_path) -> list:
    return tmesh.run_ranks(mlr.moe_cases, 4, ref_path, device="cpu", timeout=240)


def _ep_branch(key: str, mesh: str) -> bool:
    """Whether the reference takes the ep branch: ``impl="ep"``, and the
    tokens divide over the mesh's devices and are no fewer."""
    impl, _, n = key.split("-")
    b, s = SHAPES[n]
    n_dev = {"2x2": 4, "1x2": 2, "2x1": 2}[mesh]
    return impl == "ep" and (b * s) % n_dev == 0 and b * s >= n_dev


@pytest.mark.parametrize("layout", ["whole", "rows"])
@pytest.mark.parametrize("mesh", list(mlr.MESHES))
def test_moe_across_ranks_matches_reference(ranks, ref, mesh, layout):
    checked = 0
    for out in ranks:
        for key, got in out["meshes"][mesh][layout].items():
            np.testing.assert_allclose(got, ref["want"][mesh][key], rtol=0, atol=ATOL,
                                       err_msg=f"rank {out['rank']} {mesh} {layout} {key}")
            checked += 1
    assert checked >= 4 * (len(ref["cases"]) if layout == "whole" else 6)


def test_one_process_is_the_global_scatter(ranks, ref):
    for key, got in ranks[0]["one_process"].items():
        np.testing.assert_allclose(got, ref["scatter"][key], rtol=0, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("mesh", list(mlr.MESHES))
def test_per_device_capacity_drops(ref, mesh):
    """At capacity factor 1.0 the ep branch differs from the global
    scatter; at 4.0 (no drops) and on the fallback it does not."""
    for key, want in ref["want"][mesh].items():
        gap = float(np.abs(want - ref["scatter"][key]).max())
        if key.startswith("ep-cf1.0") and _ep_branch(key, mesh):
            assert gap > 0.05, (mesh, key, gap)
        else:
            assert gap < ATOL, (mesh, key, gap)


def test_ep_branch_exchanges(ranks):
    for out in ranks:
        for mesh, layouts in out["exchanges"].items():
            for layout, counts in layouts.items():
                for key, n in counts.items():
                    pair = _ep_branch(key, mesh) and mlr.MESHES[mesh][0]["model"] > 1
                    assert n == (2 if pair else 0), (out["rank"], mesh, layout, key, n)


@pytest.fixture(scope="module")
def exchanges() -> list:
    return tmesh.run_ranks(mlr.exchange_blocks, 4, None, device="cpu", timeout=120)


def test_all_to_all_against_a_loop(exchanges):
    assert [out["rank"] for out in exchanges] == [0, 1, 2, 3]
    for out in exchanges:
        assert len(out["got"]) == 12
        for key, got in out["got"].items():
            np.testing.assert_array_equal(got, out["want"][key], err_msg=f"rank {out['rank']} {key}")
