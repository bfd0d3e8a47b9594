"""The segment layer's mesh mode in the port (``distributed.context``,
``launch.mesh``, the two programs of ``graph.segmented``,
``ShardedBuilder``'s mesh build, ``train.elastic.reshard_for_mesh``)
against the reference's, on the CPU.

* No ranks: ``device_count`` and ``mesh_context`` nesting; without a
  process group ``make_segment_mesh()`` is 1 wide and a wider one raises,
  ``make_production_mesh`` raises; a 1-wide ``mesh=`` builds inline with
  the graph of no mesh; the programs need a mesh.
* The reference's own ``shard_map`` programs run in one subprocess on two
  forced host devices at its test's sizes (2 x 300 x 32, k 5, ef 32,
  rerank vectors), with ``reshard_for_mesh`` on a small tree; the npz it
  writes holds its coder, stacked build, search and each device's shards.
* Two ``gloo`` ranks (``run_ranks``, spawned), from the reference's coder
  (``FlashBackend.from_state``): on each rank the build program equals the
  reference's bit for bit (adjacency and distances of both layers,
  levels, entries, codes), the search program's ids are equal and its
  distances within rtol 1e-5, ``reshard_for_mesh`` gives the device's
  shard; ``ShardedBuilder`` mesh mode over the 600 rows is ``"mesh"`` and
  every segment equals the port's ``build_segments_vmapped`` on the same
  plan and coder; the reference's three ``ValueError``s and the search's
  S != positions error are raised, with the reference's messages.
* Four ranks as a (2, 2) host mesh, segments along "data": every rank's
  build equals the vmapped build, and the replicas along "model" agree.
* A rank that raises makes ``run_ranks`` raise.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _mesh_ranks as mr
from repro_torch.core import flash as fl
from repro_torch.distributed import context as dctx
from repro_torch.graph import segmented as tseg
from repro_torch.graph.engine import BuildParams, prefix_entries, sample_levels
from repro_torch.graph.sharded import ShardConfig, ShardedBuilder, ShardPlan
from repro_torch.launch import mesh as tmesh
from _threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.graph import BuildParams
from repro.graph import backends as bk
from repro.graph.engine import prefix_entries, sample_levels
from repro.graph.segmented import fit_shared_coder, make_segmented_build_fn, make_segmented_search_fn
from repro.launch.mesh import make_segment_mesh
from repro.train.elastic import reshard_for_mesh

out_path, S, NS, D, Q, K, EF = sys.argv[1], 2, 300, 32, 16, 5, 32
assert len(jax.devices()) == 2
rng = np.random.default_rng(0)
data = rng.normal(size=(S * NS, D)).astype(np.float32)
queries = rng.normal(size=(Q, D)).astype(np.float32)
segs = data.reshape(S, NS, D)
params = BuildParams(r_upper=8, r_base=16, ef=32, batch=32, max_layers=2)
coder = fit_shared_coder(jax.random.PRNGKey(0), jnp.asarray(data), d_f=16, m_f=8, kmeans_iters=5)
levels = np.stack([sample_levels(s, NS, r_upper=8, max_layers=2) for s in range(S)])
entries = np.stack([prefix_entries(levels[s], params.batch) for s in range(S)])
mesh = make_segment_mesh()
built = make_segmented_build_fn(mesh, params=params)(
    jnp.asarray(segs), coder, jnp.asarray(levels), jnp.asarray(entries))
offsets = np.array([0, NS], np.int32)
ids, dists = make_segmented_search_fn(mesh, k=K, ef_search=EF)(
    built, jnp.asarray(queries), jnp.asarray(offsets), jnp.asarray(segs))
out = dict(data=data, queries=queries, plan_levels=levels, plan_entries=entries, offsets=offsets,
           ids=np.asarray(ids), dists=np.asarray(dists), codes=np.asarray(built.backend.codes),
           **{f: np.asarray(getattr(built, f)) for f in ("adj0", "adj0_d", "adj_up", "adj_up_d", "levels", "entry")})
# the sharded output cannot be sliced on this JAX (x[s] raises), so the
# coder's state takes the first segment's codes through numpy
state = bk.FlashBackend(coder, jnp.asarray(out["codes"][0])).state_dict()
out.update({"coder_state." + k: np.asarray(v) for k, v in state.items()})
tree = {"w": np.arange(48, dtype=np.float32).reshape(8, 6),
        "b": {"x": np.arange(4, dtype=np.int32), "y": np.arange(12, dtype=np.float32).reshape(2, 6)}}
specs = {"w": P("data", None), "b": {"x": P(), "y": P(None, ("data",))}}
placed = reshard_for_mesh(tree, specs, mesh)
for pos, dev in enumerate(mesh.devices.flat):
    for name, arr in (("w", placed["w"]), ("b.x", placed["b"]["x"]), ("b.y", placed["b"]["y"])):
        out[f"shard.{pos}.{name}"] = next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)
np.savez(out_path, **out)
print("REF-OK")
"""

#: the reference's messages (src/repro/graph/sharded.py's ``_build_mesh``)
#: for the builds in ``_mesh_ranks.two_ranks``, and the port's search error
ERRORS = {
    "algo": ("mesh mode runs the stacked hnsw/flash shard_map program; algo='vamana' must build through "
             "workers= instead"),
    "uniform": ("mesh mode needs uniform segment sizes, got [300, 299] (use balanced=True with n divisible "
                "by n_segments)"),
    "tile": "3 segments do not tile 2 mesh devices",
    "search_segments": ("the search program takes one segment a position of the mesh axes ('data',): "
                        "4 segments, 2 positions"),
}


def _params() -> BuildParams:
    return BuildParams(**mr.PARAMS)


def _assert_graph_equal(got: dict, want: dict, what: str):
    for f in (*mr.FIELDS, "codes"):
        np.testing.assert_array_equal(np.asarray(got[f]), np.asarray(want[f]), err_msg=f"{what}: {f}")


# ---- no ranks ---------------------------------------------------------------


def test_device_count_and_mesh_context_nesting():
    a = tmesh.make_segment_mesh(device="cpu")
    b = tmesh.Mesh({"data": 2, "model": 3}, range(6), "cpu")
    assert dctx.device_count(None) == 0 and dctx.device_count(a) == 1 and dctx.device_count(b) == 6
    assert tmesh.n_devices(b) == 6 and tmesh.batch_axes(b) == ("data",)
    assert dctx.get_current_mesh() is None
    with dctx.mesh_context(a):
        assert dctx.get_current_mesh() is a
        with dctx.mesh_context(b):
            assert dctx.get_current_mesh() is b
        assert dctx.get_current_mesh() is a
    assert dctx.get_current_mesh() is None
    dctx.set_current_mesh(b)
    try:
        assert dctx.get_current_mesh() is b
    finally:
        dctx.set_current_mesh(None)


def test_meshes_without_a_group_are_one_wide():
    m = tmesh.make_segment_mesh(device="cpu")
    assert m.shape == {"data": 1} and m.axis_names == ("data",) and m.coords == {"data": 0}
    assert m.axis_index(("data",)) == 0 and m.members("data") == [0]
    h = tmesh.make_host_mesh(device="cpu")
    assert h.shape == {"data": 1, "model": 1} and tmesh.batch_axes(h) == ("data",)
    with pytest.raises(ValueError, match="asked for 2 devices, have 1"):
        tmesh.make_segment_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.make_host_mesh(model=2, device="cpu")


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multi_pod"])
def test_production_mesh_raises_without_its_ranks(multi_pod):
    need = 512 if multi_pod else 256
    with pytest.raises(ValueError, match=f"needs {need} ranks, have 1"):
        tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_one_device_mesh_degrades_to_inline(tmp_path):
    data = np.random.default_rng(1).normal(size=(400, 32)).astype(np.float32)
    cfg = ShardConfig(n_segments=2, chunk_size=256, params=_params(), sample_size=256,
                      backend_kwargs=mr.CODER_KW)
    res = ShardedBuilder(cfg, mesh=tmesh.make_segment_mesh(1, device="cpu"), workdir=str(tmp_path / "a"),
                         device="cpu").build(data)
    assert res.mode == "inline" and res.n_workers == 1 and res.index.n == 400
    plain = ShardedBuilder(cfg, workdir=str(tmp_path / "b"), device="cpu").build(data)
    for got, want in zip(res.index.segments, plain.index.segments):
        _assert_graph_equal(mr.graph_arrays(got.graph), mr.graph_arrays(want.graph), "1-wide mesh")


def test_mesh_programs_need_a_mesh():
    with pytest.raises(ValueError, match="need a mesh"):
        tseg.make_segmented_build_fn(None, params=_params())
    with pytest.raises(ValueError, match="need a mesh"):
        tseg.make_segmented_search_fn(None, k=mr.K, ef_search=mr.EF)


# ---- the reference's programs -------------------------------------------------


@pytest.fixture(scope="module")
def ref_npz(tmp_path_factory) -> str:
    path = str(tmp_path_factory.mktemp("mesh_ref") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, path], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and "REF-OK" in proc.stdout, proc.stderr[-2000:]
    return path


@pytest.fixture(scope="module")
def ref(ref_npz) -> dict:
    return dict(np.load(ref_npz))


@pytest.fixture(scope="module")
def vmapped(ref) -> dict:
    """The port's single-process program from the reference's coder."""
    segs = torch.from_numpy(ref["data"].reshape(mr.S, mr.NS, mr.D))
    built = tseg.build_segments_vmapped(segs, mr.ref_coder(ref, "cpu"), ref["plan_levels"], ref["plan_entries"],
                                        params=_params())
    return mr.graph_arrays(built.index)


def test_vmapped_equals_the_reference_shard_map(ref, vmapped):
    _assert_graph_equal(vmapped, ref, "build_segments_vmapped")


# ---- two gloo ranks -----------------------------------------------------------


@pytest.fixture(scope="module")
def two(ref_npz, tmp_path_factory) -> list:
    return tmesh.run_ranks(mr.two_ranks, 2, ref_npz, str(tmp_path_factory.mktemp("mesh_two")), device="cpu",
                           timeout=120)


@pytest.mark.parametrize("rank", [0, 1])
def test_build_program_is_bit_equal_to_the_shard_map(two, ref, rank):
    out = two[rank]
    assert out["coords"] == {"data": rank} and out["device"] == "cpu"
    _assert_graph_equal(out["build"], ref, f"rank {rank}")


@pytest.mark.parametrize("rank", [0, 1])
def test_search_program_matches_the_shard_map(two, ref, rank):
    out = two[rank]
    assert out["ids"].dtype == np.int32 and out["ids"].shape == (mr.Q, mr.K)
    np.testing.assert_array_equal(out["ids"], ref["ids"])
    np.testing.assert_allclose(out["dists"], ref["dists"], rtol=1e-5)


@pytest.mark.parametrize("rank", [0, 1])
def test_reshard_for_mesh_gives_the_device_shard(two, ref, rank):
    for name, got in two[rank]["shards"].items():
        want = ref[f"shard.{rank}.{name}"]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_builder_mesh_mode_equals_vmapped(two, rank):
    out = two[rank]["sharded"]
    assert out["mode"] == "mesh" and out["n_workers"] == 2 and out["seg_sizes"] == [mr.NS, mr.NS]
    assert out["spill_dir"] == two[0]["sharded"]["spill_dir"]  # the first rank's plan, for every rank
    assert (out["ids"] >= 0).all()
    np.testing.assert_array_equal(out["ids"], two[0]["sharded"]["ids"])
    plan = ShardPlan.load(out["spill_dir"])
    stacked = torch.from_numpy(np.stack([plan.load_segment(s)[0] for s in range(plan.n_segments)]))
    p = _params()
    levels = np.stack([sample_levels(s, mr.NS, r_upper=p.r_upper, max_layers=p.max_layers)
                       for s in range(plan.n_segments)])
    entries = np.stack([prefix_entries(levels[s], p.batch) for s in range(plan.n_segments)])
    coder = fl.FlashCoder(*(torch.from_numpy(a) for a in out["coder"]))
    want = tseg.build_segments_vmapped(stacked, coder, levels, entries, params=p)
    for s in range(plan.n_segments):
        _assert_graph_equal(out["segments"][s], mr.graph_arrays(want.segment(s)), f"rank {rank}, segment {s}")


@pytest.mark.parametrize("case", list(ERRORS))
def test_reference_value_errors(two, case):
    assert [out["errors"][case] for out in two] == [ERRORS[case]] * 2


# ---- four ranks: a (2, 2) host mesh --------------------------------------------


@pytest.fixture(scope="module")
def four(ref_npz) -> list:
    return tmesh.run_ranks(mr.host_mesh_2x2, 4, ref_npz, device="cpu", timeout=120)


def test_host_mesh_build_equals_vmapped(four, vmapped):
    assert [out["coords"] for out in four] == [{"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    for r, out in enumerate(four):
        _assert_graph_equal(out["build"], vmapped, f"rank {r}")


def test_host_mesh_replicas_agree(four, ref):
    for out in four:
        np.testing.assert_array_equal(out["ids"], ref["ids"])
        np.testing.assert_array_equal(out["dists"], four[0]["dists"])


# ---- the launcher ----------------------------------------------------------------


def test_a_failing_rank_raises_in_the_caller():
    """The caller sees the first failure, not the peer's broken collective."""
    with pytest.raises(RuntimeError, match=r"(?s)the first:\nrank 1: .*failed on purpose"):
        tmesh.run_ranks(mr.fail_on_last, 2, device="cpu", timeout=60)
