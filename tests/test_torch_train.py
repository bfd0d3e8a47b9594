"""The port's BERT4Rec training against the reference's (``repro.train``,
``bert4rec_loss``, ``repro.data.pipeline``) on the same numpy inputs, on
the CPU, at the registry's reduced config (2,000 items, D 32, 2 blocks, 2
heads, S 24).

* ``bert4rec_loss`` and its gradients against ``jax.value_and_grad``, on
  random masks and on one masked position a row: loss rtol 1e-6, every gradient leaf allclose at rtol 1e-4, atol 2e-6 (float32
  sums in another order; the largest gradient is ~0.5).
* The tree helpers: the flatten order and path strings of a whole train
  state equal ``jax.tree_util.tree_flatten_with_path``'s; ``tree_size``,
  ``tree_bytes`` and ``fingerprint`` equal; ``tree_global_norm`` rtol 1e-6.
* ``adamw_update`` over a random tree, given the same gradients, for f32
  and bf16 moments × cosine / linear / constant × clipped or not, over 3
  steps through the warmup: parameters, f32 moments and metrics allclose at
  rtol 2e-6, atol 1e-7 (``cos`` and ``pow`` may round the last bit
  otherwise); bf16 moments within one bf16 step (2⁻⁷ relative).
* Both compressions are bit-equal (bf16 round trip; int8 with error
  feedback over 3 steps: codes, scales and residuals).
* ``make_train_step`` at microbatches 1 and 2 × none / bf16 / int8_ef over
  3 steps against the reference's jitted step: loss and lr at rtol 1e-5,
  grad_norm at rtol 1e-4 (it is the norm of the compressed gradients, and
  an int8 code at a rounding boundary moves it ~1e-5). Every parameter, moment and residual is within atol 1e-4,
  rtol 1e-4 of the reference's except at most 1 in 10,000 elements. Those
  are elements whose gradient is float noise in one package: AdamW's first
  step moves a parameter by ±lr whatever its gradient's size, so a noise
  gradient of the other sign moves it the other way, and an int8 code at a
  rounding boundary moves its residual by one quantization step. The test
  counts them and holds them within 2·steps·lr of the reference's.
* ``train`` resumed from a checkpoint equals an uninterrupted run bit for
  bit (int8_ef, bf16 moments, microbatches 2), the history continues from
  the checkpoint's step, ``donate=True`` updated the caller's tensors, and
  the last step is saved once (the reference saves it twice when
  ``n_steps`` is a multiple of ``checkpoint_every`` and its second
  ``os.replace`` raises).
* The checkpoint: roundtrip, keep-K, CRC corruption, shape mismatch, no
  ``.tmp`` left; the same tree saved by both packages gives an equal
  ``manifest.json``; checkpoints cross-load both ways bit for bit,
  bf16 moments and ``ef_state`` included.
* Elastic and pipeline as the reference's ``tests/test_train.py``:
  reassignment, divisibility over a mesh's axis sizes, data replayed on
  restart, prefetch order, microbatch reshape, deterministic batches; and
  ``reshard_for_mesh`` on a 1-wide mesh keeps the leaves whole and raises
  ``ValueError`` for a spec that does not divide (the ranks' shards are in
  ``tests/test_torch_mesh.py``).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import utils as jutils
from repro.models.recsys import bert4rec as jb
from repro.train import checkpoint as jck
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import utils as tu
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import microbatch_reshape, prefetch, sharded_batches
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models.recsys import bert4rec as tb
from repro_torch.train import checkpoint as tck
from repro_torch.train import compression as tcomp
from repro_torch.train import elastic
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl

CFG = get_arch("bert4rec").make_reduced()
JCFG = jb.Bert4RecConfig(**{f: getattr(CFG, f) for f in
                            ("n_items", "embed_dim", "n_blocks", "n_heads", "seq_len", "mask_prob")})
OPT = dict(lr=3e-3, warmup_steps=0, schedule="constant")  # the reference's recsys test's settings
BATCH = 8


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray, jb.init_bert4rec(jax.random.PRNGKey(0), JCFG))


def _torch(tree):
    return tu.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _batch(seed: int, step: int, b: int = BATCH) -> dict:
    """A session batch as a pure function of (seed, step)."""
    rng = np.random.default_rng([seed, step])
    items = rng.integers(0, CFG.n_items, (b, CFG.seq_len)).astype(np.int32)
    mask = rng.random((b, CFG.seq_len)) < CFG.mask_prob
    mask[:, -1] = True
    return {"items": items, "mask_positions": mask}


def _jloss(p, batch):
    return jb.bert4rec_loss(p, JCFG, batch["items"], batch["mask_positions"]), {}


def _tloss(p, batch):
    return tb.bert4rec_loss(p, CFG, batch["items"], batch["mask_positions"]), {}


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as integers: bf16 from either package, V2, or any dtype."""
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _state_pair(params, *, compression="int8_ef", state_dtype="bf16"):
    """One train state in both packages (random moments and residuals, so
    a roundtrip cannot pass on zeros)."""
    rng = np.random.default_rng(3)
    jtc = jtl.TrainConfig(opt=jopt.AdamWConfig(state_dtype=state_dtype), compression=compression)
    jstate = jtl.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jtc)
    noisy = lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)).astype(x.dtype)  # noqa: E731
    jtree = {"params": jstate.params,
             "opt_state": jopt.AdamWState(step=jnp.asarray(7, jnp.int32),
                                          mu=jax.tree_util.tree_map(noisy, jstate.opt_state.mu),
                                          nu=jax.tree_util.tree_map(noisy, jstate.opt_state.nu)),
             "ef_state": jcomp.EFState(residual=jax.tree_util.tree_map(noisy, jstate.ef_state.residual))}
    jtree = jax.tree_util.tree_map(np.asarray, jtree)

    def port_leaf(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(a))

    ttree = {"params": _torch(params),
             "opt_state": topt.AdamWState(step=torch.tensor(7, dtype=torch.int32),
                                          mu=tu.tree_map(port_leaf, jtree["opt_state"].mu),
                                          nu=tu.tree_map(port_leaf, jtree["opt_state"].nu)),
             "ef_state": tcomp.EFState(residual=tu.tree_map(port_leaf, jtree["ef_state"].residual))}
    return jtree, ttree


# ---- the loss ---------------------------------------------------------------


@pytest.mark.parametrize("masks", ["random", "one_column"])
def test_loss_and_grads_match_reference(params, masks):
    b = _batch(0, 0)
    if masks == "one_column":  # the mean runs over masked positions only
        b["mask_positions"][:] = False
        b["mask_positions"][:, 3] = True
    jl, jg = jax.value_and_grad(lambda p: _jloss(p, b)[0])(params)
    tl_, _, tg = ttl.value_and_grad(_tloss, _torch(params), {k: torch.from_numpy(v) for k, v in b.items()})
    assert tl_.dtype == torch.float32 and tl_.dim() == 0 and float(tl_) > 0
    np.testing.assert_allclose(float(tl_), float(jl), rtol=1e-6)
    jpaths = [p for p, _ in jck._flatten_with_paths(jg)[0]]
    assert [p for p, _ in tu.tree_paths(tg)] == jpaths
    for (path, g), jgl in zip(tu.tree_paths(tg), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgl), rtol=1e-4, atol=2e-6, err_msg=path)


def test_params_tree_roundtrip(params):
    model = tb.params_from_jax(params, CFG, device="cpu")
    back = tb.params_to_jax(model)
    assert [p for p, _ in tu.tree_paths(back)] == [p for p, _ in jck._flatten_with_paths(params)[0]]
    for a, b in zip(tu.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    # the module's no-grad encode and the tree's forward are one computation
    items = torch.from_numpy(_batch(2, 0)["items"])
    assert torch.equal(model.encode(items), tb.bert4rec_encode(tb.params_tree(model), CFG, items).detach())


# ---- tree helpers, optimizer, compression -----------------------------------


def test_tree_helpers_match_reference(params):
    jtree, ttree = _state_pair(params)
    jitems = jck._flatten_with_paths(jtree)[0]
    assert [p for p, _ in tu.tree_paths(ttree)] == [p for p, _ in jitems]
    assert tu.tree_size(ttree) == jutils.tree_size(jtree)
    assert tu.tree_bytes(ttree) == jutils.tree_bytes(jtree)
    assert tu.fingerprint(ttree) == jutils.fingerprint(jtree)
    np.testing.assert_allclose(float(tu.tree_global_norm(ttree["params"])),
                               float(jutils.tree_global_norm(jtree["params"])), rtol=1e-6)
    cast = tu.tree_cast(ttree["params"], torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in tu.tree_leaves(cast))
    rebuilt = tu.tree_unflatten(ttree, tu.tree_leaves(ttree))
    assert [p for p, _ in tu.tree_paths(rebuilt)] == [p for p, _ in jitems]
    assert isinstance(rebuilt["opt_state"], topt.AdamWState)


def _random_tree(rng, scale):
    return {"a": (rng.normal(size=(5, 7)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(11,)) * scale).astype(np.float32)}}


@pytest.mark.parametrize("clip", [False, True], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
def test_adamw_update_matches_reference(state_dtype, schedule, clip):
    rng = np.random.default_rng(4)
    kw = dict(lr=0.05, warmup_steps=2, total_steps=6, schedule=schedule, state_dtype=state_dtype,
              clip_norm=1.0 if clip else 1e6)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    p = _random_tree(rng, 1.0)
    jp, jst = p, jopt.adamw_init(p, state_dtype=state_dtype)
    tp, tst = _torch(p), topt.adamw_init(_torch(p), state_dtype=state_dtype)
    for _ in range(3):
        g = _random_tree(rng, 10.0 if clip else 0.1)
        jp, jst, jm = jopt.adamw_update(jcfg, g, jst, jp)
        tp, tst, tm = topt.adamw_update(tcfg, _torch(g), tst, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-6)
    if clip:
        assert float(jm["grad_norm"]) > 1.0
    assert int(tst.step) == int(jst.step) == 3
    for a, b in zip(tu.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-7)
    for tree_t, tree_j in ((tst.mu, jst.mu), (tst.nu, jst.nu)):
        for a, b in zip(tu.tree_leaves(tree_t), jax.tree_util.tree_leaves(tree_j)):
            assert a.dtype == (torch.bfloat16 if state_dtype == "bf16" else torch.float32)
            rtol = 2 ** -7 if state_dtype == "bf16" else 2e-6
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1, schedule=schedule)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = jopt.schedule_lr(jopt.AdamWConfig(**kw), jnp.asarray(s, jnp.int32))
        got = topt.schedule_lr(topt.AdamWConfig(**kw), torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=f"step {s}")


def test_compressions_bit_equal():
    rng = np.random.default_rng(5)
    g = _random_tree(rng, 0.01)
    np.testing.assert_array_equal(
        tcomp.decompress_f32(tcomp.compress_bf16(_torch(g)))["a"].numpy(),
        np.asarray(jcomp.decompress_f32(jcomp.compress_bf16(g))["a"]))
    jef, tef = jcomp.ef_init(g), tcomp.ef_init(_torch(g))
    for _ in range(3):
        g = _random_tree(rng, 0.01)
        jq, js, jef = jcomp.compress_int8(g, jef)
        tq, ts, tef = tcomp.compress_int8(_torch(g), tef)
        for tree_t, tree_j in ((tq, jq), (ts, js), (tef.residual, jef.residual),
                               (tcomp.decompress_int8(tq, ts), jcomp.decompress_int8(jq, js))):
            for a, b in zip(tu.tree_leaves(tree_t), jax.tree_util.tree_leaves(tree_j)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tu.tree_leaves(tq)[0].dtype == torch.int8


# ---- the train step ---------------------------------------------------------


def _noise_count(got, want, *, lr: float, steps: int, what: str) -> int:
    """Elements of ``got`` beyond atol/rtol 1e-4 of ``want``, each held
    within 2·steps·lr (see the module doc). Returns their count."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= 2 * steps * lr + 1e-4), what
    return int((np.abs(got - want) > 1e-4 + 1e-4 * np.abs(want)).sum())


@pytest.mark.parametrize("compression", ["none", "bf16", "int8_ef"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(params, microbatches, compression):
    jtc = jtl.TrainConfig(opt=jopt.AdamWConfig(**OPT), microbatches=microbatches, compression=compression)
    ttc = ttl.TrainConfig(opt=topt.AdamWConfig(**OPT), microbatches=microbatches, compression=compression)
    jstep = jax.jit(jtl.make_train_step(_jloss, jtc))
    tstep = ttl.make_train_step(_tloss, ttc)
    jtree = jtl.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jtc).tree()
    ttree = ttl.init_train_state(_torch(params), ttc).tree()
    steps = 3
    for s in range(steps):
        b = _batch(7, s)
        if microbatches > 1:
            b = {k: v.reshape(microbatches, BATCH // microbatches, *v.shape[1:]) for k, v in b.items()}
        jtree, jm = jstep(jtree, b)
        ttree, tm = tstep(ttree, {k: torch.from_numpy(v) for k, v in b.items()})
        assert sorted(tm) == sorted(jm)
        for k in jm:
            rtol = 1e-4 if k == "grad_norm" else 1e-5  # after int8: a code at a rounding boundary
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, err_msg=k)
    assert sorted(ttree) == sorted(jtree)
    assert int(ttree["opt_state"].step) == steps
    noise = sum(_noise_count(a.float().numpy(), np.asarray(b, np.float32), lr=OPT["lr"], steps=steps, what=path)
                for (path, a), b in zip(tu.tree_paths(ttree), jax.tree_util.tree_leaves(jtree)))
    assert noise <= tu.tree_size(ttree) // 10_000, f"{noise} of {tu.tree_size(ttree)} elements differ"


def test_train_resume_is_bit_equal(params, tmp_path):
    """An uninterrupted 6-step run against 3 steps, then a resume to 6 from
    the step-3 checkpoint, in the port (int8_ef, bf16 moments, 2
    microbatches, a checkpoint every 3 steps)."""
    tc = ttl.TrainConfig(opt=topt.AdamWConfig(**OPT, state_dtype="bf16"), microbatches=2,
                         compression="int8_ef", checkpoint_every=3, keep_checkpoints=5, log_every=1)

    def data(start):
        mk = lambda step, shard: microbatch_reshape(  # noqa: E731
            {k: torch.from_numpy(v) for k, v in _batch(11 + shard, step).items()}, 2)
        return sharded_batches(mk, shard_id=0, start_step=start)

    logs = []
    whole_p = _torch(params)
    whole, whole_hist = ttl.train(_tloss, whole_p, data(0), tc=tc, n_steps=6, ckpt_dir=str(tmp_path / "a"),
                                  log_fn=logs.append)
    assert whole.params is whole_p  # donate=True: the caller's tensors hold the result
    assert tck.list_checkpoints(str(tmp_path / "a")) == [3, 6]
    first, _ = ttl.train(_tloss, _torch(params), data(0), tc=tc, n_steps=3, ckpt_dir=str(tmp_path / "b"),
                         log_fn=logs.append)
    resumed, hist = ttl.train(_tloss, _torch(params), data(3), tc=tc, n_steps=6, ckpt_dir=str(tmp_path / "b"),
                              log_fn=logs.append)
    assert "[train] resumed from step 3" in logs
    assert [h["step"] for h in hist] == [4, 5, 6]
    assert [h["loss"] for h in hist] == [h["loss"] for h in whole_hist[3:]]
    for a, b in zip(tu.tree_leaves(resumed.tree()), tu.tree_leaves(whole.tree())):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the checkpoint's bf16 moments and residuals restore into the reference
    jtc = jtl.TrainConfig(opt=jopt.AdamWConfig(**OPT, state_dtype="bf16"), compression="int8_ef")
    jlike = jtl.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jtc).tree()
    jtree, step = jck.restore_checkpoint(str(tmp_path / "b"), jlike)
    assert step == 6
    for a, b in zip(jax.tree_util.tree_leaves(jtree), tu.tree_leaves(resumed.tree())):
        np.testing.assert_array_equal(_bits(a), _bits(b))


# ---- checkpoints ------------------------------------------------------------


def test_checkpoint_roundtrip_and_verify(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)}}
    tck.save_checkpoint(str(tmp_path), 7, tree)
    restored, step = tck.restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    assert tu.fingerprint(restored) == tu.fingerprint(tree)
    assert restored["b"]["c"].dtype == torch.int32


def test_checkpoint_keep_k_pruning(tmp_path):
    tree = {"a": torch.zeros(3)}
    for s in range(6):
        tck.save_checkpoint(str(tmp_path), s, tree, keep=3)
    assert tck.list_checkpoints(str(tmp_path)) == [3, 4, 5]
    assert tck.latest_checkpoint(str(tmp_path)) == 5


def test_checkpoint_corruption_detected(tmp_path):
    tree = {"a": torch.arange(100, dtype=torch.float32)}
    path = tck.save_checkpoint(str(tmp_path), 1, tree)
    npz = os.path.join(path, "arrays.npz")
    data = dict(np.load(npz))
    data["a0"][3] += 1.0
    np.savez(npz, **data)
    with pytest.raises(IOError):
        tck.restore_checkpoint(str(tmp_path), tree)


def test_checkpoint_shape_mismatch_detected(tmp_path):
    tck.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros((3, 4))})
    with pytest.raises(ValueError):
        tck.restore_checkpoint(str(tmp_path), {"a": torch.zeros((4, 3))})
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(tmp_path / "none"), {"a": torch.zeros((3, 4))})


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    tck.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3)})
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_manifest_equal_from_both_packages(params, tmp_path):
    jtree, ttree = _state_pair(params)
    jpath = jck.save_checkpoint(str(tmp_path / "ref"), 5, jtree)
    tpath = tck.save_checkpoint(str(tmp_path / "port"), 5, ttree)
    with open(os.path.join(jpath, "manifest.json")) as f:
        jman = f.read()
    with open(os.path.join(tpath, "manifest.json")) as f:
        tman = f.read()
    assert tman == jman
    dtypes = {m["dtype"] for m in json.loads(tman)["arrays"].values()}
    assert dtypes == {"float32", "bfloat16", "int32"}
    paths = [m["path"] for m in json.loads(tman)["arrays"].values()]
    for p in ("['params']/['blocks']/['attn']/['wq']", "['opt_state']/.step",
              "['opt_state']/.mu/['item_embed']", "['ef_state']/.residual/['out_bias']"):
        assert p in paths


def test_checkpoints_cross_load_both_ways(params, tmp_path):
    jtree, ttree = _state_pair(params)
    # the reference's checkpoint into the port
    jck.save_checkpoint(str(tmp_path / "ref"), 5, jtree)
    got, step = tck.restore_checkpoint(str(tmp_path / "ref"), ttree)
    assert step == 5 and isinstance(got["opt_state"], topt.AdamWState)
    assert tu.tree_leaves(got["opt_state"].mu)[0].dtype == torch.bfloat16
    for a, b in zip(tu.tree_leaves(got), jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the port's checkpoint into the reference
    tck.save_checkpoint(str(tmp_path / "port"), 6, ttree)
    back, step = jck.restore_checkpoint(str(tmp_path / "port"), jtree)
    assert step == 6
    for a, b in zip(jax.tree_util.tree_leaves(back), tu.tree_leaves(ttree)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


# ---- elastic and the pipeline (the reference's tests/test_train.py) ---------


def test_reassign_deterministic():
    a = elastic.reassign_data_shards(16, [0, 1, 3])
    b = elastic.reassign_data_shards(16, [3, 1, 0])
    assert a == b
    assert sorted(sum(a.values(), [])) == list(range(16))
    with pytest.raises(ValueError):
        elastic.reassign_data_shards(4, [])


def test_divisibility_guard_and_policy():
    assert elastic.validate_divisibility((16, 4), ("model", None), {"model": 1})
    assert elastic.validate_divisibility((16, 4), (("data", "model"),), {"data": 4, "model": 2})
    assert not elastic.validate_divisibility((6, 4), ("model",), {"model": 4})
    pol = elastic.ElasticPolicy()
    assert pol.should_restart(2) and not pol.should_restart(1)
    assert pol.can_continue(3, 4) and not pol.can_continue(2, 4)
    one = make_host_mesh(device="cpu")  # no process group: a 1 x 1 mesh keeps every leaf whole
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": np.arange(4)}}
    placed = elastic.reshard_for_mesh(tree, {"a": ("model",), "b": {"c": ()}}, one)
    assert torch.equal(placed["a"], tree["a"]) and torch.equal(placed["b"]["c"], torch.arange(4))
    with pytest.raises(ValueError, match="does not divide"):
        elastic.reshard_for_mesh(tree, {"a": (None, "data"), "b": {"c": ()}},
                                 Mesh({"data": 2}, [0, 1], "cpu"))


def test_restart_replays_same_data():
    mk = lambda step, shard: {k: torch.from_numpy(v) for k, v in _batch(shard, step).items()}  # noqa: E731
    it1 = sharded_batches(mk, shard_id=0)
    batches = [next(it1) for _ in range(5)]
    resumed = next(sharded_batches(mk, shard_id=0, start_step=3))
    assert torch.equal(batches[3]["items"], resumed["items"])
    assert not torch.equal(batches[2]["items"], resumed["items"])


def test_prefetch_preserves_order():
    assert list(prefetch(iter(range(10)), size=3)) == list(range(10))


def test_microbatch_reshape():
    out = microbatch_reshape({"x": torch.zeros((8, 4)), "y": {"z": torch.zeros(8)}}, 4)
    assert tuple(out["x"].shape) == (4, 2, 4) and tuple(out["y"]["z"].shape) == (4, 2)
    with pytest.raises(ValueError):
        microbatch_reshape({"x": torch.zeros((6, 4))}, 4)


@pytest.mark.parametrize("step", [0, 17, 1000])
def test_batches_deterministic(step):
    a, b = _batch(1, step), _batch(1, step)
    np.testing.assert_array_equal(a["items"], b["items"])
    np.testing.assert_array_equal(a["mask_positions"], b["mask_positions"])
