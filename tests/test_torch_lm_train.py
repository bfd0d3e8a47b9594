"""LM training in the port (``transformer.lm_loss``, the train step over it,
``launch.steps``, ``data.synthetic.lm_batch``, ``examples/torch_train_lm.py``)
against the reference's, on the CPU, with the weights of
``_lm_common.draw_like`` carried across by ``params_from_jax`` and the same
numpy tokens.

* ``lm_loss`` and every gradient leaf against ``jax.value_and_grad(lm_loss,
  has_aux=True)`` on the five reduced configs, a moonshot case at
  capacity factor 1.0 (tokens drop) and the same through the ``einsum``
  dispatch: loss and metrics (``ce``, ``moe/load_balance``,
  ``moe/router_z``, deepseek's ``mtp_ce``) at ``LOSS_RTOL``; each float32
  gradient leaf within ``GRAD_RTOL`` of its largest magnitude, each
  bfloat16 leaf (reduced qwen2 and deepseek store bfloat16) within one
  bfloat16 step of it (``BF16_GRAD_RTOL``): float32 sums in another order.
  Read on the CPU: loss and metrics 1.5e-7 relative at most, float32
  gradients 2.9e-6 of the leaf's largest, bfloat16 ones 2.4e-3.
* The train step against the reference's jitted ``make_train_step`` over
  2 steps, moonshot reduced: float32 and bfloat16 moments, and 2
  microbatches against the reference's ``scan``; metrics at ``LOSS_RTOL``
  (``grad_norm`` at ``GRAD_RTOL``); every parameter and moment within
  ``STATE_ATOL`` + ``STATE_RTOL``·|reference| but at most 1 in 10,000
  elements, each within 2·steps·lr (an element whose gradient is float
  noise beside its moments moves by up to lr a step, whichever sign the
  noise has; one wk element of 4,096 read 6.6e-5 off at lr 1e-3). The
  donated step equals the functional one bit for bit,
  and writes into the tensors it was given; remat on equals remat off bit
  for bit (loss, metrics, every gradient).
* ``lm_opt_cfg`` equals the reference's ``_lm_opt_cfg``, and the train,
  prefill and decode FLOPs equal the ``model_flops`` of the reference's
  bundles (``lm_train_bundle`` …) at the registry's shapes, on the five
  full configs.
* ``lm_batch``: shapes, dtype, range, labels the tokens shifted by one,
  the same draw for the same (seed, step, shard) and another for another;
  the share of each of the tokens 0–3 within 0.02 of the reference's draw
  at the same size (token 0's expected share is 1 − 2^(−1/0.7) ≈ 0.628).
* ``examples/torch_train_lm.py`` on the CPU at 1 layer, d 64, V 256, S 16:
  2 steps with checkpoints, then ``--resume`` to 4, whose loss equals a
  4-step run's.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import synthetic as jsyn
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import transformer as jt
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import utils as tu
from repro_torch.configs import registry as treg
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl
from _lm_common import draw_like, jit_ref

ARCHS = ("qwen2-72b", "qwen1.5-0.5b", "llama3.2-3b", "deepseek-v3-671b", "moonshot-v1-16b-a3b")
#: case -> (arch, MoE fields replaced in both packages' reduced configs)
CASES = {
    **{arch: (arch, {}) for arch in ARCHS},
    "moonshot-drop": ("moonshot-v1-16b-a3b", {"capacity_factor": 1.0}),
    "moonshot-einsum-drop": ("moonshot-v1-16b-a3b", {"capacity_factor": 1.0, "impl": "einsum"}),
}
B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_GRAD_RTOL = 2.0 ** -7
STATE_ATOL = STATE_RTOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=0, schedule="constant")

_value_and_grad = jit_ref(jax.value_and_grad(jt.lm_loss, has_aux=True), static_argnums=1)


def _configs(case: str):
    arch, moe = CASES[case]
    jcfg, tcfg = jreg.get_arch(arch).make_reduced(), treg.get_arch(arch).make_reduced()
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe))
    return jcfg, tcfg


def _tokens(seed: int, vocab: int, b: int = B) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, S + 1)).astype(np.int32)


def _np32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t32(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


@pytest.fixture(scope="module")
def grads() -> dict:
    return {}


def _grads(cache: dict, case: str) -> dict:
    """Both packages' loss, metrics and gradients on one case (weights and
    tokens drawn from the arch, so the moonshot cases share them)."""
    if case in cache:
        return cache[case]
    arch = CASES[case][0]
    jcfg, tcfg = _configs(case)
    tree_np = draw_like(lambda: jt.init_lm(jax.random.PRNGKey(0), jcfg), ARCHS.index(arch))
    toks = _tokens(ARCHS.index(arch), jcfg.vocab)
    (jloss, jm), jg = _value_and_grad(jax.tree_util.tree_map(jnp.asarray, tree_np), jcfg,
                                      jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))
    tp = tt.params_from_jax(tree_np, tcfg, device="cpu")
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    tloss, tm, tg = ttl.value_and_grad(tsteps.lm_loss_fn(tcfg), tp, batch)
    cache[case] = {
        "ref": (float(jloss), {k: float(v) for k, v in jm.items()}, jax.tree_util.tree_leaves(jg)),
        "port": (float(tloss), {k: float(v) for k, v in tm.items()}, tu.tree_paths(tg)),
    }
    return cache[case]


@pytest.mark.parametrize("case", CASES)
def test_lm_loss_and_grads_match_reference(grads, case):
    run = _grads(grads, case)
    (jloss, jm, jg), (tloss, tm, tg) = run["ref"], run["port"]
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    want_keys = {"ce"} | ({"moe/load_balance", "moe/router_z"} if "moonshot" in case or "deepseek" in case
                          else set()) | ({"mtp_ce"} if "deepseek" in case else set())
    assert set(tm) == set(jm) == want_keys
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k], v, rtol=LOSS_RTOL, err_msg=k)
    assert len(tg) == len(jg)
    for (path, got), want in zip(tg, jg):
        assert tuple(got.shape) == want.shape and str(got.dtype).removeprefix("torch.") == str(want.dtype), path
        want = _np32(want)
        rtol = BF16_GRAD_RTOL if got.dtype == torch.bfloat16 else GRAD_RTOL
        np.testing.assert_allclose(_t32(got), want, rtol=0, atol=rtol * float(np.abs(want).max()), err_msg=path)


def test_capacity_one_drops_tokens(grads):
    """The dropping cases see other losses than the one at the reduced
    config's capacity factor (4.0: no drop) on the same weights and tokens,
    in both packages."""
    full = _grads(grads, "moonshot-v1-16b-a3b")
    for case in ("moonshot-drop", "moonshot-einsum-drop"):
        run = _grads(grads, case)
        assert run["ref"][0] != full["ref"][0] and run["port"][0] != full["port"][0], case


# ---- the train step ---------------------------------------------------------


def _moonshot_state(tc_kwargs: dict, mb: int):
    jcfg, tcfg = _configs("moonshot-v1-16b-a3b")
    tree_np = draw_like(lambda: jt.init_lm(jax.random.PRNGKey(0), jcfg), 7)
    jtc = jtl.TrainConfig(opt=jopt.AdamWConfig(**OPT, **tc_kwargs), microbatches=mb)
    ttc = ttl.TrainConfig(opt=topt.AdamWConfig(**OPT, **tc_kwargs), microbatches=mb)
    jtree = jtl.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree_np), jtc).tree()
    ttree = ttl.init_train_state(tt.params_from_jax(tree_np, tcfg, device="cpu"), ttc).tree()
    return jcfg, tcfg, jtc, ttc, jtree, ttree


def _lm_batches(vocab: int, mb: int, steps: int = 2) -> list:
    out = []
    for s in range(steps):
        toks = _tokens(100 + s, vocab, B * mb)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if mb > 1:
            b = {k: v.reshape(mb, B, S) for k, v in b.items()}
        out.append(b)
    return out


@pytest.mark.parametrize("state_dtype,mb", [("f32", 1), ("bf16", 1), ("f32", 2)],
                         ids=["f32-moments", "bf16-moments", "f32-moments-2-microbatches"])
def test_train_step_matches_reference(state_dtype, mb):
    jcfg, tcfg, jtc, ttc, jtree, ttree = _moonshot_state({"state_dtype": state_dtype}, mb)
    jstep = jit_ref(jtl.make_train_step(lambda p, b: jt.lm_loss(p, jcfg, b["tokens"], b["labels"]), jtc))
    tstep = tsteps.lm_train_step(tcfg, ttc)
    for b in _lm_batches(jcfg.vocab, mb):
        jtree, jm = jstep(jtree, {k: jnp.asarray(v) for k, v in b.items()})
        ttree, tm = tstep(ttree, {k: torch.from_numpy(v) for k, v in b.items()})
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=GRAD_RTOL if k == "grad_norm" else LOSS_RTOL, err_msg=k)
    assert int(ttree["opt_state"].step) == 2
    off = total = 0
    for (path, got), want in zip(tu.tree_paths(ttree), jax.tree_util.tree_leaves(jtree)):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), path
        got, want = _t32(got).astype(np.float64), _np32(want).astype(np.float64)
        assert np.all(np.abs(got - want) <= 2 * 2 * OPT["lr"] + STATE_ATOL), path
        off += int((np.abs(got - want) > STATE_ATOL + STATE_RTOL * np.abs(want)).sum())
        total += want.size
    assert off <= total // 10_000, f"{off} of {total} elements differ"


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()


def test_donated_step_is_bit_equal_to_the_functional_step():
    """deepseek reduced (bfloat16 parameters, MLA, MoE, MTP), 2 microbatches,
    2 steps: the same metrics and state bits; the donated step returns the
    trees it was given, their tensors updated in place."""
    jcfg, tcfg = _configs("deepseek-v3-671b")
    tree_np = draw_like(lambda: jt.init_lm(jax.random.PRNGKey(0), jcfg), 5)
    tc = ttl.TrainConfig(opt=topt.AdamWConfig(**OPT), microbatches=2)
    trees = [ttl.init_train_state(tt.params_from_jax(tree_np, tcfg, device="cpu"), tc).tree() for _ in range(2)]
    given = trees[1]
    ptrs = [t.data_ptr() for t in tu.tree_leaves(given["params"])]
    functional, donated = tsteps.lm_train_step(tcfg, tc), tsteps.lm_train_step(tcfg, tc, donate=True)
    for b in _lm_batches(jcfg.vocab, 2):
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        trees[0], m0 = functional(trees[0], b)
        trees[1], m1 = donated(trees[1], b)
        assert {k: _bits(v) for k, v in m0.items()} == {k: _bits(v) for k, v in m1.items()}
    assert trees[1]["params"] is given["params"] and trees[1]["opt_state"].mu is given["opt_state"].mu
    assert [t.data_ptr() for t in tu.tree_leaves(trees[1]["params"])] == ptrs
    for (path, a), b in zip(tu.tree_paths(trees[0]), tu.tree_leaves(trees[1])):
        assert a.dtype == b.dtype and _bits(a) == _bits(b), path


def test_microbatches_sum_from_the_first_gradients():
    """A step over 2 microbatches equals ``adamw_update`` given the
    gradients' mean as the reference forms it, (0 + g₁ + g₂) / 2, bit for
    bit."""
    _, tcfg = _configs("llama3.2-3b")
    params = tt.init_lm(torch.Generator().manual_seed(3), tcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _lm_batches(tcfg.vocab, 2, steps=1)[0].items()}
    tc = ttl.TrainConfig(opt=topt.AdamWConfig(**OPT), microbatches=2)
    new, metrics = tsteps.lm_train_step(tcfg, tc)(ttl.init_train_state(params, tc).tree(), batch)
    gs = [ttl.value_and_grad(tsteps.lm_loss_fn(tcfg), params, {k: v[i] for k, v in batch.items()})[2]
          for i in range(2)]
    mean = tu.tree_map(lambda a, b: (torch.zeros_like(a) + a + b) / 2, *gs)
    want, _, want_m = topt.adamw_update(tc.opt, mean, ttl.init_train_state(params, tc).opt_state, params)
    assert _bits(metrics["grad_norm"]) == _bits(want_m["grad_norm"])
    for (path, a), b in zip(tu.tree_paths(new["params"]), tu.tree_leaves(want)):
        assert _bits(a) == _bits(b), path


def test_remat_is_bit_equal_to_no_remat():
    """deepseek reduced (MLA, MoE routing, MTP): loss, metrics and every
    gradient bit-equal with and without per-layer rematerialisation."""
    _, tcfg = _configs("deepseek-v3-671b")
    params = tt.init_lm(torch.Generator().manual_seed(4), tcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _lm_batches(tcfg.vocab, 1, steps=1)[0].items()}
    runs = [ttl.value_and_grad(tsteps.lm_loss_fn(dataclasses.replace(tcfg, remat=r)), params, batch)
            for r in (False, True)]
    (l0, m0, g0), (l1, m1, g1) = runs
    assert _bits(l0) == _bits(l1)
    assert {k: _bits(v) for k, v in m0.items()} == {k: _bits(v) for k, v in m1.items()}
    for (path, a), b in zip(tu.tree_paths(g0), tu.tree_leaves(g1)):
        assert _bits(a) == _bits(b), path


# ---- launch.steps -----------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_opt_cfg_matches_reference(arch):
    want = jsteps._lm_opt_cfg(jreg.get_arch(arch).make_full())
    assert dataclasses.asdict(tsteps.lm_opt_cfg(treg.get_arch(arch).make_full())) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch):
    jcfg, tcfg = jreg.get_arch(arch).make_full(), treg.get_arch(arch).make_full()
    mesh = jmesh.make_host_mesh()
    shapes = {s.name: s for s in jreg.LM_SHAPES}
    train = jsteps.lm_train_bundle(jcfg, shapes["train_4k"], mesh)
    assert tsteps.lm_train_flops(tcfg, 256, 4096) == train.model_flops == 6.0 * jcfg.active_param_count() * 256 * 4096
    prefill = jsteps.lm_prefill_bundle(jcfg, shapes["prefill_32k"], mesh)
    assert tsteps.lm_prefill_flops(tcfg, 32, 32768) == prefill.model_flops
    decode = jsteps.lm_decode_bundle(jcfg, shapes["decode_32k"], mesh)
    assert tsteps.lm_decode_flops(tcfg, 128, 32768) == decode.model_flops


# ---- lm_batch ---------------------------------------------------------------


def test_lm_batch_shape_range_and_determinism():
    kw = dict(batch=4, seq=32, vocab=100, device="cpu")
    b = lm_batch(0, 5, 1, **kw)
    assert set(b) == {"tokens", "labels"}
    for v in b.values():
        assert tuple(v.shape) == (4, 32) and v.dtype == torch.int32
        assert int(v.min()) >= 0 and int(v.max()) <= 99
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    again = lm_batch(0, 5, 1, **kw)
    assert all(torch.equal(b[k], again[k]) for k in b)
    for other in ((1, 5, 1), (0, 6, 1), (0, 5, 2)):
        assert not torch.equal(lm_batch(*other, **kw)["tokens"], b["tokens"]), other


def test_lm_batch_distribution_matches_reference():
    kw = dict(batch=64, seq=511, vocab=32768)
    got = lm_batch(0, 0, 0, device="cpu", **kw)["tokens"].numpy()
    want = np.asarray(jsyn.lm_batch(0, 0, 0, **kw)["tokens"])
    assert got.shape == want.shape and got.dtype == want.dtype
    for tok in range(4):
        assert abs((got == tok).mean() - (want == tok).mean()) < 0.02, tok
    assert abs((got == 0).mean() - (1 - 2 ** (-1 / 0.7))) < 0.02
    assert got.max() > 1000  # the tail reaches far


# ---- examples/torch_train_lm.py ---------------------------------------------


def _example():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples",
                        "torch_train_lm.py")
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_trains_and_resumes(tmp_path, capsys):
    ex = _example()
    tiny = ["--device", "cpu", "--layers", "1", "--d-model", "64", "--vocab", "256", "--seq", "16", "--batch", "4"]
    whole = ex.main(tiny + ["--steps", "4"])
    ckpt = ["--resume", "--ckpt-dir", str(tmp_path)]
    ex.main(tiny + ckpt + ["--steps", "2"])
    resumed = ex.main(tiny + ckpt + ["--steps", "4"])
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert [h["step"] for h in resumed] == [4] and np.isfinite(resumed[-1]["loss"])
    assert resumed[-1]["loss"] == whole[-1]["loss"]
