"""The port's decoder-only LM (``repro_torch.models.transformer``) against
the reference's ``repro.models.transformer``, on the CPU.

* Each of the five LM archs at its reduced config, with weights in the
  layout and dtypes of the reference's ``init_lm`` (numpy draws, norm
  scales and biases away from 1 and 0) carried across by
  ``params_from_jax``: ``lm_forward``
  logits and MoE aux, ``lm_prefill`` logits and caches, and 3
  ``lm_decode_step``s (fixed tokens) logits and caches, against the
  reference's jitted functions on the same numpy tokens. Float32: atol
  2e-5 on logits of order 1, aux at rtol 1e-5.
* Compute in bfloat16 from float32 masters, for a dense (llama3.2) and an
  MoE (moonshot) reduced config: ``_cast_block`` rounds every block weight
  but the norm scales, the router included, which ``_route`` lifts back to
  float32: the port's ``_cast_block`` equals the reference's bit for bit,
  and the first layer's prefill caches hold the reference's bits. Logits
  and caches within ``BF16_ATOL`` and the aux within ``BF16_AUX_RTOL``
  (products summed in another order round to a neighbouring bfloat16; a
  token routed to another expert would move its logits far more); the
  readings and a float32 control beside the constants.
  ``serving_params`` (the roundings made once) computes bit-equal to the
  masters.
* ``params_to_jax(params_from_jax(tree))`` is the reference's tree bit for
  bit, dtypes included (reduced qwen2 and deepseek store bfloat16).
* ``init_lm``'s tree has ``jax.eval_shape(init_lm)``'s paths, shapes and
  dtypes; the five full and reduced configs equal the reference's field
  for field, with equal ``param_count`` and ``active_param_count``; the
  registry's LM shapes are the reference's. ``lm_loss`` and training are
  held by ``test_torch_lm_train.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jt
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as tt
from repro_torch.utils import tree_paths
from _lm_common import draw_like, jit_ref

ARCHS = ("qwen2-72b", "qwen1.5-0.5b", "llama3.2-3b", "deepseek-v3-671b", "moonshot-v1-16b-a3b")
B, S, STEPS = 2, 12, 3
ATOL = 2e-5
#: bfloat16 compute: six bfloat16 steps at |x| ≤ 4 (2⁻⁸ relative; the
#: roundings of two layers in another order), and the MoE aux at rtol 1e-3.
#: Read on the CPU (``tests/witness_bf16_control.py``), logits and aux:
#: 0.043 and 0 (llama), 0.078 and 8.1e-5 (moonshot). A port computing in
#: float32 from the same masters (the control) reads 0.056 and 0 (llama),
#: 0.71 and 7.6e-4 (moonshot): this bound catches it in moonshot only, as
#: the reference's own bfloat16 sums lie as far from the port's as the
#: control's do in llama. The first layer's prefill caches, which hang on
#: the rounded weights and the embedding alone, catch it in both: the
#: port's hold the reference's bits in every element, the control's in
#: none (BF16_LAYER0_EQUAL, the share of equal elements required). A
#: router left in float32 moves neither reading; `_cast_block` is held to
#: the reference's bit for bit for that.
BF16_ATOL, BF16_AUX_RTOL = 0.1, 1e-3
BF16_LAYER0_EQUAL = 0.99

_forward = jit_ref(jt.lm_forward, static_argnums=1)
_prefill = jit_ref(jt.lm_prefill, static_argnums=1)
_decode = jit_ref(jt.lm_decode_step, static_argnums=1)


def _configs(arch: str, bf16: bool):
    jcfg, tcfg = jreg.get_arch(arch).make_reduced(), treg.get_arch(arch).make_reduced()
    if bf16:
        jcfg, tcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16), dataclasses.replace(tcfg, dtype=torch.bfloat16)
    return jcfg, tcfg


def _np32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t32(x: torch.Tensor) -> np.ndarray:
    """A float32 copy (the decode step writes its caches in place)."""
    return x.detach().float().numpy().copy()


@pytest.fixture(scope="module")
def runs() -> dict:
    return {}


def _run(runs: dict, arch: str, bf16: bool = False) -> dict:
    """Both packages on one arch's reduced config: weights, outputs, caches."""
    key = (arch, bf16)
    if key in runs:
        return runs[key]
    jcfg, tcfg = _configs(arch, bf16)
    tree_np = draw_like(lambda: jt.init_lm(jax.random.PRNGKey(0), jcfg), ARCHS.index(arch))
    params = jax.tree_util.tree_map(jnp.asarray, tree_np)
    tp = tt.params_from_jax(tree_np, tcfg, device="cpu")
    toks = np.random.default_rng([ARCHS.index(arch), bf16]).integers(0, jcfg.vocab, (B, S + STEPS))
    prompt, tprompt = jnp.asarray(toks[:, :S], jnp.int32), torch.from_numpy(toks[:, :S])
    out = {"tree_np": tree_np, "params": tp, "cfg": tcfg}
    logits, aux = _forward(params, jcfg, prompt)
    out["forward"] = (_np32(logits), {k: float(v) for k, v in aux.items()})
    logits, aux = tt.lm_forward(tp, tcfg, tprompt)
    out["t_forward"] = (_t32(logits), {k: float(v) for k, v in aux.items()})
    logits, caches = _prefill(params, jcfg, prompt)
    out["prefill"] = (_np32(logits), {k: _np32(v) for k, v in caches.items()})
    tlogits, tcaches = tt.lm_prefill(tp, tcfg, tprompt, s_max=S + STEPS)
    assert all(not v[:, :, S:].any() for v in tcaches.values())  # zero past the prompt
    out["t_prefill"] = (_t32(tlogits), {k: _t32(v[:, :, :S]) for k, v in tcaches.items()})
    caches = jax.tree_util.tree_map(
        lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, STEPS)] + [(0, 0)] * (c.ndim - 3)), caches)
    out["decode"], out["t_decode"] = [], []
    for i in range(STEPS):
        logits, caches = _decode(params, jcfg, caches, jnp.asarray(toks[:, S + i], jnp.int32), jnp.int32(S + i))
        out["decode"].append((_np32(logits), {k: _np32(v) for k, v in caches.items()}))
        pos = S + i if i % 2 else torch.tensor(S + i)  # an int and a 0-dim tensor
        tlogits, tcaches = tt.lm_decode_step(tp, tcfg, tcaches, torch.from_numpy(toks[:, S + i]), pos)
        out["t_decode"].append((_t32(tlogits), {k: _t32(v) for k, v in tcaches.items()}))
    runs[key] = out
    return out


def _layer0(blocks: dict) -> dict:
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in blocks.items()}


def _close(got: np.ndarray, want: np.ndarray, atol: float):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _same_outputs(run: dict, atol: float, aux_rtol: float = 1e-5):
    _close(run["t_forward"][0], run["forward"][0], atol)
    assert run["t_forward"][1].keys() == run["forward"][1].keys()
    for k, v in run["forward"][1].items():
        np.testing.assert_allclose(run["t_forward"][1][k], v, rtol=aux_rtol)
    for (got, got_c), (want, want_c) in [(run["t_prefill"], run["prefill"]),
                                         *zip(run["t_decode"], run["decode"])]:
        _close(got, want, atol)
        assert got_c.keys() == want_c.keys()
        for k in want_c:
            _close(got_c[k], want_c[k], atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_prefill_decode_match_reference(runs, arch):
    run = _run(runs, arch)
    _same_outputs(run, ATOL)
    moe = run["cfg"].moe is not None
    assert set(run["forward"][1]) == ({"moe/load_balance", "moe/router_z"} if moe else set())


@pytest.mark.parametrize("arch", ["llama3.2-3b", "moonshot-v1-16b-a3b"])
def test_bf16_compute_matches_reference(runs, arch):
    run = _run(runs, arch, bf16=True)
    _same_outputs(run, BF16_ATOL, BF16_AUX_RTOL)
    # _cast_block rounds the leaves the reference's rounds, the router
    # included, to the same bits
    jcfg, cfg = _configs(arch, True)
    for key in ("blocks_dense", "blocks_moe"):
        if run["tree_np"].get(key) is None:
            continue
        want = jt._cast_block(jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), run["tree_np"][key]), jcfg.dtype)
        got = tt.params_to_jax(tt._cast_block(_layer0(run["params"][key]), cfg.dtype))
        want, got = jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves_with_path(got)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    if cfg.moe is not None:
        assert _layer0(run["params"]["blocks_moe"])["ffn"]["router"].dtype == torch.float32
        assert tt._cast_block(_layer0(run["params"]["blocks_moe"]), cfg.dtype)["ffn"]["router"].dtype == cfg.dtype
    # the first layer's prefill caches: every element the reference's bits
    got_c, want_c = run["t_prefill"][1], run["prefill"][1]
    for k in want_c:
        assert np.mean(got_c[k][0] == want_c[k][0]) >= BF16_LAYER0_EQUAL, k
    # the serving copy (roundings made once) computes bit-equal to the masters
    cfg = run["cfg"]
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (B, S)))
    served = tt.serving_params(run["params"], cfg)
    assert served["blocks_dense"]["attn"]["wq"].dtype == torch.bfloat16
    assert served["blocks_dense"]["ln1"].dtype == torch.float32
    (la, ca), (lb, cb) = tt.lm_prefill(run["params"], cfg, toks), tt.lm_prefill(served, cfg, toks)
    assert torch.equal(la, lb) and all(torch.equal(ca[k], cb[k]) for k in ca)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_bit_exact(runs, arch):
    tree_np = _run(runs, arch)["tree_np"]
    back = tt.params_to_jax(tt.params_from_jax(tree_np, treg.get_arch(arch).make_reduced(), device="cpu"))
    want, got = jax.tree_util.tree_leaves_with_path(tree_np), jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    with pytest.raises(ValueError, match="layers"):
        tt.params_from_jax(tree_np, dataclasses.replace(treg.get_arch(arch).make_reduced(), n_layers=5),
                           device="cpu")


def _shapes(tree) -> dict:
    return {path: (tuple(x.shape), str(x.dtype).removeprefix("torch.")) for path, x in tree_paths(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_matches_reference_eval_shape(arch):
    jcfg, tcfg = _configs(arch, False)
    want = jax.eval_shape(lambda: jt.init_lm(jax.random.PRNGKey(0), jcfg))
    got = tt.init_lm(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert _shapes(got) == _shapes(want)


_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    for k in ("dtype", "param_dtype"):
        out[k] = _DTYPES.get(out[k], out[k])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_counts_match_reference(arch):
    for make in ("make_full", "make_reduced"):
        want, got = getattr(jreg.get_arch(arch), make)(), getattr(treg.get_arch(arch), make)()
        assert _fields(got) == _fields(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert (got.n_dense_layers, got.n_moe_layers) == (want.n_dense_layers, want.n_moe_layers)
    assert treg.get_arch(arch).family == "lm"
    assert [(s.name, s.kind, s.dims) for s in treg.get_arch(arch).shapes] == [
        (s.name, s.kind, s.dims) for s in jreg.LM_SHAPES]
