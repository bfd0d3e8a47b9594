"""The port's transformer layers for the LM family against the reference's
``repro.models.layers``, on the CPU, from the same numpy inputs.

* ``rms_norm`` in float32 and bfloat16 (float32 inside, the input's dtype
  out): atol 1e-6, and bit-equal in bfloat16.
* ``attend`` against ``_causal_attend``: causal and bidirectional, whole
  and chunked by ``block_q``, queries offset by ``q_offset`` against a
  longer key axis, and a value head wider than the query head (MLA).
* GQA ``gqa_forward`` (chunked), ``gqa_prefill`` (out and the rotated k,
  v) and ``gqa_decode`` (out and both caches, written at ``pos`` in place)
  with and without QKV bias (random, not the init's zeros) at RoPE θ 1e4
  and 5e5; ``init_gqa`` makes the reference's leaves; ``GQAAttention``
  takes θ and the bias switch.
* MLA ``mla_forward`` (chunked) and the weight-absorbed ``mla_decode``
  against the latent caches.

Float32 tolerance: atol 2e-5 on outputs of order 1 (float32 sums in
another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl
from _lm_common import draw_like, jit_ref

ATOL = 2e-5
B, S, D, H, KV, HD = 2, 16, 32, 4, 2, 8


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got: torch.Tensor, want, atol: float = ATOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(), want.astype(np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32) * 3
    g = rng.normal(size=(48,)).astype(np.float32)
    want = jl.rms_norm(jnp.asarray(x).astype(dtype), jnp.asarray(g))
    got = tl.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(g))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want, 1e-6)
    else:
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("sq,sk,q_offset,block_q,causal,v_hd", [
    (16, 16, 0, None, True, HD),
    (16, 16, 0, 4, True, HD),
    (16, 24, 8, None, True, HD),
    (16, 24, 8, 8, True, HD),
    (16, 16, 0, 4, False, HD),
    (16, 16, 0, 8, True, 12),
])
def test_attend_matches_causal_attend(sq, sk, q_offset, block_q, causal, v_hd):
    rng = np.random.default_rng([sq, sk, q_offset, block_q or 0, causal, v_hd])
    q = rng.normal(size=(B, sq, H, HD)).astype(np.float32)
    k = rng.normal(size=(B, sk, KV, HD)).astype(np.float32)
    v = rng.normal(size=(B, sk, KV, v_hd)).astype(np.float32)
    want = jit_ref(lambda q, k, v: jl._causal_attend(q, k, v, q_offset=q_offset, block_q=block_q,
                                                 causal=causal))(q, k, v)
    got = tl.attend(*map(torch.from_numpy, (q, k, v)), q_offset=q_offset, block_q=block_q, causal=causal)
    _close(got, want)


def _gqa_params(bias: bool, seed: int) -> dict:
    """Weights in ``init_gqa``'s layout; biases drawn (the init's zeros
    would not show a missing add)."""
    return draw_like(lambda: jl.init_gqa(jax.random.PRNGKey(0), d_model=D, n_heads=H, n_kv=KV, head_dim=HD,
                                         qkv_bias=bias), seed)


def test_init_gqa_leaves_match_reference():
    for bias in (True, False):
        want = jax.eval_shape(lambda: jl.init_gqa(jax.random.PRNGKey(0), d_model=D, n_heads=H, n_kv=KV,
                                                  head_dim=HD, qkv_bias=bias))
        got = tl.init_gqa(torch.Generator().manual_seed(0), d_model=D, n_heads=H, n_kv=KV, head_dim=HD,
                          qkv_bias=bias, device="cpu")
        assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
            k: (v.shape, torch.float32) for k, v in want.items()}
        assert all(v.dtype == jnp.float32 for v in want.values())


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_gqa_forward_prefill_decode_match_reference(bias, theta):
    p = _gqa_params(bias, seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, rope_theta=theta)
    pt, tx, tpos = _t(p), torch.from_numpy(x), torch.from_numpy(np.array(pos))

    want = jit_ref(lambda p, x, pos: jl.gqa_forward(p, x, pos, block_q=4, **kw))(p, x, pos)
    _close(tl.gqa_forward(pt, tx, tpos, block_q=4, **kw), want)

    want_out, (wk, wv) = jit_ref(lambda p, x, pos: jl.gqa_prefill(p, x, pos, **kw))(p, x, pos)
    out, (k, v) = tl.gqa_prefill(pt, tx, tpos, **kw)
    _close(out, want_out)
    _close(k, wk)
    _close(v, wv)

    # decode position S − 1 of a cache padded to S + 4, the pad zero
    xd = rng.normal(size=(B, 1, D)).astype(np.float32)
    pad = [(0, 0), (0, 4), (0, 0), (0, 0)]
    jk, jv = jnp.pad(wk, pad), jnp.pad(wv, pad)
    want_d, (jk, jv) = jit_ref(lambda *a: jl.gqa_decode(*a, **kw))(p, xd, jk, jv, jnp.int32(S - 1))
    ck, cv = torch.from_numpy(np.pad(np.asarray(wk), pad)), torch.from_numpy(np.pad(np.asarray(wv), pad))
    got_d, (ck2, cv2) = tl.gqa_decode(pt, torch.from_numpy(xd), ck, cv, S - 1, **kw)
    assert ck2 is ck and cv2 is cv  # written in place
    _close(got_d, want_d)
    _close(ck, jk)
    _close(cv, jv)


def test_gqa_module_takes_theta_and_bias():
    p = _gqa_params(False, seed=3)
    mod = tl.GQAAttention(torch.Generator().manual_seed(0), d_model=D, n_heads=H, n_kv=KV, head_dim=HD,
                          rope_theta=1e6, qkv_bias=False, device="cpu")
    assert sorted(mod.params()) == ["wk", "wo", "wq", "wv"]
    with torch.no_grad():
        for k, v in _t(p).items():
            getattr(mod, k).copy_(v)
    x = np.random.default_rng(4).normal(size=(B, S, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = jit_ref(lambda p, x, pos: jl.gqa_forward(p, x, pos, n_heads=H, n_kv=KV, head_dim=HD,
                                                 rope_theta=1e6))(p, x, pos)
    _close(mod(torch.from_numpy(x), torch.from_numpy(np.array(pos))), want)


MLA = dict(n_heads=H, qk_nope_dim=8, qk_rope_dim=4, v_head_dim=6)


def test_mla_forward_and_decode_match_reference():
    p = draw_like(lambda: jl.init_mla(jax.random.PRNGKey(0), d_model=D, q_lora_rank=12, kv_lora_rank=10, **MLA), 5)
    got_p = tl.init_mla(torch.Generator().manual_seed(0), d_model=D, q_lora_rank=12, kv_lora_rank=10,
                        device="cpu", **MLA)
    assert {k: tuple(v.shape) for k, v in got_p.items()} == {k: v.shape for k, v in p.items()}
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    pt, tx, tpos = _t(p), torch.from_numpy(x), torch.from_numpy(np.array(pos))

    want = jit_ref(lambda x, pos: jl.mla_forward(p, x, pos, rope_theta=1e4, block_q=4, **MLA))(x, pos)
    got = tl.mla_forward(pt, tx, tpos, rope_theta=1e4, block_q=4, **MLA)
    _close(got, want)

    # the prefill's latent caches of the first S − 1 positions (the decode's
    # own latent function, mla_latent, over the same x), then decode S − 1
    out, (ckv, krope) = tl.mla_prefill(pt, tx, tpos, rope_theta=1e4, block_q=4, **MLA)
    assert torch.equal(out, got)
    lat = tl.mla_latent(pt, tx, tpos, qk_rope_dim=MLA["qk_rope_dim"], rope_theta=1e4)
    assert torch.equal(ckv, lat[0]) and torch.equal(krope, lat[1][:, :, 0])
    ckv = torch.nn.functional.pad(ckv[:, :S - 1], (0, 0, 0, 3))
    krope = torch.nn.functional.pad(krope[:, :S - 1], (0, 0, 0, 3))
    jckv, jkrope = jnp.asarray(ckv.numpy()), jnp.asarray(krope.numpy())
    xd = x[:, S - 1:]
    kw = dict(kv_lora_rank=10, rope_theta=1e4, **MLA)
    want_d, (jckv, jkrope) = jit_ref(lambda *a: jl.mla_decode(p, *a, **kw))(xd, jckv, jkrope, jnp.int32(S - 1))
    got_d, _ = tl.mla_decode(pt, torch.from_numpy(np.array(xd)), ckv, krope, torch.tensor(S - 1), **kw)
    _close(got_d, want_d)
    _close(ckv, jckv)
    _close(krope, jkrope)
    # the absorbed decode equals the full multi-head form at that position
    _close(got_d[:, 0], np.asarray(want)[:, S - 1], 1e-4)
