"""Shared helpers of the LM-family tests (``test_torch_lm_layers.py``,
``test_torch_moe.py``, ``test_torch_transformer.py``). Not collected by
pytest (no ``test_`` prefix)."""

from __future__ import annotations

import jax
import numpy as np

#: the reference compiled whole and without LLVM's optimisation passes:
#: eager, each of its many small ops compiles on its own, and compiling is
#: most of these tests' time
FAST = {"xla_backend_optimization_level": 0}


def jit_ref(fn, **kw):
    return jax.jit(fn, compiler_options=FAST, **kw)


def draw_like(make, seed: int):
    """A numpy tree in the layout and dtypes of the reference's ``make()``
    (an ``init_*`` call, traced by ``jax.eval_shape``, never run), drawn at
    its scales: dense weights (…, fan_in, fan_out) N(0, 1/fan_in), ``embed``
    N(0, 0.02²); norm scales near 1 and biases near 0 rather than exactly
    so, which would hide a missing multiply or add. bfloat16 leaves are
    rounded by ``ml_dtypes`` (to nearest even)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1])
        if "ln" in name or "norm" in name:
            x = 1.0 + 0.1 * rng.normal(size=leaf.shape)
        elif name in ("['bq']", "['bk']", "['bv']"):
            x = 0.1 * rng.normal(size=leaf.shape)
        elif name == "['embed']":
            x = 0.02 * rng.normal(size=leaf.shape)
        else:
            x = rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[-2])
        return x.astype(np.float32).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(make))
