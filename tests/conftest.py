"""Shared fixtures: small clustered datasets (embedding-like) + helpers.

NOTE: no XLA_FLAGS here — smoke tests and benches must see 1 device; only
launch/dryrun.py forces 512 placeholder devices (in its own process).
"""

from __future__ import annotations

import random
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _install_hypothesis_stub() -> None:
    """Minimal in-process ``hypothesis`` replacement (container lacks the dep).

    Only the subset this suite uses is implemented: ``given`` + ``settings``
    decorators and the ``integers`` / ``sampled_from`` strategies. Examples are
    drawn deterministically (boundaries first, then a seeded PRNG stream), so
    runs are reproducible; ``deadline`` and shrinking are out of scope.
    """
    try:
        import hypothesis  # noqa: F401

        return
    except ImportError:
        pass

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw  # (rng, index) -> value

    def integers(min_value=0, max_value=None, **_kw):
        lo = int(min_value)
        hi = int(max_value) if max_value is not None else 2**31 - 1

        def draw(rng, i):
            if i == 0:
                return lo
            if i == 1:
                return hi
            return rng.randint(lo, hi)

        return _Strategy(draw)

    def sampled_from(seq):
        opts = list(seq)

        def draw(rng, i):
            if i < len(opts):
                return opts[i]
            return opts[rng.randrange(len(opts))]

        return _Strategy(draw)

    def settings(max_examples=10, deadline=None, **_kw):  # noqa: ARG001
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn

        return deco

    def given(*strategies, **kw_strategies):
        def deco(fn):
            n_examples = getattr(fn, "_stub_max_examples", 10)

            def wrapper(*args):  # (self,) for methods, () for plain functions
                rng = random.Random(0xC0FFEE)
                for i in range(n_examples):
                    drawn = [s._draw(rng, i) for s in strategies]
                    kw = {k: s._draw(rng, i) for k, s in kw_strategies.items()}
                    fn(*args, *drawn, **kw)

            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper

        return deco

    hyp = types.ModuleType("hypothesis")
    hyp.given = given
    hyp.settings = settings
    st = types.ModuleType("hypothesis.strategies")
    st.integers = integers
    st.sampled_from = sampled_from
    hyp.strategies = st
    hyp.__stub__ = True
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st


_install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips, with its reason, without one)"
    )


def make_clustered(
    n: int, d: int, *, n_clusters: int = 24, sep: float = 1.0, seed: int = 0
) -> np.ndarray:
    """Gaussian-mixture data with smooth variance decay (embedding-like)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * sep
    # anisotropic within-cluster noise: decaying per-dim scales, like PCA
    # spectra of real embedding sets
    scales = np.linspace(1.0, 0.2, d)
    x = centers[rng.integers(0, n_clusters, n)] + rng.normal(size=(n, d)) * scales
    return x.astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _bounded_executable_cache():
    """Drop compiled executables at module boundaries.

    XLA-CPU's JIT segfaults inside ``backend_compile`` once one process
    holds a few hundred live compiled computations (reproducible at the
    same test ~70% through a full-suite run; every module passes alone).
    Clearing per module keeps the resident count bounded — modules pay
    their own compiles either way, only cross-module reuse is lost.
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def small_data():
    """(data (2000, 48), queries (64, 48)) jnp arrays."""
    x = make_clustered(2064, 48, seed=0)
    return jnp.asarray(x[:2000]), jnp.asarray(x[2000:])


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)
