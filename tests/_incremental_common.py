"""Shared inputs of the incremental-build tests (``test_torch_incremental*.py``):
the clustered rows and queries, the reference's fitted Flash backends per
m_f, the reference/port backend pairs over them, the bit-equality cases
with their builds (``build_pair``) and check (``check_bit_equal``). Not
collected by pytest (no ``test_`` prefix); the test files import from it.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flash as jflash
from repro.graph import backends as jbk
from repro.graph.hnsw import HNSWParams as JParams
from repro.graph.hnsw import build_hnsw as jbuild
from repro_torch.core.flash import query_ctx
from repro_torch.graph import backends as tbk
from repro_torch.graph.engine import PH_BEAM_BASE, PH_BOOTSTRAP, BuildParams
from repro_torch.graph.hnsw import build_hnsw as tbuild
from conftest import make_clustered

N, D = 1500, 48
R_BASE = 16
FLASH_KW = dict(d_f=32, l_f=4, h=8, kmeans_iters=8)
PARAMS = dict(r_upper=8, r_base=R_BASE, ef=32, batch=16)

#: (name, n, max_layers, backend kind, m_f, extra params): n ∈ {2, batch − 1,
#: 2·batch + 5, 1,500}, 1 and 3 layers, both Flash backends, m_f ∈ {6, 16},
#: one case each of the ablation modes
CASES = [
    ("n2", 2, 3, "flash_blocked", 16, {}),
    ("batch_minus_1", 15, 1, "flash", 16, {}),
    ("two_batches_plus_5", 37, 3, "flash_blocked", 6, {}),
    ("n1500_l3", N, 3, "flash_blocked", 16, {}),
    ("n1500_l1_flash_m6", N, 1, "flash", 6, {}),
    ("prune_farthest", 300, 3, "flash_blocked", 16, {"prune_mode": "farthest"}),
    ("select_closest", 300, 3, "flash", 6, {"select_mode": "closest"}),
]


@pytest.fixture(scope="module")
def sets():
    x = make_clustered(N + 64, D, seed=3)
    return x[:N], x[N:]


@pytest.fixture(scope="module")
def coders(sets):
    """The reference's fitted blocked backend (coder + codes) per m_f."""
    data, _ = sets
    return {
        m: jbk.make_backend("flash_blocked", jnp.asarray(data), jax.random.PRNGKey(0),
                            r_for_blocked=R_BASE, m_f=m, **FLASH_KW)
        for m in (6, 16)
    }


def ref_backend(jbe, kind: str, n: int):
    """The reference backend of ``kind`` over the first n rows' codes."""
    codes = jbe.codes[:n]
    if kind == "flash":
        return jbk.FlashBackend(jbe.coder, codes)
    return jbk.FlashBlockedBackend(jbe.coder, codes, jnp.zeros((n,) + jbe.nbr_codes.shape[1:], jnp.uint8))


def port_backend(jbe, kind: str):
    cls = tbk.FlashBlockedBackend if kind == "flash_blocked" else tbk.FlashBackend
    return cls.from_state({k: np.asarray(v) for k, v in jbe.state_dict().items()}, device="cpu")


def recall(ids: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean([len(set(a) & set(b)) / gt.shape[1] for a, b in zip(ids, gt)]))


def build_pair(sets, coders, case) -> SimpleNamespace:
    """Both packages' incremental builds of one case from the reference's
    coder and codes: ``jidx``/``jst`` and ``tidx``/``tst``, the port's
    backend ``tbe`` and the count of ADT levels that differ."""
    name, n, layers, kind, m_f, extra = case
    data = sets[0][:n]
    params = dict(PARAMS, max_layers=layers, **extra)
    jbe = ref_backend(coders[m_f], kind, n)
    tbe = port_backend(jbe, kind)
    jctx = jax.vmap(lambda v: jflash.query_ctx(jbe.coder, v))(jnp.asarray(data))
    mismatch = int((query_ctx(tbe.coder, torch.from_numpy(data)).adt_q.numpy() != np.asarray(jctx.adt_q)).sum())
    jidx, jst = jbuild(jnp.asarray(data), jbe, params=JParams(**params), seed=0, strategy="incremental")
    tidx, tst = tbuild(torch.from_numpy(data), tbe, params=BuildParams(**params), seed=0, strategy="incremental")
    return SimpleNamespace(case=case, params=params, tbe=tbe, mismatch=mismatch, jidx=jidx, jst=jst, tidx=tidx,
                           tst=tst)


def check_bit_equal(b: SimpleNamespace) -> None:
    """The port's build equals the reference's bit for bit: adjacency and
    its distances on every layer, levels, entry, the mirror, per-phase
    n_dists and n_hops."""
    _, n, layers, kind, _, _ = b.case
    assert b.mismatch == 0, f"{b.mismatch} ADT levels differ from the reference's: the builds cannot be compared bit for bit"
    tidx, jidx, tst, jst = b.tidx, b.jidx, b.tst, b.jst
    np.testing.assert_array_equal(tidx.adj0.numpy(), np.asarray(jidx.adj0))
    np.testing.assert_array_equal(tidx.adj0_d.numpy(), np.asarray(jidx.adj0_d))
    np.testing.assert_array_equal(tidx.adj_up.numpy(), np.asarray(jidx.adj_up))
    np.testing.assert_array_equal(tidx.adj_up_d.numpy(), np.asarray(jidx.adj_up_d))
    assert tidx.adj_up.shape[0] == layers - 1
    np.testing.assert_array_equal(tidx.levels.numpy(), np.asarray(jidx.levels))
    assert tidx.entry == int(jidx.entry)
    if kind == "flash_blocked":
        np.testing.assert_array_equal(tidx.backend.nbr_codes.numpy(), np.asarray(jidx.backend.nbr_codes))
        assert int(b.tbe.nbr_codes.sum()) == 0  # the build wrote a copy of the mirror
    np.testing.assert_array_equal(np.asarray(tst.phases), np.asarray(jst.phases, np.float64))
    assert (tst.n_dists, tst.n_hops) == (float(jst.n_dists), float(jst.n_hops))
    p = min(PARAMS["batch"], n)
    assert tst.phases[PH_BOOTSTRAP] == p * p
    if n > PARAMS["batch"]:
        assert tst.phases[PH_BEAM_BASE] > 0
    assert {"bootstrap", "insert_batches"} <= set(tst.seconds)
