"""The plain version of ``flash_beam`` against the reference's beam search.

``beam_search(fused=True)`` on CPU tensors of the blocked backend reaches
``ops.flash_beam``, which takes ``ref.flash_beam`` (``ref.beam_loop`` with
``ref.flash_expand`` as its step) because the tensors lie on the CPU; the
kernel holds itself to that plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2). Here it is held
bit-equal to ``repro.graph.beam.beam_search`` under ``jax.vmap`` on the same
numpy inputs: ids, dists, ``n_dists`` and ``n_hops``. The unfused path
(``fused=False``, the same loop with the gather step) must agree as well.

The graphs and tables are made to reach every tie rule the kernel keeps:
a table of two levels (equal sums at the merge), rows that repeat a vertex
and rows with −1 slots, frontier rows that share neighbours, −1 entries,
as many entries as the beam, a ``max_iters`` that is hit, and ``banned``
with ``n_keep``.
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
from repro.graph import beam as jbeam
from repro_torch.core import flash as tflash
from repro_torch.core.flash import FlashQueryCtx
from repro_torch.graph import backends as tbk
from repro_torch.graph import beam as tbeam
from repro_torch.kernels import ref as tref

M, K = 16, 16
N, R, Q = 1500, 16, 16
#: the backends read only the coder's M (to unpack mirror rows); the query
#: tables are made here, not by a coder
CODER = SimpleNamespace(m_f=M)


def _graph(seed: int, *, holes: float, repeats: float = 0.0, local: int = 0):
    """adjacency (N, R) int32 with −1 holes, codes (N, M), and the mirror
    (N, R, M) int32 of each slot's neighbour codes (0 where empty)."""
    rng = np.random.default_rng(seed)
    if local:  # neighbours from a window around the vertex: rows share vertices
        adj = (np.arange(N)[:, None] + rng.integers(-local, local + 1, (N, R))) % N
    else:
        adj = rng.integers(0, N, (N, R))
    adj = adj.astype(np.int32)
    adj[rng.random((N, R)) < holes] = -1
    if repeats:  # rows that hold one vertex twice (and a −1 slot twice)
        rep = rng.random(N) < repeats
        adj[rep, 3] = adj[rep, 0]
        adj[rep, R - 1] = adj[rep, 5]
    codes = rng.integers(0, K, (N, M)).astype(np.int32)
    mirror = np.where(adj[..., None] >= 0, codes[np.maximum(adj, 0)], 0).astype(np.int32)
    return adj, codes, mirror


def _reference(adj, codes, mirror, adt, entries, *, ef, width, max_iters, banned, n_keep):
    jbe = jbk.FlashBlockedBackend(CODER, jnp.asarray(codes), jnp.asarray(mirror))
    ctx = jflash.FlashQueryCtx(
        adt_q=jnp.asarray(adt), adt_f=jnp.zeros(adt.shape, jnp.float32),
        codes=jnp.zeros(adt.shape[:2], jnp.int32),
    )
    ban = None if banned is None else jnp.asarray(banned)

    def one(qc, e):
        return jbeam.beam_search(jbe, qc, jnp.asarray(adj), e, ef=ef, width=width, max_iters=max_iters,
                                 banned=ban, fused=True, n_keep=n_keep)

    return jax.jit(jax.vmap(one))(ctx, jnp.asarray(entries))


def _port(adj, codes, mirror, adt, entries, *, fused, **kw):
    be = tbk.FlashBlockedBackend(CODER, torch.from_numpy(codes), torch.from_numpy(mirror))
    ctx = FlashQueryCtx(torch.from_numpy(adt), torch.zeros(adt.shape), torch.zeros(adt.shape[:2], dtype=torch.int32))
    if kw.get("banned") is not None:
        kw["banned"] = torch.from_numpy(kw["banned"])
    return tbeam.beam_search(be, ctx, torch.from_numpy(adj), torch.from_numpy(entries), fused=fused, **kw)


CASES = {
    # name: (graph kwargs, case kwargs)
    "w1_ef8": (dict(holes=0.1), dict(width=1, ef=8)),
    "w1_ef64": (dict(holes=0.1), dict(width=1, ef=64)),
    "w4_ef8": (dict(holes=0.1), dict(width=4, ef=8)),
    "w4_ef64": (dict(holes=0.1), dict(width=4, ef=64)),
    "w8_ef8": (dict(holes=0.1), dict(width=8, ef=8)),
    "w8_ef64": (dict(holes=0.1), dict(width=8, ef=64)),
    "ties_w1": (dict(holes=0.1), dict(width=1, ef=64, levels=2)),
    "ties_w4": (dict(holes=0.1), dict(width=4, ef=64, levels=2)),
    "repeats_and_holes": (dict(holes=0.3, repeats=0.5), dict(width=4, ef=16, levels=3)),
    "shared_neighbours": (dict(holes=0.05, local=8), dict(width=8, ef=32)),
    "entries_with_minus_one": (dict(holes=0.1), dict(width=4, ef=16, n_entries=4, dead_entries=0.5)),
    "entries_fill_the_beam": (dict(holes=0.1), dict(width=2, ef=8, n_entries=8, dead_entries=0.25)),
    "max_iters_hit": (dict(holes=0.1), dict(width=2, ef=32, max_iters=3)),
    "banned_n_keep": (dict(holes=0.1), dict(width=4, ef=32, banned=0.2, n_keep=10)),
    "unpacked_mirror": (dict(holes=0.1), dict(width=4, ef=64, packed=False)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_flash_beam_plain_version_matches_reference(name, monkeypatch):
    graph_kw, kw = CASES[name]
    seed = list(CASES).index(name)
    rng = np.random.default_rng(100 + seed)
    adj, codes, mirror = _graph(seed, **graph_kw)
    if kw.get("packed", True):
        mirror = tflash.pack_codes(torch.from_numpy(mirror)).numpy()
    adt = rng.integers(0, kw.get("levels", 256), (Q, M, K)).astype(np.int32)
    entries = rng.integers(0, N, (Q, kw.get("n_entries", 1))).astype(np.int32)
    entries[rng.random(entries.shape) < kw.get("dead_entries", 0.0)] = -1
    banned = None if "banned" not in kw else rng.random(N) < kw["banned"]
    args = dict(ef=kw["ef"], width=kw["width"], max_iters=kw.get("max_iters"), banned=banned,
                n_keep=kw.get("n_keep"))

    calls = []
    plain = tref.flash_beam
    monkeypatch.setattr(tref, "flash_beam", lambda *a, **k: calls.append(1) or plain(*a, **k))
    got = _port(adj, codes, mirror, adt, entries, fused=True, **args)
    assert calls == [1], "beam_search(fused=True) on CPU tensors must run ref.flash_beam once"
    want = _reference(adj, codes, mirror, adt, entries, **args)
    for f in ("ids", "dists", "n_dists", "n_hops"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    unfused = _port(adj, codes, mirror, adt, entries, fused=False, **args)
    for f in ("ids", "dists", "n_dists", "n_hops"):
        np.testing.assert_array_equal(getattr(unfused, f).numpy(), getattr(got, f).numpy(), err_msg=f)

    # each case reaches what it was made for
    ids, d = got.ids.numpy(), got.dists.numpy()
    if "levels" in kw:
        fin = np.where(np.isfinite(d), d, np.nan)
        assert (np.diff(fin, axis=1) == 0).any(), "no equal sums in any beam"
    if graph_kw.get("repeats"):
        assert any(len(set(row[row >= 0])) < (row >= 0).sum() for row in ids), "no vertex kept twice"
    if "max_iters" in kw:
        free = _port(adj, codes, mirror, adt, entries, fused=True, **{**args, "max_iters": None})
        assert (got.n_hops < free.n_hops).any(), "max_iters never hit"
    if "dead_entries" in kw:
        assert (entries < 0).any() and (entries >= 0).any()
    if banned is not None:
        assert not banned[ids[ids >= 0]].any() and ids.shape[1] == kw["n_keep"]
