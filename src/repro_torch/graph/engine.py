"""The batched CA + NS build engine, in PyTorch (reference: repro.graph.engine).

Both halves of the reference's engine are ported:

* the incremental engine — ``BuildEngine.acquire`` (batched beam search),
  ``select``, ``commit_forward``, ``reverse_pass`` and ``insert_batch`` —
  composed into the paper's build by ``bootstrap`` (the exact sequential
  seed batch) and ``build_layered`` (then one ``insert_batch`` per batch of
  P ids, ``strategy="incremental"``); the bulk build runs ``insert_batch``
  to re-insert unreachable vertices;
* the bulk engine — ``bulk_refine`` (RNN-Descent refinement rounds scored by
  ``backend.round_dists``, kernel ``flash_round``), ``bulk_commit`` /
  ``bulk_reverse`` and ``repair_reachability``.

Graph arrays are torch tensors on the backend's device and are updated in
place (the reference's functional ``.at[].set`` copies them per step). The
host-side numpy parts stay numpy, draw for draw: level sampling, the bulk
seeds and augmentation, ``batch_schedule`` and ``bfs_reachable``. With the
same coder, codes and query tables the whole build replays the reference's
bit for bit: every distance is an integer level sum, every selection a
stable sort. Counters are int64/float64 (the reference's int32/float32
counters are exact at the sizes the tests compare).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.graph.backends import ctx_rows
from repro_torch.graph.beam import INF, BeamResult, beam_search, stable_smallest
from repro_torch.graph.select import Selection, prune_list, select_neighbors
from repro_torch.utils import sync

#: build phases for per-phase distance attribution (the reference's order)
PHASE_NAMES = ("bootstrap", "beam_upper", "beam_base", "bulk", "repair")
N_PHASES = len(PHASE_NAMES)
PH_BOOTSTRAP, PH_BEAM_UPPER, PH_BEAM_BASE, PH_BULK, PH_REPAIR = range(N_PHASES)


@dataclass(frozen=True)
class BuildParams:
    """Static build hyper-parameters (field for field the reference's).

    r_upper/r_base: R on layers ≥ 1 / layer 0; ef: construction beam C;
    batch: P concurrent inserts; max_layers: L; alpha: RNG slack;
    prune_mode: "heuristic" | "farthest"; max_iters: beam cap; width: W;
    select_mode: "heuristic" | "closest"; bulk_rounds / bulk_pool /
    bulk_eps / bulk_alpha: the bulk build's round cap, pool width (0 = 2·R),
    convergence threshold and selection slack.
    """

    r_upper: int = 16
    r_base: int = 32
    ef: int = 64
    batch: int = 32
    max_layers: int = 3
    alpha: float = 1.0
    prune_mode: str = "heuristic"
    max_iters: int | None = None
    width: int = 1
    select_mode: str = "heuristic"
    bulk_rounds: int = 3
    bulk_pool: int = 0
    bulk_eps: float = 0.02
    bulk_alpha: float = 1.2

    def bulk_select_alpha(self) -> float:
        """Effective RNG slack for bulk selection/reverse pruning."""
        return max(self.alpha, self.bulk_alpha)


@dataclass
class CostAccount:
    """Build cost counters (float64): distance evaluations, expanded
    vertices, and the per-phase split of ``n_dists`` in PHASE_NAMES order."""

    n_dists: float = 0.0
    n_hops: float = 0.0
    phases: list = dataclasses.field(default_factory=lambda: [0.0] * N_PHASES)

    def add_beam(self, res: BeamResult, *, phase: int = PH_BEAM_BASE) -> "CostAccount":
        nd = float(res.n_dists.sum())
        self.n_dists += nd
        self.n_hops += float(res.n_hops.sum())
        self.phases[phase] += nd
        return self

    def add_dists(self, n, *, phase: int, n_hops=0) -> "CostAccount":
        self.n_dists += float(n)
        self.n_hops += float(n_hops)
        self.phases[phase] += float(n)
        return self


class BuildStats(NamedTuple):
    """Public build-cost summary; ``seconds`` holds the wall time of each
    timed build phase (coder fit, per-layer refine/commit, repair) and
    ``repair_unreachable`` the unreachable counts repair started from."""

    n_dists: float
    n_hops: float
    phases: list | None = None
    seconds: dict | None = None
    repair_unreachable: list | None = None

    def phase_dict(self) -> dict | None:
        if self.phases is None:
            return None
        return {name: float(v) for name, v in zip(PHASE_NAMES, self.phases)}


def sample_levels(seed: int, n: int, *, r_upper: int, max_layers: int) -> np.ndarray:
    """Exponentially decaying level assignment, mL = 1/ln(R_upper)."""
    rng = np.random.default_rng(seed)
    m_l = 1.0 / np.log(max(r_upper, 2))
    lv = np.floor(-np.log(rng.uniform(1e-12, 1.0, size=n)) * m_l).astype(np.int32)
    return np.minimum(lv, max_layers - 1)


def prefix_entries(
    levels: np.ndarray, batch: int, *, start: int = 0, entry0: int = -1
) -> np.ndarray:
    """Host-side: the entry point of each insert batch — the highest-level
    vertex among all earlier ids (the first one on ties).

    Batch b inserts ids [start + b·P, start + (b+1)·P). A fresh build uses
    the defaults; growth (``AnnIndex.add``) passes the old size as ``start``
    and the live entry as ``entry0``, continuing from the built prefix.
    """
    n = len(levels)
    nb = -(-(n - start) // batch)
    ent = np.full((nb,), -1, np.int64)
    best = int(entry0)
    best_lv = int(levels[best]) if best >= 0 else -1
    idx = start if best >= 0 else 0
    for b in range(nb):
        bstart = start + b * batch
        while idx < bstart:
            if levels[idx] > best_lv:
                best_lv, best = int(levels[idx]), idx
            idx += 1
        ent[b] = best
    return ent.astype(np.int32)


# ---------------------------------------------------------------------------
# Edge commit
# ---------------------------------------------------------------------------


def commit_forward(adj, adj_d, backend, new_ids, sel_ids, sel_d, mask):
    """Write the selected lists of the masked-in new vertices (in place)."""
    ids = new_ids[mask].long()
    adj[ids] = sel_ids[mask].to(adj.dtype)
    adj_d[ids] = sel_d[mask]
    backend = backend.with_updated_edges(ids, sel_ids[mask])
    return adj, adj_d, backend


def _reverse_waves(sel: np.ndarray, ok: np.ndarray) -> list[np.ndarray]:
    """Group the inserts of one batch into waves that touch disjoint rows.

    Insert i joins the wave after the last earlier insert that shares a
    destination row with it, so each row sees its updates in insert order
    and no two inserts of a wave write the same row: running a wave at once
    equals running its inserts one by one.
    """
    wave_of = np.zeros(len(sel), np.int64)
    last = {}  # destination row -> wave of the latest insert touching it
    for i in range(len(sel)):
        dsts = sel[i][ok[i]]
        w = 1 + max((last.get(int(y), -1) for y in dsts), default=-1)
        wave_of[i] = w
        for y in dsts:
            last[int(y)] = w
    return [np.nonzero(wave_of == w)[0] for w in range(int(wave_of.max(initial=-1)) + 1)]


def reverse_pass(adj, adj_d, backend, new_ids, sel_ids, sel_d, mask, *, params: BuildParams):
    """Add reverse edges y → x for each new x, pruning overflow (in place).

    The reference walks the P inserts one by one (two may share a
    destination y); here inserts that share no destination run together
    (:func:`_reverse_waves`), which gives the same rows. Destinations that
    already list x are skipped; a full row is pruned over existing ∪ {x}.
    """
    p, r = sel_ids.shape
    ok0 = (sel_ids >= 0) & mask[:, None]
    waves = _reverse_waves(sel_ids.cpu().numpy(), ok0.cpu().numpy())
    for wave in waves:
        wi = torch.as_tensor(wave, device=sel_ids.device)
        g = wi.shape[0]
        x = new_ids[wi].to(torch.int32)  # (G,)
        nbrs, nd = sel_ids[wi], sel_d[wi]  # (G, r)
        ok = ok0[wi]
        safe = torch.where(ok, nbrs, 0).long()
        ex_ids = adj[safe]  # (G, r, r)
        ex_d = adj_d[safe]
        ok = ok & ~(ex_ids == x[:, None, None]).any(2)
        counts = (ex_ids >= 0).sum(2)  # (G, r)
        slot = torch.arange(r, device=adj.device) == counts[..., None]
        rows = torch.where(slot, x[:, None, None], ex_ids)  # room left: append
        rows_d = torch.where(slot, nd[..., None], ex_d)
        need = ok & (counts >= r)  # full: prune existing ∪ {x}
        if bool(need.any()):
            cand_ids = torch.cat([ex_ids, x[:, None, None].expand(g, r, 1)], 2)[need]
            cand_d = torch.cat([ex_d, nd[..., None]], 2)[need]
            pruned = prune_list(
                backend, cand_ids, cand_d, r=r, alpha=params.alpha, mode=params.prune_mode
            )
            rows[need] = pruned.ids
            rows_d[need] = pruned.dists
        dst = safe[ok]
        adj[dst] = rows[ok]
        adj_d[dst] = rows_d[ok]
        backend = backend.with_updated_edges(dst, rows[ok])
    return adj, adj_d, backend


def _drop_self(cand_ids, cand_d, new_ids):
    """Strike each inserted vertex from its own candidate row (a no-op for
    fresh inserts; re-inserted vertices would otherwise find themselves)."""
    self_hit = cand_ids == new_ids[:, None]
    d = torch.where(self_hit, INF, cand_d)
    ids = torch.where(self_hit, -1, cand_ids)
    d_s, order = torch.sort(d, dim=1, stable=True)
    return ids.gather(1, order), d_s


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BuildEngine:
    """CA → NS → commit over one static param set."""

    params: BuildParams

    def acquire(self, backend, qctx, adjacency, entries) -> BeamResult:
        """Batched beam search: qctx with leading (P,), entries (P,)."""
        p = self.params
        return beam_search(
            backend, qctx, adjacency, entries[:, None], ef=p.ef, width=p.width,
            max_iters=p.max_iters,
        )

    def select_one(self, backend, cand_ids, cand_d, *, r: int) -> Selection:
        """Select ≤ r neighbors from one sorted (C,) candidate list."""
        sel = self.select(backend, cand_ids[None], cand_d[None], r=r)
        return Selection(*(t[0] for t in sel))

    def select(self, backend, cand_ids, cand_d, *, r: int) -> Selection:
        """Selection over (P, C) sorted candidate rows (``select_mode``)."""
        mode = self.params.select_mode
        if mode == "heuristic":
            return select_neighbors(backend, cand_ids, cand_d, r=r, alpha=self.params.alpha)
        if mode == "closest":
            c = cand_ids.shape[1]
            kk = min(r, c)
            ids = torch.where(torch.isfinite(cand_d[:, :kk]), cand_ids[:, :kk], -1)
            dists = torch.where(ids >= 0, cand_d[:, :kk], INF)
            if kk < r:
                ids = torch.nn.functional.pad(ids, (0, r - kk), value=-1)
                dists = torch.nn.functional.pad(dists, (0, r - kk), value=INF)
            return Selection(ids, dists, (ids >= 0).sum(1).to(torch.int32))
        raise ValueError(f"unknown select_mode {mode!r}")

    def insert_batch(
        self, data, adj0, adj0_d, adj_up, adj_up_d, backend, levels,
        new_ids, entry: int, mask, *, acct: CostAccount,
    ):
        """Insert one batch of P vectors against the current graph (in place).

        levels (n,) int32 tensor; new_ids/mask (P,) tensors on the device.
        """
        p = new_ids.shape[0]
        params = self.params
        qctx = backend.prepare_query(data[new_ids.long()])
        lv = levels[new_ids.long()]
        eps = torch.full((p,), int(entry), dtype=torch.int32, device=new_ids.device)
        for l in range(params.max_layers - 1, 0, -1):
            adj_l, adj_ld = adj_up[l - 1], adj_up_d[l - 1]
            res = self.acquire(backend, qctx, adj_l, eps)
            acct.add_beam(res, phase=PH_BEAM_UPPER)
            do = (lv >= l) & mask
            cand_ids, cand_d = _drop_self(res.ids, res.dists, new_ids)
            sel = self.select(backend, cand_ids, cand_d, r=params.r_upper)
            sel_ids = torch.where(do[:, None], sel.ids, -1)
            sel_d = torch.where(do[:, None], sel.dists, INF)
            commit_forward(adj_l, adj_ld, backend, new_ids, sel_ids, sel_d, do)
            reverse_pass(adj_l, adj_ld, backend, new_ids, sel_ids, sel_d, do, params=params)
            eps = torch.where(res.ids[:, 0] >= 0, res.ids[:, 0], eps)
        res = self.acquire(backend, qctx, adj0, eps)
        acct.add_beam(res, phase=PH_BEAM_BASE)
        cand_ids, cand_d = _drop_self(res.ids, res.dists, new_ids)
        sel = self.select(backend, cand_ids, cand_d, r=params.r_base)
        sel_ids = torch.where(mask[:, None], sel.ids, -1)
        sel_d = torch.where(mask[:, None], sel.dists, INF)
        _, _, backend = commit_forward(adj0, adj0_d, backend, new_ids, sel_ids, sel_d, mask)
        _, _, backend = reverse_pass(
            adj0, adj0_d, backend, new_ids, sel_ids, sel_d, mask, params=params
        )
        return adj0, adj0_d, adj_up, adj_up_d, backend, acct

    def bootstrap(
        self, data, adj0, adj0_d, adj_up, adj_up_d, backend, levels,
        *, acct: CostAccount | None = None,
    ):
        """Exact sequential insertion of the first ``p = min(batch, n)`` rows
        (the connected seed), in place: insert i scores the p seed rows
        (``query_dists``, charged to the ``bootstrap`` phase) and, on every
        layer from the top down, selects among the earlier seed rows that
        reach the layer, commits its list and adds the reverse edges.

        ``levels`` is an (n,) int32 tensor on the graph's device. A layer
        above insert i's level selects nothing and commits nothing (its mask
        is empty), so it is skipped on the host. Returns the graph carry
        and the account.
        """
        params = self.params
        p = min(params.batch, int(data.shape[0]))
        dev = adj0.device
        cand_pool = torch.arange(p, dtype=torch.int32, device=dev)
        acct = CostAccount() if acct is None else acct
        lv = levels[:p]
        lv_np = lv.cpu().numpy()
        for i in range(p):
            qctx = backend.prepare_query(data[i:i + 1])
            d_all = backend.query_dists(qctx, cand_pool[None])[0]  # (p,)
            acct.add_dists(p, phase=PH_BOOTSTRAP)
            new_ids = torch.full((1,), i, dtype=torch.int32, device=dev)
            for l in range(params.max_layers - 1, -1, -1):
                if lv_np[i] < l:
                    continue
                r_l = params.r_base if l == 0 else params.r_upper
                elig = (cand_pool < i) & (lv >= l) & (lv[i] >= l)
                d_s, order = torch.sort(torch.where(elig, d_all, INF), stable=True)
                ids_s = torch.where(torch.isfinite(d_s), cand_pool[order], -1)
                sel = self.select_one(backend, ids_s, d_s, r=r_l)
                m1 = lv[i:i + 1] >= l
                adj, adj_d = (adj0, adj0_d) if l == 0 else (adj_up[l - 1], adj_up_d[l - 1])
                _, _, backend = commit_forward(
                    adj, adj_d, backend, new_ids, sel.ids[None], sel.dists[None], m1
                )
                _, _, backend = reverse_pass(
                    adj, adj_d, backend, new_ids, sel.ids[None], sel.dists[None], m1,
                    params=params,
                )
        return adj0, adj0_d, adj_up, adj_up_d, backend, acct

    def build_layered(self, data, backend, levels, entries, *, seconds: dict | None = None):
        """The batch-synchronous build over all of ``data`` (the paper's
        incremental strategy): ``bootstrap``, then ``insert_batch`` for
        b = 1 … ⌈n/P⌉ − 1 over ids ``b·P + arange(P)`` (masked past n,
        clamped to n − 1) from entry ``entries[b]``.

        ``backend`` is written in place (callers pass a clone); ``levels``
        an (n,) int32 tensor on the data's device; ``entries`` the host plan
        of :func:`prefix_entries`. ``seconds`` (optional) gets the wall time
        of the seed batch (``bootstrap``) and of the insert batches
        (``insert_batches``), the card synchronised at each end. Returns
        (adj0, adj0_d, adj_up, adj_up_d, backend, CostAccount).
        """
        params = self.params
        n = int(data.shape[0])
        p = params.batch
        dev = data.device
        # a 1-layer build allocates a 0-length upper stack
        l_up = params.max_layers - 1
        adj0 = torch.full((n, params.r_base), -1, dtype=torch.int32, device=dev)
        adj0_d = torch.full((n, params.r_base), INF, device=dev)
        adj_up = torch.full((l_up, n, params.r_upper), -1, dtype=torch.int32, device=dev)
        adj_up_d = torch.full((l_up, n, params.r_upper), INF, device=dev)
        seconds = {} if seconds is None else seconds
        sync(dev)
        t0 = time.perf_counter()
        adj0, adj0_d, adj_up, adj_up_d, backend, acct = self.bootstrap(
            data, adj0, adj0_d, adj_up, adj_up_d, backend, levels
        )
        sync(dev)
        t1 = time.perf_counter()
        seconds["bootstrap"] = seconds.get("bootstrap", 0.0) + t1 - t0
        ar = torch.arange(p, dtype=torch.int32, device=dev)
        for b in range(1, -(-n // p)):
            ids = b * p + ar
            mask = ids < n
            adj0, adj0_d, adj_up, adj_up_d, backend, acct = self.insert_batch(
                data, adj0, adj0_d, adj_up, adj_up_d, backend, levels,
                ids.clamp_max(n - 1), int(entries[b]), mask, acct=acct,
            )
        sync(dev)
        seconds["insert_batches"] = seconds.get("insert_batches", 0.0) + time.perf_counter() - t1
        return adj0, adj0_d, adj_up, adj_up_d, backend, acct


def run_insert_schedule(
    engine: BuildEngine, data, adj0, adj0_d, adj_up, adj_up_d, backend,
    levels, ids, entries, mask,
):
    """``engine.insert_batch`` over a (nb, P) id schedule; returns the graph,
    the backend and a CostAccount of the insertions."""
    acct = CostAccount()
    for b in range(ids.shape[0]):
        adj0, adj0_d, adj_up, adj_up_d, backend, acct = engine.insert_batch(
            data, adj0, adj0_d, adj_up, adj_up_d, backend, levels,
            ids[b], int(entries[b]), mask[b], acct=acct,
        )
    return adj0, adj0_d, adj_up, adj_up_d, backend, acct


def batch_schedule(ids: np.ndarray, batch: int):
    """Host-side: pad a flat id list to full (nb, P) batches + validity mask."""
    n = len(ids)
    nb = -(-n // batch)
    pad = nb * batch - n
    ids_p = np.concatenate([ids, np.full(pad, ids[-1] if n else 0, np.int32)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return ids_p.reshape(nb, batch).astype(np.int32), mask.reshape(nb, batch)


# ---------------------------------------------------------------------------
# Bulk construction: RNN-Descent refinement rounds
# ---------------------------------------------------------------------------

#: rows per ``round_dists`` launch. The reference scores 256 rows per call;
#: rows are independent, so coarser blocks give the same results and fill
#: the card (a (16384, C, M) int32 code block is 128 MiB at C = 128, M = 16).
_BULK_CHUNK = 16384

#: pool prefix expanded per round: candidates per round are P + E²
_BULK_EXPAND = 8

#: random extra candidates appended to each final pool before selection
_BULK_RANDOM = 32

#: id sentinel that sorts invalid candidates after every real id
_ID_SENTINEL = 2 ** 30


def _bulk_score(backend, qctx, members, cand):
    """Score one block of candidate rows against their members' tables;
    self and invalid entries to +inf. Returns (dists, bad)."""
    d = backend.round_dists(qctx, cand.clamp_min(0))
    bad = (cand < 0) | (cand == members[:, None])
    return torch.where(bad, INF, d), bad


def _topk_rows(d, ids, pool_p):
    vals, idx = stable_smallest(d, pool_p)
    fin = torch.isfinite(vals)
    return torch.where(fin, ids.gather(1, idx), -1), torch.where(fin, vals, INF)


def _bulk_pass(backend, qctxs, members, cand, pool_p, *, dedup: bool):
    """Score (m, C) candidate rows in blocks and keep the best P per row.

    dedup=False is the reference's duplicate-tolerant round merge
    (``_bulk_score_topk``); dedup=True strikes repeated ids first (stable
    sort by id, adjacent repeats to +inf — ``_bulk_score_merge``).
    Returns (ids (m, P), dists (m, P), n_scored).
    """
    m = cand.shape[0]
    out_ids = torch.empty((m, pool_p), dtype=torch.int32, device=cand.device)
    out_d = torch.empty((m, pool_p), dtype=torch.float32, device=cand.device)
    n_scored = 0
    for s in range(0, m, _BULK_CHUNK):
        e = min(m, s + _BULK_CHUNK)
        c = cand[s:e]
        d, bad = _bulk_score(backend, ctx_rows(qctxs, slice(s, e)), members[s:e], c)
        n_scored += int((~bad).sum())
        if dedup:
            idkey = torch.where(bad, _ID_SENTINEL, c)
            _, order = torch.sort(idkey, dim=1, stable=True)
            c = c.gather(1, order)
            d = d.gather(1, order)
            dup = torch.zeros_like(bad)
            dup[:, 1:] = c[:, 1:] == c[:, :-1]
            d = torch.where(dup, INF, d)
        out_ids[s:e], out_d[s:e] = _topk_rows(d, c, pool_p)
    return out_ids, out_d, n_scored


def bulk_pool_width(params: BuildParams, r: int, m: int) -> int:
    """Candidate-pool width P for a layer of degree r over m members."""
    p = params.bulk_pool if params.bulk_pool > 0 else 2 * r
    return max(1, min(p, m - 1))


def bulk_refine(
    data, backend, member_ids: np.ndarray, *, r: int, params: BuildParams,
    seed: int, layer: int = 0,
):
    """Refine a k-NN candidate pool over ``member_ids`` by batched rounds.

    Returns (pool_ids (m, P+S), pool_d, n_dists, n_hops, n_rounds): the
    first P columns are the refined pool ascending by distance, the S-wide
    tail the scored random augmentation (unsorted).
    """
    m = int(len(member_ids))
    if m < 2:
        raise ValueError(f"bulk_refine needs ≥ 2 members, got {m}")
    n = data.shape[0]
    dev = data.device
    pool_p = bulk_pool_width(params, r, m)
    r_exp = min(r, pool_p, _BULK_EXPAND)
    s_aug = min(_BULK_RANDOM, m - 1)
    mem_np = np.asarray(member_ids, np.int32)
    rng = np.random.default_rng([seed, 0xB07B, layer])
    rnd = rng.integers(0, m - 1, size=(m, pool_p))
    rnd += rnd >= np.arange(m)[:, None]  # shift past self: uniform on m−1
    cand0 = torch.from_numpy(mem_np[rnd]).to(dev)
    del rnd
    aug = torch.from_numpy(mem_np[rng.integers(0, m, size=(m, s_aug))]).to(dev)

    members = torch.from_numpy(mem_np).to(dev)
    inv = torch.zeros(n, dtype=torch.int64, device=dev)
    inv[members.long()] = torch.arange(m, device=dev)
    qctxs = backend.prepare_query(data[members.long()])
    eps_count = int(params.bulk_eps * m)

    pool_ids, pool_d, n_scored = _bulk_pass(backend, qctxs, members, cand0, pool_p, dedup=True)
    del cand0
    rounds, changed = 0, 2 ** 30
    while rounds < params.bulk_rounds and changed > eps_count:
        top = pool_ids[:, :r_exp]  # (m, E) global ids
        ok = top >= 0
        rows = pool_ids[:, :r_exp][inv[top.clamp_min(0).long()]]  # (m, E, E)
        non = torch.where(ok[:, :, None], rows, -1).reshape(m, r_exp * r_exp)
        cand = torch.cat([pool_ids, non], 1)  # (m, P + E²)
        new_ids, new_d, nsc = _bulk_pass(backend, qctxs, members, cand, pool_p, dedup=False)
        changed = int((new_ids != pool_ids).any(1).sum())
        pool_ids, pool_d = new_ids, new_d
        n_scored += nsc
        rounds += 1
    # rounds merge duplicate-tolerant; one exact merge strikes the repeats
    pool_ids, pool_d, nsc = _bulk_pass(backend, qctxs, members, pool_ids, pool_p, dedup=True)
    n_scored += nsc
    # random augmentation: S scored random members per pool (long-range edges)
    aug_d = torch.empty(aug.shape, dtype=torch.float32, device=dev)
    aug_ids = torch.empty_like(aug)
    for s in range(0, m, _BULK_CHUNK):
        e = min(m, s + _BULK_CHUNK)
        d, bad = _bulk_score(backend, ctx_rows(qctxs, slice(s, e)), members[s:e], aug[s:e])
        aug_d[s:e] = d
        aug_ids[s:e] = torch.where(bad, -1, aug[s:e])
        n_scored += int((~bad).sum())
    pool_ids = torch.cat([pool_ids, aug_ids], 1)
    pool_d = torch.cat([pool_d, aug_d], 1)
    if obs.enabled():
        # init merge + per-round passes + exit merge + random augmentation,
        # each chunked into ceil(m / _BULK_CHUNK) round_dists launches
        obs.tick("bulk_round_batches_total", n=(rounds + 3) * -(-m // _BULK_CHUNK),
                 layer=str(layer))
        obs.tick("bulk_rounds_total", n=rounds, layer=str(layer))
    return pool_ids, pool_d, float(n_scored), float(m * r_exp * rounds), rounds


def bulk_reverse(adj, adj_d, backend, members, sel_ids, sel_d, *, params: BuildParams):
    """Reverse pass for a whole-membership commit, batched (in place).

    Every forward edge x→y becomes a proposal y←x; proposals are grouped by
    destination (stable sort by distance, then by destination), ranked, the
    best K = 2R per row kept, and each touched row's existing ∪ proposed
    candidates pruned with the same MRNG heuristic.
    """
    m, r = sel_ids.shape
    n = adj.shape[0]
    dev = adj.device
    k_cap = 2 * r
    src = torch.repeat_interleave(members.to(torch.int32), r)
    dst = sel_ids.reshape(-1)
    dd = sel_d.reshape(-1)
    dstk = torch.where(dst >= 0, dst, n)
    _, o1 = torch.sort(dd, stable=True)
    _, o2 = torch.sort(dstk[o1], stable=True)
    o = o1[o2]
    dst_s, src_s, dd_s = dstk[o], src[o], dd[o]
    idx = torch.arange(m * r, device=dev)
    first = torch.ones(m * r, dtype=torch.bool, device=dev)
    first[1:] = dst_s[1:] != dst_s[:-1]
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    rank = idx - start
    ok = (dst_s < n) & (rank < k_cap)
    prop_ids = torch.full((n, k_cap), -1, dtype=torch.int32, device=dev)
    prop_d = torch.full((n, k_cap), INF, device=dev)
    row, col = dst_s[ok].long(), rank[ok]
    prop_ids[row, col] = src_s[ok]
    prop_d[row, col] = dd_s[ok]
    touched = torch.nonzero(prop_ids[:, 0] >= 0)[:, 0]

    cand_ids = torch.cat([adj[touched], prop_ids[touched]], 1)  # (T, r + K)
    cand_d = torch.cat([adj_d[touched], prop_d[touched]], 1)
    del prop_ids, prop_d
    # dedup (x may already sit in y's row): sort by id, strike repeats
    badc = cand_ids < 0
    idkey = torch.where(badc, _ID_SENTINEL, cand_ids)
    _, order = torch.sort(idkey, dim=1, stable=True)
    ids_s = cand_ids.gather(1, order)
    d_s = torch.where(badc, INF, cand_d).gather(1, order)
    dup = torch.zeros_like(badc)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    ids_s = torch.where(dup, -1, ids_s)
    d_s = torch.where(dup, INF, d_s)
    pruned = prune_list(
        backend, ids_s, d_s, r=r, alpha=params.bulk_select_alpha(), mode=params.prune_mode
    )
    adj[touched] = pruned.ids
    adj_d[touched] = pruned.dists
    # the reference rewrites every mirror row from the layer's lists
    backend = backend.with_updated_edges(torch.arange(n, device=dev), adj)
    return adj, adj_d, backend


def bulk_commit(engine: BuildEngine, adj, adj_d, backend, members, pool_ids, pool_d, *, r: int):
    """Commit refined pools: MRNG selection (slack ``bulk_select_alpha``)
    over each pool, forward commit, then :func:`bulk_reverse` (in place)."""
    p = engine.params
    pool_d = torch.where(pool_ids >= 0, pool_d, INF)
    pool_d, order = torch.sort(pool_d, dim=1, stable=True)
    pool_ids = pool_ids.gather(1, order)
    if p.select_mode == "heuristic":
        sel = select_neighbors(backend, pool_ids, pool_d, r=r, alpha=p.bulk_select_alpha())
    else:
        sel = engine.select(backend, pool_ids, pool_d, r=r)
    del pool_ids, pool_d
    mask = torch.ones(members.shape, dtype=torch.bool, device=members.device)
    commit_forward(adj, adj_d, backend, members, sel.ids, sel.dists, mask)
    return bulk_reverse(adj, adj_d, backend, members, sel.ids, sel.dists, params=p)


def bfs_reachable(adj: np.ndarray, entry: int) -> np.ndarray:
    """Host-side BFS over an adjacency table: (n,) bool reachability."""
    n = adj.shape[0]
    seen = np.zeros(n, bool)
    if n == 0:
        return seen
    seen[entry] = True
    frontier = np.asarray([entry])
    while frontier.size:
        nxt = adj[frontier].reshape(-1)
        nxt = np.unique(nxt[nxt >= 0])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return seen


def _reach_unseen(adj: np.ndarray, start: int, seen: np.ndarray) -> np.ndarray:
    """(n,) bool: the vertices reachable from ``start`` through unseen ones.

    The graft loop keeps ``seen`` closed under out-edges (it only ever adds
    whole reachable closures), so any path that enters a seen vertex stays
    in ``seen``: this equals ``bfs_reachable(adj, start) & ~seen``, at the
    cost of the island instead of the whole graph.
    """
    out = np.zeros(adj.shape[0], bool)
    out[start] = True
    frontier = np.asarray([start])
    while frontier.size:
        nxt = adj[frontier].reshape(-1)
        nxt = np.unique(nxt[nxt >= 0])
        nxt = nxt[~seen[nxt] & ~out[nxt]]
        out[nxt] = True
        frontier = nxt
    return out


#: pair-distance elements per block in the structural graft fallback
_GRAFT_TILE = 1 << 26


def repair_reachability(
    data, adj0, adj0_d, adj_up, adj_up_d, backend, levels, entry: int,
    *, params: BuildParams, max_passes: int = 2, seconds: dict | None = None,
):
    """Make every vertex reachable from ``entry`` on the base layer.

    BFS the base layer; re-insert unreachable vertices through
    :func:`run_insert_schedule` (up to ``max_passes``); force-link any
    leftovers to their nearest reachable vertex. ``levels`` is an (n,) int32
    tensor. Returns (adj0, adj0_d, adj_up, adj_up_d, backend, n_dists,
    n_hops, unreachable) — the last the count of unreachable vertices each
    pass started from (a last entry for the graft stage, if it ran).
    ``seconds`` (optional) gets the wall time of the re-insert passes
    (``repair_insert``) and of the graft stage (``repair_graft``).
    """
    seconds = {} if seconds is None else seconds
    t0 = time.perf_counter()
    engine = BuildEngine(params)
    dev = adj0.device
    n = int(adj0.shape[0])
    n_d = n_h = 0.0
    repaired: list[int] = []
    for _ in range(max_passes):
        seen = bfs_reachable(adj0.cpu().numpy(), int(entry))
        unreach = np.nonzero(~seen)[0].astype(np.int32)
        if unreach.size == 0:
            seconds["repair_insert"] = time.perf_counter() - t0
            return adj0, adj0_d, adj_up, adj_up_d, backend, n_d, n_h, repaired
        if unreach.size > n // 4:
            break  # mostly islands: go structural
        repaired.append(int(unreach.size))
        ids, mask = batch_schedule(unreach, params.batch)
        ent = np.full((ids.shape[0],), int(entry), np.int32)
        adj0, adj0_d, adj_up, adj_up_d, backend, acct = run_insert_schedule(
            engine, data, adj0, adj0_d, adj_up, adj_up_d, backend, levels,
            torch.from_numpy(ids).to(dev), ent, torch.from_numpy(mask).to(dev),
        )
        # The reference pads the schedule to a power of two of batches (one
        # compile per size class). A padded batch (ids 0, all masked out)
        # commits nothing, so every one of them searches the same graph and
        # counts the same evaluations: run one, count it for all.
        nb = ids.shape[0]
        n_pad = (1 << (nb - 1).bit_length()) - nb
        if n_pad:
            p = params.batch
            _, _, _, _, _, pad_acct = run_insert_schedule(
                engine, data, adj0, adj0_d, adj_up, adj_up_d, backend, levels,
                torch.zeros((1, p), dtype=torch.int32, device=dev),
                np.full((1,), int(entry), np.int32),
                torch.zeros((1, p), dtype=torch.bool, device=dev),
            )
            acct.n_dists += n_pad * pad_acct.n_dists
            acct.n_hops += n_pad * pad_acct.n_hops
        n_d += acct.n_dists
        n_h += acct.n_hops
    seconds["repair_insert"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    adj_np = adj0.cpu().numpy().copy()
    adj_d_np = adj0_d.cpu().numpy().copy()
    seen = bfs_reachable(adj_np, int(entry))
    if not seen.all():
        unreach = np.nonzero(~seen)[0].astype(np.int32)
        repaired.append(int(unreach.size))
        all_ids = torch.arange(n, dtype=torch.int32, device=dev)
        blk = max(1, min(int(unreach.size), _GRAFT_TILE // max(1, n)))
        u_dev = torch.from_numpy(unreach).to(dev)
        d_all = np.concatenate([
            backend.pair_dists(u_dev[i:i + blk, None], all_ids[None, :]).cpu().numpy()
            for i in range(0, int(unreach.size), blk)
        ])
        n_d += float(d_all.size)
        row_of = {int(u): i for i, u in enumerate(unreach)}

        def dists_from(v: int) -> np.ndarray:
            i = row_of.get(v)
            if i is not None:
                return d_all[i]
            return backend.pair_dists(
                torch.full((1, 1), v, dtype=torch.int32, device=dev), all_ids[None, :]
            ).cpu().numpy()[0]

        grafted = np.zeros(adj_np.shape, bool)  # graft slots are permanent

        def link(u: int, y: int, d: float) -> bool:
            row = adj_np[y]
            free = np.nonzero(row < 0)[0]
            if free.size:
                slot = int(free[0])
            else:
                evictable = np.nonzero(~grafted[y])[0]
                if evictable.size == 0:
                    return False  # row is all grafts: caller picks another y
                slot = int(evictable[np.argmin(adj_d_np[y, evictable])])
            adj_np[y, slot] = u
            adj_d_np[y, slot] = d
            grafted[y, slot] = True
            return True

        # per island: graft the best border pair, then flood its closure
        for _ in range(64):
            todo = np.nonzero(~seen)[0]
            if todo.size == 0:
                break
            for u in todo:
                while not seen[u]:
                    members = np.nonzero(_reach_unseen(adj_np, int(u), seen))[0]
                    d_sub = np.stack([dists_from(int(v)) for v in members])
                    d_sub = np.where(seen[None, :], d_sub, np.inf)
                    while True:
                        flat = int(np.argmin(d_sub))
                        ui, y = divmod(flat, n)
                        if link(int(members[ui]), y, float(d_sub[ui, y])):
                            break
                        d_sub[:, y] = np.inf
                    seen |= _reach_unseen(adj_np, int(members[ui]), seen)
            seen = bfs_reachable(adj_np, int(entry))
        adj0 = torch.from_numpy(adj_np).to(dev)
        adj0_d = torch.from_numpy(adj_d_np).to(dev)
        backend = backend.with_updated_edges(all_ids, adj0)
    seconds["repair_graft"] = time.perf_counter() - t0
    return adj0, adj0_d, adj_up, adj_up_d, backend, n_d, n_h, repaired
