"""Lemma 1 / Theorem 1 machinery (paper §3.1), in PyTorch (reference:
repro.core.margin).

A distance comparison is the sign of a hyperplane test:

    δ(u, v) < δ(u, w)  ⇔  e·u − b < 0,   e = w − v,  b = (‖w‖² − ‖v‖²)/2.

Theorem 1: with compact codes u', v', w' and error vectors E_x = x − x', the
compressed comparison keeps its sign whenever |e·u − b| ≥ |E| (Eq. 1). The
calibration protocol samples (u, v, w) triples — a vector and its two
nearest neighbors — and measures the share whose margin dominates the
coder's error; coder parameters are tuned on that share.

``sample_triples`` draws from a ``torch.Generator`` (the reference draws
from ``jax.random``); :func:`triples_from` is its deterministic half, which
picks the reference's neighbors when given the reference's sampled rows.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.utils import topk_first


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def hyperplane_margin(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """e·u − b for the perpendicular-bisector hyperplane of (v, w) (Lemma 1);
    broadcastable (…, D) inputs -> (…)."""
    e = w - v
    b = 0.5 * (_dot(w, w) - _dot(v, v))
    return _dot(e, u) - b


def comparison_sign(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sign(δ(u,v) − δ(u,w)) computed directly (the oracle of Lemma 1)."""
    dv = ((u - v) ** 2).sum(-1)
    dw = ((u - w) ** 2).sum(-1)
    return torch.sign(dv - dw)


def error_term(u, v, w, eu, ev, ew) -> torch.Tensor:
    """E of Theorem 1 (Eq. 1); all inputs (…, D) -> (…)."""
    return (
        _dot(ew - ev, u)
        + _dot(w - v, eu)
        + _dot(ev, eu)
        - _dot(ew, eu)
        + 0.5 * _dot(ew, ew)
        - 0.5 * _dot(ev, ev)
        + _dot(v, ev)
        - _dot(w, ew)
    )


class TripleSet(NamedTuple):
    """Calibration triples: each row is (u, its NN v, its 2nd-NN w)."""

    u: torch.Tensor  # (T, D)
    v: torch.Tensor  # (T, D)
    w: torch.Tensor  # (T, D)


def triples_from(data: torch.Tensor, q_idx, p_idx, *, topk: int = 100) -> TripleSet:
    """The triples of sampled rows: u = data[q_idx], and v / w its first and
    second nearest rows of the pool data[p_idx]. Distances are
    ‖q‖² + ‖p‖² − 2 q·p; near-zero ones (the row itself) are struck; the
    neighbors come from ``lax.top_k``'s order (lowest index on ties)."""
    q_idx = torch.as_tensor(np.array(q_idx), device=data.device).long()
    p_idx = torch.as_tensor(np.array(p_idx), device=data.device).long()
    q, p = data[q_idx], data[p_idx]
    d2 = (q * q).sum(1, keepdim=True) + (p * p).sum(1)[None, :] - 2.0 * q @ p.T
    d2 = torch.where(d2 < 1e-9, torch.inf, d2)
    _, nn = topk_first(-d2, min(topk, p.shape[0]))
    return TripleSet(u=q, v=p[nn[:, 0]], w=p[nn[:, 1]])


def sample_triples(
    gen: torch.Generator,
    data: torch.Tensor,
    *,
    n_triples: int = 1024,
    topk: int = 100,
    pool: int = 8192,
) -> TripleSet:
    """The paper's protocol: sample vectors without replacement, find their
    nearest neighbors in a sampled pool, pair each with its 1st and 2nd (the
    hardest comparison, the one a build meets near convergence). ``gen``
    lies on ``data``'s device."""
    n = data.shape[0]
    q_idx = torch.randperm(n, generator=gen, device=data.device)[: min(n_triples, n)]
    p_idx = torch.randperm(n, generator=gen, device=data.device)[: min(pool, n)]
    return triples_from(data, q_idx.cpu().numpy(), p_idx.cpu().numpy(), topk=topk)


def margin_satisfaction_rate(
    triples: TripleSet, reconstruct: Callable[[torch.Tensor], torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Share of triples with |e·u − b| ≥ |E| for a coder's reconstruction
    (``reconstruct`` maps (T, D) originals to derived vectors), and the
    share whose compressed comparison has the true sign (the empirically
    stronger statistic: the bound is sufficient, not necessary)."""
    u, v, w = triples
    ru, rv, rw = reconstruct(u), reconstruct(v), reconstruct(w)
    margin = hyperplane_margin(u, v, w)
    err = error_term(u, v, w, u - ru, v - rv, w - rw)
    ok = margin.abs() >= err.abs()
    sign_match = comparison_sign(u, v, w) == comparison_sign(ru, rv, rw)
    return ok.to(torch.float32).mean(), sign_match.to(torch.float32).mean()


def calibrate(
    gen: torch.Generator,
    data: torch.Tensor,
    coder_factory: Callable[..., tuple[Callable[[torch.Tensor], torch.Tensor], float]],
    grid: list[dict],
    *,
    target_rate: float = 0.9,
    n_triples: int = 512,
) -> dict:
    """Grid-tune coder parameters: the smallest code whose sign-agreement
    rate reaches ``target_rate``, else the best rate.
    ``coder_factory(**params)`` returns ``(reconstruct_fn, code_bytes)``."""
    triples = sample_triples(gen, data, n_triples=n_triples)
    results = []
    for params in grid:
        reconstruct, code_bytes = coder_factory(**params)
        rate, sign_rate = margin_satisfaction_rate(triples, reconstruct)
        results.append({**params, "code_bytes": code_bytes, "margin_rate": float(rate),
                        "sign_rate": float(sign_rate)})
    feasible = [r for r in results if r["sign_rate"] >= target_rate]
    if feasible:
        best = min(feasible, key=lambda r: (r["code_bytes"], -r["sign_rate"]))
    else:
        best = max(results, key=lambda r: r["sign_rate"])
    best = dict(best)
    best["all_results"] = results
    return best


def np_ground_truth_sign(u: np.ndarray, v: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Numpy oracle of :func:`comparison_sign`."""
    dv = np.sum((u - v) ** 2, axis=-1)
    dw = np.sum((u - w) ** 2, axis=-1)
    return np.sign(dv - dw)
