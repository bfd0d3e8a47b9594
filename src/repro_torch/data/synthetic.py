"""Deterministic synthetic data: the vectors and the CSR graph of the
neighbour sampler (numpy, the same generators the reference package uses,
so both packages see identical data from one seed), the LM token stream
and the recsys session batch (reference: ``repro.data.synthetic``).

A batch is a pure function of (seed, step, shard), so any host, or a
restarted one, draws exactly the same batch.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.recsys.bert4rec import Bert4RecConfig, sample_training_batch
from repro_torch.utils import resolve_device


def vector_dataset(
    seed: int, *, n: int, d: int, n_clusters: int = 64, sep: float = 1.0
) -> np.ndarray:
    """Embedding-like GMM with anisotropic (PCA-spectrum-like) noise."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * sep
    scales = np.linspace(1.0, 0.2, d).astype(np.float32)
    x = centers[rng.integers(0, n_clusters, n)]
    x += rng.normal(size=(n, d)).astype(np.float32) * scales
    return x


def _generator(seed: int, step: int, shard: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step, shard) alone."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence((seed, step, shard)).generate_state(1, np.uint64)[0]))
    return gen


def lm_batch(seed: int, step: int, shard: int, *, batch: int, seq: int, vocab: int,
             device: str | torch.device = "cuda") -> dict:
    """Zipf-ish token stream and next-token labels, int32 (B, S) each on
    ``device``: ``clip(int(u^-0.7 − 1), 0, vocab − 1)`` with u uniform on
    [1e-6, 1), so token 0 takes a share of 1 − 2^(−1/0.7) ≈ 0.628. The
    reference draws u from ``jax.random``; this draw has its distribution,
    not its bits."""
    dev = resolve_device(device)
    u = torch.rand((batch, seq + 1), generator=_generator(seed, step, shard, dev), device=dev)
    u = torch.clamp_min(u * (1.0 - 1e-6) + 1e-6, 1e-6)
    toks = torch.clamp((u.pow(-0.7) - 1).to(torch.int32), 0, vocab - 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def recsys_batch(seed: int, step: int, shard: int, *, batch: int, seq: int, n_items: int,
                 mask_prob: float = 0.2, device: str | torch.device = "cuda") -> dict:
    """Popularity-skewed sessions and cloze mask positions on ``device``:
    ``bert4rec.sample_training_batch`` from the (seed, step, shard)
    generator, as ``items`` (B, S) int32 and ``mask_positions`` (B, S)
    bool, each position masked with probability ``mask_prob`` and the last
    always. Like :func:`lm_batch`, the draw has the reference's
    distribution, not its bits."""
    dev = resolve_device(device)
    cfg = Bert4RecConfig(n_items=n_items, seq_len=seq, mask_prob=mask_prob)
    items, mask = sample_training_batch(_generator(seed, step, shard, dev), cfg, batch)
    return {"items": items, "mask_positions": mask}


def random_csr_graph(seed: int, *, n_nodes: int, avg_degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Random graph in CSR form (indptr int64, indices int32) for the
    neighbour sampler: Poisson degrees (at least 1), uniform endpoints.
    numpy, the reference's draw, so both packages give equal arrays."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg_degree, n_nodes).clip(1, None)
    indptr = np.zeros(n_nodes + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, n_nodes, indptr[-1]).astype(np.int32)
    return indptr, indices
