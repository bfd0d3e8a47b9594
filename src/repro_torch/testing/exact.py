"""Baseline backends whose every distance is an exact float32 integer.

Over integer rows in [−8, 8], with fp32, PQ with integer codebooks, SQ with
s2 = 1, and PCA with a zero mean and a column selection of the identity as
its rotation, every sum a backend computes is an integer small enough for
float32, so any summation order gives the same bits. Builds over them are
then equal on every device: the card's builds are held to the CPU's this
way (``chip_smoke.py`` phase 5, ``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import baselines as bl
from repro_torch.core import quantize as qz
from repro_torch.graph import backends as bk


def exact_backends(x: torch.Tensor, device) -> dict:
    """{kind: backend} for fp32, pq, sq and pca over the integer rows ``x``
    (a CPU tensor, D a multiple of 8), each carried to ``device`` through
    its ``state_dict`` / ``from_state`` round trip."""
    d = x.shape[1]
    cb = torch.from_numpy(np.random.default_rng(3).integers(-8, 9, (8, 16, d // 8)).astype(np.float32))
    diff = cb[:, :, None, :] - cb[:, None, :, :]
    pq = bl.PQCoder(codebooks=cb, sdc=(diff * diff).sum(-1))
    ones = torch.ones(d)
    sq = bl.SQCoder(params=qz.SQParams(lo=-8 * ones, scale=16 * ones,
                                       bits=torch.tensor(8, dtype=torch.int32)), s2=ones)
    pca = bl.PCACoder(mean=torch.zeros(d), rot=torch.eye(d)[:, ::2].contiguous())
    cpu = {
        "fp32": bk.FP32Backend(x),
        "pq": bk.PQBackend(pq, bl.pq_encode(pq, x)),
        "sq": bk.SQBackend(sq, bl.sq_encode(sq, x)),
        "pca": bk.PCABackend(pca, bl.pca_encode(pca, x)),
    }
    return {kind: type(be).from_state(be.state_dict(), device=device) for kind, be in cpu.items()}
