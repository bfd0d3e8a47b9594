"""Every algorithm × strategy × backend build of the port against the
reference's, on exactly representable inputs, on the CPU.

Integer rows in [−8, 8] with hand-made coders (PQ with integer codebooks,
SQ with s2 = 1, PCA with a zero mean and identity columns; fp32 as is;
Flash with the reference's coder, whose distances are integer level sums).
Every distance is an exact float32 integer, so HNSW (bulk, incremental),
Vamana (incremental with and without the second pass, bulk) and NSG
(incremental with the reference's k-NN graph carried across, bulk) must
give bit-equal graphs, distances, entries and n_dists over every backend,
and equal search ids and exact rerank distances (reconstruct rerank
distances of decoded, non-integer vectors: allclose at rtol 1e-5). The
shared inputs and the check are in ``_flat_common.py``. This file holds
the HNSW and NSG cases, ``test_torch_flat_exact_vamana.py`` the Vamana
ones (one file took 627 s on one test worker); the other flat tests are in
``test_torch_flat.py`` and ``test_torch_flat_float.py``.
"""

from __future__ import annotations

import pytest

from _flat_common import CASES, KINDS, check_exact_build, int_rows  # noqa: F401 (fixture)
from _threads import one_torch_thread  # noqa: F401 (autouse fixture)

HNSW_NSG = [c for c in CASES if c[0] != "vamana"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("algo,strategy,kw", HNSW_NSG, ids=[f"{a}-{s}-{k}" for a, s, k in HNSW_NSG])
def test_build_bit_equal_on_exact_inputs(int_rows, kind, algo, strategy, kw):
    check_exact_build(int_rows, kind, algo, strategy, kw)
