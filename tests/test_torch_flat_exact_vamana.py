"""The Vamana cases of the exact-input builds (incremental with and without
the second pass, bulk) over every backend, port against reference, on the
CPU: bit-equal graphs, distances, entries and n_dists, equal searches
(``test_torch_flat_exact.py`` holds the HNSW and NSG cases and says how;
the inputs and the check are in ``_flat_common.py``).
"""

from __future__ import annotations

import pytest

from _flat_common import CASES, KINDS, check_exact_build, int_rows  # noqa: F401 (fixture)
from _threads import one_torch_thread  # noqa: F401 (autouse fixture)

VAMANA = [c for c in CASES if c[0] == "vamana"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("algo,strategy,kw", VAMANA, ids=[f"{a}-{s}-{k}" for a, s, k in VAMANA])
def test_build_bit_equal_on_exact_inputs(int_rows, kind, algo, strategy, kw):
    check_exact_build(int_rows, kind, algo, strategy, kw)
