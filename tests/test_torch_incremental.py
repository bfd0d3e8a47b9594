"""The port's incremental HNSW build against the reference's, bit for bit.

``build_hnsw(strategy="incremental")`` — ``BuildEngine.bootstrap`` (the
exact sequential seed batch) then ``build_layered``'s insert batches —
started from the reference's fitted Flash coder and codes
(``FlashBackend.from_state`` / ``FlashBlockedBackend.from_state``) gives
bit-equal ``adj0``, ``adj_up``, ``levels``, ``entry``, mirror, per-phase
``n_dists`` and ``n_hops``. The port builds its own query tables; each
case first requires them level-equal to the reference's, which is what
makes the comparison exact. This file holds every case but ``n1500_l3``,
which ``test_torch_incremental_graph.py`` shares with the ``from_graph``
tests; the facade's own builds are in ``test_torch_incremental_facade.py``
and the shared inputs in ``_incremental_common.py``.
"""

from __future__ import annotations

import pytest

from _incremental_common import CASES, build_pair, check_bit_equal, coders, sets  # noqa: F401 (fixtures)
from _threads import one_torch_thread  # noqa: F401 (autouse fixture)

SMALL = [c for c in CASES if c[0] != "n1500_l3"]


@pytest.mark.parametrize("name,n,layers,kind,m_f,extra", SMALL, ids=[c[0] for c in SMALL])
def test_incremental_build_is_bit_equal_to_reference(sets, coders, name, n, layers, kind, m_f, extra):
    check_bit_equal(build_pair(sets, coders, (name, n, layers, kind, m_f, extra)))
