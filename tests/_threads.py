"""One intra-op thread for the port's CPU builds (not collected by pytest;
test modules import the fixture).

A CPU graph build is thousands of small torch ops. With the default of one
intra-op thread per core in each of the suite's test workers, the threads
oversubscribe the cores and wait on each other: a two-segment flash-ann
build took 7 s alone and 250 s beside six busy processes with eight
threads, 52 s with one. The ops here are too small to gain from more
threads (5.8 s with eight on an idle machine, 7.0 s with one).
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the importing module's tests with one torch intra-op thread,
    restoring the count afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
