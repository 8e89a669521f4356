"""A fixture shared by the port's CPU tests (`tests/test_torch_*.py`).

A test module imports `one_torch_thread` to run each of its tests with one
intra-op torch thread.  The tests' shapes are tiny and the test files run
in parallel processes: a full thread pool in every process oversubscribes
the cores, and each small op then waits on its pool far longer than it
computes (about twice the wall time of these files with 6 processes on 8
cores).
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
