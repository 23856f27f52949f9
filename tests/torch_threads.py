"""The port's CPU tests run their torch operations on two threads.

The suite runs in six worker processes on one host; with torch's default
of one thread per core in each worker, the workers' threads contend, and
the port's test files took about three times as long (six of them, run
alone in six workers on an 8-core host: 416 s, and 128 s with
OMP_NUM_THREADS=2). Each port
test module imports ``few_torch_threads``, a module-scoped autouse
fixture, which restores the count after the module. The port's results do
not depend on it beyond summation order: its tests compare against the
JAX package at stated tolerances, or between runs in one setting.
"""
import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TORCH_THREADS))
    yield
    torch.set_num_threads(n)
