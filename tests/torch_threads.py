"""torch on one thread for the port's CPU tests.

The port's tests run tiny shapes, where torch's intra-op thread pool (a
thread a core by default) adds nothing but overhead; and under pytest-xdist
every worker process starts such a pool, so six workers on eight cores
oversubscribe the cores several times over.  Each ``tests/test_torch_*.py``
module imports :func:`one_torch_thread` (autouse, module scope): its tests
run torch on one thread, and the module's teardown gives the count back.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
