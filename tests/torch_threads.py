"""The port's test modules run torch on one thread.

Each ``tests/test_torch_*.py`` imports ``one_thread``: a module-scoped
autouse fixture that sets ``torch.set_num_threads(1)`` while the module's
tests run and restores the count afterwards. The test runner starts several
worker processes, and torch on every core in each of them oversubscribes
the host many times over; on one thread a module's sums also run in one
order on any host.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
