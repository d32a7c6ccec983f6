"""One intra-op thread for the port's CPU tests.

The suite runs in several worker processes at once (``pytest -n``).
PyTorch gives each of them as many intra-op threads as the host has
cores, and the port's CPU paths run many small ops (digit planes, smoke
widths): each op's fork and join of its threads then costs more than
the op, and with every worker's threads contending for the cores they
wait on each other.  Each ``tests/test_torch_*.py`` imports
:func:`one_torch_thread`, which runs its module on one thread and
restores the setting after.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
