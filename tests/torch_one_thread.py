"""A module fixture that runs torch on one intra-op thread.

The suite runs on several pytest-xdist workers at once, each of which would
start as many torch threads as the machine has cores; the port's tests call
many small ops, whose threads then wait on one another for the cores.  A
test module that imports `one_thread` runs its tests on one thread, and the
count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
