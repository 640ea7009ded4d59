"""Torch's CPU threads for the port's tests.

Under pytest-xdist the workers share the machine's cores, and torch's
default of one intra-op thread per core in every worker oversubscribes
them: the many small parallel regions of a tiny training run then wait on
descheduled threads for most of their time (``train_adapt`` of drn_d_14 at
32x24 for 4 iterations took 128 s with eight threads beside five busy
processes on 8 cores, 4.7 s with one). ``torch_threads``, imported into a
test module, gives each worker its share of the cores for that module's
tests and restores torch's setting after; outside xdist it changes
nothing.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
