"""One intra-op thread for a test module of the port.

Import the fixture into a test module to arm it there:

    from _torch_threads import one_intra_op_thread  # noqa: F401

The tier-1 run holds six pytest workers on the host at once.  With
torch's default of one intra-op thread per core in each of them (and in
the ranks they spawn), every OpenMP thread beyond a free core spins at
each parallel region's barrier: on an 8-core host a test that takes
10.5 s alone took 201 s there.  One thread a worker keeps each test near its own cost under that
load; ranks a test spawns take their share of it (``mesh.rank_threads``),
so a run and its twin in one module compute with the same thread count.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
