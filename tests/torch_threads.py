"""One torch intra-op thread for the port's CPU tests.

The suite runs in several worker processes that share the machine's
cores; torch's default of one OpenMP thread a core in every worker then
oversubscribes them, and the small tensors of these tests spend their time
in parallel regions waiting for threads (a 10-bit WoP lookup at N=256, on
an 8-core host beside six busy processes: 123 s, and 12 s on one
thread).  A test module
imports the fixture below, autouse and module-scoped, to run on one
thread; the count it found comes back after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
