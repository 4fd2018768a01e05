"""A fixture for the port's test modules whose plain draws run at full
width: torch on one intra-op thread for the module.  A plain threefry draw
is tens of elementwise int64 operations over millions of values, each
ending at a barrier of torch's thread pool; with the suite's processes
oversubscribing the cores those barriers stall for whole time slices (a
vg128 init took minutes in place of seconds), and the threads they spin
on slow every other process.  Import it into a test module to use it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
