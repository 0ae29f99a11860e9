"""A module-scoped autouse fixture for the port's test files whose plain
recurrences (the sLSTM loop, the Mamba2 and mLSTM scans) run as
thousands of small torch ops: each op of such a loop wakes torch's
intra-op thread pool, and beside the suite's other xdist workers that
pool costs more than the op.  Import it into a test module to run the
module's torch ops on one thread (the setting before it comes back after
the module)."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
