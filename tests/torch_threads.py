"""One PyTorch CPU thread per test process, for the port's CPU tests.

The suite runs in several worker processes that share the machine's
cores. Left alone, PyTorch in each of them starts one OpenMP thread per
core for every elementwise op above its parallel grain, and the spinning
threads of six workers on an 8-core host slow the port's plain versions
several times over.

Import the fixture into a test module to use it there:

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
