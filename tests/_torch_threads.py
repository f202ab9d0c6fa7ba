"""One intra-op thread for the port's CPU tests.

A test run starts several worker processes on one machine's cores. On as
many threads each as the machine has cores, torch's many small CPU ops
spend most of their time waiting on one another: one graph-body test took
over 100 times as long in six workers at once as alone (741 s against
5.5 s; one thread each: 5.5 s). Each port test module imports
:func:`one_torch_thread`, an autouse fixture that runs the module on one
thread and restores the count after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
