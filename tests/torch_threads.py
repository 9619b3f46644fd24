"""The one-thread pin of the port's test modules.

`from torch_threads import one_thread` in a test module runs that module
with one torch thread and gives the caller's count back after it. Under
the suite's xdist workers each worker otherwise takes every core for its
own intra-op threads, and the workers' threads oversubscribe the host."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
