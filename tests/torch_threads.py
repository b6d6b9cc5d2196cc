"""One intra-op torch thread for a test module.

The tier-1 run puts six pytest workers on the machine's eight cores. Each
worker's torch would start a thread per core for its CPU ops, so the
workers' threads outnumber the cores several times over and wait on one
another: a module of small ops ran 10-16x slower there than alone. A
module that imports `one_torch_thread` runs its torch ops on one thread
and gives the count back after; its checks hold at any thread count.
Import it as `from torch_threads import one_torch_thread` (pytest puts
this directory on the path), so that modules which also run on the card,
where `tests` may name another package, import it too.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
