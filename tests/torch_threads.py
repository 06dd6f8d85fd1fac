"""One PyTorch intra-op thread for the port's CPU tests.

Their tensors are tiny, so intra-op threads buy nothing; and the suite runs
several pytest workers on one machine, where every worker's threads contend
for the same cores and each small op waits for all of them to be scheduled.
Import the fixture into a test module to apply it there.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
