"""One intra-op torch thread for a test module, shared by the port's tests.

The port's tests run many small ops, which torch's thread pool slows many
times over when several test processes share the cores: beside other
torch-heavy files on the other workers, such a file has run tens of times
slower than alone. A test module takes the fixture with
``from torch_threads import _one_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
