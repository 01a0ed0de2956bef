"""``_one_thread``: a module-scoped autouse fixture that runs a test
module's torch on one intra-op thread and restores the count after it.
The fast tier runs six test processes on the host's cores, and torch's
spinning worker threads starve the others; import it into a test module
(``from torch_one_thread import _one_thread  # noqa: F401``)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
