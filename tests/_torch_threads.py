"""The port's tests run torch on one thread: at test sizes the ops are tiny,
and a thread pool in each test worker only spins beside the others on the
cores they share.  A test file takes the fixture with
``from _torch_threads import _one_thread  # noqa: F401``."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
