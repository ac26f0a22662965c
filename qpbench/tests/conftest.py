"""CPU tests of the benchmark: ``python3 -m pytest qpbench/tests``. Tests
marked ``cuda`` need the card and skip without one."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    """Small torch calls spread over every core wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
