"""A fixture for the test files that hold the port against the JAX package
on the CPU: PyTorch runs on one thread while such a file runs. Their
tensors are small (gpt2-tiny, a few hundred elements an op), so threads
buy nothing, and under ``pytest -n 6`` six workers of eight threads each
oversubscribe the cores while XLA compiles beside them.

Import it into a test module (``from tests.torch_threads import
one_torch_thread  # noqa: F401``); it applies to every test there."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
