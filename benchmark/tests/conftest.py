"""Fixtures of the benchmark's own tests: a temporary checkout with the
tiny cells (``tiny.py``), made once a session."""

import pytest

from benchmark.tests.tiny import make_root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present (decided here, never
    while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
