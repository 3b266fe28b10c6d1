"""Fixtures of the benchmark's tests.  Whether there is a card is decided
inside the ``cuda`` fixture, never while a module is imported."""

import pytest

from portbench import manifest


@pytest.fixture
def cuda():
    """Skip a test that needs the card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (see portbench/README.md)")
    return torch.device("cuda")


@pytest.fixture(scope="session", autouse=True)
def one_thread():
    """Tiny CPU runs in one thread each, so that workers do not crowd the
    cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="session")
def bench():
    return manifest.manifest()
