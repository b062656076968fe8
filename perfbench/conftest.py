"""pytest settings of the benchmark's own tests (``python3 -m pytest perfbench/tests``).

``card``: a test that runs on an NVIDIA card; its fixture ``card`` skips it
where there is none (decided when the test runs, never at import).
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the chip")
    return torch.device("cuda:0")
