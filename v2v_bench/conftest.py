"""pytest settings of the benchmark's own tests (v2v_bench/tests): the
`card` marker, for tests that need an NVIDIA card, and the fixture that
skips them where there is none. Run them with
`python -m pytest v2v_bench/tests -q` from the checkout's root."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The card's torch.device; skips the test where CUDA is missing."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's own size runs there")
    return torch.device("cuda", 0)
