import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Few intra-op threads: the cells are tiny and workers share cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card)")
    return torch.device("cuda", 0)
