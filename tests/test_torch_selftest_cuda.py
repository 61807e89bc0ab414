"""On-card tier of the port's kernel self-test: every check of
multimodalvc_tpu_torch/ops/selftest.py (the JAX selftest's sixteen, K1-K8
through the port's public entries against their oracles) on the GPU.
Needs an NVIDIA GPU with nvcc:

    python -m pytest --noconftest tests/test_torch_selftest_cuda.py -m cuda

``--noconftest`` because tests/conftest.py imports JAX.  Without a card
every test here skips.
"""
import pytest

from multimodalvc_tpu_torch.ops.selftest import CHECKS, run_all


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CHECKS))
def test_kernel_matches_oracle_on_the_card(card, name):
    (result,) = run_all([name], device=card)
    assert result["ok"], result
