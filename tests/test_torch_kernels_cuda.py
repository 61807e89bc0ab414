"""On-card tier of the port: each hand-written CUDA kernel (K1-K9, and the
merged K2 + K3 entry) built by nvcc and held against its plain PyTorch
version at the serving shapes, through the same checks chip_smoke.py runs.  Needs an NVIDIA GPU with nvcc:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

``--noconftest`` because tests/conftest.py imports JAX.  Without a card
every test here skips.
"""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def smoke():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def _all_ok(results):
    bad = [r for r in results if not r["ok"]]
    assert results and not bad, bad


@pytest.mark.cuda
def test_kernels_build(smoke):
    from multimodalvc_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load()
    assert lib.path.exists() and all(hasattr(lib.lib, name) for name in kernel_lib.SIGNATURES)


@pytest.mark.cuda
def test_flash_attention_kernel(smoke):
    results = []
    smoke.check_flash(results)
    _all_ok(results)


@pytest.mark.cuda
def test_flash_attention_speech_shapes(smoke):
    """K1 at the speech path's shapes: the Conformer-L self-attention [8, 8,
    2400, 64] with keys to 1600 frames (rows past kv_len), and the
    cross-attention fusion [8, 8, 400, 128]."""
    results = []
    smoke.check_flash(results, smoke.SPEECH_FLASH_CASES)
    _all_ok(results)


@pytest.mark.cuda
def test_flash_attention_grad(smoke):
    """K1 through its autograd Function at the LLaMA training shape [8, 24,
    T, 128], causal with left-pad key windows: out, dq, dk, dv against the
    plain version under autograd."""
    results = []
    smoke.check_flash_grad(results)
    _all_ok(results)


@pytest.mark.cuda
def test_decode_attention_kernels(smoke):
    """K2 and K3 (int8 KV) at beam 5, and at beams 8 and 17 (24 and 51
    query rows a kv head, in 16-row tiles) at batch 8 and 48, at beam 129
    (generated chunks of one slot) and at beam 337 (a slot's source beams
    in pieces)."""
    results = []
    smoke.check_decode(results)
    _all_ok(results)


@pytest.mark.cuda
def test_ancestry_attention_kernel(smoke):
    """The merged K2 + K3 entry at the decode shapes, at beams 8 and 17 at
    batch 8 and 48, and at beams 129 and 337, against the merge of the plain
    partials; exact zeros where no key is valid; the same bits from two
    launches."""
    results = []
    smoke.check_merged(results)
    _all_ok(results)


@pytest.mark.cuda
def test_beam_topk_columns_kernel(smoke):
    """K4 at [40, 128256] and [240, 128256], with the row statistics inside
    the kernel (the max exact, the logsumexp within LS_TOL, the selection
    bit for bit the plain version's on them) and given, and at beams 8 and
    12 ([64, 128256], [96, 128256]) inside, at beams 17, 32, 64 and the
    ceiling ``topk_max_beams()`` (the wide instance, each also timed on the
    select form) inside, and at the ceiling + 1, 128 and 200 (the select
    form); two launches give the same bits."""
    results = []
    smoke.check_topk(results)
    _all_ok(results)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32", "bf16", "v_odd", "from_logits", "from_logits_v_odd",
                                  "from_logits_stats", "from_logits_v_odd_stats", "wide",
                                  "select"])
def test_beam_topk_kernel(smoke, case):
    """K5: f32 and bf16 log-probs with ties and bans (also at V % 8 != 0),
    and from raw logits at V % 8 == 0 and != 0, with the statistics given
    and inside; the wide instance's log-probs at beams 17, 32 and 64; the
    select form's at beam 128 (f32, bf16, from logits); indices identical
    to the plain version."""
    results = []
    smoke.check_beam_topk(results, only=case)
    _all_ok(results)


@pytest.mark.cuda
def test_topk_plans(smoke):
    """K4 and K5 under every plan of TOPK_PLAN_CASES: each equal to its plain
    version, the first plan topk_plan's."""
    assert smoke.topk_plans()


@pytest.mark.cuda
def test_decode_attention_bf16_kernels(smoke):
    results = []
    smoke.check_decode(results, "bf16")
    _all_ok(results)


@pytest.mark.cuda
def test_gather_rows_kernel(smoke):
    """K6: a decode step's 56 leaves in one launch (the gather cache's and
    the full cache's) and single leaves, exact, timed with a cold L2."""
    results = []
    smoke.check_gather_rows(results)
    _all_ok(results)


@pytest.mark.cuda
def test_adamw_kernel(smoke):
    """K9 at the NoLLM head's 485 trained leaves (shapes from the module on
    the meta device), a leaf under 16 bytes and one not 16-byte aligned: the
    square sums within SQUARE_RTOL of the plain version's (f32 reduction
    order), the finite flag; the update equal to the plain version on the
    card bit for bit given the same norm (the NoLLM step with the clip, no
    clip at a plateau scale, f32 gradients without copies); one launch a
    call; timed against its byte bound."""
    results = []
    smoke.check_adamw(results)
    _all_ok(results)


@pytest.mark.cuda
def test_int8_matmul_kernel(smoke):
    results = []
    smoke.check_int8_matmul(results)
    _all_ok(results)


@pytest.mark.cuda
def test_int4_matmul_kernel(smoke):
    results = []
    smoke.check_int4_matmul(results)
    _all_ok(results)
