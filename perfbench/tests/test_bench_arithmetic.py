"""The yardstick's arithmetic against hand counts at tiny shapes: bounds,
attention's work, model FLOPs, the tail, and the readers over a small
hand-made trace."""
import json

import pytest

from perfbench import readers, yardstick
from perfbench.runners.common import norm_gap, percentile
from perfbench.trace import Trace


def test_bound_takes_the_larger():
    assert yardstick.bound(3.35e12) == pytest.approx(1.0)
    assert yardstick.bound(0.0, 989e12) == pytest.approx(1.0)
    assert yardstick.bound(3.35e9, 989e9) == pytest.approx(1e-3)


def test_flash_forward_by_hand():
    # b 2, h 3, t 4, d 8; row 0 sees 4 keys, row 1 sees 2
    got = yardstick.flash_fwd(2, 3, 4, 8, [4, 2])
    pairs = 4 * 4 + 4 * 2
    assert got["ops"] == 4 * 3 * 8 * pairs
    # q 8 rows + K, V 6 rows each + out 8 rows, 2 bytes, 3 heads of 8; lengths 4 bytes a row
    assert got["bytes"] == 2 * 3 * 8 * (8 + 2 * 6 + 8) + 8
    assert got["bound_s"] == yardstick.bound(got["bytes"], got["ops"])


def test_flash_backward_by_hand():
    got = yardstick.flash_bwd(1, 2, 4, 8, [3])
    pairs = 4 * 3
    assert got["ops"] == 10 * 2 * 8 * pairs == 2.5 * yardstick.flash_fwd(1, 2, 4, 8, [3])["ops"]
    reads = 2 * 2 * 8 * (4 + 3 + 3 + 4 + 4) + 4 * 2 * 4  # q k v o dO, f32 row statistics
    writes = 2 * 2 * 8 * (4 + 3 + 3)  # dq dk dv
    assert got["bytes"] == reads + writes + 4


def test_linear_and_attention_flops():
    assert yardstick._linear(3, 4, 5) == 2 * 3 * 4 * 5
    assert yardstick._tlayer(1, 2, 4, 8) == 4 * 2 * 2 * 4 * 4 + 4 * 2 * 2 * 4 + 2 * 2 * 2 * 4 * 8


def test_generator_flops_by_hand():
    voc = {"upsample_initial_channel": 4, "upsample_factors": [2], "upsample_kernel_sizes": [4],
           "resblock_kernel_sizes": [3], "resblock_dilations": [[1]]}
    # conv_pre 1 frame x 3 in x 4 out x 7 taps; up 8 -> 2 channels (k 4) on 1 frame;
    # one block of two convs 2 -> 2 (k 3) on 2 samples; conv_post 2 -> 1 (k 7) on 2
    want = 2 * 1 * 3 * 4 * 7 + 2 * 1 * 4 * 2 * 4 + 2 * 2 * 2 * 2 * 2 * 3 + 2 * 2 * 2 * 7
    assert yardstick.generator_flops(voc, 3, [1]) == want


def test_training_counts_trainable_parts_thrice(tmp_path):
    from perfbench.tests.tiny import config

    m = config()["model"]
    frames = [10, 20]
    fwd = yardstick.step_flops(m, frames, "nollm", train=False)
    trn = yardstick.step_flops(m, frames, "nollm", train=True)
    frozen = yardstick.whisper_flops(m, 2) + yardstick.avhubert_flops(m, frames) \
        + yardstick.sr_flops(m, frames)
    assert trn - frozen == pytest.approx(3 * (fwd - frozen))


def test_tail_is_over_every_clip():
    # two batches: the p90 over all 20 clips, not a mean of two batches' p90s
    a, b = [10.0] * 10, [float(x) for x in range(100, 110)]
    got = percentile(a + b, 0.9)
    assert got == pytest.approx(107.1)
    assert got != pytest.approx((percentile(a, 0.9) + percentile(b, 0.9)) / 2)


def test_norm_gap_uses_the_median_leaf_for_small_leaves():
    got = norm_gap([1.0, 2.2, 1e-9 + 0.001], [1.0, 2.0, 1e-9])
    assert got == pytest.approx(0.2 / 2.0)
    assert norm_gap([1.0, 5.0], [1.0, 2.0], keep=[True, False]) == 0.0


def _launch(corr, ts, name, start, dur):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1, "ts": ts,
             "dur": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "tid": 9, "ts": start, "dur": dur,
             "args": {"correlation": corr}}]


def _trace(tmp_path):
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    ev = (_launch(100, 5, spin, 5, 0) + _launch(101, 9, spin, 9, 0)  # step and attn_fwd open
          + _launch(7, 11, "k1(int)", 20, 40) + _launch(102, 14, spin, 60, 0)  # attn_fwd closes
          + _launch(8, 30, "other(int)", 70, 10) + _launch(103, 95, spin, 95, 0))  # step closes
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    marks = [4.0, 8.0, 13.0, 94.0]
    return Trace(str(p), [("attn_fwd", 1, 2), ("step", 0, 3)], marks)


def test_trace_readers_by_hand(tmp_path):
    tr = _trace(tmp_path)
    assert tr.busy_s() == pytest.approx(50e-6)
    assert tr.device_s("attn_fwd") == pytest.approx(40e-6)
    layer = {"trace": tr, "window_s": 100e-6, "kind": "train", "steps": 1,
             "attention": [("fwd", (1, 1, 4, 8), [4])], "flops": 989e12 * 100e-6 * 0.25}
    assert readers.idle_share(layer, "train") == pytest.approx(50.0)
    assert readers.mfu(layer, "train") == pytest.approx(25.0)
    share = readers.attention_share(layer, "train", "fwd")
    assert share == pytest.approx(100 * yardstick.flash_fwd(1, 1, 4, 8, [4])["bound_s"] / 40e-6)
    assert readers.attention_share(layer, "train", "bwd") is None  # nothing to read: no 0
    assert readers.mfu(layer, "synth") is None
    gaps = tr.idle_gaps()
    assert gaps == [["step", pytest.approx(10e-6)]]  # the markers are not the program's
    assert tr.attributed("step") == 1.0
    assert tr.top_ops()[0] == ["k1(int)", pytest.approx(40e-6)]


@pytest.mark.parametrize("lost, want", [(None, [0, 1, 2, 3]), (0, [1, 2, 3]), (3, [0, 1, 2])])
def test_markers_align_when_the_trace_lacks_one_at_an_edge(lost, want):
    from perfbench.trace import _aligned

    marks = [10.0, 12.0, 30.0, 31.0]
    found = [(m + 1000.0 + 0.1 * i, 1) for i, m in enumerate(marks)]
    if lost is not None:
        del found[lost]
    assert _aligned([0, 1, 2, 3], marks, found) == want
