"""The readers of the port's own spans over small hand-made traces: device
time launched on any thread inside a span, idle time split between nested
spans, wait spans counted, and nothing read from a program without spans."""
import json

import pytest

from perfbench import harness, program_spans, trace
from perfbench.program_spans import READINGS
from perfbench.trace import Trace

SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"
OFFSET = 1000.0  # the host's clock against the trace's


def _op(corr, tid, ts, name, start, dur):
    """A launch on thread ``tid`` at ``ts`` and its device operation."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid, "ts": ts,
             "dur": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "tid": 99, "ts": start, "dur": dur,
             "args": {"correlation": corr}}]


def _trace(tmp_path, spans, kernels):
    """``spans``: (name, opening launch time, closing launch time, thread);
    ``kernels``: (thread, launch time, device start, duration)."""
    events, marks, ranges = [], [], []
    for name, s, e, tid in spans:
        for ts in (s, e):
            events += _op(len(marks), tid, ts, SPIN, ts, 0)
            marks.append(ts - OFFSET)
        ranges.append((name, len(marks) - 2, len(marks) - 1))
    for i, (tid, ts, start, dur) in enumerate(kernels):
        events += _op(1000 + i, tid, ts, f"k{i}(int)", start, dur)
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return Trace(str(p), ranges, marks)


def _train(tmp_path):
    """One step: the backward's kernels launched from a second thread while
    the main thread waits inside ``train.backward``; the optimizer launches,
    waits in ``train.finite.wait`` for the drain, then launches again; the
    metrics' read.  An operation launched on an idle card starts 1 us later."""
    spans = [("step", 0, 100, 1), ("train.backward", 2, 12, 1), ("train.optimizer", 14, 80, 1),
             ("optimizer", 18, 79, 1),  # the benchmark's range around the update
             ("train.optimizer.update", 19, 78, 1), ("train.finite.wait", 20, 58, 1),
             ("train.metrics.wait", 90, 95, 1)]
    kernels = [(2, 3, 4, 20), (2, 5, 24, 20),  # backward: [4, 44] on the card
               (1, 15, 44, 6),  # the norm, queued: [44, 50]
               (1, 62, 63, 2), (1, 70, 71, 1),  # AdamW after the wait
               (1, 92, 93, 1)]  # the metrics' read
    tr = _trace(tmp_path, spans, kernels)
    return {"trace": tr, "window_s": 100e-6, "kind": "train", "steps": 1}


def test_backward_takes_kernels_of_any_thread(tmp_path):
    layer = _train(tmp_path)
    assert program_spans.launched_ms(layer, "train", "train.backward") == pytest.approx(40e-3)
    assert layer["trace"].device_s("train.backward") == 0.0  # its own thread launched none
    assert READINGS["backward_ms.train"](layer) == pytest.approx(40e-3)


def test_optimizer_device_time_leaves_out_the_drain(tmp_path):
    layer = _train(tmp_path)
    assert READINGS["optimizer_device_ms.train"](layer) == pytest.approx(9e-3)


def test_idle_gaps_end_at_the_launch_that_ends_them(tmp_path):
    # card gaps [50, 63], [65, 71], [72, 93] end with launches at 62, 70, 92
    tr = _train(tmp_path)["trace"]
    assert program_spans.idle_gaps_on_host(tr) == [(49.0, 62.0), (64.0, 70.0), (71.0, 92.0)]


def test_idle_split_between_nested_spans(tmp_path):
    layer = _train(tmp_path)
    by_inner = {}
    for us, stack in program_spans.idle_by_stack(layer["trace"]):
        by_inner[stack[-1]] = by_inner.get(stack[-1], 0.0) + us
    # [49, 62]: 9 in the wait, 4 in the update after it; [64, 70] in the
    # update; [71, 92]: 7 in the update, 2 in the optimizer after it, 10 in
    # no program span, 2 in the metrics' wait
    assert by_inner == pytest.approx({"train.finite.wait": 9.0, "train.optimizer.update": 17.0,
                                      "train.optimizer": 2.0, "train.metrics.wait": 2.0})
    assert READINGS["optimizer_idle_ms.train"](layer) == pytest.approx(19e-3)


def test_waits_counted_and_gaps_named_by_program_spans(tmp_path):
    layer = _train(tmp_path)
    assert READINGS["host_syncs.train"](layer) == 2.0
    gaps = layer["trace"].idle_gaps()
    assert gaps == [["train.optimizer.update", pytest.approx(21e-6)],
                    ["train.finite.wait", pytest.approx(13e-6)],
                    ["train.optimizer.update", pytest.approx(6e-6)]]


def test_synthesis_head_and_generator_idle(tmp_path):
    spans = [("step", 0, 100, 1), ("layer.head", 1, 10, 1), ("synth.lengths.wait", 11, 30, 1),
             ("layer.generator", 32, 50, 1), ("layer.generator", 60, 90, 1)]
    kernels = [(1, 2, 3, 20),  # the head: [3, 23]
               (1, 12, 23, 1),  # the lengths' read, queued: [23, 24]
               (1, 33, 34, 10), (1, 40, 44, 2),  # first call: [34, 46]
               (1, 61, 62, 10)]  # second call: [62, 72]
    tr = _trace(tmp_path, spans, kernels)
    layer = {"trace": tr, "window_s": 100e-6, "kind": "synth", "batches": 2}
    assert READINGS["head_ms.synth"](layer) == pytest.approx(10e-3)
    # gaps [24, 34] and [46, 62] on the host's clock: [23, 33] and [45, 61];
    # in the calls 1 + 5 + 1 us, over 2 batches
    assert READINGS["generator_idle_ms.synth"](layer) == pytest.approx(3.5e-3)
    assert READINGS["host_syncs.synth"](layer) == 0.5


@pytest.mark.parametrize("metric", ["optimizer_device_ms.train", "optimizer_idle_ms.train",
                                    "backward_ms.train", "host_syncs.train"])
def test_a_program_without_spans_reads_nothing(tmp_path, metric):
    spans = [("step", 0, 100, 1), ("optimizer", 8, 80, 1)]
    tr = _trace(tmp_path, spans, [(1, 9, 50, 5)])
    layer = {"trace": tr, "window_s": 100e-6, "kind": "train", "steps": 1}
    assert READINGS[metric](layer) is None
    assert READINGS[metric](dict(layer, kind="synth", batches=1)) is None


def test_readings_line(tmp_path):
    got = program_spans.readings(_train(tmp_path))
    assert got["spans"] == pytest.approx({"optimizer_device_ms.train": 9e-3,
                                          "optimizer_idle_ms.train": 19e-3,
                                          "backward_ms.train": 40e-3, "host_syncs.train": 2.0})
    assert list(got["idle_ms"]) == ["train.optimizer.update", "train.finite.wait",
                                    "train.optimizer", "train.metrics.wait"]
    assert got["idle_ms"] == pytest.approx({"train.optimizer.update": 17e-3,
                                            "train.finite.wait": 9e-3,
                                            "train.optimizer": 2e-3,
                                            "train.metrics.wait": 2e-3})


def test_recording_installs_each_ranges_until_it_closes(monkeypatch):
    from types import SimpleNamespace

    from multimodalvc_tpu_torch.runtime import tracing

    runner = SimpleNamespace(run=lambda ctx: ("outcome", ctx))
    monkeypatch.setattr(harness, "runner_of", lambda mix: runner)
    make, runner_of = trace.Ranges.__init__, harness.runner_of
    with program_spans.recording({}) as got:
        ranges = trace.Ranges()
        assert tracing.install(ranges) is ranges  # it was the recorder
        ranges.close()
        assert tracing.install(None) is None
        assert harness.runner_of({"runner": "train"}).run("ctx") == ("outcome", "ctx")
        assert got["out"] == ("outcome", "ctx")
    assert trace.Ranges.__init__ is make and harness.runner_of is runner_of
    assert tracing.span("x") is tracing.span("y")  # nothing installed
