"""The port's span API (``runtime/tracing.py``) and the spans a training step
and a synthesis open: the null path when nothing is installed, the spans'
nesting in one tiny NoLLM step, one wait and one generator span a length in
``synthesize``, the profiler recorder and ``cli/train.py: Profiler`` (~10 s).

The ``cuda`` test holds the wait spans against the synchronisations that
``torch.cuda.set_sync_debug_mode("warn")`` reports; on the GPU machine:

    python -m pytest --noconftest tests/test_torch_tracing.py -m cuda
"""
import contextlib
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from multimodalvc_tpu_torch.runtime import tracing

torch.set_num_threads(1)  # tier-1 runs several xdist workers on the same cores


class Tree:
    """A recorder that keeps the spans as a tree of (name, children)."""

    def __init__(self):
        self.root = []
        self._open = [self.root]

    @contextlib.contextmanager
    def span(self, name):
        node = (name, [])
        self._open[-1].append(node)
        self._open.append(node[1])
        try:
            yield
        finally:
            self._open.pop()

    def names(self):
        out, todo = [], list(self.root)
        while todo:
            name, kids = todo.pop(0)
            out.append(name)
            todo = kids + todo
        return out


@contextlib.contextmanager
def recording(recorder):
    previous = tracing.install(recorder)
    try:
        yield recorder
    finally:
        tracing.install(previous)


def _batch(device, rows=2):
    """Rows of the tiny NoLLM speech head (80 mel frames), both streams; row
    r of ``rows`` has 80 - 15 r valid frames."""
    from multimodalvc_tpu_torch.models.speech import SpeechConfig

    cfg = SpeechConfig.tiny()
    rng = np.random.default_rng(5)
    t_v = cfg.max_video_frames
    frames = [80 - 15 * r for r in range(rows)]
    b = {
        "audio_feats": rng.standard_normal((rows, cfg.whisper.n_mels, 2 * cfg.whisper.max_frames)),
        "video": rng.standard_normal((rows, t_v, 24, 24, 1)),
        "video_lengths": np.asarray([t_v - 3 * r for r in range(rows)], np.int32),
        "audio_lengths": np.asarray([f * 160 for f in frames], np.int32),
        "target_mel": rng.standard_normal((rows, cfg.max_mel_frames, 128)),
        "target_mel_lengths": np.asarray(frames, np.int32),
    }
    return {k: torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v).to(device)
            for k, v in b.items()}


def _trainer(device):
    from multimodalvc_tpu_torch.config.configs import OptimizationConfig
    from multimodalvc_tpu_torch.models.speech import SpeechConfig
    from multimodalvc_tpu_torch.runtime.trainer import Trainer
    from multimodalvc_tpu_torch.tasks import SpeechTask, SpeechTaskConfig

    task = SpeechTask(SpeechTaskConfig(variant="nollm", max_mel_frames=80), SpeechConfig.tiny(),
                      device=device)
    task.init_random(0)
    trainer = Trainer(task.make_loss_fn(), task.module,
                      OptimizationConfig(lr=1e-3, warmup_updates=2, max_update=10),
                      task.frozen_patterns(), seed=0)
    return task, trainer


def _synthesis(device):
    from multimodalvc_tpu_torch.models.speech import SpeechConfig, SpeechNoLLMSystem
    from multimodalvc_tpu_torch.models.vocoder import VocoderConfig, VocoderModel
    from multimodalvc_tpu_torch.nn.hifigan import HifiGanConfig

    system = SpeechNoLLMSystem(SpeechConfig.tiny(), device=device)
    system.init_random(0)
    vocoder = VocoderModel(VocoderConfig(generator=HifiGanConfig(upsample_initial_channel=16)),
                           device=device)
    vocoder.init_random(0)
    batch = {k: v for k, v in _batch(device, rows=3).items() if not k.startswith("target")}
    return system, vocoder, batch


def test_nothing_installed_is_one_shared_null_context():
    assert tracing.install(None) is None
    first = tracing.span("train.forward")
    assert tracing.span("layer.head") is first
    assert isinstance(first, contextlib.nullcontext)


def test_install_returns_the_previous_recorder():
    a, b = Tree(), Tree()
    assert tracing.install(a) is None
    assert tracing.install(b) is a
    with tracing.span("x"):
        pass
    assert tracing.install(None) is b
    assert b.names() == ["x"] and a.names() == []
    assert tracing.span("y") is tracing.span("z")  # the null path again


def test_train_step_spans_nest():
    from multimodalvc_tpu_torch.models.speech import synthesize

    task, trainer = _trainer("cpu")
    batch = task.prepare_batch(_batch("cpu"))
    with recording(Tree()) as tree:
        trainer.train_step(batch)
    assert tree.root == [("train.step", [
        ("train.forward", [("layer.encoder", []),
                           ("layer.head", [("conformer.scale.wait", [])])]),
        ("train.backward", []),
        # the update writes the module's copies itself: no leaf is fsdp-split,
        # so train.optimizer.copy (the gather of fsdp shares) does not run
        ("train.optimizer", [("train.optimizer.update", [("train.finite.wait", [])])]),
        ("train.metrics.wait", []),
    ])]
    # uninstalled, the same step and a synthesis reach it no more
    trainer.train_step(batch)
    synthesize(*_synthesis("cpu"))
    assert len(tree.root) == 1


def test_synthesize_waits_once_and_calls_the_generator_a_length():
    from multimodalvc_tpu_torch.models.speech import synthesize

    system, vocoder, batch = _synthesis("cpu")
    with recording(Tree()) as tree:
        wavs = synthesize(system, vocoder, batch)
    assert [w.shape[0] for w in wavs] == [80 * 160, 65 * 160, 50 * 160]
    names = tree.names()
    assert names.count("synth.lengths.wait") == 1
    assert names.count("layer.generator") == 3
    ((batch_span, parts),) = tree.root
    assert batch_span == "synth.batch"
    assert [n for n, _ in parts] == ["layer.encoder", "layer.head", "synth.lengths.wait",
                                     "synth.vocoder"]
    assert parts[-1][1] == [("synth.rows.wait", []), ("layer.generator", [])] * 3


def test_profiler_spans_are_profile_events():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording(tracing.ProfilerSpans()):
            with tracing.span("train.forward"):
                torch.ones(4).sum()
            with tracing.span("synth.lengths.wait"):
                torch.ones(4).tolist()
    names = {e.name for e in prof.events()}
    assert {"train.forward", "synth.lengths.wait"} <= names


def test_cli_profiler_installs_the_spans_while_it_records(tmp_path):
    from multimodalvc_tpu_torch.cli.train import Profiler
    from multimodalvc_tpu_torch.config import TrainRootConfig

    cfg = TrainRootConfig()
    cfg = dataclasses.replace(cfg, common=dataclasses.replace(
        cfg.common, profile=True, profile_dir=str(tmp_path)))
    with Profiler(cfg):
        assert isinstance(tracing.span("a"), torch.profiler.record_function)
        with tracing.span("train.step"):
            torch.ones(4).sum()
    assert tracing.span("a") is tracing.span("b")
    (path,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "train.step" in names


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return "cuda"


def _syncs_and_waits(run):
    """The synchronisations sync debug mode reports while ``run()`` runs,
    and the wait spans recorded meanwhile."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught, recording(Tree()) as tree:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    return syncs, sum(n.endswith(tracing.WAIT) for n in tree.names())


@pytest.mark.cuda
def test_each_host_sync_is_a_wait_span(card):
    from multimodalvc_tpu_torch.models.speech import synthesize

    task, trainer = _trainer(card)
    raw = _batch(card)
    trainer.train_step(task.prepare_batch(raw))  # first use of every shape
    syncs, waits = _syncs_and_waits(lambda: trainer.train_step(task.prepare_batch(raw)))
    assert waits >= 2 and syncs == waits
    system, vocoder, batch = _synthesis(card)
    synthesize(system, vocoder, batch)
    syncs, waits = _syncs_and_waits(lambda: synthesize(system, vocoder, batch))
    assert waits >= 1 and syncs == waits
