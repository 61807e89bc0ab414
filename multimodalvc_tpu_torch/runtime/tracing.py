"""Named spans at the port's layer boundaries.

``span(name)`` is a context manager around a layer's work.  With no recorder
installed (the default) it returns one shared ``contextlib.nullcontext``:
no allocation, no clock read, no launch.  ``install(recorder)`` makes every
later ``span(name)`` return ``recorder.span(name)``; a recorder is any
object with that one method.

The names the port opens (each at a function's boundary, never inside a
loop over leaves, blocks or layers):

- ``train.step`` / ``.forward`` / ``.backward`` / ``.optimizer`` (with
  ``.optimizer.update`` and ``.optimizer.copy`` inside it) in
  ``runtime/trainer.py: Trainer.train_step``; the backward's kernels launch
  from autograd's device thread while the caller waits inside
  ``train.backward``;
- ``synth.batch`` and ``synth.vocoder`` (around the calls, one a length) in
  ``models/speech.py: synthesize``;
- ``layer.encoder`` (``AVSREncoder.forward``), ``layer.head``
  (``SpeechHead.forward``), ``layer.generator`` (``HifiGanGenerator.forward``);
- ``k1.fwd`` (the K1 entry ``ops/attention.py: flash_attention`` on the
  card) and ``k1.bwd`` (``FlashAttentionGrad.backward``).

A name ending in ``.wait`` marks a point where the host blocks on the
device: a device-to-host read (``train.finite.wait``, ``train.metrics.wait``,
``synth.lengths.wait``) or a host value copied to the device, which waits
for the device's queue as well (``train.mode.wait``, ``encoder.mode.wait``,
``conformer.scale.wait``, ``synth.rows.wait``).  The host's synchronisations
are counted as these spans.

``ProfilerSpans`` records each span as a ``torch.profiler.record_function``
range: ``cli/train.py: Profiler`` installs it while ``common.profile`` is on,
so the chrome trace it writes holds the spans on its own clock.
"""
from __future__ import annotations

import contextlib
from typing import ContextManager, Optional, Protocol

import torch

WAIT = ".wait"  # the suffix of a span around a host synchronisation


class Recorder(Protocol):
    def span(self, name: str) -> ContextManager: ...


_NULL = contextlib.nullcontext()
_active: Optional[Recorder] = None


def span(name: str) -> ContextManager:
    """The span ``name`` of the installed recorder, or the shared null
    context when there is none."""
    rec = _active
    return _NULL if rec is None else rec.span(name)


def install(recorder: Optional[Recorder]) -> Optional[Recorder]:
    """Make ``recorder`` the active one (None: no recording); returns the one
    it replaces."""
    global _active
    previous, _active = _active, recorder
    return previous


class ProfilerSpans:
    """Spans as ``torch.profiler.record_function`` ranges, in the CPU events
    of whatever profile is running."""

    def span(self, name: str) -> ContextManager:
        return torch.profiler.record_function(name)
