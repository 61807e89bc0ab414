"""The synthesis runner: batch synthesis of a corpus through the port.

The configuration's ``system`` picks the path: "e2e" drives
``SpeechE2ESystem.__call__`` (the NoLLM trunk and the HiFi-GAN generator on
the Conformer's features, one call a batch); "nollm" drives
``models/speech.py: synthesize`` (the NoLLM mel, each row cut to its
frames, then ``VocoderModel.generate`` once a distinct length).  Set-up
loads the seeded weights, makes the pool's batches on the device and runs
one pass over the pool (every shape the window uses, the vocoder's lengths
included).  The window repeats passes in the same order.

A clip's latency is the time from its batch's start on the device to the
end of the call that completes its waveform (CUDA events, read after the
window).  At most two batches are in flight, as a pipeline that writes out
each batch's results would hold them.

The check (after the window, the program freed): a sample of the pool's
clips drawn from the seed, the longest among them, as the window first
produced them, against the plain reference (f32, TF32 off) on the same rows
of the same batches: each clip's valid waveform samples and, for "nollm",
its valid mel frames, by relative L2; the worst clip is compared.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import weights
from perfbench import workload as wl
from perfbench.harness import Outcome, traced, window
from perfbench.reference import model as ref
from perfbench.runners.common import (
    DTYPES,
    card,
    exact_f32,
    percentile,
    port_hifigan_config,
    port_speech_config,
    reference_module,
    rel_l2,
    seeded_state,
    sync,
)

REF_ROWS = 4  # rows the reference runs at once


def sample_clips(mix: Dict, seed: int) -> List[int]:
    """``compare_clips`` clip ids drawn from the seed, the pool's longest
    clip among them."""
    frames = wl.clip_frames(mix)
    longest = int(np.argmax(frames))
    rest = [i for i in range(len(frames)) if i != longest]
    rng = np.random.default_rng(wl.sub_seed(seed, "sample"))
    pick = rng.choice(len(rest), mix["compare_clips"] - 1, replace=False)
    return sorted([longest] + [rest[int(i)] for i in pick])


class Program:
    """The port's system (and vocoder) with the run's weights, the pool's
    batches, and what the window's calls produced."""

    def __init__(self, ctx, seed: int, fault: Optional[str] = None):
        from multimodalvc_tpu_torch.models import speech

        c, dev = ctx.config, ctx.device
        self.ctx, self.seed, self.model, self.kind = ctx, seed, c["model"], c["system"]
        cfg, dtype = port_speech_config(self.model), DTYPES[c["dtype"]]
        if self.model["mel_bins"] != speech.MEL_BINS or self.model["hop"] != speech.HOP:
            raise ValueError("the port's mel bins or hop differ from the configuration file's")
        voc = port_hifigan_config(self.model, self.model["mel_bins"])
        if self.kind == "e2e":
            self.system = speech.SpeechE2ESystem(cfg, voc, dtype=dtype, device=dev)
            weights.load_into(self.system.module, seeded_state(self.model, "e2e", seed, dev, dtype))
            self.generator = self.system.module.generator
            self.vocoder = None
        else:
            from multimodalvc_tpu_torch.models.vocoder import VocoderConfig, VocoderModel

            self.system = speech.SpeechNoLLMSystem(cfg, dtype=dtype, device=dev)
            weights.load_into(self.system.module,
                              seeded_state(self.model, "nollm", seed, dev, dtype))
            vdt = DTYPES[c["vocoder_dtype"]]
            self.vocoder = VocoderModel(VocoderConfig(generator=voc), dtype=vdt, device=dev)
            state = seeded_state(self.model, "vocoder", seed, dev, vdt)
            weights.load_into(self.vocoder.generator,
                              {k[len("generator."):]: v for k, v in state.items()})
            self.generator = self.vocoder.generator
            self._wrap_vocoder()
        self.fault = fault
        self.encoder = self.system.module.encoder if self.kind != "e2e" \
            else self.system.module.trunk.encoder
        mix = ctx.mix
        self.batches_ids = wl.pool_batches(mix, seed)
        self.batches = [wl.make_batch(ids, mix, self.model, seed, dev, targets=False)
                        for ids in self.batches_ids]
        self.mel_len = [f * round(mix["frame_ms"] * mix["sample_rate"] / 1000) // self.model["hop"]
                        for f in wl.clip_frames(mix)]
        self.wanted = set(sample_clips(mix, seed))
        self.got: Dict[int, Dict[str, torch.Tensor]] = {}
        self.records: List = []  # (clip ids, start event, [end event a row])
        self._calls: List = []

    def _wrap_vocoder(self) -> None:
        """``vocoder.generate`` records an event after each call and hands the
        call's mel and waveform to the batch in progress."""
        inner = self.vocoder.generate

        def generate(mel):
            wav = inner(mel)
            end = torch.cuda.Event(enable_timing=True) if mel.is_cuda else None
            if end is not None:
                end.record()
            self._calls.append((mel.shape[1], mel, wav, end))
            return wav

        self.vocoder.generate = generate

    def batch(self, b: int) -> None:
        """Synthesise pool batch ``b``; keep the sampled clips' outputs and the
        events that time every clip."""
        from multimodalvc_tpu_torch.models.speech import synthesize

        ids, batch = self.batches_ids[b], self.batches[b]
        cuda = self.ctx.device != "cpu"
        start = torch.cuda.Event(enable_timing=True) if cuda else None
        if cuda:
            start.record()
        if self.kind == "e2e":
            wav = self.system(batch)["waveform"][..., 0]
            if self.fault == "altered":
                wav = wav.clone()
                wav[0, :16] += 0.5
            end = torch.cuda.Event(enable_timing=True) if cuda else None
            if cuda:
                end.record()
            ends = [end] * len(ids)
            for row, i in enumerate(ids):
                if i in self.wanted and i not in self.got:
                    self.got[i] = {"wav": wav[row, : self.mel_len[i] * self.model["hop"]]}
        else:
            self._calls = []
            wavs = synthesize(self.system, self.vocoder, batch)
            if self.fault == "altered":
                wavs[0] = wavs[0].clone()
                wavs[0][:16] += 0.5
            ends = [None] * len(ids)
            lens = [self.mel_len[i] for i in ids]
            for n, mel, _, end in self._calls:
                rows = [r for r, m in enumerate(lens) if m == n]
                for j, r in enumerate(rows):
                    ends[r] = end
                    i = ids[r]
                    if i in self.wanted and i not in self.got:
                        self.got[i] = {"mel": mel[j], "wav": wavs[r]}
            self._calls = []
        self.records.append((ids, start, ends))
        if cuda and len(self.records) >= 2:  # at most two batches in flight
            for end in set(self.records[-2][2]):
                end.synchronize()

    def latencies_ms(self) -> List[float]:
        return [start.elapsed_time(end) for _, start, ends in self.records for end in ends]


def reference_outputs(ctx, seed: int, prog_batches: List[Dict], prog_ids: List[List[int]],
                      clips: List[int], precision: Optional[str] = None) -> Dict[int, Dict]:
    """The reference's valid waveform (and mel) of each clip of ``clips``,
    run on its rows of the batch that first held it."""
    c, dev = ctx.config, ctx.device
    model, dtype = c["model"], DTYPES[c["dtype"]]
    kind = c["system"]
    module = reference_module(model, "e2e" if kind == "e2e" else "nollm", seed, dev, dtype)
    ref.set_precision(module, precision)
    voc = None
    if kind != "e2e":
        voc = reference_module(model, "vocoder", seed, dev, DTYPES[c["vocoder_dtype"]])
        ref.set_precision(voc, precision)
    where = {}
    for b, ids in enumerate(prog_ids):
        for r, i in enumerate(ids):
            if i in clips and i not in where:
                where[i] = (b, r)
    out: Dict[int, Dict] = {}
    by_batch: Dict[int, List] = {}
    for i, (b, r) in where.items():
        by_batch.setdefault(b, []).append((r, i))
    with torch.no_grad(), exact_f32():
        for b, rows in sorted(by_batch.items()):
            rows.sort()
            for s in range(0, len(rows), REF_ROWS):
                part = rows[s:s + REF_ROWS]
                idx = torch.tensor([r for r, _ in part], device=dev)
                sub = {k: v.index_select(0, idx) for k, v in prog_batches[b].items()}
                if kind == "e2e":
                    wav, lens = module(sub)
                    for j, (_, i) in enumerate(part):
                        out[i] = {"wav": wav[j, : int(lens[j]) * model["hop"]].float()}
                else:
                    mel, lens = module(sub)
                    for j, (_, i) in enumerate(part):
                        n = int(lens[j])
                        out[i] = {"mel": mel[j, :n].float(),
                                  "wav": voc(mel[j:j + 1, :n])[0].float()}
    del module, voc
    return out


def compare(got: Dict[int, Dict], want: Dict[int, Dict]) -> Dict[str, float]:
    """The worst clip's relative L2 of each output kind ("mel_gap",
    "wav_gap"); a sampled clip the window never produced reads inf."""
    out: Dict[str, float] = {}
    for i, w in want.items():
        g = got.get(i)
        for key, target in w.items():
            gap = math.inf if g is None or g[key].shape != target.shape \
                else rel_l2(g[key].float(), target)
            out[f"{key}_gap"] = max(out.get(f"{key}_gap", 0.0), gap)
    return out


def flops(model: Dict, mix: Dict, ids: List[int], kind: str) -> float:
    from perfbench.yardstick import step_flops

    frames = wl.clip_frames(mix)
    return step_flops(model, [frames[i] for i in ids], "e2e" if kind == "e2e" else "nollm+vocoder",
                      train=False)


def run(ctx) -> Outcome:
    dev, mix = ctx.device, ctx.mix
    prog = Program(ctx, ctx.seed, ctx.fault)
    nb = len(prog.batches)
    with torch.inference_mode():
        for b in range(nb):  # set-up: every shape of the window
            prog.batch(b)
        sync(dev)()
    prog.records, prog.got = [], {}

    def step(i: int) -> None:
        with torch.inference_mode():
            prog.batch(len(prog.records) % nb)

    layer, values, device = None, {}, card(dev)
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx.t0
    if ctx.trace:
        from perfbench.trace import Ranges

        ranges = Ranges()
        ranges.attention()
        ranges.method(prog.encoder, "forward", "encoder")
        ranges.method(prog.generator, "forward", "generator")
        steps = mix["trace_steps"]
        tr, wall = traced(step, steps, sync(dev), ctx.root / "build" / "perfbench" /
                          f"trace_{ctx.cell['name']}.json", ranges)
        ctx.log(f"perfbench: trace {tr.summary()}")
        active = [ids for ids, _, _ in prog.records[-steps:]]
        layer = {"trace": tr, "window_s": wall, "kind": "synth", "batches": steps,
                 "attention": ranges.attention_calls(), "model": prog.model,
                 "flops": sum(flops(prog.model, mix, ids, prog.kind) for ids in active)}
        ranges.close()
        layer["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        device.update(busy_s=tr.busy_s(), window_s=wall)
        attempted = sum(len(ids) for ids in active)
    else:
        _, wall = window(step, ctx.seconds, sync(dev), whole=nb)
        audio = sum(wl.audio_seconds(ids, mix) for ids, _, _ in prog.records)
        values = {"setup_s": setup_s, "synth_audio_s_per_s": audio / wall}
        if dev != "cpu":
            values["synth_clip_p90_ms"] = percentile(prog.latencies_ms(), 0.9)
        attempted = sum(len(ids) for ids, _, _ in prog.records)
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    values["peak_gib"] = peak / 2 ** 30
    ctx.log(f"perfbench: setup_s {setup_s!r}, window {wall!r} s, {attempted} clips, values "
            f"{values}, device {device}")
    got, batches, ids = prog.got, prog.batches, prog.batches_ids
    clips = sorted(prog.wanted)
    del prog
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    want = reference_outputs(ctx, ctx.seed, batches, ids, clips)
    compared = compare(got, want)
    failed = sum(1 for k, v in compared.items() if not v <= ctx.limits.get(k, math.inf))
    return Outcome(values=values, layer=layer, compared=compared, attempted=attempted,
                   failed=failed, peak_bytes=peak, device=device)
