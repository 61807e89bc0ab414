#!/usr/bin/env python3
"""Smoke run of the PyTorch port (multimodalvc_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Prints the card (``nvidia-smi`` name and power limit) and builds the CUDA
   kernels from ``multimodalvc_tpu_torch/csrc`` with nvcc.
2. Holds each kernel (K1 flash_attention, also with its gradient, K2
   prompt_attention and K3
   gen_attention_ancestor with int8 and bf16 KV, their merged entry
   ancestry_attention, K4 beam_topk_columns, K5 beam_topk /
   beam_topk_from_logits, K6 gather_rows, K7 int8_matmul, K8 int4_matmul)
   against its plain PyTorch version at the serving shapes, with
   edge cases, and times both, the one PyTorch call that computes the same
   function where there is one, and the card's bound for the work (K7 and
   K8 with a cold L2, as the decode finds their weights).  Then the
   ``selftest`` phase: the package's kernel self-test
   (``multimodalvc_tpu_torch.ops.selftest.run_all``), the JAX selftest's
   sixteen checks at its shapes against its oracles, one line and one wall
   a record; a red record fails the run.  The smoke's own cases at the
   selftest's shapes stay: they hold more than its tolerances do.
3. Serves batches through the full-width AVSR path (Whisper-medium,
   AV-HuBERT-Large, Q-Former, LLaMA-3.2-3B with random weights from seed 0):
   batch 8, 16 s, beam 5 (8 and 17 where named), in fourteen phases:
   - bf16 weights, int8 KV with the ancestry decode (16 new tokens), with the
     encoders and one prefill + decode step held against the plain versions;
   - bf16 weights, bf16 KV through ``generate()``'s defaults (the ancestry
     decode on the GPU), and bf16 KV with the gather reorder (16 tokens
     each), with two decode steps from one prefill through both caches;
   - bf16 weights, int8 KV, the ancestry decode at beam 8 (two 16-row tiles
     of the decode attention a kv head), its tokens held against the same
     run with K4 plain and one decode step against the plain versions; then
     the ancestry decode at beam 17 with int8 KV and at beams 8 and 17 with
     bf16 KV, each with its launches and output checked;
   - bf16 weights: unordered constraints (16 tokens); the full per-beam
     cache (``generate_beam(share_prompt_kv=False)``); a 32 s clip through
     ``generate_long_form`` (two windows, int8 KV); a two-member ensemble
     (seeds 0 and 1, int8 KV);
   - int8 weights (the serving configuration: int8 KV, ancestry), 64 new
     tokens, with the stage walls and the realtime factor, then n-gram
     blocking (16 tokens), held against the same run with K5 plain;
   - int4 weights, 16 new tokens.
   Each phase checks its output and the launches of every kernel (which
   must run, how often, which must not); the quantized phases hold one
   prefill + decode step against the plain versions.
4. Trains the same full-width model (``AVSRTask`` -> ``Trainer``, the
   conf/mms-llama.yaml optimizer with a short warmup) for six steps on one
   batch of 8 x 16 s clips with 64 label tokens, in two phases:
   ``train_avsr`` (the trunk attention plain at this prompt length) and
   ``train_avsr_flash`` (``use_flash_prefill=True``: K1 with its
   gradient), each with its loss, frozen and trainable leaves, K1
   launches, a checkpoint round trip, the step wall, tokens/s and peak
   memory; the flash phase also holds its step-1 gradients against K1's
   plain version (``check_flash_grad`` holds K1's gradient alone).
5. Synthesizes speech with ``SpeechConfig()`` at full width (the same
   encoders, the Q-Former, proj1 3072->768, proj2 768->512, Conformer-L
   12x512 with 8 heads, the 128-band mel head; HiFi-GAN), modality dropout
   on, random weights from seed 0, the same batch with 16 s of audio a clip,
   bf16, in five phases, each with its wall, realtime factor (128 audio s /
   wall) and peak GiB:
   - ``speech_nollm``: the mel [8, 2400, 128] in modality modes 0, 1 and 2,
     K1 60 times a forward (24 Whisper, 24 AV-HuBERT, 12 Conformer layers);
     mode 0 against K1 plain at the noise floor of the features; modes 1
     and 2 move the mel;
   - ``vocoder``: ``VocoderModel.generate`` in f32 on that mel's valid
     frames, timed with cuDNN's default TF32 convs and with TF32 off, a 1 s
     slice of one row (TF32 off) against the same module on the CPU;
   - ``speech_llm``: LLaMA-3.2-3B hidden states (no unembed) into the mel
     head, K1 60 times (the trunk's 130 slots stay plain), against K1
     plain;
   - ``speech_e2e``: the waveform [8, 384000, 1], K1 60 times, |w| <= 1 and
     tanh(conv_post's bias) past each row's frames, against K1 plain;
   - ``fusion_modes``: the AVSR encoder with the "add" and "cross-att"
     fusions and no speech-rate predictor, K1 48 and 50 times, against K1
     plain.
   ``check_flash`` holds K1 at the Conformer-L and cross-attention shapes
   too (``SPEECH_FLASH_CASES``).
6. Trains the speech heads and the vocoder at full width (random weights
   from seed 0, dropout on, TF32 off), each phase with its step wall,
   audio seconds trained a second, peak GiB and K1 launches a step:
   - ``train_speech_nollm`` / ``train_speech_llm``: ``SpeechTask`` ->
     ``Trainer`` (conf/mms-speech-nollm.yaml's optimizer, warmup cut to 2),
     6 steps at batch 8 x 16 s (bf16) with target mels; the step-1
     gradients against K1 plain at the run's noise floor, the frozen
     leaves bit for bit, the Conformer's running statistics moved, K1 60
     a step (12 through ``FlashAttentionGrad``), the mel L1 falling, and
     one step timed by stage (``step_split``);
   - ``train_e2e_gan``: ``E2EGanTask`` at batch 4 (the trunk bf16; the
     generator, the discriminators and the STFT f32), 3 steps of stage 1
     (the trunk frozen bit for bit, K1 without a gradient) and 2 of stage
     2 (K1 12 times with a gradient), the five losses a step;
   - ``train_vocoder``: ``VocoderModel.train_step`` at 64 x 8320 samples,
     6 steps, the EMA moved; one step at batch 2 against the CPU (1e-4).
   ``check_flash_grad`` holds K1's gradient at Conformer-L too.
7. Drives the command line from a manifest at full width (the presets as
   dotted overrides, ``PRESETS``; random weights from the presets' seed):
   - ``cli_corpus``: 32 clips of 4-16 s (96 x 96 uint8 video at 25 fps, 16 kHz
     wavs, three-word transcripts), a babble track and the train / valid /
     test manifests, under build/cli_corpus;
   - ``cli_loader``: the loader over the train subset with the preset's 3
     worker processes and with 0 (samples/s, ms a batch);
   - ``cli_train_avsr``: ``cli.train.main`` on conf/mms-llama.yaml to 6
     updates resumed to 8, beside a straight run to 8 (8 clips of 16 s a
     batch at bucket 400): the first update against ``Trainer.train_step``
     on the directly collated batch, K1 24 or 48 times a step, the resumed
     run's losses and leaves against the straight run's, a validation WER;
   - ``cli_eval``: ``cli.eval.main`` from that checkpoint over the test
     subset three times (int8 weights + int8 KV + the ancestry decode;
     int4 weights + n-gram blocking; constraints on every other clip), each
     with the kernels its options select, the first against
     ``AVSRSystem.generate`` on the same batches;
   - ``cli_train_speech``: the NoLLM head (4 updates), the E2E GAN's two
     stages (2 each) and the vocoder (3) through ``cli.train.main``;
   - ``cli_generate``: ``cli.generate synthesize`` on a 16 s clip from the
     NoLLM and vocoder checkpoints, then ``vocode`` of its mel.
   Each run prints its step ms, the share of a step spent waiting for the
   batch and its peak GiB.  Then ``cli_dummy_avsr``: ``cli.train`` of
   ``task.name=dummy_avsr model.name=mms_llama_avsr
   optimization.max_update=3`` (``AVSRConfig()``, the task's fabricated
   batch of 4 x 100 frames with a 30 s Whisper window, validation off, one
   save, not written): the first update against ``Trainer.train_step`` on
   the fabricated batch, K1 24 times a step, the step and data ms, label
   tokens/s and the peak GiB.
8. Starts from the paper's weights, in their reference layouts:
   - ``import_pretrained``: the seed-0 bf16 system written out as HF
     LLaMA-3.2-3B and HF Whisper-medium state dicts, a fairseq
     AV-HuBERT-Large ``.pt`` (f32, the positional conv weight-normed, with a
     ``cfg`` Namespace), the speech-rate predictor's state dict and a product
     ``.pt`` of trainables drawn from seed 1 (Q-Former, ``query_tokens``,
     ``afeat_1d_conv``, the projector, peft LoRA, an ``args`` Namespace);
     the two files read back through ``load_pt`` and imported into a fresh
     seed-2 system (``merge_state``): every entry equal to its source bit
     for bit but the folded positional convs (their error printed), only
     ``audio_proj.*`` logged absent, ``inspect_checkpoint``'s totals of both
     files, and with int8 weights the same beams as the source's, bit for
     bit, launching K1, the merged K2 + K3 entry, K7 and K4;
   - ``cli_init_from_pt``: ``cli.train.main`` on conf/mms-llama.yaml with
     ``checkpoint.init_from_pt`` = that product ``.pt``, 2 updates, one
     checkpoint write: the imported entries equal the file's before update
     1, K1 as in ``cli_train_avsr``;
   - ``cli_demo``: ``cli.demo.main`` on one 16 s corpus clip from that
     run's checkpoint at beam 5 (bf16 KV, the ancestry decode: K1, K3, K4),
     its transcript equal to ``AVSRSystem.generate``'s on the clip.
9. Pretrains AV-HuBERT on the corpus of 7. (conf/avhubert-pretrain.yaml as
   overrides, AV-HuBERT-Large at full width, random weights, bf16):
   - ``pretrain_kmeans_mfcc``: ``cli.manifest_tools learn-kmeans`` (500
     clusters on the train clips' MFCCs, the inertia of each epoch), then
     ``dump-labels`` for train and valid;
   - ``pretrain_train``: ``cli.train`` for 4 updates at max_tokens 1000,
     one checkpoint and one validation: K1 24 times in a step of the 300 or
     400 bucket (through ``FlashAttentionGrad``) and in such a validation
     batch, none elsewhere; finite losses, the ResNet's running statistics
     moved, the checkpoint equal to the trainer's state; each step's ms and
     masked share, the peak GiB;
   - ``pretrain_dump_features``: ``dump-features --layer 12`` from that
     checkpoint at the default f32 (no launches) and at bf16 (K1 12 times
     a clip of >= 256 padded frames), the bf16 dump's error;
   - ``pretrain_kmeans_features``: iteration 2, k-means on the f32
     features, the labels of both dumps in [0, 500) and the share of
     frames where they agree;
   - ``seq2seq`` / ``seq2seq_constrained``: ``generate_seq2seq`` at the
     default decoder config (d 768, 6 layers, vocabulary 1000) on seeded
     encoder states [8, 400, 768], beam 5, 64 tokens: K4 once a step at
     [40, 1000], no K6, the tokens equal under ``plain_versions()``; then
     with unordered constraints (no kernel).
   ``check_topk`` holds K4 at [40, 1000] too, ``check_flash_grad`` K1's
   gradient at the pretraining shape [2, 16, 400, 64].
10. Remat and the other optimizers (run after 4. and, for the last, 9.):
   - ``train_avsr_remat``: the ``train_avsr_flash`` system with
     ``LlamaConfig.remat`` and the preset's LoRA dropout: step 1's loss,
     gradients and dropout generator with and without remat on one module,
     bit for bit; K1 104 a step (28 forwards and 28 recomputes through
     ``FlashAttentionGrad``, 48 in the encoders); 3 steps with remat, then
     2 without and the training forward alone: walls and peaks (the remat
     peak below both the plain steps' and ``train_avsr_flash``'s);
   - ``train_optimizers``: adafactor, lamb, adagrad, adamax, nag and sgd,
     3 updates each on that trainer from the same masters: finite losses,
     the frozen leaves bit for bit, each optimizer's state GiB beside
     AdamW's, update 1 against the same optimizer on the CPU in f32 on the
     same gradients (1e-5 of each leaf's largest element);
   - ``pretrain_remat``: two AV-HuBERT-Large pretraining updates with the
     encoder's remat against the same two without, under torch's
     deterministic algorithms: bit for bit (K1 48 a step with remat).
11. Data preparation: ``prep_tools``, every manifest_tools subcommand over
   the corpus of 7. laid out raw (``generate``'s rows equal the corpus's,
   ``generate-mels``' files the mels the dataset computes, ``align-mouth``
   from synthetic landmarks, ``split`` / ``hours`` / ``normalize-rates`` /
   ``update-paths`` / ``filter-language`` / ``make-babble``), then
   ``quantize_tree`` of the full-width bf16 state dict on the card (its
   error, size ratio and one leaf's codes equal to the CPU's).  Then
   ``native``: the host C++ routines (``multimodalvc_tpu_torch/native``)
   built with g++, each against its plain Python version at corpus size
   (10k word pairs, 1M clip lengths, 1M sentences, 10k BLEU pairs, [4000,
   100] n-gram rows; the balanced assignment of 19,200 frames to 4 experts
   against the greedy fill's total score), both host times printed.

12. Several ranks (the corpus of 7. written first if absent):
   ``parallel_nccl_1rank`` (``cli.train`` in an NCCL group of one under
   ``torch.distributed.run``), ``parallel_data_2rank`` (two data-parallel
   gloo ranks sharing the card), ``parallel_moe_speech`` (the MoE Conformer
   preset), then two gloo ranks at {tensor 2} sharing the card:
   ``parallel_tensor_avsr`` (``cli.train`` on mms-llama with
   ``mesh.tensor=2``) and ``parallel_tensor_speech`` (the NoLLM head, K1
   with a gradient on 4 of Conformer-L's 8 heads), each against a
   one-process run, its nudged and dithered runs and its run with K1 plain,
   all in the smoke's own process, with
   each rank's bytes of the split leaves, peak and K1 launches; K1 at the
   local-head shapes (``TENSOR_FLASH_CASES``, ``conformer_l_tensor2``) is
   in 2.

Prints JSON lines with the kernel checks and the phases, the smoke's own
wall, then the ``{"kernels": [...]}`` summary, then the card line, then, as the last line,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Needs a CUDA device and the repository around it; it does not fall
back to the CPU.

``python3 chip_smoke.py --selftest`` runs only the ``selftest`` phase.

``python3 chip_smoke.py --train`` runs only ``check_flash_grad`` and the two
training phases.

``python3 chip_smoke.py --parallel`` runs only K1's local-head cases and the
several-rank phases (12.).

``python3 chip_smoke.py --cli`` runs only the command-line phases (7.).

``python3 chip_smoke.py --import`` runs only the weight-import phases (8.),
writing the corpus of 7. first.

``python3 chip_smoke.py --pretrain`` runs only K1's pretraining gradient
case, K4 at [40, 1000] and the pretraining phases (9.), writing the corpus
of 7. first.

``python3 chip_smoke.py --optim`` runs only the phases of 10. (writing the
corpus of 7. and its k-means labels first where absent);
``--profile-remat`` profiles one ``train_avsr_remat`` step with and one
without remat.

``python3 chip_smoke.py --dummy`` runs only ``cli_dummy_avsr`` (7.) and
``native`` (11.).

``python3 chip_smoke.py --prep`` writes the corpus of 7. and runs
``prep_tools`` (11.).

``python3 chip_smoke.py --speech`` runs only K1's speech cases and the five
speech phases.

``python3 chip_smoke.py --speech-train`` runs only K1's Conformer-L
gradient case and the four speech training phases.

``python3 chip_smoke.py --adamw`` runs only K9 (``check_adamw``: the
optimizer's square sums and update at the NoLLM head's 485 trained leaves,
against the plain versions and their byte bound) and ``train_speech_nollm``
(K9 once each a step, the profiled update's kernels).

``python3 chip_smoke.py --digests`` runs only the AVSR serving phases and
prints their output digests as one JSON line: copied into an older tree
(``git archive`` of it under ``build/``, this file put beside its
``multimodalvc_tpu_torch``), it gives that tree's digests to hold against
this tree's in the same call.

``python3 chip_smoke.py --plans`` times the decode-attention entries at the
serving shapes under other chunk plans than ``decode_plan``'s (PLAN_CASES),
and K4/K5 under other cluster sizes and rings than ``topk_plan``'s
(TOPK_PLAN_CASES).

``python3 chip_smoke.py --profile-gather`` profiles the decode steps of the
bf16-weight system on the gather path (bf16 KV, the gather reorder).

``python3 chip_smoke.py --beam5`` runs only the checks an older tree can
run too (the decode attention and K4 up to beam 12), with each output's
digest: copied into an older tree, it holds two builds' bits and times in
one call.

``python3 chip_smoke.py --phases`` times K4's phases (``PHASE_NAMES``): it
builds ``csrc/topk.cu`` with ``MMVC_TOPK_MARKS`` defined, which reads the
global timer at their boundaries.

``python3 chip_smoke.py --profile`` runs no checks: it profiles the decode
steps of the bf16-, int8- and int4-weight systems with ``torch.profiler``
and prints the device time per step by kernel (K7's, K8's, the decode
attention's and the top-k kernels apart) and the device's idle share, the
host time a call of K7's wrapper beside ``F.linear``'s, and the decode
step's candidate stage alone (``candidate_stage``).
"""
from __future__ import annotations

import copy
import functools
import hashlib
import itertools
import json
import math
import os
import subprocess
import sys
import time
import warnings
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
DEV = "cuda"
BATCH, SECONDS, BEAMS, INSTRUCTION = 8, 16, 5, 10
NEW_TOKENS, SHORT_TOKENS = 64, 16  # the int8-weight phase, the other phases
TRAIN_LABELS, TRAIN_STEPS, TRAIN_WARMUP = 64, 6, 2  # the train_avsr phases
REL_TOL = 2e-2  # relative L2 between two paths (bf16 activations), layer by layer
# End-to-end decode logits of two paths that round differently are gated
# against the noise floor that the same run measures on the same weights and
# cache: the relative L2 by which one bf16 ulp on 0.01% of the prompt
# embeddings moves them.  This random-weight 28-layer model is chaotic, so the
# floor is large (3.52e-2 with int8 and int4 weights on an H100 80GB HBM3 at
# 700 W) and a kernel that merely sums in another order than cuBLAS lands
# near it, where a wrong one lands at O(1).  The gate is FLOOR_MARGIN times
# the floor, and never under REL_TOL; a floor above FLOOR_MAX means the model
# or its rounding changed, and fails the run.
FLOOR_MARGIN, FLOOR_MAX = 1.5, 5e-2
# the card's published peaks (H100 SXM, dense): the bound of a kernel is the
# larger of its bytes over HBM_BPS and its operations over the peak rate of
# their type
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12


class SmokeFailure(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device time of one call: CUDA events around ``iters`` calls queued
    behind a ~50 ms device sleep, so the host's launch cost (tens of
    microseconds through ctypes or PyTorch's dispatcher) hides behind it and
    the events time the kernels alone."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: float, ops: float = 0.0, peak: float = BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of ``moved`` bytes
    over the memory rate and ``ops`` operations over ``peak``."""
    by_bytes, by_ops = moved / HBM_BPS * 1e3, ops / peak * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def record(results, name, err, tol, library=None, **extra):
    """One kernel case: its error against the plain version, its times
    (``ms``, ``plain_ms``, ``library_ms`` = ``library`` timed unless given,
    or None) and its bound."""
    ok = err <= tol
    if "library_ms" not in extra:
        extra["library_ms"] = None if library is None else time_ms(library)
    results.append({"name": name, "max_abs_err": err, "tol": tol, "ok": ok, **extra})
    print(f"  {name}: max_err={err:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}"
          + "".join(f" {k}={v:.3e}" if k.endswith("_err") else f" {k}={v:.4f}"
                    for k, v in extra.items() if isinstance(v, float)))


# ---- the package's kernel self-test ----------------------------------------------


def selftest_phase() -> dict:
    """``multimodalvc_tpu_torch.ops.selftest.run_all()`` on the card: the JAX
    selftest's sixteen checks, K1-K8 through the port's entries at its
    shapes against its oracles, each timed (its inputs, the launch and the
    oracle, synchronised), one line a record.  Fails on a red record."""
    import torch

    from multimodalvc_tpu_torch.ops.selftest import CHECKS, run_all

    t0 = time.perf_counter()
    records = []
    for name in CHECKS:
        t1 = time.perf_counter()
        (rec,) = run_all([name])
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t1
        records.append(rec)
        print(f"  selftest {name}: max_err={rec['max_err']:.3e} tol={rec['tol']:g} "
              f"{'ok' if rec['ok'] else 'FAIL'} ({rec['wall_s']:.2f} s)"
              + (f" error: {rec['error']}" if "error" in rec else ""))
    wall_s = time.perf_counter() - t0
    print(f"  selftest: {len(records)} checks in {wall_s:.1f} s")
    failed = [r["name"] for r in records if not r["ok"]]
    if failed or len(records) != len(CHECKS):
        raise SmokeFailure(f"selftest: red checks {failed}")
    torch.cuda.empty_cache()
    return {"records": records, "wall_s": wall_s}


# ---- kernels against their plain versions ------------------------------------


# K1 cases: (name, [B, H, T, D], kv_lens, kv_starts or None, causal, scale
# or None for 1/sqrt(D)).  The serving shapes, the JAX selftest's flash shapes
# (multimodalvc_tpu/ops/selftest.py), the serving prefill (130 slots, ragged
# against every tile, left-pad starts), and edge rows: kv_len 1, kv_len
# inside a key tile, kv_start inside the first key tile with causal (whole
# leading query rows dead), a batch row with kv_len 0 at D=128; then Whisper
# at scales 0 (uniform weights) and -0.125, which the wrapper folds into q.
FLASH_CASES = [
    ("whisper", (8, 16, 1536, 64), [1500] * 8, None, False, None),
    ("avhubert_masked_row", (8, 16, 400, 64), [400, 0, 257, 400, 1, 400, 64, 399], None, False,
     None),
    ("prefill_causal_starts", (2, 24, 256, 128), [256, 200], [0, 37], True, None),
    ("encoder_selftest", (2, 16, 768, 64), [700, 512], None, False, None),
    ("prefill_1kb", (8, 24, 512, 128), [512] * 8, [0, 63, 0, 0, 17, 0, 0, 128], True, None),
    ("serving_prefill", (8, 24, 130, 128), [130] * 8, [0, 7, 19, 33, 41, 52, 58, 64], True, None),
    ("edges_d64", (4, 2, 200, 64), [1, 100, 200, 37], [0, 0, 45, 0], False, None),
    ("edges_causal_d128", (4, 2, 150, 128), [150, 0, 150, 90], [29, 0, 5, 70], True, None),
    ("whisper_scale0", (8, 16, 1536, 64), [1500] * 8, None, False, 0.0),
    ("whisper_scale_neg", (8, 16, 1536, 64), [1500] * 8, None, False, -0.125),
]
# K1 on the speech-synthesis path: the Conformer-L self-attention (8 heads of
# 64 over the 2400-frame mel buffer, keys to the 1600 frames of 16 s: a third
# of the query rows past kv_len) and the cross-attention fusion (8 heads of
# 128, video queries against the audio frames)
SPEECH_FLASH_CASES = [
    ("conformer_l", (8, 8, 2400, 64), [1600] * 8, None, False, None),
    ("cross_att_fusion", (8, 8, 400, 128), [400] * 8, None, False, None),
]
# K1 on a tensor axis of 2: each rank attends with its half of the heads
# (Whisper-medium 16 -> 8, AV-HuBERT-Large 16 -> 8)
TENSOR_FLASH_CASES = [
    ("whisper_tensor2", (8, 8, 1536, 64), [1500] * 8, None, False, None),
    ("avhubert_tensor2", (8, 8, 400, 64), [400] * 8, None, False, None),
]
# K1 against its plain version: at most 3e-2 absolute on bf16 outputs (the
# JAX selftest's) and at most 1e-2 relative L2.  The absolute bound alone is
# about a typical output value at Whisper (1500 keys average the values down
# to ~0.04), so a smaller fault could pass it there; the relative one scales
# with the output.  Every case proves that the check fails the plain version
# with the last FLASH_TILE_KEYS-key tile of each window dropped.
FLASH_TOL, FLASH_REL_TOL, FLASH_TILE_KEYS = 3e-2, 1e-2, 64
# the serving prefill also runs through the LLaMA attention layer, both
# branches of its flash gate
SERVING_PREFILL = "serving_prefill"


def flash_inputs(case, g):
    """q, k, v, kv_lens, kv_starts (or None) and the allowed-pair mask [B, T, T]."""
    import torch

    _, shape, lens, starts, causal, _ = case
    b, h, t, d = shape
    q, k, v = (torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16) for _ in range(3))
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=DEV)
    kv_starts = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=DEV)
    col = torch.arange(t, device=DEV)
    allowed = (col[None, None, :] < kv_lens[:, None, None]).expand(-1, t, -1)
    if kv_starts is not None:
        allowed = allowed & (col[None, None, :] >= kv_starts[:, None, None])
    if causal:
        allowed = allowed & (col[None, None, :] <= col[None, :, None])
    return q, k, v, kv_lens, kv_starts, allowed


def flash_bound(shape, allowed, ops, *index) -> dict:
    """K1's bound from the pairs this data allows: ``ops`` operations; the q
    rows that have a valid key, the K and V rows that some query row sees
    (per batch row, every head), the whole output and the ``index`` tensors
    (kv_lens, kv_starts), each once."""
    b, h, t, d = shape
    q_rows = int(allowed.any(dim=-1).sum())
    kv_rows = int(allowed.any(dim=-2).sum())
    return bound(2 * h * d * (q_rows + 2 * kv_rows + b * t) + nbytes(*index), ops)


def prefill_layer(starts, g) -> dict:
    """One LLaMA-3.2-3B attention layer (random weights) on the serving
    prefill, [len(starts), 130] tokens with these left pads, through both
    branches of its flash gate (``use_flash_prefill``): False, the plain
    grouped attention that serving prompts take today; True, the GQA
    repeat + K1.  Their ms, and their agreement on the rows that are not
    padding."""
    import dataclasses

    import torch

    from multimodalvc_tpu_torch.nn.llama import LlamaAttention, LlamaConfig

    cfg = LlamaConfig()
    torch.manual_seed(0)
    attn = LlamaAttention(cfg, device=DEV, dtype=torch.bfloat16)
    b, t = len(starts), 130
    x = torch.randn(b, t, cfg.hidden_size, generator=g, device=DEV).to(torch.bfloat16)
    slot = torch.arange(t, device=DEV)[None].expand(b, t)
    mask = (slot >= torch.tensor(starts, device=DEV)[:, None]).to(torch.int32)
    # as prefill_split_cache calls it: RoPE positions from the mask, the
    # cache's slot ids for causality, a [B, Hkv, T, D] cache to fill
    positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
    kv = torch.zeros(b, cfg.num_kv_heads, t, cfg.head_dim, dtype=torch.bfloat16, device=DEV)
    cache = {"k": kv, "v": kv.clone(), "index": 0}
    out, ms = {}, {}
    with torch.inference_mode():
        for flash in (False, True):
            attn.cfg = dataclasses.replace(cfg, use_flash_prefill=flash)
            call = lambda: attn(x, positions, mask, cache, slot)[0]  # noqa: E731
            out[flash], ms[flash] = call(), time_ms(call)
    real = mask.bool()
    rel = rel_l2(out[True][real], out[False][real])
    if not rel <= REL_TOL:
        raise SmokeFailure(f"prefill layer: the flash and plain branches disagree ({rel:.3e})")
    return {"layer_plain_ms": ms[False], "layer_flash_ms": ms[True], "layer_rel_l2": rel}


def check_flash(results, cases=None):
    """K1 at ``cases`` (FLASH_CASES) against its plain version, at FLASH_TOL and
    FLASH_REL_TOL, with exact zeros on every row with no valid key; the
    reading of the same check on the plain version with each window's last
    key tile dropped must fail it.  Each case reports the kernel's TFLOP/s
    and share of its bound, and ``library_ms``: SDPA with the same boolean
    mask (key window, causality)."""
    import torch
    import torch.nn.functional as F

    from multimodalvc_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=DEV).manual_seed(0)
    for case in FLASH_CASES if cases is None else cases:
        name, shape, _, _, causal, scale = case
        q, k, v, kv_lens, kv_starts, allowed = flash_inputs(case, g)
        run = lambda: flash_attention(q, k, v, kv_lens, causal, scale, kv_starts)  # noqa: E731
        plain = lambda: flash_attention_plain(q, k, v, kv_lens, causal, scale, kv_starts)  # noqa: E731
        got, want = run(), plain()
        torch.cuda.synchronize()
        dead = ~allowed.any(dim=-1)  # [B, T]: rows with no valid key
        if dead.any() and (got.float().abs().amax(dim=(1, 3))[dead] != 0).any():
            raise SmokeFailure(f"flash_attention {name}: rows with no valid key not exact zeros")
        lo = torch.zeros_like(kv_lens) if kv_starts is None else kv_starts
        short = torch.maximum(lo, (kv_lens - 1).div(FLASH_TILE_KEYS, rounding_mode="floor")
                              * FLASH_TILE_KEYS)
        dropped = flash_attention_plain(q, k, v, short, causal, scale, kv_starts)
        rel, wrong_rel, wrong_err = rel_l2(got, want), rel_l2(dropped, want), max_err(dropped, want)
        if not rel <= FLASH_REL_TOL:
            raise SmokeFailure(f"flash_attention {name}: rel_l2 {rel:.3e} > {FLASH_REL_TOL:g}")
        if not (wrong_rel > FLASH_REL_TOL or wrong_err > FLASH_TOL):
            raise SmokeFailure(f"flash_attention {name}: the check passes a dropped key tile "
                               f"(rel_l2 {wrong_rel:.3e})")
        sdpa_mask = allowed[:, None]
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=sdpa_mask, scale=scale)
        # QK^T and PV over the key pairs this data allows
        ops, ms = 4 * shape[1] * shape[3] * int(allowed.sum()), time_ms(run)
        index = (kv_lens,) if kv_starts is None else (kv_lens, kv_starts)
        extra = dict(ms=ms, plain_ms=time_ms(plain), **flash_bound(shape, allowed, ops, *index))
        extra.update(tflops=ops / ms / 1e9, bound_share=extra["bound_ms"] / ms, rel_l2=rel,
                     dropped_tile_max_abs_err=wrong_err, dropped_tile_rel_l2=wrong_rel,
                     dead_rows=int(dead.sum()))
        if name == SERVING_PREFILL:
            extra.update(prefill_layer(case[3], g))
        record(results, f"flash_attention/{name}", max_err(got, want), FLASH_TOL,
               library=library, **extra)


# K1 with a gradient (ops/attention.py: FlashAttentionGrad) at the LLaMA
# training shape: [8, 24, T, 128] bf16, causal, left-pad key windows, at the
# train_avsr phases' prompt length and at T = 512.  out against the plain
# version at FLASH_TOL / FLASH_REL_TOL (the forward is K1).  The backward is
# the plain version's own (the Function recomputes the plain forward under
# autograd from the saved q, k, v and takes its gradient with the same
# cotangent), so dq, dk, dv must equal the plain version's bit for bit: the
# check holds the Function's wiring (saved inputs, order, kv_lens and
# kv_starts passed through), not the kernel.


def train_prompt_len() -> int:
    """The train_avsr phases' prompt: instruction + the query slots + labels."""
    from multimodalvc_tpu_torch.models.avsr import AVSRConfig

    return INSTRUCTION + AVSRConfig().max_queries + TRAIN_LABELS


def flash_grad_cases() -> list:
    """K1 with its gradient at the training shapes: (name, [B, H, T, D],
    causal).  The LLaMA trunk's prompt in ``train_avsr_flash`` (left pads,
    causal) and at 512 slots; the Conformer-L self-attention of the speech
    training phases (keys to the 1600 frames of 16 s in the 2400-frame
    buffer, no causal mask); AV-HuBERT-Large's self-attention in the
    pretraining phase (two 16 s clips of the 400 bucket, keys to 266);
    Conformer-L on a tensor axis of 2 (4 of its 8 heads a rank,
    ``parallel_tensor_speech``)."""
    return [("trunk", (BATCH, 24, train_prompt_len(), 128), True),
            ("trunk", (BATCH, 24, 512, 128), True),
            (CONFORMER_GRAD, (BATCH, 8, 2400, 64), False),
            (PRETRAIN_GRAD, (2, 16, 400, 64), False),
            (CONFORMER_TENSOR_GRAD, (BATCH, 4, 2400, 64), False)]


CONFORMER_GRAD, PRETRAIN_GRAD = "conformer_l", "avhubert_pretrain"
CONFORMER_TENSOR_GRAD = "conformer_l_tensor2"


def check_flash_grad(results, only=None):
    """K1 through its autograd Function against the plain version under
    autograd, at ``flash_grad_cases()`` (those named ``only``): out and dq,
    dk, dv.  ``ms`` is K1's forward (inputs saved), ``plain_ms`` the plain
    forward under autograd, ``bound_ms`` the forward's; ``bwd_ms`` the
    backward (the plain recompute), ``step_ms`` forward + backward beside
    ``plain_step_ms`` and ``step_bound_ms``, ``library_ms`` SDPA's forward +
    backward, and ``recompute_peak_gib`` the memory forward + backward
    allocate above their inputs."""
    import torch
    import torch.nn.functional as F

    from multimodalvc_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=DEV).manual_seed(13)
    for case, (b, h, t, d), causal in flash_grad_cases():
        if only is not None and case not in only:
            continue
        if causal:
            starts = torch.randint(0, t // 3, (b,), generator=g, device=DEV).to(torch.int32)
            starts[0] = 0
            lens = torch.full((b,), t, dtype=torch.int32, device=DEV)
        else:
            starts = torch.zeros((b,), dtype=torch.int32, device=DEV)
            lens = torch.full((b,), 2 * t // 3, dtype=torch.int32, device=DEV)
        q, k, v, cot = (torch.randn(b, h, t, d, generator=g, device=DEV).to(torch.bfloat16)
                        for _ in range(4))
        col = torch.arange(t, device=DEV)
        allowed = ((col[None, None, :] >= starts[:, None, None])
                   & (col[None, None, :] < lens[:, None, None])).expand(-1, t, -1)
        if causal:
            allowed = allowed & (col[None, None, :] <= col[None, :, None])

        def run(fn, backward=True):
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            out = fn(*leaves)
            if not backward:
                return out
            dq, dk, dv = torch.autograd.grad(out, leaves, cot)
            return out, dq, dk, dv

        kernel = lambda *a: flash_attention(*a, lens, causal, None, starts)  # noqa: E731
        plain = lambda *a: flash_attention_plain(*a, lens, causal, None, starts)  # noqa: E731
        sdpa = lambda *a: F.scaled_dot_product_attention(*a, attn_mask=allowed[:, None])  # noqa: E731
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = run(kernel)
        torch.cuda.synchronize()
        recompute_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        want = run(plain)
        torch.cuda.synchronize()
        rel_out = rel_l2(got[0], want[0])
        name = f"flash_attention/grad/{b}x{h}x{t}x{d}"
        if not rel_out <= FLASH_REL_TOL or max_err(got[0], want[0]) > FLASH_TOL:
            raise SmokeFailure(f"{name}: out rel_l2 {rel_out:.3e}")
        for which, a, c in zip(("dq", "dk", "dv"), got[1:], want[1:]):
            if not torch.equal(a, c):
                raise SmokeFailure(f"{name}: {which} differs from the plain version's "
                                   f"(rel_l2 {rel_l2(a, c):.3e}); it must be the same recompute")
        if not all(bool(torch.isfinite(x).all()) for x in got):
            raise SmokeFailure(f"{name}: non-finite output or gradient")
        err = max_err(got[0], want[0])
        del got, want
        # the forward: QK^T and PV, 4 h d flops a key pair, q k v read and out
        # written once; forward + backward adds the recompute's forward and
        # backward (QK^T, PV; dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T
        # Q): 4 + 12 h d flops a pair, dO read and dq dk dv written
        pairs = int(allowed.sum())
        fwd_moved = nbytes(q, k, v, lens, starts) + nbytes(q)
        step = bound(fwd_moved + nbytes(cot) + 3 * nbytes(q), (4 + 12) * h * d * pairs)
        fwd_ms = time_ms(lambda: run(kernel, backward=False))
        step_ms = time_ms(lambda: run(kernel))
        record(results, name, err, FLASH_TOL, ms=fwd_ms, plain_ms=time_ms(lambda: run(plain, backward=False)),
               bwd_ms=step_ms - fwd_ms, step_ms=step_ms, plain_step_ms=time_ms(lambda: run(plain)),
               step_bound_ms=step["bound_ms"], library_ms=time_ms(lambda: run(sdpa)),
               out_rel_l2=rel_out, recompute_peak_gib=recompute_peak,
               **bound(fwd_moved, 4 * h * d * pairs))
        torch.cuda.empty_cache()


def _int8_kv(shape, g):
    import torch

    from multimodalvc_tpu_torch.ops.decode_attention import quantize_kv

    return quantize_kv(torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16))


def prompt_bound(q, kv, out, mask, beams) -> dict:
    """K2: q, the prompt KV (+ scales, mask) and the partials once; QK^T and
    PV over each batch element's valid slots."""
    rows, h, d = q.shape
    ops = 4 * beams * h * d * int(mask.sum())
    return bound(nbytes(q, *kv, *out), ops)


def gen_bound(q, kv, out, valid, slots) -> dict:
    """K3: q, the partials, and the first ``valid`` of ``slots`` generated
    slots of the KV (+ scales, anc map); QK^T and PV over those slots."""
    rows, h, d = q.shape
    return bound(nbytes(q, *out) + nbytes(*kv) * valid / slots, 4 * rows * h * d * valid)


def merged_bound(q, prompt, mask, gen, out, valid, slots, beams) -> dict:
    """The merged entry: q, the valid prompt slots' K/V and scales (and the
    mask), the first ``valid`` generated slots' K/V and scales of every
    source row (and their anc), the bf16 output; QK^T and PV over each
    row's valid prompt slots and generated slots."""
    rows, h, d = q.shape
    share = float(mask.float().mean())
    moved = nbytes(q, mask, out) + nbytes(*prompt) * share + nbytes(*gen) * valid / slots
    return bound(moved, 4 * h * d * (beams * int(mask.sum()) + rows * valid))


# The earlier decode-attention kernels' times at these cases (one block a
# batch element and kv head, f32 FMAs; H100 80GB HBM3, 700 W, as PERF.md
# records them), printed beside the new ones; a case they were not timed
# at has none.
EARLIER_MS = {
    "prompt_attention/int8/40x24x128": 0.0626, "prompt_attention/int8/240x24x128": 0.0668,
    "prompt_attention/bf16/40x24x128": 0.1409, "prompt_attention/bf16/240x24x128": 0.1472,
    "gen_attention_ancestor/int8/40x16x8x128/valid15": 0.0307,
    "gen_attention_ancestor/int8/240x64x8x128/valid41": 0.0766,
    "gen_attention_ancestor/bf16/40x16x8x128/valid15": 0.0309,
    "gen_attention_ancestor/bf16/240x64x8x128/valid41": 0.0858,
}
# the decode shapes: (batch, generated slots, valid lengths).  Batch 8 with
# 16 slots serves the 16-token phases, batch 8 with 64 the int8-weight phase
# (valid 1 and 63: its first and last steps), batch 48 the serving batch.
DECODE_CASES = ((8, SHORT_TOKENS, (SHORT_TOKENS - 1,)), (48, 64, (41, 0)), (8, 64, (1, 63)))
DECODE_TOL = 5e-2  # the JAX selftest's
# wider beams: 24 and 51 query rows a kv head (two and four 16-row tiles)
# at the 16-token phases' shape, where each block holds one chunk and keeps
# it staged across its tiles, and at the serving batch (48, 64 slots), where
# a block holds several chunks and stages each again for every tile; and
# WIDEST_DECODE_BEAMS at the first shape, whose generated chunks are one slot
# of every source beam (144 key rows, past the other chunks' 128); and, at the
# first shape, one beam past ``decode_max_beams()`` (337), whose slots are
# read in pieces of the source beams (``gen_chunk_beams``)
WIDE_DECODE_BEAMS, WIDEST_DECODE_BEAMS = (8, 17), 129


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes: the bits of a kernel's output, to hold
    one build of it against another in one call."""
    import torch

    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def decode_inputs(b, slots, kv, g, beams=BEAMS):
    """q, the prompt KV (values, scales or None) and mask, the generated KV
    and anc of one decode case: ``beams`` (5), 24 query / 8 kv heads,
    d=128, 130 prompt slots with random left pads, batch element 3 without
    a valid prompt slot."""
    import torch

    h, hkv, d, tp = 24, 8, 128, 130

    def cache(shape):  # (values, scales or None)
        if kv == "int8":
            return _int8_kv(shape, g)
        return torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16), None

    q = torch.randn(b * beams, h, d, generator=g, device=DEV).to(torch.bfloat16)
    prompt = cache((b, hkv, tp, d)), cache((b, hkv, tp, d))
    pad = torch.randint(0, 60, (b,), generator=g, device=DEV)
    mask = (torch.arange(tp, device=DEV)[None, :] >= pad[:, None]).to(torch.int32)
    mask[3] = 0  # a batch element with no valid prompt slot
    gen = cache((b * beams, slots, hkv, d)), cache((b * beams, slots, hkv, d))
    anc = torch.randint(0, beams, (b * beams, slots), generator=g, device=DEV).to(torch.int32)
    return q, prompt, mask, gen, anc


def _same_bits(name, run, got):
    """A second launch on the same inputs must give the same bits; prints
    their digest, to hold them against another build's."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    again = run()
    for a, c in zip(got, again if isinstance(again, tuple) else (again,)):
        if not torch.equal(a, c):
            raise SmokeFailure(f"{name}: two launches on the same inputs differ")
    print(f"  {name}: output sha256 {digest(*got)}")


def decode_cases(cases, wide):
    """(batch, slots, valid lengths, beams): ``cases`` at beam 5, then (with
    ``wide``) WIDE_DECODE_BEAMS at DECODE_CASES' first two shapes and
    WIDEST_DECODE_BEAMS at the first."""
    from multimodalvc_tpu_torch.ops.decode_attention import decode_max_beams

    out = [(b, slots, valids, BEAMS) for b, slots, valids in cases]
    if wide:
        out += [(b, slots, valids, k) for b, slots, valids in DECODE_CASES[:2]
                for k in WIDE_DECODE_BEAMS]
        out.append((*DECODE_CASES[0], WIDEST_DECODE_BEAMS))
        out.append((*DECODE_CASES[0], decode_max_beams() + 1))
    return out


def _beam_tag(beams) -> str:
    return "" if beams == BEAMS else f"beam{beams}/"


def check_decode(results, kv="int8", wide=True):
    """K2 and K3 with an int8 (or bf16) KV cache at DECODE_CASES' first two
    shapes: batch 8 (40 query rows, 16 generated slots, valid 15) and batch
    48 (64 slots, valid 41 and 0); with ``wide``, both at beams 8 and 17
    (24 and 51 query rows a kv head) and batch 8 at beam 129.  Tolerance DECODE_TOL on out, m and l;
    a row with no valid key (K2: batch element 3; K3: valid 0) must be
    exactly (0, -1e30, 0); two launches must give the same bits."""
    import torch

    from multimodalvc_tpu_torch.ops.decode_attention import (
        gen_attention_ancestor,
        gen_attention_ancestor_plain,
        prompt_attention,
        prompt_attention_plain,
    )

    def empty(part, rows) -> bool:
        return (bool((part[0][rows] == 0).all()) and bool((part[1][rows] == -1e30).all())
                and bool((part[2][rows] == 0).all()))

    g = torch.Generator(device=DEV).manual_seed(1 if kv == "int8" else 5)
    h, d = 24, 128
    for b, slots, valids, beams in decode_cases(DECODE_CASES[:2], wide):
        q, ((pk, pks), (pv, pvs)), mask, ((gk, gks), (gv, gvs)), anc = decode_inputs(
            b, slots, kv, g, beams)
        hkv = pk.shape[1]
        kw = dict(beams=beams, scale=d ** -0.5, k_scale=pks, v_scale=pvs)
        run = lambda: prompt_attention(q, pk, pv, mask, **kw)  # noqa: E731
        plain = lambda: prompt_attention_plain(q, pk, pv, mask, **kw)  # noqa: E731
        got = run()
        name = f"prompt_attention/{kv}/{_beam_tag(beams)}{b * beams}x{h}x{d}"
        err = max(max_err(a, c) for a, c in zip(got, plain()))
        if not empty(got, slice(3 * beams, 4 * beams)):
            raise SmokeFailure(f"{name}: a batch element without a valid slot must give "
                               "(0, -1e30, 0)")
        _same_bits(name, run, got)
        moved = tuple(x for x in (pk, pv, pks, pvs, mask) if x is not None)
        record(results, name, err, DECODE_TOL, ms=time_ms(run), plain_ms=time_ms(plain),
               earlier_ms=EARLIER_MS.get(name), **prompt_bound(q, moved, got, mask, beams))

        kw = dict(beams=beams, scale=d ** -0.5, k_scale=gks, v_scale=gvs)
        moved = tuple(x for x in (gk, gv, gks, gvs, anc) if x is not None)
        for valid in valids:
            run = lambda: gen_attention_ancestor(q, gk, gv, anc, valid, **kw)  # noqa: E731
            plain = lambda: gen_attention_ancestor_plain(q, gk, gv, anc, valid, **kw)  # noqa: E731
            got, want = run(), plain()
            name = (f"gen_attention_ancestor/{kv}/{_beam_tag(beams)}{b * beams}x{slots}x{hkv}x{d}"
                    f"/valid{valid}")
            err = max(max_err(a, c) for a, c in zip(got, want))
            if valid == 0 and not empty(got, slice(None)):
                raise SmokeFailure(f"{name}: valid_len 0 must give (0, -1e30, 0)")
            _same_bits(name, run, got)
            record(results, name, err, DECODE_TOL, ms=time_ms(run), plain_ms=time_ms(plain),
                   earlier_ms=EARLIER_MS.get(name), **gen_bound(q, moved, got, valid, slots))


def check_merged(results, wide=True):
    """The merged entry (int8 KV, bf16 output) at every DECODE_CASES shape
    (and with ``wide`` at ``decode_cases``' wider beams) against the
    merge of the plain partials, cast: tolerance DECODE_TOL on the bf16
    output and on the f32 output of the same entry; the rows with no valid
    key in either segment (batch element 3 with valid 0) exactly zero; two
    launches the same bits.  ``unfused_ms`` is this tree's K2 +
    K3 + the PyTorch merge and cast, the decode step's path before the
    merged entry."""
    import torch

    from multimodalvc_tpu_torch.ops.decode_attention import (
        ancestry_attention,
        ancestry_attention_plain,
        gen_attention_ancestor,
        merge_softmax_segments,
        prompt_attention,
    )

    g = torch.Generator(device=DEV).manual_seed(11)
    h, d = 24, 128
    for b, slots, valids, beams in decode_cases(DECODE_CASES, wide):
        q, ((pk, pks), (pv, pvs)), mask, ((gk, gks), (gv, gvs)), anc = decode_inputs(
            b, slots, "int8", g, beams)
        for valid in valids:
            kw = dict(beams=beams, scale=d ** -0.5, prompt_k_scale=pks, prompt_v_scale=pvs,
                      gen_k_scale=gks, gen_v_scale=gvs)
            args = (q, pk, pv, mask, gk, gv, anc, valid)
            run = lambda: ancestry_attention(*args, **kw)  # noqa: E731
            plain = lambda: ancestry_attention_plain(*args, **kw)  # noqa: E731

            def unfused():
                part_p = prompt_attention(q, pk, pv, mask, beams=beams, scale=d ** -0.5,
                                          k_scale=pks, v_scale=pvs)
                part_g = gen_attention_ancestor(q, gk, gv, anc, valid, beams=beams,
                                                scale=d ** -0.5, k_scale=gks, v_scale=gvs)
                return merge_softmax_segments(*part_p, *part_g).to(torch.bfloat16)

            got, want = run(), plain()
            name = (f"ancestry_attention/int8/{_beam_tag(beams)}{b * beams}x{slots}x{pk.shape[1]}"
                    f"x{d}/valid{valid}")
            f32 = dict(kw, out_dtype=torch.float32)
            err_f32 = max_err(ancestry_attention(*args, **f32), ancestry_attention_plain(*args, **f32))
            if got.dtype != torch.bfloat16 or not bool(torch.isfinite(got).all()):
                raise SmokeFailure(f"{name}: expected a finite bf16 output")
            if valid == 0 and not bool((got[3 * beams : 4 * beams] == 0).all()):
                raise SmokeFailure(f"{name}: rows with no valid key must be exact zeros")
            _same_bits(name, run, got)
            record(results, name, max(max_err(got, want), err_f32), DECODE_TOL,
                   ms=time_ms(run), plain_ms=time_ms(plain), unfused_ms=time_ms(unfused),
                   f32_out_max_abs_err=err_f32,
                   **merged_bound(q, (pk, pv, pks, pvs), mask, (gk, gv, gks, gvs, anc), got,
                                  valid, slots, beams))


# K4/K5 with the statistics inside the kernel: m must equal torch.amax, ls
# (summed in another order than PyTorch's) within LS_TOL of
# log(sum(exp(x - m))), and the selection must equal the plain version's on
# the kernel's own m and ls bit for bit.  Against the fully plain chain each
# value must agree within the ls difference plus 2 ulps of the largest value
# (two f32 roundings), and the indices must agree except among candidates
# whose plain-chain values lie within that tolerance of each other: two rows'
# statistics an ulp apart may order such a near tie either way (beam 100 of
# random logits holds one in 200 candidates).  The planted ties must come out
# in flat order.
LS_TOL = 2e-6
TOPK_OPS_STATS = 8  # f32 ops a value with the statistics inside: max, sub, exp, add; sub, sub, add, max


def _topk_stats_case(results, name, fn, plain, x, scores, n, check_ties):
    """One statistics-inside case of K4 or of K5 from logits (``fn``, with
    ``plain`` its plain version) on raw logits ``x`` [B*K, V]."""
    import torch

    from multimodalvc_tpu_torch.ops.topk import _candidates, row_stats

    r = x.shape[0]
    b = scores.shape[0]

    def run():
        m, ls = torch.empty(r, device=DEV), torch.empty(r, device=DEV)
        return (*fn(x, None, None, scores, n, stats_out=(m, ls)), m, ls)

    got = run()
    gv, gi, m, ls = got
    want_m, want_ls = (t.reshape(r) for t in row_stats(x))
    torch.cuda.synchronize()
    if not torch.equal(m, want_m):
        raise SmokeFailure(f"{name}: row max differs from torch.amax by "
                           f"{max_err(m, want_m):.3e}")
    ls_err = max_err(ls, want_ls)
    if not ls_err <= LS_TOL:
        raise SmokeFailure(f"{name}: logsumexp {ls_err:.3e} from PyTorch's (tol {LS_TOL:g})")
    wv, wi = plain(x, m, ls, scores, n)  # the plain version on the kernel's statistics
    if not (torch.equal(gi, wi) and torch.equal(gv, wv)):
        bad = int(((gi != wi) | (gv != wv)).any(dim=1).nonzero()[0])
        raise SmokeFailure(f"{name}: selection differs from the plain version on the kernel's "
                           f"statistics at batch {bad}: {gi[bad].tolist()} vs {wi[bad].tolist()}")
    # the fully plain chain, one candidate past n to see a near tie at the cut
    wide_v, wide_i = plain(x, None, None, scores, min(n + 1, x.numel() // b))
    fv, fi = wide_v[:, :n], wide_i[:, :n]
    chain_err = max_err(gv, fv)
    chain_tol = ls_err + 2 * torch.finfo(torch.float32).eps * float(fv.abs().max())
    if not chain_err <= chain_tol:
        raise SmokeFailure(f"{name}: values {chain_err:.3e} from the plain chain "
                           f"(tol {chain_tol:.3e})")
    close = (wide_v[:, :-1] - wide_v[:, 1:]) <= chain_tol  # a gap within the tolerance
    near = torch.zeros_like(wide_i, dtype=torch.bool)
    near[:, :-1] |= close
    near[:, 1:] |= close
    differ = gi != fi
    among = (gi[:, :, None] == wide_i[:, None, :]).any(dim=2)
    if (differ & ~(near[:, :n] & among)).any():
        bad = int((differ & ~(near[:, :n] & among)).any(dim=1).nonzero()[0])
        raise SmokeFailure(f"{name}: indices differ from the plain chain at batch {bad}: "
                           f"{gi[bad].tolist()} vs {fi[bad].tolist()}")
    check_ties(fi)
    check_ties(gi)
    _same_bits(name, run, got)
    ms_planted = time_ms(lambda: fn(x, None, None, scores, n))
    x, scores = _unplanted(x, scores)
    k, v = r // b, x.shape[1]
    cand = _candidates(x, *row_stats(x), scores).reshape(b, -1)
    chain = lambda: torch.topk(  # noqa: E731
        (scores[:, :, None] + torch.log_softmax(x, dim=-1).reshape(b, k, v)).reshape(b, -1), n)
    record(results, name, max_err(gv, wv), 0.0, library=lambda: torch.topk(cand, n),
           ms=time_ms(lambda: fn(x, None, None, scores, n)), ms_planted=ms_planted,
           plain_ms=time_ms(lambda: plain(x, None, None, scores, n), iters=3),
           library_chain_ms=time_ms(chain), ls_err=ls_err, chain_err=chain_err,
           chain_near_ties_reordered=int(differ.sum()),
           **topk_bound(x, (scores,), TOPK_OPS_STATS, (gv, gi)))


def _unplanted(*like):
    """Fresh N(0, 3^2) logits (and N(0, 1) scores) of the planted inputs'
    shapes: the times of K4/K5 are taken on these, as the decode's logits
    hold no planted ties (the planted case that makes a warp take its exact
    path is timed beside them as ``ms_planted``)."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(20)
    out = [torch.randn(t.shape, generator=g, device=DEV) * (3.0 if t.ndim > 2 or i == 0 else 1.0)
           for i, t in enumerate(like)]
    return [o.to(t.dtype) for o, t in zip(out, like)]


# columns that thread 0 of a block's first 512 threads streams (f32: units
# of 4 columns, 512 apart; bf16: of 8): with more than its 4 kept keys among
# the best n, its warp must take its exact path
FIVE_IN_ONE_THREAD = [0, 1, 2, 3, 2048, 4096]


def _k4_inputs(b, k, v, g):
    """Raw logits [B*K, V] and scores with three winners in one column, rows
    that tie everywhere, a tie across blocks and a 4-way tie (2 rows x 2
    columns, batch 3: flat [3, 7, V + 3, V + 7] first)."""
    import torch

    logits = torch.randn(b * k, v, generator=g, device=DEV) * 3.0
    scores = torch.randn(b, k, generator=g, device=DEV)
    logits[0, 999], logits[1, 999], logits[3, 999] = 40.0, 39.5, 39.0  # 3 winners, 1 column
    logits[k + 3] = logits[k + 2]  # batch 1: two beams tie on every candidate
    scores[1, 3] = scores[1, 2]
    logits[2 * k, 100] = logits[2 * k, 5000] = 45.0  # batch 2: a tie within a block,
    logits[2 * k, 50000] = 45.0  # and across blocks
    logits[3 * k, 3] = logits[3 * k, 7] = 50.0  # batch 3: 4-way tie, 2 rows x 2 columns
    logits[3 * k + 1] = logits[3 * k]
    scores[3, 1] = scores[3, 0]
    if k > 16:  # among more rows a random row's best may pass the tie: lift the tied rows
        scores[3, :2] = scores[3].amax() + 4.0
    logits[4 * k + 2, FIVE_IN_ONE_THREAD] = 50.0  # batch 4: the best 6 in one thread's columns
    return logits, scores


# beams past the narrow instances' 16 (n = 2K up to 128), then the ceiling,
# ``topk_max_beams()``: the wide instance; then past it (the ceiling + 1
# too), the select form.  Every width up to the ceiling (8 and 12 too) is
# also timed on the select form (``select_ms``)
WIDE_TOPK_BEAMS, SELECT_TOPK_BEAMS = (17, 32, 64), (128, 200)


def check_topk(results, wide=True):
    """K4 at the serving shapes [8*5, 128256] and [48*5, 128256], n = 2K =
    10, with three winners in one column, rows that tie everywhere, and ties
    across blocks: first with the statistics inside the kernel (the decode
    step's call; see LS_TOL), then given (the JAX contract: indices
    identical, values within 1e-6); then beams 8 and 12 (n = 16, 24: the
    kernel for up to 16 rows a batch element; beam 5 takes its own) at batch
    8, statistics inside; with ``wide``, beams 17, 32 and 64 (n = 34, 64,
    128: the wide instance) and the ceiling ``topk_max_beams()`` the same
    way, then the select form's ceiling + 1, 128 and 200; each width up to
    the ceiling also on the select form; with ``wide``, the seq2seq shape
    (``check_topk_small_vocab``).  ``library_ms`` is
    ``torch.topk`` on the prebuilt candidate row; ``library_chain_ms`` the
    eager ``log_softmax`` + add + ``torch.topk``."""
    import torch

    from multimodalvc_tpu_torch.ops import topk as tk
    from multimodalvc_tpu_torch.ops.topk import (
        _candidates,
        beam_topk_columns,
        beam_topk_columns_plain,
        row_stats,
        topk_max_beams,
    )

    g = torch.Generator(device=DEV).manual_seed(2)
    k, v, n = BEAMS, 128256, 2 * BEAMS

    def ties(wi):
        if wi[3, :4].tolist() != [3, 7, v + 3, v + 7]:
            raise SmokeFailure(f"beam_topk_columns: tie order {wi[3, :4].tolist()}")

    inputs = {b: _k4_inputs(b, k, v, g) for b in (BATCH, 48)}
    for b, (logits, scores) in inputs.items():
        _topk_stats_case(results, f"beam_topk_columns/{b * k}x{v}", beam_topk_columns,
                         beam_topk_columns_plain, logits, scores, n, ties)
    for b, (logits, scores) in inputs.items():
        row_max, row_ls = row_stats(logits)
        run = lambda: beam_topk_columns(logits, row_max, row_ls, scores, n)  # noqa: E731
        plain = lambda: beam_topk_columns_plain(logits, row_max, row_ls, scores, n)  # noqa: E731
        (gv, gi), (wv, wi) = run(), plain()
        if not torch.equal(gi, wi):
            bad = int((gi != wi).any(dim=1).nonzero()[0])
            raise SmokeFailure(f"beam_topk_columns: indices differ at batch {bad}: "
                               f"{gi[bad].tolist()} vs {wi[bad].tolist()}")
        ties(wi)
        _same_bits(f"beam_topk_columns/stats_given/{b * k}x{v}", run, (gv, gi))
        ms_planted = time_ms(run)
        logits, scores = _unplanted(logits, scores)
        row_max, row_ls = row_stats(logits)
        cand = _candidates(logits, row_max, row_ls, scores).reshape(b, -1)
        record(results, f"beam_topk_columns/stats_given/{b * k}x{v}", max_err(gv, wv), 1e-6,
               library=lambda: torch.topk(cand, n), ms=time_ms(run), ms_planted=ms_planted,
               plain_ms=time_ms(plain, iters=3),
               **topk_bound(logits, (row_max, row_ls, scores), 4, (gv, gi)))
    # the kernel for up to 16 rows, with 16-byte copies; then the wide one
    for beams in (8, 12) + (WIDE_TOPK_BEAMS + (topk_max_beams(), topk_max_beams() + 1)
                            + SELECT_TOPK_BEAMS if wide else ()):
        logits, scores = _k4_inputs(BATCH, beams, v, g)
        _topk_stats_case(results, f"beam_topk_columns/beam{beams}/{BATCH * beams}x{v}",
                         beam_topk_columns, beam_topk_columns_plain, logits, scores, 2 * beams,
                         ties)
        if beams <= topk_max_beams():  # the same on the select form
            results[-1]["select_ms"] = _form_ms(logits, scores, 2 * beams,
                                                tk.select_plan(BATCH, beams, v))
            print(f"  the same on the select form: ms={results[-1]['select_ms']:.4f}")
        del logits, scores
    if wide:  # a case older trees never ran (the --beam5 comparison skips it)
        check_topk_small_vocab(results)


SEQ2SEQ_VOCAB = 1000  # the seq2seq decoder's default vocabulary (nn/seq2seq.py)


def _k4_small_vocab_inputs(b, k, v, g):
    """Raw logits [B*K, V] and scores for a vocabulary of a few blocks (V =
    1000: 8 blocks of 128 columns): three winners in one column, two beams
    tied on every candidate, a tie within a block and across blocks, a
    4-way tie (2 rows x 2 columns, batch 3: flat [3, 7, V + 3, V + 7]
    first), the best 6 of batch 4 in one warp's columns."""
    import torch

    logits = torch.randn(b * k, v, generator=g, device=DEV) * 3.0
    scores = torch.randn(b, k, generator=g, device=DEV)
    logits[0, v - 1], logits[1, v - 1], logits[3, v - 1] = 40.0, 39.5, 39.0
    logits[k + 3] = logits[k + 2]
    scores[1, 3] = scores[1, 2]
    logits[2 * k, 100] = logits[2 * k, 120] = logits[2 * k, 900] = 45.0
    logits[3 * k, 3] = logits[3 * k, 7] = 50.0
    logits[3 * k + 1] = logits[3 * k]
    # over 1000 columns a random row's best log-prob is only ~ -4: lift the
    # tied rows' scores past every other beam's
    scores[3, :2] = scores[3].amax() + 8.0
    logits[4 * k + 2, :6] = 50.0
    scores[4, 2] = scores[4].amax() + 8.0
    return logits, scores


def check_topk_small_vocab(results):
    """K4 at the seq2seq decode's shape [8*5, 1000], n = 10, statistics
    inside (the decode step's call) and given, with the ties of
    ``_k4_small_vocab_inputs``: the first vocabulary other than LLaMA's on
    the card (``topk_plan`` covers it: a cluster of 8 blocks of 128
    columns, the last of 104, each block's range whole in its ring)."""
    import torch

    from multimodalvc_tpu_torch.ops import topk as tk
    from multimodalvc_tpu_torch.ops.topk import (
        _candidates,
        beam_topk_columns,
        beam_topk_columns_plain,
        row_stats,
    )

    g = torch.Generator(device=DEV).manual_seed(21)
    k, v, n = BEAMS, SEQ2SEQ_VOCAB, 2 * BEAMS

    def ties(wi):
        if wi[3, :4].tolist() != [3, 7, v + 3, v + 7]:
            raise SmokeFailure(f"beam_topk_columns V={v}: tie order {wi[3, :4].tolist()}")
        if sorted(wi[4, :6].tolist()) != [2 * v + j for j in range(6)]:
            raise SmokeFailure(f"beam_topk_columns V={v}: batch 4's best 6 {wi[4, :6].tolist()}")

    print(f"  topk_plan({BATCH}, {k}, {v}, {n}) = {tk.topk_plan(BATCH, k, v, n)}")
    logits, scores = _k4_small_vocab_inputs(BATCH, k, v, g)
    _topk_stats_case(results, f"beam_topk_columns/{BATCH * k}x{v}", beam_topk_columns,
                     beam_topk_columns_plain, logits, scores, n, ties)
    logits, scores = _k4_small_vocab_inputs(BATCH, k, v, g)
    row_max, row_ls = row_stats(logits)
    run = lambda: beam_topk_columns(logits, row_max, row_ls, scores, n)  # noqa: E731
    plain = lambda: beam_topk_columns_plain(logits, row_max, row_ls, scores, n)  # noqa: E731
    (gv, gi), (wv, wi) = run(), plain()
    if not torch.equal(gi, wi):
        bad = int((gi != wi).any(dim=1).nonzero()[0])
        raise SmokeFailure(f"beam_topk_columns V={v}: indices differ at batch {bad}: "
                           f"{gi[bad].tolist()} vs {wi[bad].tolist()}")
    ties(wi)
    _same_bits(f"beam_topk_columns/stats_given/{BATCH * k}x{v}", run, (gv, gi))
    logits, scores = _unplanted(logits, scores)
    row_max, row_ls = row_stats(logits)
    cand = _candidates(logits, row_max, row_ls, scores).reshape(BATCH, -1)
    record(results, f"beam_topk_columns/stats_given/{BATCH * k}x{v}", max_err(gv, wv), 1e-6,
           library=lambda: torch.topk(cand, n), ms=time_ms(run), plain_ms=time_ms(plain, iters=3),
           **topk_bound(logits, (row_max, row_ls, scores), 4, (gv, gi)))


def _form_ms(logits, scores, n, plan, iters=None) -> float:
    """K4 (statistics inside) on ``plan`` in place of ``topk_plan``'s: its
    selection equal to the plain version's on its own statistics, and its
    ms."""
    import torch

    from multimodalvc_tpu_torch.ops import topk as tk

    r = logits.shape[0]
    m, ls = torch.empty(r, device=DEV), torch.empty(r, device=DEV)
    with mock.patch.object(tk, "topk_plan", lambda *a: plan):
        got = tk.beam_topk_columns(logits, None, None, scores, n, stats_out=(m, ls))
        want = tk.beam_topk_columns_plain(logits, m, ls, scores, n)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise SmokeFailure(f"beam_topk_columns on {plan}: differs from plain")
        kw = {} if iters is None else {"iters": iters}
        return time_ms(lambda: tk.beam_topk_columns(logits, None, None, scores, n), **kw)


def topk_bound(x, small, ops_per_value, out) -> dict:
    """K4/K5: one read of the candidates' source ``x`` and of the per-row
    scalars, the outputs written once; ``ops_per_value`` f32 operations on
    every value (the normalise, the add, the clamp; with the statistics
    inside also their max, subtract, exp and add), outside the tensor cores."""
    return bound(nbytes(x, *small, *out), ops_per_value * x.numel(), F32_FLOPS)


def _planted(b, k, v, g, scale=3.0):
    """Log-probs [B, K, V] f32 with ties across rows and across blocks, and
    -1e7 "banned" entries (what the n-gram block writes)."""
    import torch

    logp = torch.randn(b, k, v, generator=g, device=DEV) * scale - 12.0
    scores = torch.randn(b, k, generator=g, device=DEV)
    ban = torch.rand(b, k, v, generator=g, device=DEV) < 0.01
    logp = logp.masked_fill(ban, -1.0e7)
    logp[0, 0, 999] = logp[0, 2, 999] = 9.0  # batch 0: a tie across rows, one column
    scores[0, 2] = scores[0, 0]
    logp[1, 3, 100] = logp[1, 3, 5000] = 8.0  # batch 1: a tie within a block,
    logp[1, 3, 50000] = 8.0  # and across blocks
    logp[2, 1] = logp[2, 0]  # batch 2: two beams tie on every candidate
    scores[2, 1] = scores[2, 0]
    logp[3, 4, :] = -1.0e7  # batch 3: a beam with every token banned
    logp[3, 0, 2047] = logp[3, 0, 2048] = 7.5  # and ties across 2048 columns
    logp[3, 1, 8015] = logp[3, 1, 8016] = 7.5  # and a block boundary
    logp[3, 2, FIVE_IN_ONE_THREAD] = 9.5  # and the best 6 in one thread's columns
    return logp, scores


# K5 cases: (key, name, batch, V, log-prob type or None for raw logits,
# statistics inside, beams)
BEAM_TOPK_CASES = [
    ("f32", "logp/8x5x128256", 8, 128256, "f32", False, BEAMS),
    ("f32", "logp/4x5x128256", 4, 128256, "f32", False, BEAMS),
    ("bf16", "logp_bf16/4x5x128256", 4, 128256, "bf16", False, BEAMS),
    ("v_odd", "logp/4x5x128250", 4, 128250, "f32", False, BEAMS),  # 4-byte copies
    ("v_odd", "logp_bf16/4x5x128250", 4, 128250, "bf16", False, BEAMS),  # no ring: global loads
    ("from_logits_stats", "from_logits/240x128256", 48, 128256, None, True, BEAMS),
    ("from_logits_v_odd_stats", "from_logits/240x128250", 48, 128250, None, True, BEAMS),
    ("from_logits", "from_logits/stats_given/240x128256", 48, 128256, None, False, BEAMS),
    ("from_logits_v_odd", "from_logits/stats_given/240x128250", 48, 128250, None, False, BEAMS),
    # the wide instance: the n-gram step's log-probs past 16 beams
    ("wide", "logp/beam32/8x32x128256", 8, 128256, "f32", False, 32),
    ("wide", "logp/beam64/8x64x128256", 8, 128256, "f32", False, 64),
    ("wide", "logp_bf16/beam17/8x17x128250", 8, 128250, "bf16", False, 17),
    ("wide", "from_logits/beam17/136x128250", 8, 128250, None, True, 17),  # 4-byte loads
    # the select form (past the wide instance): f32 and bf16 log-probs, raw
    # logits with the statistics inside and given
    ("select", "logp/beam128/8x128x128256", 8, 128256, "f32", False, 128),
    ("select", "logp_bf16/beam128/8x128x128250", 8, 128250, "bf16", False, 128),
    ("select", "from_logits/beam128/1024x128250", 8, 128250, None, True, 128),
    ("select", "from_logits/stats_given/beam128/1024x128256", 8, 128256, None, False, 128),
]


def check_beam_topk(results, only=None):
    """K5 (BEAM_TOPK_CASES) at the n-gram phase's shape [8, 5, 128256] and
    the JAX selftest's [4, 5, 128256], f32 and bf16 log-probs with planted
    ties and bans (and at V = 128250, whose rows take the unaligned paths);
    from raw logits at [240, 128256] and [240, 128250] (V % 8
    != 0), with the statistics inside (see LS_TOL) and given; n = 10; and
    the wide instance's log-probs at beams 32 and 64 (f32) and 17 (bf16, V =
    128250) and its raw logits at beam 17, V = 128250, statistics inside;
    n = 2K.  Indices must be identical; values within 1e-6 where
    given.
    ``library_ms`` is ``torch.topk`` on the prebuilt candidate row, without
    the add that K5 fuses."""
    import torch

    from multimodalvc_tpu_torch.ops.topk import (
        _candidates,
        beam_topk,
        beam_topk_from_logits,
        beam_topk_from_logits_plain,
        beam_topk_plain,
        row_stats,
    )

    g = torch.Generator(device=DEV).manual_seed(10)
    for key, name, b, v, dtype, stats, k in BEAM_TOPK_CASES:
        if only is not None and key != only:
            continue
        n = 2 * k
        logp, scores = _planted(b, k, v, g)
        if dtype is None:
            x = (logp.reshape(b * k, v) * 0.25).contiguous()  # raw logits
            x[2 * k, 321] = x[2 * k + 1, 321] = 60.0  # batch 2: the tied rows' best, first
        if stats:
            def ties(fi, v=v):
                if fi[2, :2].tolist() != [321, v + 321]:
                    raise SmokeFailure(f"beam_topk {name}: tie order {fi[2, :2].tolist()}")

            _topk_stats_case(results, f"beam_topk/{name}", beam_topk_from_logits,
                             beam_topk_from_logits_plain, x, scores, n, ties)
            continue
        if dtype is not None:
            logp = logp.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
            run = lambda: beam_topk(logp, scores, n)  # noqa: E731
            plain = lambda: beam_topk_plain(logp, scores, n)  # noqa: E731
            cand = (logp.float() + scores[:, :, None]).reshape(b, -1)
            small, ops, x = (scores,), 2, logp
        else:
            row_max, row_ls = row_stats(x)
            run = lambda: beam_topk_from_logits(x, row_max, row_ls, scores, n)  # noqa: E731
            plain = lambda: beam_topk_from_logits_plain(x, row_max, row_ls, scores, n)  # noqa: E731
            small, ops = (row_max, row_ls, scores), 4
        (gv, gi), (wv, wi) = run(), plain()
        torch.cuda.synchronize()
        if not torch.equal(gi, wi):
            bad = int((gi != wi).any(dim=1).nonzero()[0])
            raise SmokeFailure(f"beam_topk {name}: indices differ at batch {bad}: "
                               f"{gi[bad].tolist()} vs {wi[bad].tolist()}")
        if dtype is not None and wi[0, :2].tolist() != [999, 2 * v + 999]:
            raise SmokeFailure(f"beam_topk {name}: tie order {wi[0, :2].tolist()}")
        _same_bits(f"beam_topk/{name}", run, (gv, gi))
        ms_planted = time_ms(run)
        if dtype is not None:
            logp, scores = _unplanted(logp, scores)
            logp = logp - 12.0  # log-probs: below 0, as _planted's
            cand = (logp.float() + scores[:, :, None]).reshape(b, -1)
            small, x = (scores,), logp
        else:
            x, scores = _unplanted(x, scores)
            row_max, row_ls = row_stats(x)
            cand = _candidates(x, row_max, row_ls, scores).reshape(b, -1)
            small = (row_max, row_ls, scores)
        record(results, f"beam_topk/{name}", max_err(gv, wv), 1e-6,
               library=lambda: torch.topk(cand, n), ms=time_ms(run), ms_planted=ms_planted,
               plain_ms=time_ms(plain, iters=3), **topk_bound(x, small, ops, (gv, gi)))


def check_gather_rows(results):
    """K6, bf16, exact: first one decode step's reorder of the gather
    cache's 56 generated-KV leaves [40, 16, 8, 128] in one launch
    (``gather_rows_many``, the serving path), and of the full cache's 56
    [40, 8, 146, 128], by a permutation; then single leaves with repeated
    and permuted source rows, the gather reorder's and the full cache's leaf
    and [B*K, 64, 8, 128] for batch 8 and 48.  Times with a cold L2 (``time_cold``): each call reads
    its own copy of the leaves and writes its own outputs, rotated over at
    least COLD_BYTES, over a window of TAIL_BYTES.  ``library_ms`` is
    ``torch.index_select`` a leaf."""
    import torch

    from multimodalvc_tpu_torch.ops.beam_gather import (
        gather_rows,
        gather_rows_many,
        gather_rows_many_plain,
        gather_rows_plain,
    )

    g = torch.Generator(device=DEV).manual_seed(6)

    def source(rows, repeats=True):
        perm = torch.randperm(rows, generator=g, device=DEV).to(torch.int32)
        src = perm.clone()
        if repeats:  # a permuted half, then repeats of it
            src[rows // 2:] = perm[: rows - rows // 2]
        return src

    rows = BATCH * BEAMS
    for leaves, shape in ((56, (SHORT_TOKENS, 8, 128)), (56, (8, 146, 128))):
        xs = [torch.randn(rows, *shape, generator=g, device=DEV).to(torch.bfloat16)
              for _ in range(leaves)]
        src = source(rows, repeats=False)  # every byte read once: the bound of a permutation
        got, want = gather_rows_many(xs, src), gather_rows_many_plain(xs, src)
        name = f"gather_rows/step{leaves}x" + "x".join(str(i) for i in (rows, *shape))
        if not all(torch.equal(a, c) for a, c in zip(got, want)):
            raise SmokeFailure(f"{name}: rows differ")
        _same_bits(name, lambda: tuple(gather_rows_many(xs, src)), tuple(got))
        sets = [xs] + [[x.clone() for x in xs]
                       for _ in range(math.ceil(COLD_BYTES / nbytes(*xs)) - 1)]
        run = [functools.partial(gather_rows_many, c, src) for c in sets]
        plain = [functools.partial(gather_rows_many_plain, c, src) for c in sets]
        library = [functools.partial(lambda c: [torch.index_select(x, 0, src) for x in c], c)
                   for c in sets]
        moved = 2 * nbytes(*got) + nbytes(src)
        record(results, name, 0.0, 0.0, ms=time_cold(run, moved, True),
               plain_ms=time_cold(plain, moved, True), library_ms=time_cold(library, moved, True),
               copies=len(sets), **gather_bound(src, *got))
        del xs, got, want, sets, run, plain, library
        torch.cuda.empty_cache()
    for rows, shape in ((8 * BEAMS, (SHORT_TOKENS, 8, 128)), (8 * BEAMS, (8, 146, 128)),
                        (8 * BEAMS, (64, 8, 128)), (48 * BEAMS, (64, 8, 128))):
        x = torch.randn(rows, *shape, generator=g, device=DEV).to(torch.bfloat16)
        src = source(rows)
        got = gather_rows(x, src)
        name = "x".join(str(i) for i in (rows, *shape))
        if not torch.equal(got, gather_rows_plain(x, src)):
            raise SmokeFailure(f"gather_rows [{name}]: rows differ")
        _same_bits(f"gather_rows/{name}", lambda: gather_rows(x, src), got)
        copies = [x] + [x.clone() for _ in range(math.ceil(COLD_BYTES / nbytes(x)) - 1)]
        run = [functools.partial(gather_rows, c, src) for c in copies]
        plain = [functools.partial(gather_rows_plain, c, src) for c in copies]
        library = [functools.partial(torch.index_select, c, 0, src) for c in copies]
        moved = 2 * nbytes(got) + nbytes(src)
        record(results, f"gather_rows/{name}", 0.0, 0.0, ms=time_cold(run, moved, True),
               plain_ms=time_cold(plain, moved, True), library_ms=time_cold(library, moved, True),
               copies=len(copies), **gather_bound(src, got))
        del x, copies, run, plain, library


# K9's square sums against the plain version's, relative: both sum f32
# squares, in other orders (the kernel by 16 KB chunks, then leaf by leaf)
SQUARE_RTOL = 1e-5


def nollm_trained_shapes() -> list:
    """The shapes of the NoLLM head's trained leaves (``SpeechTask("nollm")``
    at full width, ``speech_config()``), from the module built on the meta
    device: 485 leaves, 123.96M elements."""
    import torch

    from multimodalvc_tpu_torch.runtime.trainer import trainable_mask
    from multimodalvc_tpu_torch.tasks import SpeechTask, SpeechTaskConfig

    task = SpeechTask(SpeechTaskConfig(variant="nollm"), speech_config(), dtype=torch.bfloat16,
                      device="meta")
    named = dict(task.module.named_parameters())
    mask = trainable_mask(named, task.frozen_patterns())
    return [tuple(p.shape) for n, p in named.items() if mask[n]]


def adamw_leaves(shapes, grad_dtype, copy_dtype, seed, misalign=()):
    """Seeded operands of K9 at ``shapes``: gradients of ``grad_dtype`` (~1e-3,
    so that the NoLLM's norm ~ 10 engages a clip of 1), f32 masters, moments
    (v > 0), module copies of ``copy_dtype`` (None: no copies).  The leaves
    at the indices ``misalign`` start 4 bytes past a 16-byte boundary in
    every operand (views one element into a larger buffer)."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed)

    def make(shape, dtype, scale, i, positive=False):
        n = math.prod(shape)
        off = (4 // torch.empty((), dtype=dtype).element_size()) if i in misalign else 0
        x = torch.empty(n + off, device=DEV).uniform_(0, 1, generator=g) if positive else \
            torch.randn(n + off, generator=g, device=DEV)
        return (scale * x).to(dtype)[off:].view(shape)

    out = {"grads": [], "masters": [], "mu": [], "nu": [], "copies": []}
    for i, s in enumerate(shapes):
        out["grads"].append(make(s, grad_dtype, 1e-3, i))
        out["masters"].append(make(s, torch.float32, 0.02, i))
        out["mu"].append(make(s, torch.float32, 1e-4, i))
        out["nu"].append(make(s, torch.float32, 1e-7, i, positive=True))
        if copy_dtype is not None:
            out["copies"].append(out["masters"][-1].to(copy_dtype) if i not in misalign else
                                 make(s, copy_dtype, 0.0, i).copy_(out["masters"][-1]))
    if copy_dtype is None:
        out["copies"] = None
    return out


def host_ms(fn, iters: int = 10) -> float:
    """The median host time of one call of ``fn`` on an idle card (its
    launches enqueued, not run)."""
    import torch

    times = []
    for _ in range(iters + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * sorted(times[2:])[iters // 2]


def adamw_bound(leaves) -> dict:
    """K9's update: each gradient read once, the master and both moments read
    and written, each copy written."""
    moved = sum(nbytes(*leaves[k]) for k in ("grads", "copies") if leaves[k] is not None) \
        + 2 * sum(nbytes(*leaves[k]) for k in ("masters", "mu", "nu"))
    return bound(moved)


# the update cases: (name, gradient dtype, copy dtype, clip engaged, weight
# decay, plateau scale, update count); the first is the NoLLM step's
ADAMW_CASES = [
    ("nollm_step", "bfloat16", "bfloat16", True, 0.01, 1.0, 1),
    ("no_clip_scaled", "bfloat16", "bfloat16", False, 0.0, 0.5, 3),
    ("f32_no_copy", "float32", None, False, 1e-4, 1.0, 7),
]


def check_adamw(results, shapes=None):
    """K9 at the NoLLM head's 485 trained leaves (``nollm_trained_shapes``)
    plus a leaf of 3 elements (under 16 bytes) and, in the update, one whose
    every operand starts 4 bytes past a 16-byte boundary (the scalar path):
    - ``square_sums_many``: each leaf's sum within SQUARE_RTOL of the plain
      version's, the totals and the norm too, the finite flag (and false with
      one inf planted), two calls bit for bit, one launch a call;
    - ``adamw_many_`` in ADAMW_CASES (the NoLLM step: bf16 gradients and
      copies, the clip engaged; no clip at a plateau scale of 0.5; f32
      gradients and no copies, the GAN trainers' AdamW): given the plain
      version's norm, the masters, both moments and the copies equal the plain
      version's on the card bit for bit; one launch a call.
    The leaves move 3.47 GB a call, so each launch finds them cold.
    ``library_ms``: ``torch.optim.AdamW(fused=True)`` over the same leaves
    (f32 gradients, no clip, no copies: the port never calls it); the square
    sums' is ``torch._foreach_norm``.  ``host_ms``: the wrapper's host time a
    call (its table and launch)."""
    import torch

    from multimodalvc_tpu_torch.ops import adamw

    shapes = (nollm_trained_shapes() + [(3,)]) if shapes is None else shapes
    grads = adamw_leaves(shapes, torch.bfloat16, None, 26)["grads"]
    plain = adamw.square_sums_many_plain(grads)
    adamw.square_sums_many.launches = 0
    got = adamw.square_sums_many(grads)
    again = adamw.square_sums_many(grads)
    if adamw.square_sums_many.launches != 2:
        raise SmokeFailure(f"square_sums_many: {adamw.square_sums_many.launches} launches in "
                           "2 calls")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SmokeFailure("square_sums_many: two calls differ")
    rel = lambda a, b: float(((a.double() - b.double()).abs()  # noqa: E731
                              / b.double().abs().clamp_min(1e-30)).max())
    err = max(rel(got[0], plain[0]), rel(got[1][:1], plain[1][:1]),
              rel(torch.sqrt(got[1][0]), torch.sqrt(plain[1][0])))
    if not bool(got[2]) or float(got[1][1:].abs().sum()) != 0.0:
        raise SmokeFailure(f"square_sums_many: finite {bool(got[2])}, totals {got[1].tolist()}")
    planted = grads[len(grads) // 2].view(-1)
    keep = planted[7].clone()
    planted[7] = float("inf")
    if bool(adamw.square_sums_many(grads)[2]):
        raise SmokeFailure("square_sums_many: an inf gradient counted finite")
    planted[7] = keep
    n = sum(g.numel() for g in grads)
    record(results, f"adamw/square_sums/{len(shapes)}_leaves", err, SQUARE_RTOL,
           ms=time_ms(lambda: adamw.square_sums_many(grads), iters=20),
           plain_ms=time_ms(lambda: adamw.square_sums_many_plain(grads), iters=3, warmup=1),
           library_ms=time_ms(lambda: torch._foreach_norm(grads), iters=20),
           host_ms=host_ms(lambda: adamw.square_sums_many(grads)), elements=n,
           leaves=len(shapes), **bound(nbytes(*grads)))
    norm = torch.sqrt(plain[1][0])
    del grads, got, again, plain
    for name, gdt, cdt, clipped, wd, scale, count in ADAMW_CASES:
        gdt, cdt = getattr(torch, gdt), None if cdt is None else getattr(torch, cdt)
        leaves = adamw_leaves(shapes + [(1031,)], gdt, cdt, 27, misalign=[len(shapes)])
        twin = {k: None if v is None else [t.clone() for t in v] for k, v in leaves.items()}
        hyper = dict(count=count, lr=2e-4, betas=(0.9, 0.98), eps=1e-8, weight_decay=wd,
                     scale=scale, clip=1.0 if clipped else float(norm) * 2.0, norm=norm)
        args = lambda t: (t["masters"], t["grads"], t["mu"], t["nu"])  # noqa: E731
        adamw.adamw_many_.launches = 0
        adamw.adamw_many_(*args(leaves), copies=leaves["copies"], **hyper)
        adamw.adamw_many_plain(*args(twin), copies=twin["copies"], **hyper)
        if adamw.adamw_many_.launches != 1:
            raise SmokeFailure(f"adamw_many_ {name}: {adamw.adamw_many_.launches} launches")
        differ = [(k, i) for k in ("masters", "mu", "nu", "copies") if leaves[k] is not None
                  for i, (a, b) in enumerate(zip(leaves[k], twin[k])) if not torch.equal(a, b)]
        if differ:
            k, i = differ[0]
            raise SmokeFailure(f"adamw_many_ {name}: {len(differ)} tensors differ from the plain "
                               f"version, first {k}[{i}] {tuple(leaves[k][i].shape)} max err "
                               f"{max_err(leaves[k][i], twin[k][i]):.3e}")
        del twin
        def call(leaves=leaves, hyper=hyper):
            adamw.adamw_many_(*args(leaves), copies=leaves["copies"], **hyper)

        extra = {"library_ms": None}
        if name == ADAMW_CASES[0][0]:
            params = [torch.nn.Parameter(t.clone()) for t in leaves["masters"]]
            for p, g in zip(params, leaves["grads"]):
                p.grad = g.float()
            library = torch.optim.AdamW(params, lr=2e-4, betas=(0.9, 0.98), eps=1e-8,
                                        weight_decay=wd, fused=True)
            extra.update(host_ms=host_ms(call), library_ms=time_ms(library.step, iters=20),
                         plain_ms=time_ms(lambda: adamw.adamw_many_plain(
                             *args(leaves), copies=leaves["copies"], **hyper), iters=3, warmup=1))
            del params, library
        record(results, f"adamw/update/{name}", 0.0, 0.0, ms=time_ms(call, iters=20),
               elements=sum(p.numel() for p in leaves["masters"]), leaves=len(shapes) + 1,
               **extra, **adamw_bound(leaves))
        del leaves
        torch.cuda.empty_cache()


# A rotation of weight copies at least this large (two 50 MB L2s) finds
# every copy cold at its next use, as the decode does, which streams ~3.2 GB
# of int8 weight a step.
COLD_BYTES = 100e6


# A window that moves at least this many bytes leaves at most 2% of its
# writes in the L2 (50 MB) when its end is recorded.
TAIL_BYTES = 2.5e9


def time_cold(calls, moved: float = 0.0, keep: bool = False) -> float:
    """``time_ms`` of ``calls`` taken in turn, each copy used once a round.
    With ``keep``, each call's output lives until the next call of its copy,
    so the outputs too rotate over as many buffers as the inputs; with
    ``moved`` (bytes a call reads and writes), enough calls that the window
    moves TAIL_BYTES."""
    import collections

    it = itertools.cycle(calls)
    held = collections.deque(maxlen=len(calls) if keep else 0)
    iters = max(10, 2 * len(calls), math.ceil(TAIL_BYTES / moved) if moved else 0)
    # the held outputs are allocated before the window (an allocation inside
    # it can wait for the device)
    return time_ms(lambda: held.append(next(it)()), iters=iters,
                   warmup=len(calls) + 2 if keep else 2)


def int8_library(x, w_q, w_s):
    """K7's library call: ``torch._weight_int8pack_mm`` (bf16 x, int8 [N, K],
    bf16 scales), its operands built here, outside the timed call."""
    import torch

    w_t, s = w_q.T.contiguous(), w_s.to(torch.bfloat16)
    return lambda: torch._weight_int8pack_mm(x, w_t, s)


def int4_library(x, packed, scale):
    """K8's library call: ``torch._weight_int4pack_mm`` on the same weights,
    converted once: nibbles offset by 8 (its unsigned form), zero points 0,
    group 128."""
    import torch

    from multimodalvc_tpu_torch.ops.int8_matmul import INT4_GROUP

    w8 = packed.to(torch.int32)
    u = (torch.cat([((w8 & 0xF) ^ 8) - 8, w8 >> 4], dim=0).T + 8).to(torch.uint8)  # [N, K]
    w_t = torch._convert_weight_to_int4pack((u[:, ::2] << 4 | u[:, 1::2]).contiguous(), 8)
    sz = torch.stack([scale, torch.zeros_like(scale)], dim=-1).to(torch.bfloat16).contiguous()
    return lambda: torch._weight_int4pack_mm(x, w_t, INT4_GROUP, sz)


def _quant_case(results, name, quantize, kernel, plain, library, rows, d_in, d_out, tol, g):
    """One K7/K8 shape: f32 outputs against the plain version; two launches
    must give the same bits.  ``ms``, ``plain_ms`` and ``library_ms`` rotate
    over copies of the weights that together exceed COLD_BYTES;
    ``ms_l2_warm`` repeats one copy.  A library call that refuses the case
    leaves ``library_ms`` None and its error in ``library_error``."""
    import torch

    w = torch.randn(d_in, d_out, generator=g, device=DEV) * 0.02
    w_q, w_s = quantize(w)
    del w
    x = torch.randn(rows, d_in, generator=g, device=DEV).to(torch.bfloat16)
    copies = max(1, math.ceil(COLD_BYTES / nbytes(w_q, w_s)))
    weights = [(w_q, w_s)] + [(w_q.clone(), w_s.clone()) for _ in range(copies - 1)]
    f32 = torch.float32
    calls = [functools.partial(kernel, x, a, b, out_dtype=f32) for a, b in weights]
    plains = [functools.partial(plain, x, a, b, out_dtype=f32) for a, b in weights]
    case = f"{name}/{rows}x{d_in}x{d_out}"
    got, want = calls[0](), plains[0]()
    if not torch.equal(got, calls[0]()):
        raise SmokeFailure(f"{case}: two launches on the same inputs differ")
    # the output's bits, to hold one kernel against another build of it
    print(f"  {case}: output sha256 {hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]}")
    extra = dict(ms=time_cold(calls), ms_l2_warm=time_ms(calls[0]), plain_ms=time_cold(plains),
                 weight_copies=copies, **bound(nbytes(x, w_q, w_s, got), 2 * rows * d_in * d_out))
    try:
        libs = [library(x, a, b) for a, b in weights]
        extra.update(library_max_abs_err=max_err(libs[0](), want), library_ms=time_cold(libs))
    except RuntimeError as e:  # the op refuses these shapes or types on this card
        extra.update(library_ms=None, library_error=str(e).splitlines()[0][:200])
        print(f"  {case}: library call refused: {extra['library_error']}")
    extra["bound_share"] = extra["bound_ms"] / extra["ms"]
    record(results, case, max_err(got, want), tol, **extra)
    del weights, calls, plains
    torch.cuda.empty_cache()


# (d_in, d_out) of the trunk's projections and the tied unembed
TRUNK_SHAPES = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072), (3072, 128256)]


def check_int8_matmul(results):
    """K7 at the decode shapes of the LLaMA-3.2-3B trunk (3072->3072 q/o,
    3072->1024 k/v, 3072->8192 gate/up, 8192->3072 down) and the tied unembed
    (3072->128256) at batch 8 (40 rows, the serving phases) and 48 (240
    rows).  Tolerance 1e-2 absolute on f32 outputs (the JAX selftest's);
    the same bits from two launches (the split-K sum keeps its order)."""
    import torch

    from multimodalvc_tpu_torch.ops import int8_matmul as q

    g = torch.Generator(device=DEV).manual_seed(7)
    for rows in (40, 240):
        for d_in, d_out in TRUNK_SHAPES:
            _quant_case(results, "int8_matmul", q.quantize_kernel, q.int8_matmul,
                        q.int8_matmul_plain, int8_library, rows, d_in, d_out, 1e-2, g)


def check_int4_matmul(results):
    """K8 at the decode shapes of check_int8_matmul (40 and 240 rows) and the
    JAX selftest shape (240 x 1024 -> 2048), tolerance 5e-2 (the JAX
    selftest's), the same bits from two launches; then its dequantization
    bit for bit (int4_exact)."""
    import torch

    from multimodalvc_tpu_torch.ops import int8_matmul as q

    g = torch.Generator(device=DEV).manual_seed(8)
    for rows, d_in, d_out in [(rows, d_in, d_out) for rows in (40, 240)
                              for d_in, d_out in TRUNK_SHAPES] + [(240, 1024, 2048)]:
        _quant_case(results, "int4_matmul", q.quantize_kernel_int4, q.int4_matmul,
                    q.int4_matmul_plain, int4_library, rows, d_in, d_out, 5e-2, g)
    int4_exact(results, g)


def int4_exact(results, g):
    """K8's in-register dequantization, bit for bit: one-hot x rows (x[i,
    k_i] = 1) pick logical weight rows k_i, so the f32 output must equal
    those rows of ``dequantize_int4``.  The packed weight holds every byte,
    so all 16 nibbles in both halves; column 1 is all zero with the scale
    floor 1e-12 / 7; the other scales are f32 spread over 2^-40..2^20.  At
    512 rows (64-row tiles, split-K) two launches pick every logical row,
    the low-nibble half then the high; at 40 rows (five n8 tiles) one picks
    rows spread over both halves."""
    import torch

    from multimodalvc_tpu_torch.ops import int8_matmul as q

    d_in, d_out = 1024, 1024
    half = d_in // 2
    packed = torch.randint(-128, 128, (half, d_out), generator=g, device=DEV).to(torch.int8)
    packed[:256, 0] = torch.arange(-128, 128, device=DEV).to(torch.int8)
    packed[:, 1] = 0
    exponent = torch.rand(d_in // q.INT4_GROUP, d_out, generator=g, device=DEV) * 60 - 40
    scale = torch.exp2(exponent).float()
    scale[:, 1] = torch.tensor(1e-12, device=DEV) * torch.tensor(1 / 7, device=DEV)
    want_rows = q.dequantize_int4(packed, scale).float()
    for rows, picks in [(512, [torch.arange(half), torch.arange(half, d_in)]),
                        (40, [torch.arange(40) * 25 + 3])]:
        for k in picks:
            k = k.to(DEV)
            x = torch.zeros(rows, d_in, dtype=torch.bfloat16, device=DEV)
            x[torch.arange(rows, device=DEV), k] = 1
            got, want = q.int4_matmul(x, packed, scale, out_dtype=torch.float32), want_rows[k]
            case = f"int4_matmul/exact/{rows}x{d_in}x{d_out}/rows{int(k[0])}-{int(k[-1])}"
            if not torch.equal(got, want):
                bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
                raise SmokeFailure(f"{case}: {bad} outputs differ from dequantize_int4 in bits")
            record(results, case, max_err(got, want), 0.0)


# ---- the full-width serving slice --------------------------------------------


def kernels():
    """name -> (wrapper, counter attribute, source, TPU kernel, the phase
    whose run supplies the launch count, whether a serving path runs it)."""
    from multimodalvc_tpu_torch.ops.attention import flash_attention
    from multimodalvc_tpu_torch.ops.beam_gather import gather_rows
    from multimodalvc_tpu_torch.ops.decode_attention import (
        ancestry_attention,
        gen_attention_ancestor,
        prompt_attention,
    )
    from multimodalvc_tpu_torch.ops.int8_matmul import int4_matmul, int8_matmul
    from multimodalvc_tpu_torch.ops.topk import beam_topk, beam_topk_columns

    da = "multimodalvc_tpu/ops/decode_attention.py"
    return {
        "flash_attention": (flash_attention, "launches", "csrc/flash_attention.cu",
                            "multimodalvc_tpu/ops/attention.py:328", "int8_weights", True),
        # the int8 decode runs K2's and K3's segments through the merged
        # entry (below), and no serving path runs K2 on a bf16 cache (the JAX
        # package's neither: a bf16 prompt segment is plain einsums), so no
        # phase may launch these three; their checks above are their only use
        "prompt_attention/int8": (prompt_attention, "launches", "csrc/decode_attention.cu",
                                  f"{da}:370", "int8_weights", False),
        "prompt_attention/bf16": (prompt_attention, "launches_bf16", "csrc/decode_attention.cu",
                                  f"{da}:370", "bf16_kv_ancestry", False),
        "gen_attention_ancestor/int8": (gen_attention_ancestor, "launches",
                                        "csrc/decode_attention.cu", f"{da}:195", "int8_weights",
                                        False),
        "gen_attention_ancestor/bf16": (gen_attention_ancestor, "launches_bf16",
                                        "csrc/decode_attention.cu", f"{da}:195",
                                        "bf16_kv_ancestry", True),
        # K2 + K3 + their merge, one launch a layer and step (the JAX decode
        # step's attention: both kernels, merge_softmax_segments, the cast)
        "ancestry_attention": (ancestry_attention, "launches", "csrc/decode_attention.cu",
                               "multimodalvc_tpu/nn/llama.py:342", "int8_weights", True),
        "beam_topk_columns": (beam_topk_columns, "launches", "csrc/topk.cu",
                              "multimodalvc_tpu/ops/topk.py:271", "int8_weights", True),
        # beam_topk and beam_topk_from_logits share the counter: one TPU kernel
        "beam_topk": (beam_topk, "launches", "csrc/topk.cu",
                      "multimodalvc_tpu/ops/topk.py:125", "int8_ngram", True),
        "gather_rows": (gather_rows, "launches", "csrc/beam_gather.cu",
                        "multimodalvc_tpu/ops/beam_gather.py:57", "bf16_kv_gather", True),
        "int8_matmul": (int8_matmul, "launches", "csrc/int8_matmul.cu",
                        "multimodalvc_tpu/ops/int8_matmul.py:113", "int8_weights", True),
        "int4_matmul": (int4_matmul, "launches", "csrc/int8_matmul.cu",
                        "multimodalvc_tpu/ops/int8_matmul.py:326", "int4_weights", True),
    }


# The launches each phase must show: "+" = at least one, an int = exactly
# that many (set by the caller where it depends on another phase); every
# kernel not named must launch 0 times.
ON = "+"
EXPECT = {
    "bf16_weights": {"flash_attention": ON, "ancestry_attention": ON, "beam_topk_columns": ON},
    "bf16_kv_ancestry": {"flash_attention": ON, "gen_attention_ancestor/bf16": ON,
                         "beam_topk_columns": ON},
    "bf16_kv_gather": {"flash_attention": ON, "beam_topk_columns": ON, "gather_rows": ON},
    "bf16_constrained": {"flash_attention": ON, "gather_rows": ON},
    # no encoders and no flash prefill (the cache spans T + L slots, t != tkv)
    "bf16_full_cache": {"beam_topk_columns": ON, "gather_rows": ON},
    "int8_weights": {"flash_attention": ON, "ancestry_attention": ON, "beam_topk_columns": ON,
                     "int8_matmul": ON},
    "int8_ngram": {"flash_attention": ON, "ancestry_attention": ON, "beam_topk": ON,
                   "int8_matmul": ON},
    "int4_weights": {"flash_attention": ON, "ancestry_attention": ON, "beam_topk_columns": ON,
                     "int4_matmul": ON},
    "beam8_int8_kv": {"flash_attention": ON, "ancestry_attention": ON, "beam_topk_columns": ON},
}
# the training phases: K1 48 times a step in the encoders (24 Whisper and 24
# AV-HuBERT layers), and with use_flash_prefill 28 more in the trunk, each
# through its autograd Function
ENCODER_FLASH, TRUNK_FLASH = 48, 28
EXPECT["train_avsr"] = {"flash_attention": ENCODER_FLASH * TRAIN_STEPS}
EXPECT["train_avsr_flash"] = {"flash_attention": (ENCODER_FLASH + TRUNK_FLASH) * TRAIN_STEPS}
# Beyond EXPECT: an ancestry phase launches the merged entry (int8 KV) or K3
# (bf16 KV) once a layer, decode step and ensemble member, the decode steps
# counted by the beam candidates' kernel (K4, or K5 with n-gram blocking);
# the PyTorch merge runs once a layer and step with bf16 KV, never with int8.
# The gather phases launch K6 once a decode step, for all 56 KV leaves.
ONCE_A_STEP = {"bf16_kv_gather": "gather_rows", "bf16_full_cache": "gather_rows"}


def plain_versions(only=None) -> ExitStack:
    """Route the model's kernel call sites to the plain PyTorch versions:
    every kernel, or only the wrappers named in ``only``."""
    from multimodalvc_tpu_torch.nn import layers, llama, whisper
    from multimodalvc_tpu_torch.ops import (
        attention,
        beam_gather,
        beam_search,
        decode_attention,
        int8_matmul,
        topk,
    )

    stack = ExitStack()
    for site, name, plain in [
        (layers, "flash_attention", attention.flash_attention_plain),
        (whisper, "flash_attention", attention.flash_attention_plain),
        (llama, "flash_attention", attention.flash_attention_plain),
        (llama, "ancestry_attention", decode_attention.ancestry_attention_plain),
        (llama, "gen_attention_ancestor", decode_attention.gen_attention_ancestor_plain),
        (llama, "int8_matmul", int8_matmul.int8_matmul_plain),
        (llama, "int4_matmul", int8_matmul.int4_matmul_plain),
        (beam_gather, "gather_rows", beam_gather.gather_rows_plain),
        (beam_gather, "gather_rows_many", beam_gather.gather_rows_many_plain),
        (beam_search, "beam_topk_columns", topk.beam_topk_columns_plain),
        (beam_search, "beam_topk", topk.beam_topk_plain),
        (beam_search, "beam_topk_from_logits", topk.beam_topk_from_logits_plain),
    ]:
        if only is None or name in only:
            stack.enter_context(mock.patch.object(site, name, plain))
    return stack


def reset_counts(table) -> None:
    for fn, attr, *_ in table.values():
        setattr(fn, attr, 0)


def read_counts(table) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr, *_) in table.items()}


def make_batch():
    """The serving batch of AVSRConfig(): BATCH clips of SECONDS s, random
    features and instructions from seed 1."""
    import torch

    from multimodalvc_tpu_torch.models.avsr import AVSRConfig

    cfg = AVSRConfig()
    t_v = cfg.max_video_frames = SECONDS * 25
    g = torch.Generator(device=DEV).manual_seed(1)
    return {
        "audio_feats": torch.randn(BATCH, cfg.whisper.n_mels, 2 * cfg.whisper.max_frames,
                                   generator=g, device=DEV),
        "video": torch.randn(BATCH, t_v, 88, 88, 1, generator=g, device=DEV),
        "video_lengths": torch.full((BATCH,), t_v, dtype=torch.int32, device=DEV),
        "instruction": torch.randint(1, 200, (BATCH, INSTRUCTION), generator=g, device=DEV),
    }


def make_long_batch():
    """BATCH clips of 2 x SECONDS s (two encoder windows) with full-clip mel
    features (4 mel frames a video frame), random from seed 4."""
    import torch

    from multimodalvc_tpu_torch.models.avsr import AVSRConfig

    t_v = 2 * SECONDS * 25
    g = torch.Generator(device=DEV).manual_seed(4)
    return {
        "audio_feats": torch.randn(BATCH, AVSRConfig().whisper.n_mels, 4 * t_v, generator=g,
                                   device=DEV),
        "video": torch.randn(BATCH, t_v, 88, 88, 1, generator=g, device=DEV),
        "video_lengths": torch.full((BATCH,), t_v, dtype=torch.int32, device=DEV),
        "instruction": torch.randint(1, 200, (BATCH, INSTRUCTION), generator=g, device=DEV),
    }


def wall(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def build_system(mode=None, seed=0):
    """AVSRConfig() at full width, bf16 random weights from ``seed``; with
    ``mode``, the LLaMA quantized in place to int8 or int4."""
    import torch

    from multimodalvc_tpu_torch.models.avsr import AVSRConfig, AVSRSystem

    cfg = AVSRConfig()
    cfg.max_video_frames = SECONDS * 25
    t0 = time.perf_counter()
    system = AVSRSystem(cfg, dtype=torch.bfloat16, device=DEV)
    system.init_random(seed=seed)
    if mode:
        system.enable_quantized_decode(mode)
    torch.cuda.synchronize()
    print(f"system: {mode or 'bf16'} weights (seed {seed}), built in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return system


def make_train_batch():
    """The serving batch with TRAIN_LABELS label tokens a clip (random from
    seed 6; lengths TRAIN_LABELS down to TRAIN_LABELS - 35)."""
    import torch

    from multimodalvc_tpu_torch.models.avsr import AVSRConfig

    batch = make_batch()
    g = torch.Generator(device=DEV).manual_seed(6)
    vocab = AVSRConfig().llama.vocab_size
    batch["labels"] = torch.randint(1, vocab, (BATCH, TRAIN_LABELS), generator=g, device=DEV)
    batch["label_lengths"] = torch.tensor([TRAIN_LABELS - 5 * i for i in range(BATCH)],
                                          dtype=torch.int32, device=DEV)
    return batch


def build_trainer(flash: bool, warmup: int = TRAIN_WARMUP, remat: bool = False):
    """The training slice's entry points at full width: ``AVSRTask`` (bf16
    random weights from seed 0, ``use_flash_prefill`` and the LLaMA's
    ``remat`` as given), its loss and frozen patterns into ``Trainer`` with
    the conf/mms-llama.yaml optimizer (AdamW, betas (0.9, 0.98), weight decay
    0.01, clip 1.0, cosine) and a warmup of ``warmup`` updates."""
    import torch

    from multimodalvc_tpu_torch.config.configs import OptimizationConfig
    from multimodalvc_tpu_torch.models.avsr import AVSRConfig
    from multimodalvc_tpu_torch.runtime.trainer import Trainer
    from multimodalvc_tpu_torch.tasks import AVSRTask, AVSRTaskConfig

    cfg = AVSRConfig()
    cfg.max_video_frames = SECONDS * 25
    cfg.llama.use_flash_prefill = True if flash else None
    cfg.llama.remat = remat
    t0 = time.perf_counter()
    task = AVSRTask(AVSRTaskConfig(), cfg, dtype=torch.bfloat16, device=DEV)
    task.system.init_random(seed=0)
    opt = OptimizationConfig(lr=1e-4, optimizer="adamw", adam_betas=(0.9, 0.98),
                             weight_decay=0.01, clip_norm=1.0, lr_scheduler="cosine",
                             warmup_updates=warmup, max_update=30000)
    trainer = Trainer(task.make_loss_fn(), task.system.module, opt, task.frozen_patterns())
    torch.cuda.synchronize()
    print(f"trainer: {'flash' if flash else 'plain'} trunk attention"
          f"{', LLaMA remat' if remat else ''}, built in "
          f"{time.perf_counter() - t0:.1f} s, {sum(p.numel() for p in trainer.master.values())} "
          f"trainable of {sum(p.numel() for p in task.system.module.parameters())} parameters")
    return task, trainer


def step_gradients(trainer, batch, seed=9):
    """The trainable leaves' gradients of one training loss on ``batch``,
    its dropout from a generator seeded ``seed``, as one f32 vector."""
    import torch

    gen = torch.Generator(device=DEV).manual_seed(seed)
    loss, _ = trainer.loss_fn(batch, gen)
    grads = torch.autograd.grad(loss, list(trainer.params.values()), allow_unused=True)
    return torch.cat([(torch.zeros_like(p) if g is None else g).float().reshape(-1)
                      for g, p in zip(grads, trainer.params.values())])


def gradient_gate(trainer, batch, name: str = "train_avsr_flash") -> dict:
    """The step-1 gradients against the same step with K1's plain version
    (``plain_versions()``), gated at the noise floor this run measures: the
    relative L2 by which one bf16 ulp on every 9973rd audio feature moves
    them, times FLOOR_MARGIN, and at least REL_TOL."""
    nudged = dict(batch)
    nudged["audio_feats"] = batch["audio_feats"].clone()
    flat = nudged["audio_feats"].view(-1)
    flat[::9973] = flat[::9973] * (1 + 2 ** -7)
    kernel = step_gradients(trainer, batch)
    floor = rel_l2(step_gradients(trainer, nudged), kernel)
    with plain_versions():
        plain = step_gradients(trainer, batch)
    rel, tol = rel_l2(kernel, plain), max(REL_TOL, FLOOR_MARGIN * floor)
    print(f"    step-1 gradients, K1 vs plain: rel_l2={rel:.3e}; noise floor (one bf16 ulp on "
          f"0.01% of the audio features) {floor:.3e}, gate {tol:.3e}")
    if not rel <= tol:
        raise SmokeFailure(f"{name}: step-1 gradients {rel:.3e} from plain K1 (gate {tol:.3e})")
    return {"grad_rel_l2": rel, "noise_floor_rel_l2": floor, "tol_rel_l2": tol}


def train_phase(table, name: str, flash: bool) -> dict:
    """TRAIN_STEPS training steps on one repeated batch (make_train_batch)
    through ``Trainer.train_step``, with every launch count set to 0 before
    the first and read after the last (EXPECT[name]).  Checks: every loss
    finite and the last below the first; every frozen leaf (and buffer)
    bitwise unchanged; every trainable leaf's f32 master moved (but those
    the loss does not depend on); after step 3
    a save and restore (``CheckpointManager``) gives back every trainable
    leaf, Adam moment, counter and the generator state bit for bit, and the
    run goes on from the restored state.  Prints the step wall (the mean of
    steps 2..), label and sequence tokens/s and the peak GiB allocated.
    With ``flash``, first the step-1 gradient gate (``gradient_gate``)."""
    import gc
    import shutil

    import torch

    from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager

    gc.collect()
    torch.cuda.empty_cache()
    task, trainer = build_trainer(flash)
    batch = task.prepare_batch(make_train_batch())
    record = {}
    if flash:
        record.update(gradient_gate(trainer, batch))
    frozen = {n: x.clone() for n, x in trainer.module.state_dict().items()
              if n not in trainer.master}
    start = {n: x.clone() for n, x in trainer.master.items()}
    ckpt_dir = REPO / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    manager = CheckpointManager(str(ckpt_dir))
    torch.cuda.reset_peak_memory_stats()
    metrics, walls = [], []
    reset_counts(table)
    for step in range(TRAIN_STEPS):
        m, t_step = wall(lambda: trainer.train_step(batch))
        metrics.append(m)
        walls.append(t_step)
        print(f"    step {step + 1}: loss {m['loss']:.4f} gnorm {m['gnorm']:.3e} accuracy "
              f"{m['accuracy']:.4f} tokens {m['n_tokens']} {1e3 * t_step:.1f} ms")
        if step == 2:
            saved = trainer.state_dict(include_frozen=False)
            manager.save(saved, trainer.step)
            back = manager.restore(map_location=DEV)
            _same_state("train checkpoint", saved, back)
            trainer.load_state_dict(back)
    launches = read_counts(table)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    expect = EXPECT[name]
    wrong = {k: (n, expect.get(k, 0)) for k, n in launches.items() if n != expect.get(k, 0)}
    if wrong:
        raise SmokeFailure(f"{name}: launches (got, expected) {wrong}")
    losses = [m["loss"] for m in metrics]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SmokeFailure(f"{name}: losses {losses} (finite, the last below the first)")
    changed = [n for n, x in trainer.module.state_dict().items()
               if n in frozen and not torch.equal(x, frozen[n])]
    if changed:
        raise SmokeFailure(f"{name}: frozen leaves changed: {changed[:5]}")
    # the loss does not depend on the attention key biases (softmax is
    # shift-invariant: their gradient is rounding noise, or 0), nor on a bridge
    # before the speech-rate predictor (narrow configurations only)
    still = [n for n, x in trainer.master.items() if torch.equal(x, start[n])]
    if [n for n in still if not (n.endswith("k_proj.bias") or n.startswith("encoder.sr_bridge."))]:
        raise SmokeFailure(f"{name}: trainable leaves that did not move: {still[:5]}")
    step_s = sum(walls[1:]) / len(walls[1:])
    b, t = batch["instruction"].shape[0], INSTRUCTION + task.model_cfg.max_queries + TRAIN_LABELS
    labels = sum(m["n_tokens"] for m in metrics[1:]) / len(metrics[1:])
    record.update(losses=losses, step_ms=[1e3 * x for x in walls], mean_step_ms=1e3 * step_s,
                  label_tokens_per_s=labels / step_s, seq_tokens_per_s=b * t / step_s,
                  audio_realtime_factor=BATCH * SECONDS / step_s, peak_gib=peak,
                  launches=launches, unmoved_key_biases=len(still), frozen_leaves=len(frozen),
                  trainable_leaves=len(trainer.master))
    print(f"  phase {name}: {1e3 * step_s:.1f} ms a step (steps 2-{TRAIN_STEPS}), "
          f"{labels / step_s:.0f} label tokens/s, {b * t / step_s:.0f} sequence tokens/s, "
          f"{BATCH * SECONDS / step_s:.1f}x realtime, peak {peak:.2f} GiB, launches "
          f"{ {k: n for k, n in launches.items() if n} }")
    del task, trainer, frozen, start
    gc.collect()
    torch.cuda.empty_cache()
    return record


def _same_state(name, a, b) -> None:
    """Nested states equal: tensors bit for bit, everything else by ==."""
    import torch

    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise SmokeFailure(f"{name}: keys differ")
        for k in a:
            _same_state(f"{name}/{k}", a[k], b[k])
    elif isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or not torch.equal(a.to(b.device), b):
            raise SmokeFailure(f"{name}: not bitwise equal after the round trip")
    elif a != b:
        raise SmokeFailure(f"{name}: {a} != {b}")


# ---- speech synthesis ----------------------------------------------------------


# K1 launches a speech forward: the encoders' 48 and the 12 Conformer-L
# blocks; the cross-attention fusion adds 2
CONFORMER_FLASH, FUSION_FLASH = 12, 2
SPEECH_FLASH = ENCODER_FLASH + CONFORMER_FLASH
SPEECH_SEED, VOCODER_SEED = 0, 2
# the vocoder on the card (f32, TF32 off) against the same module on the CPU,
# by relative L2: the two sum in other orders (~1e-6); a layout fault is O(1)
VOCODER_CPU_FRAMES, VOCODER_CPU_TOL = 100, 1e-3


def speech_config():
    """SpeechConfig() at full width with modality dropout (the NoLLM recipe,
    conf/mms-speech-nollm.yaml), the serving batch's 400 video frames."""
    from multimodalvc_tpu_torch.models.speech import SpeechConfig

    cfg = SpeechConfig(modality_dropout=True)
    cfg.max_video_frames = SECONDS * 25
    return cfg


def make_speech_batch(mode: int = 0):
    """The serving batch with SECONDS s of audio a clip (1600 mel frames)
    and a modality mode."""
    import torch

    batch = make_batch()
    batch["audio_lengths"] = torch.full((BATCH,), SECONDS * 16000, dtype=torch.int32, device=DEV)
    batch["modality_mode"] = torch.tensor(mode, dtype=torch.int32, device=DEV)
    return batch


def nudged_features(batch):
    return {**batch, "audio_feats": nudge(batch["audio_feats"]), "video": nudge(batch["video"])}


def valid_rows(x, lens, per_frame: int = 1):
    """Each row's valid prefix (``lens[i] * per_frame`` steps), concatenated."""
    import torch

    return torch.cat([x[i, : int(n) * per_frame] for i, n in enumerate(lens.tolist())])


def build_speech(cls):
    """A speech system of ``speech_config()``, bf16 random weights from SPEECH_SEED."""
    import torch

    t0 = time.perf_counter()
    system = cls(speech_config(), dtype=torch.bfloat16, device=DEV)
    system.init_random(SPEECH_SEED)
    torch.cuda.synchronize()
    print(f"{cls.__name__}: bf16 random weights (seed {SPEECH_SEED}), built in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          "allocated")
    return system


def speech_run(table, name, call, flash: int) -> tuple:
    """``run_phase`` for one synthesis forward after a warm-up call: K1
    ``flash`` times and no other kernel; with the peak GiB allocated."""
    import torch

    call()  # warm-up: cuDNN's algorithm choice, the allocator
    torch.cuda.reset_peak_memory_stats()
    record, out = run_phase(table, name, call, {"flash_attention": flash} if flash else {})
    record["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"    {name}: peak {record['peak_gib']:.2f} GiB")
    return record, out


def gate_against_plain(checks, name, call, got, select):
    """``got`` (``select`` picks its valid steps) against the same forward
    with K1 plain, gated at the noise floor of the same forward on features
    nudged by one bf16 ulp on 0.01% of their values."""
    with plain_versions(only=["flash_attention"]):
        want = select(call(False))
    gate = noise_gate(rel_l2(select(call(True)), got), name, "the features")
    compare(checks, name, got, want, gate["tol_rel_l2"])
    checks[name].update(gate)
    return gate


def finite_shape(name, x, shape) -> None:
    import torch

    if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
        raise SmokeFailure(f"{name}: shape {tuple(x.shape)} (want {shape}) or non-finite values")


def speech_nollm_phase(table, checks) -> tuple:
    """SpeechNoLLMSystem in modes 0, 1 and 2: the mel [B, 2400, 128], K1 60
    times a forward; mode 0 against K1 plain; modes 1 and 2 differ from 0.
    Returns (record, the mode-0 mel's valid frames [B, 1600, 128])."""
    import torch

    from multimodalvc_tpu_torch.models.speech import SpeechNoLLMSystem

    system = build_speech(SpeechNoLLMSystem)
    cfg, record, mels = system.cfg, {}, {}
    for mode in (0, 1, 2):
        batch = make_speech_batch(mode)
        record[f"mode{mode}"], out = speech_run(table, f"speech_nollm/mode{mode}",
                                                lambda: system(batch), SPEECH_FLASH)
        finite_shape(f"speech_nollm/mode{mode}", out["melspec"],
                     (BATCH, cfg.max_mel_frames, 128))
        mels[mode], lens = out["melspec"], out["mel_lengths"]
    record["mel_lengths"] = lens.tolist()
    # the stages apart: the encoders with the Q-Former and the projector, then
    # the head (proj1, resize, proj2, Conformer-L, mel head).  The
    # speech-rate factor (clamped to [1, 2]) sets the query count and the
    # resize: a last-bit move would show in query_lens
    module = system.module
    with torch.inference_mode():
        (queries, q_lens), enc_s = wall(lambda: module.encoder(
            batch["audio_feats"], batch["video"], batch["video_lengths"],
            modality_mode=batch["modality_mode"]))
        _, head_s = wall(lambda: module.head(queries, q_lens, lens))
    record.update(query_lens=q_lens.tolist(), encoder_s=enc_s, head_s=head_s)
    print(f"    speech_nollm stages: encoders + Q-Former {enc_s:.4f} s, head {head_s:.4f} s")
    got = valid_rows(mels[0], lens)
    batch = make_speech_batch(0)
    gate = gate_against_plain(checks, "speech_nollm/mel", lambda nudged: system(
        nudged_features(batch) if nudged else batch)["melspec"], got,
        lambda m: valid_rows(m, lens))
    # a mode moves the mel by more than rounding does (FLOOR_MARGIN times the
    # noise floor): the mask embedding took the place of a stream
    least = FLOOR_MARGIN * gate["noise_floor_rel_l2"]
    for mode in (1, 2):
        moved = rel_l2(valid_rows(mels[mode], lens), got)
        record[f"mode{mode}_rel_l2_from_mode0"] = moved
        if not moved > least:
            raise SmokeFailure(f"speech_nollm: mode {mode} moves the mel by {moved:.3e}, "
                               f"within rounding ({least:.3e})")
    mel = torch.stack([mels[0][i, : int(n)] for i, n in enumerate(lens.tolist())])
    del system
    return record, mel


def speech_llm_phase(table, checks) -> dict:
    """SpeechLLMSystem (LLaMA-3.2-3B hidden states, no unembed): the mel,
    K1 60 times (the trunk's 130 slots stay plain), its valid frames against
    K1 plain."""
    from multimodalvc_tpu_torch.models.speech import SpeechLLMSystem

    system = build_speech(SpeechLLMSystem)
    batch = make_speech_batch()

    def no_unembed(*args):
        raise SmokeFailure("speech_llm: the LLaMA unembed ran")

    with mock.patch.object(system.module.llama, "unembed", no_unembed):
        record, out = speech_run(table, "speech_llm", lambda: system(batch), SPEECH_FLASH)
        mel, lens = out["melspec"], out["mel_lengths"]
        finite_shape("speech_llm", mel, (BATCH, system.cfg.max_mel_frames, 128))
        gate_against_plain(checks, "speech_llm/mel", lambda nudged: system(
            nudged_features(batch) if nudged else batch)["melspec"], valid_rows(mel, lens),
            lambda m: valid_rows(m, lens))
    del system
    return record


def speech_e2e_phase(table, checks) -> dict:
    """SpeechE2ESystem: the waveform [B, 2400 * 160, 1], K1 60 times, |w| <=
    1, tanh(conv_post's bias) from mel_len * 160 + 3 on in every row (the
    generator's input is masked to zero there), the valid samples against
    K1 plain."""
    import torch

    from multimodalvc_tpu_torch.models.speech import SpeechE2ESystem

    system = build_speech(SpeechE2ESystem)
    batch = make_speech_batch()
    record, out = speech_run(table, "speech_e2e", lambda: system(batch), SPEECH_FLASH)
    wav, lens = out["waveform"], out["mel_lengths"]
    finite_shape("speech_e2e", wav, (BATCH, system.cfg.max_mel_frames * 160, 1))
    wav = wav[..., 0]
    if not float(wav.abs().max()) <= 1.0:
        raise SmokeFailure("speech_e2e: |waveform| > 1")
    bias = torch.tanh(system.module.generator.conv_post.bias)
    for i, n in enumerate(lens.tolist()):
        if not bool((wav[i, n * 160 + 3:] == bias).all()):
            raise SmokeFailure(f"speech_e2e: row {i} past its {n} frames is not tanh(bias)")
    module = system.module
    with torch.inference_mode():
        features, trunk_s = wall(lambda: module.trunk(batch)["features"])
        _, gen_s = wall(lambda: module.generator(features, lengths=lens))
    print(f"    speech_e2e stages: trunk {trunk_s:.4f} s, generator {gen_s:.4f} s")
    record.update(mel_lengths=lens.tolist(), abs_max=float(wav.abs().max()),
                  valid_rms=float(valid_rows(wav, lens, 160).float().pow(2).mean().sqrt()),
                  trunk_s=trunk_s, generator_s=gen_s)
    gate_against_plain(checks, "speech_e2e/waveform", lambda nudged: system(
        nudged_features(batch) if nudged else batch)["waveform"][..., 0],
        valid_rows(wav, lens, 160), lambda w: valid_rows(w, lens, 160))
    del system
    return record


def vocoder_phase(table, mel, checks) -> dict:
    """VocoderModel.generate in f32 on the NoLLM mel's valid frames; a 1-row
    slice of VOCODER_CPU_FRAMES frames against the same module on the CPU."""
    import torch

    from multimodalvc_tpu_torch.models.vocoder import VocoderConfig, VocoderModel

    voc = VocoderModel(VocoderConfig(), device=DEV)
    voc.init_random(VOCODER_SEED)
    # timed with cuDNN's default (TF32 convs), as a caller of generate runs
    # it; the comparison with the CPU, and the wall beside it, with TF32 off
    torch.backends.cudnn.allow_tf32 = True
    try:
        record, wav = speech_run(table, "vocoder", lambda: voc.generate(mel), 0)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    finite_shape("vocoder", wav, (mel.shape[0], mel.shape[1] * 160))
    voc.generate(mel)  # warm-up: cuDNN's algorithm choice without TF32
    _, record["tf32_off_s"] = wall(lambda: voc.generate(mel))
    print(f"    vocoder with TF32 off: {record['tf32_off_s']:.4f} s")
    cpu = VocoderModel(VocoderConfig(), device="cpu")
    cpu.generator.load_state_dict({k: x.cpu() for k, x in voc.generator.state_dict().items()})
    piece = mel[:1, :VOCODER_CPU_FRAMES]
    got, want = voc.generate(piece).cpu(), cpu.generate(piece.cpu())
    record.update(abs_max=float(wav.abs().max()), rms=float(wav.pow(2).mean().sqrt()))
    compare(checks, "vocoder/cpu", got, want, VOCODER_CPU_TOL)
    del voc, cpu
    return record


def fusion_phase(table, checks) -> dict:
    """AVSREncoder with the "add" and "cross-att" fusions and no speech-rate
    predictor: the queries, K1 48 and 50 times, against K1 plain."""
    import torch

    from multimodalvc_tpu_torch.models.avsr import AVSRConfig, AVSREncoder
    from multimodalvc_tpu_torch.nn.init import init_random_

    batch, record = make_batch(), {}
    for fuse, flash in (("add", ENCODER_FLASH), ("cross-att", ENCODER_FLASH + FUSION_FLASH)):
        cfg = AVSRConfig(modality_fuse=fuse, use_sr_predictor=False)
        enc = AVSREncoder(cfg, device=DEV, dtype=torch.bfloat16).eval()
        init_random_(enc, SPEECH_SEED)

        def call(nudged=False, enc=enc):
            b = nudged_features(batch) if nudged else batch
            with torch.inference_mode():
                return enc(b["audio_feats"], b["video"], b["video_lengths"])

        name = f"fusion_{fuse}"
        record[fuse], (queries, lens) = speech_run(table, name, call, flash)
        finite_shape(name, queries, (BATCH, cfg.max_queries, cfg.llama.hidden_size))
        record[fuse]["query_lens"] = lens.tolist()
        gate_against_plain(checks, f"{name}/queries", lambda nudged: call(nudged)[0],
                           valid_rows(queries, lens), lambda q: valid_rows(q, lens))
        del enc
    return record


def speech_phases(table, checks) -> dict:
    """The five speech phases, each model freed before the next is built."""
    import gc

    import torch

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    phases = {}
    phases["speech_nollm"], mel = speech_nollm_phase(table, checks)
    free()
    phases["vocoder"] = vocoder_phase(table, mel, checks)
    del mel
    free()
    phases["speech_llm"] = speech_llm_phase(table, checks)
    free()
    phases["speech_e2e"] = speech_e2e_phase(table, checks)
    free()
    phases["fusion_modes"] = fusion_phase(table, checks)
    free()
    return phases


# ---- speech training -------------------------------------------------------------


# The speech training phases: the NoLLM and LLM-conditioned heads through
# Trainer (conf/mms-speech-nollm.yaml's and conf/mms-llama-speech.yaml's
# optimizer, warmup cut to TRAIN_WARMUP), the E2E GAN trainer
# (conf/mms-speech-nollm-e2e.yaml: batch 4, stage 1 then stage 2) and the
# vocoder's GAN step (conf/hifigan-vocoder.yaml: batch 64 x 8320 samples).
SPEECH_TRAIN_STEPS, E2E_BATCH, E2E_STAGE_STEPS = 6, 4, (3, 2)
VOCODER_BATCH, VOCODER_STEPS, VOCODER_CPU_BATCH, VOCODER_CPU_TOL = 64, 6, 2, 1e-4
# K1 a training step: 48 forward-only launches in the frozen encoders, 12
# through FlashAttentionGrad in the Conformer-L (none in stage 1 of the E2E
# GAN, where the trunk is frozen)
CONFORMER_GRAD_LAUNCHES = CONFORMER_FLASH


def seeded_waveform(b: int, n: int, seed: int):
    """[b, n] f32 on the card: random speech-band noise at 0.1 from ``seed``."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed)
    return 0.1 * torch.randn(b, n, generator=g, device=DEV)


def make_speech_train_batch(rows: int = 0, waveform: bool = False):
    """The speech batch (``make_speech_batch``'s first ``rows`` rows, all
    BATCH by default, 16 s a
    clip) with its target mels: ``hifigan_log_mel`` of a seeded waveform of
    the clips' 256000 samples [rows, 1600, 128], and with ``waveform`` the
    waveform itself [rows, 256000, 1] (the E2E GAN's target)."""
    import torch

    from multimodalvc_tpu_torch.ops.stft import hifigan_log_mel

    rows = rows or BATCH
    batch = {k: v[:rows] if k != "modality_mode" else v for k, v in make_speech_batch().items()}
    wav = seeded_waveform(rows, SECONDS * 16000, seed=7)
    with torch.no_grad():
        batch["target_mel"] = hifigan_log_mel(wav)
    batch["target_mel_lengths"] = torch.full((rows,), SECONDS * 100, dtype=torch.int32,
                                             device=DEV)
    if waveform:
        batch["waveform"] = wav[..., None]
    del batch["modality_mode"]  # the task draws it
    return batch


class GradLaunches:
    """Counts the K1 launches that go through ``FlashAttentionGrad`` (a launch
    with a gradient) while it is entered."""

    def __enter__(self):
        from multimodalvc_tpu_torch.ops import attention

        self.n, apply = 0, attention.FlashAttentionGrad.apply

        def counted(*args):
            self.n += 1
            return apply(*args)

        self._patch = mock.patch.object(attention.FlashAttentionGrad, "apply", counted)
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        self._patch.__exit__(*exc)


def check_k1_launches(name, launches, grads, steps, grad_each) -> None:
    """K1 SPEECH_FLASH times a step, ``grad_each`` of them with a gradient;
    no other kernel."""
    want = {"flash_attention": SPEECH_FLASH * steps}
    wrong = {k: (n, want.get(k, 0)) for k, n in launches.items() if n != want.get(k, 0)}
    if wrong or grads != grad_each * steps:
        raise SmokeFailure(f"{name}: launches (got, expected) {wrong}, {grads} through "
                           f"FlashAttentionGrad (expected {grad_each * steps})")


def module_snapshot(module, names=None) -> dict:
    """Clones of ``module``'s state_dict entries (those in ``names``)."""
    return {n: x.clone() for n, x in module.state_dict().items() if names is None or n in names}


def unchanged(name, module, before) -> None:
    """Fails unless every entry of ``before`` is bit for bit the module's."""
    import torch

    now = module.state_dict()
    moved = [n for n, x in before.items() if not torch.equal(now[n], x)]
    if moved:
        raise SmokeFailure(f"{name}: {len(moved)} frozen entries changed, e.g. {moved[:3]}")


def step_split(trainer, batch) -> dict:
    """One more step of ``trainer``, its stages timed apart (each ends in a
    synchronise): the encoders and the Q-Former (no gradient but the
    Q-Former's), the whole training forward, the backward with K1's
    recompute inside it timed on its own, and the optimizer."""
    import torch

    from multimodalvc_tpu_torch.ops import attention
    from multimodalvc_tpu_torch.runtime.trainer import copy_masters_

    module, gen = trainer.module, torch.Generator(device=DEV).manual_seed(11)
    _, enc_s = wall(lambda: module.encoder(batch["audio_feats"], batch["video"],
                                           batch["video_lengths"], dropout_rng=gen,
                                           modality_mode=batch.get("modality_mode")))
    (loss, _), fwd_s = wall(lambda: trainer.loss_fn(batch, gen))
    recompute, backward = [], attention.FlashAttentionGrad.backward

    def timed(ctx, g):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = backward(ctx, g)
        torch.cuda.synchronize()
        recompute.append(time.perf_counter() - t0)
        return out

    names = list(trainer.params)
    with mock.patch.object(attention.FlashAttentionGrad, "backward", staticmethod(timed)):
        got, bwd_s = wall(lambda: torch.autograd.grad(loss, [trainer.params[n] for n in names],
                                                      allow_unused=True))
    grads = {n: torch.zeros_like(trainer.master[n]) if x is None else x.float()
             for n, x in zip(names, got)}
    del got, loss

    def update():
        trainer.optimizer.update(grads, trainer.master)
        copy_masters_(trainer.params, trainer.master)

    _, opt_s = wall(update)
    return {"encoders_s": enc_s, "forward_s": fwd_s, "head_forward_s": fwd_s - enc_s,
            "backward_s": bwd_s, "k1_recompute_s": sum(recompute),
            "k1_recomputes": len(recompute), "optimizer_s": opt_s}


# a profiled update of the trainer's own optimizer: K9's three kernels and
# the norm's square root (the table copies are not kernels), where the
# per-leaf chain launched ~36 a leaf
OPTIMIZER_KERNELS = 8


def optimizer_profile(name, trainer) -> dict:
    """The device kernels of one ``grad_norm`` + ``update`` of ``trainer``'s
    optimizer on seeded gradients of the module's dtype, under
    ``torch.profiler``: their count, names and device ms, and the host ms of
    the two calls; more than OPTIMIZER_KERNELS kernels fail."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=DEV).manual_seed(12)
    grads = {n: 1e-3 * torch.randn(p.shape, generator=gen, device=DEV, dtype=p.dtype)
             for n, p in trainer.params.items()}
    opt = trainer.optimizer
    opt.grad_norm(grads), opt.update(grads, trainer.master)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.grad_norm(grads)
        opt.update(grads, trainer.master)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.lower().startswith(("memcpy", "memset"))]
    out = {"kernels": len(kernels), "names": sorted({e.name[:60] for e in kernels}),
           "device_ms": sum(e.device_time for e in kernels) / 1e3, "host_ms": 1e3 * host}
    print(f"    {name} optimizer: {out['kernels']} kernels, {out['device_ms']:.3f} device ms, "
          f"{out['host_ms']:.2f} host ms (grad_norm + update, the wait included)")
    if not 0 < out["kernels"] <= OPTIMIZER_KERNELS:
        raise SmokeFailure(f"{name}: {out['kernels']} kernels in one update: {out['names']}")
    return out


def train_speech_phase(table, variant: str) -> dict:
    """SpeechTask(variant) -> Trainer at full width (bf16, seed 0), the
    step-1 gradients gated against K1 plain first, then SPEECH_TRAIN_STEPS
    steps on one batch, its modality mode drawn a step as the task draws
    it; with every launch count 0 before the first step and read after the
    last.  Checks: K1 SPEECH_FLASH times a step, 12 of them with a
    gradient; the frozen leaves bit for bit; every Conformer running
    statistic moved; the losses finite and the last below the first; K9
    (the optimizer's two passes, ``ops/adamw.py``) once each a step, and in
    a profiled update (``optimizer_profile``) no more than
    OPTIMIZER_KERNELS kernels.  Then one step timed by stage
    (``step_split``)."""
    import gc

    import torch

    from multimodalvc_tpu_torch.config.configs import OptimizationConfig
    from multimodalvc_tpu_torch.ops import adamw
    from multimodalvc_tpu_torch.runtime.trainer import Trainer
    from multimodalvc_tpu_torch.tasks import SpeechTask, SpeechTaskConfig

    name = f"train_speech_{variant}"
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    task = SpeechTask(SpeechTaskConfig(variant=variant), speech_config(), dtype=torch.bfloat16,
                      device=DEV)
    task.init_random(SPEECH_SEED)
    opt = OptimizationConfig(lr=2e-4, lr_scheduler="cosine", warmup_updates=TRAIN_WARMUP,
                             max_update=60000, clip_norm=1.0)
    trainer = Trainer(task.make_loss_fn(), task.module, opt, task.frozen_patterns())
    raw = make_speech_train_batch()
    print(f"  {name}: built in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in trainer.master.values())} trainable of "
          f"{sum(p.numel() for p in task.module.parameters())} parameters")
    record = {}
    buffers = module_snapshot(task.module, {n for n, _ in task.module.named_buffers()})
    gate_batch = {**task.prepare_batch(raw, train=False),
                  "modality_mode": torch.tensor(0, dtype=torch.int32, device=DEV)}
    record.update(gradient_gate(trainer, gate_batch, name))
    with torch.no_grad():  # the gate's training forwards moved the running statistics
        for n, b in task.module.named_buffers():
            if n in buffers:
                b.copy_(buffers[n])
    frozen = module_snapshot(task.module, {n for n, _ in task.module.named_parameters()
                                           if n not in trainer.master})
    stats = {n: x for n, x in buffers.items() if ".conformer." in n and "running_" in n}
    torch.cuda.reset_peak_memory_stats()
    metrics, walls, modes = [], [], []
    reset_counts(table)
    adamw.adamw_many_.launches = adamw.square_sums_many.launches = 0
    with GradLaunches() as grads:
        for step in range(SPEECH_TRAIN_STEPS):
            batch = task.prepare_batch(raw)
            modes.append(int(batch["modality_mode"]))
            m, t_step = wall(lambda: trainer.train_step(batch))
            metrics.append(m)
            walls.append(t_step)
            print(f"    step {step + 1} (mode {modes[-1]}): mel L1 {m['mel_l1']:.4f} gnorm "
                  f"{m['gnorm']:.3e} {1e3 * t_step:.1f} ms")
    launches = read_counts(table)
    k9 = {"adamw_many_": adamw.adamw_many_.launches,
          "square_sums_many": adamw.square_sums_many.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_k1_launches(name, launches, grads.n, SPEECH_TRAIN_STEPS, CONFORMER_GRAD_LAUNCHES)
    if set(k9.values()) != {SPEECH_TRAIN_STEPS}:
        raise SmokeFailure(f"{name}: K9 launches {k9} in {SPEECH_TRAIN_STEPS} steps")
    unchanged(name, task.module, frozen)
    now = task.module.state_dict()
    still = [n for n, x in stats.items() if torch.equal(now[n], x)]
    if not stats or still:
        raise SmokeFailure(f"{name}: running statistics that did not move: {still[:3]}")
    losses = [m["mel_l1"] for m in metrics]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SmokeFailure(f"{name}: mel L1 {losses} (finite, the last below the first)")
    step_s = sum(walls[1:]) / len(walls[1:])
    record["optimizer_profile"] = optimizer_profile(name, trainer)
    split = step_split(trainer, batch)
    record.update(mel_l1=losses, modes=modes, step_ms=[1e3 * x for x in walls],
                  mean_step_ms=1e3 * step_s, audio_s_per_s=BATCH * SECONDS / step_s,
                  peak_gib=peak, launches=launches, k9_launches=k9, k1_launches_a_step=SPEECH_FLASH,
                  k1_grad_launches_a_step=grads.n // SPEECH_TRAIN_STEPS, split=split,
                  frozen_leaves=len(frozen), trainable_leaves=len(trainer.master))
    print(f"  phase {name}: {1e3 * step_s:.1f} ms a step (steps 2-{SPEECH_TRAIN_STEPS}), "
          f"{BATCH * SECONDS / step_s:.1f} audio s trained a second, peak {peak:.2f} GiB, K1 "
          f"{SPEECH_FLASH} a step ({grads.n // SPEECH_TRAIN_STEPS} with a gradient); split "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items() if k.endswith("_s")))
    del task, trainer, frozen, buffers
    gc.collect()
    torch.cuda.empty_cache()
    return record


def gan_stage(table, task, batch_raw, name, steps, grad_each) -> dict:
    """``steps`` E2E GAN steps of ``task.make_trainer()`` on one batch, the
    launch counts 0 before the first and read after the last: the five
    losses a step, K1's launches, the leaves that must not move bit for bit
    (the frozen ones) and those that must (the generator's, the
    discriminators')."""
    import torch

    trainer = task.make_trainer(seed=0)
    frozen = module_snapshot(task.model, {n for n, _ in task.model.named_parameters()
                                          if n not in trainer.gen_master})
    gen0 = {n: m.clone() for n, m in trainer.gen_master.items()}
    disc0 = {n: m.clone() for n, m in trainer.disc_master.items()}
    torch.cuda.reset_peak_memory_stats()
    metrics, walls = [], []
    reset_counts(table)
    with GradLaunches() as grads:
        for step in range(steps):
            batch = task.prepare_batch(batch_raw)
            m, t_step = wall(lambda: trainer.train_step(batch))
            metrics.append(m)
            walls.append(t_step)
            print(f"    {name} step {step + 1} (mode {int(batch['modality_mode'])}): "
                  + " ".join(f"{k} {v:.4f}" for k, v in m.items()) + f" {1e3 * t_step:.1f} ms")
    launches = read_counts(table)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_k1_launches(name, launches, grads.n, steps, grad_each)
    unchanged(name, task.model, frozen)
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise SmokeFailure(f"{name}: non-finite losses {metrics}")
    for side, start, now in (("generator", gen0, trainer.gen_master),
                             ("discriminators", disc0, trainer.disc_master)):
        if all(torch.equal(now[n], x) for n, x in start.items()):
            raise SmokeFailure(f"{name}: the {side} did not move")
    step_s = sum(walls[1:]) / len(walls[1:])
    moved = sorted({n.split(".")[0] + "." + n.split(".")[1] for n in trainer.gen_master})
    print(f"  phase {name}: {1e3 * step_s:.1f} ms a step (steps 2-{steps}), "
          f"{E2E_BATCH * SECONDS / step_s:.1f} audio s trained a second, peak {peak:.2f} GiB, "
          f"K1 {SPEECH_FLASH} a step ({grads.n // steps} with a gradient), training {moved}")
    out = {"losses": metrics, "step_ms": [1e3 * x for x in walls], "mean_step_ms": 1e3 * step_s,
           "audio_s_per_s": E2E_BATCH * SECONDS / step_s, "peak_gib": peak,
           "launches": launches, "k1_grad_launches_a_step": grads.n // steps,
           "trainable_leaves": len(trainer.gen_master), "frozen_leaves": len(frozen)}
    del trainer
    return out


def train_e2e_gan_phase(table) -> dict:
    """E2EGanTask at full width (the trunk bf16; the generator, the
    discriminators and the STFT f32; seed 0): E2E_STAGE_STEPS[0] steps of
    stage 1 (the trunk frozen: K1 without a gradient), then
    E2E_STAGE_STEPS[1] of stage 2 (the encoders frozen: the Conformer's 12
    K1 launches with a gradient), batch E2E_BATCH x 16 s, waveform [4,
    256000, 1]."""
    import gc

    import torch

    from multimodalvc_tpu_torch.tasks import E2EGanTask, E2EGanTaskConfig

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    task = E2EGanTask(E2EGanTaskConfig(stage1_freeze=True), speech_config(), dtype=torch.bfloat16,
                      device=DEV)
    task.init_random(SPEECH_SEED)
    raw = make_speech_train_batch(E2E_BATCH, waveform=True)
    print(f"  train_e2e_gan: built in {time.perf_counter() - t0:.1f} s")
    record = {"stage1": gan_stage(table, task, raw, "train_e2e_gan/stage1", E2E_STAGE_STEPS[0], 0)}
    gc.collect()
    torch.cuda.empty_cache()
    task.cfg.stage1_freeze = False
    record["stage2"] = gan_stage(table, task, raw, "train_e2e_gan/stage2", E2E_STAGE_STEPS[1],
                                 CONFORMER_GRAD_LAUNCHES)
    del task
    gc.collect()
    torch.cuda.empty_cache()
    return record


def train_vocoder_phase(table) -> dict:
    """VocoderModel's GAN step at full width (conf/hifigan-vocoder.yaml, f32,
    seed VOCODER_SEED): VOCODER_STEPS steps on VOCODER_BATCH x 8320 samples
    (mels from hifigan_log_mel), every loss finite, the EMA moved, no kernel
    launched; then one step at VOCODER_CPU_BATCH rows on the card and on the
    CPU from the same state (TF32 off), the losses and the updated
    generator within VOCODER_CPU_TOL relative L2."""
    import gc

    import torch

    from multimodalvc_tpu_torch.models.vocoder import VocoderConfig, VocoderModel
    from multimodalvc_tpu_torch.ops.stft import hifigan_log_mel

    cfg = VocoderConfig()
    voc = VocoderModel(cfg, device=DEV)
    voc.init_random(VOCODER_SEED)
    voc.init_state(VOCODER_SEED)
    wav = seeded_waveform(VOCODER_BATCH, cfg.segment_length, seed=8)
    with torch.no_grad():
        batch = {"mel": hifigan_log_mel(wav), "wav": wav[..., None]}
    cpu_batch = {k: v[:VOCODER_CPU_BATCH] for k, v in batch.items()}
    # the card-versus-CPU step first, from the fresh state
    cpu = VocoderModel(cfg, device="cpu")
    cpu.init_state(VOCODER_SEED)
    cpu.generator.load_state_dict({k: x.cpu() for k, x in voc.generator.state_dict().items()})
    cpu.discriminator.load_state_dict({k: x.cpu() for k, x in
                                       voc.discriminator.state_dict().items()})
    cpu.reset_optimizers()
    state = {k: v for k, v in voc.state_dict().items()}
    saved = {"generator": {n: x.clone() for n, x in state["generator"].items()},
             "discriminator": {n: x.clone() for n, x in state["discriminator"].items()}}
    card_m = voc.train_step(cpu_batch)
    cpu_m = cpu.train_step({k: v.cpu() for k, v in cpu_batch.items()})
    flat = lambda d: torch.cat([x.double().reshape(-1).cpu() for x in d.values()])  # noqa: E731
    gen_rel = rel_l2(flat(voc.gen_master), flat(cpu.gen_master))
    loss_rel = max(abs(card_m[k] - cpu_m[k]) / abs(cpu_m[k]) for k in cpu_m)
    print(f"    vocoder step at batch {VOCODER_CPU_BATCH}, card vs CPU: losses rel "
          f"{loss_rel:.3e}, updated generator rel_l2 {gen_rel:.3e} (tol {VOCODER_CPU_TOL:g})")
    if not (gen_rel <= VOCODER_CPU_TOL and loss_rel <= VOCODER_CPU_TOL):
        raise SmokeFailure(f"train_vocoder: the card's step is {gen_rel:.3e} / {loss_rel:.3e} "
                           "from the CPU's")
    del cpu
    # back to the fresh state for the timed steps
    with torch.no_grad():
        for key, module in (("generator", voc.generator), ("discriminator", voc.discriminator)):
            module.load_state_dict({**module.state_dict(), **saved[key]})
    voc.reset_optimizers()
    ema0 = {n: e.clone() for n, e in voc.ema.items()}
    torch.cuda.reset_peak_memory_stats()
    metrics, walls = [], []
    reset_counts(table)
    for step in range(VOCODER_STEPS):
        m, t_step = wall(lambda: voc.train_step(batch))
        metrics.append(m)
        walls.append(t_step)
        print(f"    train_vocoder step {step + 1}: " + " ".join(f"{k} {v:.4f}" for k, v in m.items())
              + f" {1e3 * t_step:.1f} ms")
    launches = read_counts(table)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if any(launches.values()):
        raise SmokeFailure(f"train_vocoder: kernels launched {launches}")
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise SmokeFailure(f"train_vocoder: non-finite losses {metrics}")
    if all(torch.equal(voc.ema[n], e) for n, e in ema0.items()):
        raise SmokeFailure("train_vocoder: the EMA did not move")
    step_s = sum(walls[1:]) / len(walls[1:])
    audio = VOCODER_BATCH * cfg.segment_length / cfg.sample_rate
    print(f"  phase train_vocoder: {1e3 * step_s:.1f} ms a step (steps 2-{VOCODER_STEPS}), "
          f"{audio / step_s:.1f} audio s trained a second, peak {peak:.2f} GiB")
    del voc
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": metrics, "step_ms": [1e3 * x for x in walls], "mean_step_ms": 1e3 * step_s,
            "audio_s_per_s": audio / step_s, "peak_gib": peak, "launches": launches,
            "cpu_loss_rel": loss_rel, "cpu_generator_rel_l2": gen_rel}


def speech_train_phases(table) -> dict:
    """The four speech training phases, each model freed before the next."""
    return {"train_speech_nollm": train_speech_phase(table, "nollm"),
            "train_speech_llm": train_speech_phase(table, "llm"),
            "train_e2e_gan": train_e2e_gan_phase(table),
            "train_vocoder": train_vocoder_phase(table)}


def check_output(name, seqs, scores, vocab, new_tokens, beams=BEAMS):
    import torch

    if tuple(seqs.shape) != (BATCH, beams, new_tokens) or tuple(scores.shape) != (BATCH, beams):
        raise SmokeFailure(f"{name}: output shapes {tuple(seqs.shape)}, {tuple(scores.shape)}")
    if not bool(torch.isfinite(scores).all()):
        raise SmokeFailure(f"{name}: non-finite beam scores")
    if not bool(((seqs >= 0) & (seqs < vocab)).all()):
        raise SmokeFailure(f"{name}: token ids out of range")
    if not bool((scores[:, :-1] >= scores[:, 1:]).all()):
        raise SmokeFailure(f"{name}: beam scores not sorted")


def check_ancestry(name, launches, merges, layers, members) -> None:
    """The per-step launches of an ancestry phase (see EXPECT)."""
    steps = launches["beam_topk_columns"] + launches["beam_topk"]
    per_step = members * layers * steps
    anc_int8, anc_bf16 = launches["ancestry_attention"], launches["gen_attention_ancestor/bf16"]
    if anc_int8 and (anc_int8, merges) != (per_step, 0):
        raise SmokeFailure(f"{name}: {anc_int8} merged-entry launches and {merges} PyTorch "
                           f"merges in {steps} decode steps of {members} x {layers} layers")
    if anc_bf16 and (anc_bf16, merges) != (per_step, per_step):
        raise SmokeFailure(f"{name}: {anc_bf16} K3 launches and {merges} PyTorch merges in "
                           f"{steps} decode steps of {members} x {layers} layers")


def run_phase(table, name, call, expect=None, audio_s=BATCH * SECONDS, layers=None,
              members=1) -> tuple:
    """Run ``call`` once with every launch count set to 0 just before it and
    read just after; fails unless the launches meet ``expect`` (default
    ``EXPECT[name]``) and, given the model's ``layers``, ``check_ancestry``.
    Returns (the phase's record, what ``call`` returned)."""
    from multimodalvc_tpu_torch.nn import llama

    merges = []
    merge = llama.merge_softmax_segments

    def counted_merge(*args):
        merges.append(1)
        return merge(*args)

    reset_counts(table)
    with mock.patch.object(llama, "merge_softmax_segments", counted_merge):
        out, t_gen = wall(call)
    launches = read_counts(table)
    expect = EXPECT[name] if expect is None else expect
    wrong = {k: (n, expect.get(k, 0)) for k, n in launches.items()
             if not (n > 0 if expect.get(k, 0) == ON else n == expect.get(k, 0))}
    if wrong:
        raise SmokeFailure(f"{name}: launches (got, expected) {wrong}")
    steps = launches["beam_topk_columns"] + launches["beam_topk"]
    if name in ONCE_A_STEP and launches[ONCE_A_STEP[name]] != steps:
        raise SmokeFailure(f"{name}: {launches[ONCE_A_STEP[name]]} {ONCE_A_STEP[name]} launches "
                           f"in {steps} decode steps (one a step)")
    if layers is not None:
        check_ancestry(name, launches, len(merges), layers, members)
    rtf = audio_s / t_gen
    print(f"  phase {name}: {t_gen:.3f} s, realtime factor {rtf:.1f}x, launches "
          f"{ {k: n for k, n in launches.items() if n} }, PyTorch merges {len(merges)}")
    return {"generate_s": t_gen, "realtime_factor": rtf, "launches": launches,
            "pytorch_merges": len(merges)}, out


def serve(table, system, batch, name, new_tokens, gen_kw, expect=None, members=1,
          beams=BEAMS) -> tuple:
    """A ``generate`` phase with its output checked: (record, sequences,
    scores)."""
    phase, (seqs, scores) = run_phase(table, name, lambda: system.generate(
        batch, num_beams=beams, max_new_tokens=new_tokens, **gen_kw), expect,
        layers=system.cfg.llama.num_layers, members=members)
    check_output(name, seqs, scores, system.cfg.llama.vocab_size, new_tokens, beams)
    phase.update(new_tokens=new_tokens, beams=beams)
    output_digest(phase, name, seqs, scores)
    return phase, seqs, scores


def output_digest(phase, name, *tensors) -> None:
    """The phase's output bits (``digest``), to hold them against another
    tree's in one call."""
    phase["output_sha256"] = digest(*tensors)
    print(f"    {name}: output sha256 {phase['output_sha256']}")


def rel_l2(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


def compare(out, name, got, want, tol):
    """Record kernel-vs-plain (or cache-vs-cache) agreement; fail above tol."""
    rel = rel_l2(got, want)
    out[name] = {"max_abs": max_err(got, want), "rel_l2": rel, "tol_rel_l2": tol}
    print(f"  {name}: max_abs={out[name]['max_abs']:.3e} rel_l2={rel:.3e} (tol {tol:g})")
    if not rel <= tol:
        raise SmokeFailure(f"{name}: the two paths disagree (rel {rel:.3e})")


def prefill_and_step(llama, emb, mask, tokens, beams=BEAMS, **cache_kw):
    """One prefill and one decode step of every beam: (first logits, step logits)."""
    from multimodalvc_tpu_torch.nn.llama import decode_step, prefill_split_cache

    first, cache, lens = prefill_split_cache(
        llama, emb, mask, num_beams=beams, max_new_tokens=SHORT_TOKENS, **cache_kw)
    logits, _ = decode_step(llama, tokens, lens.repeat_interleave(beams)[:, None], cache)
    return first, logits


INT8_KV = dict(ancestry_reorder=True, kv_quant="int8")


def logits_gate(llama, emb, mask, tokens, logits, **cache_kw) -> dict:
    """The gate for end-to-end decode-step logits on these weights and this
    cache: the noise floor, the relative L2 by which one bf16 ulp on every
    9973rd prompt-embedding value moves ``logits`` (what rounding alone does
    here), times FLOOR_MARGIN, and at least REL_TOL.  Fails if the floor
    exceeds FLOOR_MAX."""
    floor = rel_l2(prefill_and_step(llama, nudge(emb), mask, tokens, **cache_kw)[1], logits)
    return noise_gate(floor, "logits", "the prompt")


def nudge(x):
    """x with one bf16 ulp (x (1 + 2^-7)) on every 9973rd value."""
    out = x.clone()
    flat = out.view(-1)
    flat[::9973] = flat[::9973] * (1 + 2 ** -7)
    return out


def noise_gate(floor: float, what: str, where: str) -> dict:
    """The gate of an end-to-end output (``what``) from the noise floor that
    one bf16 ulp on 0.01% of ``where`` gives it: FLOOR_MARGIN times the
    floor, and at least REL_TOL; fails if the floor exceeds FLOOR_MAX."""
    tol = max(REL_TOL, FLOOR_MARGIN * floor)
    print(f"    noise floor (one bf16 ulp on 0.01% of {where}): rel_l2={floor:.3e}, "
          f"{what} gate {tol:.3e} (floor limit {FLOOR_MAX:g})")
    if not floor <= FLOOR_MAX:
        raise SmokeFailure(f"the noise floor {floor:.3e} exceeds {FLOOR_MAX:g}")
    return {"noise_floor_rel_l2": floor, "tol_rel_l2": tol}


def isolate(llama, emb, mask, tokens, logits, names) -> dict:
    """Not gated: the step logits with one kernel at a time made plain,
    against the all-kernel ``logits``: which kernel moves them, and how far."""
    out = {}
    for name in names:
        with plain_versions(only=(name,)):
            out[name] = rel_l2(prefill_and_step(llama, emb, mask, tokens, **INT8_KV)[1], logits)
    print("    step logits with one kernel plain: "
          + ", ".join(f"{k} {v:.3e}" for k, v in out.items()))
    return out


def layerwise(llama, emb, mask, tokens, name, beams=BEAMS) -> dict:
    """One decode step, layer by layer: each layer's update (output minus
    input) from the same input and cache, through the kernels and through
    the plain versions, then the final norm and unembed.  Gated at REL_TOL."""
    from multimodalvc_tpu_torch.nn.llama import prefill_split_cache

    _, cache, lens = prefill_split_cache(
        llama, emb, mask, num_beams=beams, max_new_tokens=SHORT_TOKENS, **INT8_KV)
    pos = lens.repeat_interleave(beams)[:, None]
    x = llama.embed(tokens)
    worst = 0.0
    for layer, c in zip(llama.layers, cache):
        # both runs write the same slot of this layer's cache from the same x
        y, _ = layer(x, pos, None, c)
        with plain_versions():
            y_plain, _ = layer(x, pos, None, c)
        worst = max(worst, rel_l2(y - x, y_plain - x))
        x = y
    hidden = llama.norm(x)
    logits = llama.unembed(hidden)
    with plain_versions():
        worst_unembed = rel_l2(logits, llama.unembed(hidden))
    out = {f"{name}/layerwise": {"rel_l2_worst_layer": worst, "rel_l2_unembed": worst_unembed,
                                 "tol_rel_l2": REL_TOL}}
    print(f"  {name}/layerwise: worst layer rel_l2={worst:.3e}, unembed {worst_unembed:.3e} "
          f"(tol {REL_TOL:g})")
    if not max(worst, worst_unembed) <= REL_TOL:
        raise SmokeFailure(f"{name}: kernels and plain versions disagree layer by layer")
    return out
def reorder_equivalence(llama, emb, mask, tokens) -> dict:
    """The ancestry (K3 bf16) and the gather (K6) bf16-KV caches from one
    prefill, two decode steps with a beam reorder between them, then each
    layer's attention on the same random q/k/v against both caches, gated at
    REL_TOL; the logits at the gate of ``logits_gate`` (bf16 KV, ancestry),
    with the plain versions' beside them.

    The two reorders compute the same attention but round to bf16 at other
    points (the ancestry decode merges f32 partials; the gather reorder
    rounds the normalised weights and each segment's sum, both in the JAX op
    order), so each layer differs by ~2^-9 relative and the logits by what
    28 layers of random weights make of that."""
    import torch

    from multimodalvc_tpu_torch.nn.llama import decode_step, prefill_split_cache
    from multimodalvc_tpu_torch.ops.beam_search import _gather_beams

    cfg = llama.cfg
    parents = torch.tensor([[1, 1, 0, 4, 2]] * BATCH, device=DEV)
    step_tokens = [tokens, torch.flip(tokens, dims=(0,))]

    def two_steps(reorder):
        _, cache, lens = prefill_split_cache(
            llama, emb, mask, num_beams=BEAMS, max_new_tokens=SHORT_TOKENS,
            ancestry_reorder=reorder, kv_quant=None)
        pos = lens.repeat_interleave(BEAMS)[:, None]
        out = []
        for i, tok in enumerate(step_tokens):
            step_logits, cache = decode_step(llama, tok, pos + i, cache)
            out.append(step_logits)
            cache = _gather_beams(cache, parents, BATCH, BEAMS)
        return out, cache

    checks = {}
    (anc_logits, anc_cache), (gat_logits, gat_cache) = two_steps(True), two_steps(False)
    with plain_versions():
        plain_anc, _ = two_steps(True)
        plain_gat, _ = two_steps(False)
    g = torch.Generator(device=DEV).manual_seed(9)
    rows = BATCH * BEAMS
    worst = 0.0
    for i, layer in enumerate(llama.layers):
        attn = layer.self_attn
        q = torch.randn(rows, cfg.num_heads, 1, cfg.head_dim, generator=g, device=DEV)
        k, v = (torch.randn(rows, cfg.num_kv_heads, 1, cfg.head_dim, generator=g, device=DEV)
                for _ in range(2))
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
        a, _ = attn._ancestry_step(q, k, v, dict(anc_cache[i]))
        b, _ = attn._gather_step(q, k, v, dict(gat_cache[i]))
        worst = max(worst, rel_l2(a, b))
    checks["bf16_kv/attention_ancestry_vs_gather"] = {"rel_l2_worst_layer": worst,
                                                       "tol_rel_l2": REL_TOL}
    print(f"  bf16_kv/attention_ancestry_vs_gather: worst layer rel_l2={worst:.3e} (tol {REL_TOL:g})")
    if not worst <= REL_TOL:
        raise SmokeFailure(f"bf16 KV: the ancestry and gather attention disagree ({worst:.3e})")
    gate = logits_gate(llama, emb, mask, tokens, anc_logits[0], ancestry_reorder=True,
                       kv_quant=None)
    for i in range(2):
        name = f"bf16_kv/logits_ancestry_vs_gather_step{i + 1}"
        compare(checks, name, anc_logits[i], gat_logits[i], gate["tol_rel_l2"])
        plain = rel_l2(plain_anc[i], plain_gat[i])
        checks[name].update(plain_rel_l2=plain, noise_floor_rel_l2=gate["noise_floor_rel_l2"])
        print(f"    the same through the plain versions: rel_l2={plain:.3e}")
    return checks


def contains(row, phrase) -> bool:
    return any(row[i : i + len(phrase)] == phrase for i in range(len(row) - len(phrase) + 1))


def constrained_phase(table, system, batch) -> dict:
    """Unordered constraints: rows 0-5 one 2-token phrase each (seed 3),
    rows 6-7 none; the gather reorder with a bf16 KV cache (K6), the
    candidates by a plain top-k (no K4, no K5).  Every constrained row's
    best beam must hold its phrase: bank striping keeps a satisfied
    hypothesis once one exists, and only satisfied ones finalise."""
    import numpy as np

    vocab = system.cfg.llama.vocab_size
    phrases = np.random.default_rng(3).integers(3, vocab // 2, (6, 2)).tolist()
    cons = [[p] for p in phrases] + [[] for _ in range(BATCH - len(phrases))]
    phase, seqs, _ = serve(table, system, batch, "bf16_constrained", SHORT_TOKENS,
                           dict(constraints=cons))
    best = seqs[:, 0].tolist()
    missing = [i for i, p in enumerate(phrases) if not contains(best[i], p)]
    if missing:
        raise SmokeFailure(f"bf16_constrained: rows {missing} lack their phrase")
    phase["rows_holding_their_phrase"] = len(phrases)
    return phase


def full_cache_phase(table, system, emb, mask) -> dict:
    """``generate_beam(share_prompt_kv=False)`` on the bf16 prompt: the
    [B*K, 8, T+L, 128] per-beam cache, reordered by K6 every step; its wall
    holds no encoder."""
    import torch

    from multimodalvc_tpu_torch.nn.llama import generate_beam

    cfg = system.cfg

    def call():
        with torch.inference_mode():
            return generate_beam(system.llama_module, emb, mask, eos_token_id=cfg.eos_token_id,
                                 pad_token_id=cfg.pad_token_id, num_beams=BEAMS,
                                 max_new_tokens=SHORT_TOKENS, share_prompt_kv=False)

    phase, (seqs, scores) = run_phase(table, "bf16_full_cache", call)
    check_output("bf16_full_cache", seqs, scores, cfg.llama.vocab_size, SHORT_TOKENS)
    phase["new_tokens"] = SHORT_TOKENS
    output_digest(phase, "bf16_full_cache", seqs, scores)
    return phase


def long_form_phase(table, system, flash_per_generate: int) -> dict:
    """``generate_long_form`` on a 32 s clip (800 frames, chunk_frames 400,
    mel [8, 80, 3200]), int8 KV: two ``generate`` calls, K1 twice as often as
    one, and one merged token row per sample."""
    import numpy as np
    import torch

    long_batch = make_long_batch()
    calls = []
    generate = system.generate

    def counted(*args, **kw):
        calls.append(1)
        return generate(*args, **kw)

    expect = {**EXPECT["bf16_weights"], "flash_attention": 2 * flash_per_generate}
    with mock.patch.object(system, "generate", counted):
        phase, rows = run_phase(table, "long_form", lambda: system.generate_long_form(
            long_batch, chunk_frames=SECONDS * 25, num_beams=BEAMS, max_new_tokens=SHORT_TOKENS,
            kv_quant="int8"), expect, audio_s=BATCH * 2 * SECONDS,
            layers=system.cfg.llama.num_layers)
    vocab = system.cfg.llama.vocab_size
    if len(calls) != 2:
        raise SmokeFailure(f"long_form: {len(calls)} generate calls, expected 2")
    if len(rows) != BATCH or not all(isinstance(r, np.ndarray) and r.ndim == 1 and len(r)
                                     and (r >= 0).all() and (r < vocab).all() for r in rows):
        raise SmokeFailure(f"long_form: expected {BATCH} merged token rows")
    phase.update(generate_calls=len(calls), merged_lengths=[len(r) for r in rows])
    output_digest(phase, "long_form", *(torch.from_numpy(np.ascontiguousarray(r)) for r in rows))
    return phase


def ensemble_phase(table, system, batch, flash_per_generate: int) -> dict:
    """Two bf16 systems (seeds 0 and 1), int8 KV, ancestry: each member runs
    its own encoders (K1 twice as often as one system) and decode (the
    merged entry in both), K4 on the averaged log-probs."""
    import torch

    member = build_system(seed=1)
    expect = {**EXPECT["bf16_weights"], "flash_attention": 2 * flash_per_generate}
    phase, _, _ = serve(table, system, batch, "bf16_ensemble2", SHORT_TOKENS,
                        dict(kv_quant="int8", ensemble=[member]), expect, members=2)
    del member
    torch.cuda.empty_cache()
    return phase


def bf16_weight_phases(table, batch) -> tuple:
    """The bf16-weight phases on one system: int8 KV with the ancestry
    decode, the two bf16-KV phases, constraints, the full cache, long-form
    and a two-member ensemble.  Returns (phases, checks, prompt, first-step
    tokens, the bf16-weight logits for the quantized phases to compare with)."""
    import torch

    system = build_system()
    llama = system.llama_module
    system.generate(batch, num_beams=BEAMS, max_new_tokens=4, kv_quant="int8")  # warm-up
    phases = {}
    phases["bf16_weights"], seqs, _ = serve(table, system, batch, "bf16_weights", SHORT_TOKENS,
                                            dict(kv_quant="int8"))
    # generate()'s defaults: kv_quant=None, and on the GPU the ancestry decode
    phases["bf16_kv_ancestry"], _, _ = serve(table, system, batch, "bf16_kv_ancestry",
                                             SHORT_TOKENS, {})
    phases["bf16_kv_gather"], _, _ = serve(table, system, batch, "bf16_kv_gather", SHORT_TOKENS,
                                           dict(ancestry_reorder=False))
    tokens = seqs[:, :, 0].reshape(-1, 1)

    # the same weights and inputs through the kernels and the plain versions:
    # the two encoders (K1), then one prefill + one decode step (K2, K3) from
    # the same prompt embeddings.  The prompt itself is not compared: the
    # speech-rate factor is truncated to an integer query count, so a last-bit
    # difference upstream may move a query across the left-pad boundary.
    enc = system.module.encoder
    checks = {}
    with torch.inference_mode():
        emb, mask = system.module.prompt_for_generation(batch)

        def encoders():
            return (enc.whisper(batch["audio_feats"]),
                    enc.avhubert(video=batch["video"], lengths=batch["video_lengths"]))

        got = encoders() + prefill_and_step(llama, emb, mask, tokens, **INT8_KV)
        with plain_versions():
            want = encoders() + prefill_and_step(llama, emb, mask, tokens, **INT8_KV)
        # bf16 activations: the kernels round the attention probabilities at
        # other points than the plain versions (bf16 relative resolution
        # 2^-8), and 24 layers carry that on.  The prefill (130 slots) runs
        # no kernel, so its logits must be identical.
        for name, a, c in zip(("whisper_out", "avhubert_out", "prefill_logits", "step_logits"),
                              got, want):
            compare(checks, f"bf16_weights/{name}", a, c, 0.0 if name == "prefill_logits" else REL_TOL)
        bf16_logits = got[2:]

        checks.update(reorder_equivalence(llama, emb, mask, tokens))
    phases["beam8_int8_kv"] = beam8_phase(table, system, batch, emb, mask)
    # the ancestry decode past beam 5 with both caches: launches and output
    for beams, kv in WIDE_DECODES:
        name = f"beam{beams}_{kv}_kv"
        phases[name], _, _ = serve(table, system, batch, name, SHORT_TOKENS,
                                   dict(kv_quant="int8") if kv == "int8" else {},
                                   EXPECT["beam8_int8_kv" if kv == "int8" else "bf16_kv_ancestry"],
                                   beams=beams)
    flash = phases["bf16_weights"]["launches"]["flash_attention"]
    phases["bf16_constrained"] = constrained_phase(table, system, batch)
    phases["bf16_full_cache"] = full_cache_phase(table, system, emb, mask)
    phases["long_form"] = long_form_phase(table, system, flash)
    phases["bf16_ensemble2"] = ensemble_phase(table, system, batch, flash)
    del system, llama, enc
    torch.cuda.empty_cache()
    return phases, checks, (emb, mask), tokens, bf16_logits


WIDE_PHASE_BEAMS = 8  # 24 query rows a kv head: two 16-row tiles of the merged entry
# further ancestry decodes past beam 5, (beams, KV cache): 51 query rows a kv
# head (four tiles) and K4's wide instance at beam 17; the bf16 cache through
# generate()'s defaults, K3 on the tiles and the PyTorch merge
WIDE_DECODES = ((17, "int8"), (8, "bf16"), (17, "bf16"))


def beam8_phase(table, system, batch, emb, mask) -> dict:
    """bf16 weights, int8 KV, the ancestry decode at beam 8 (16 tokens): the
    merged entry on two row tiles a kv head once a layer and step, K4 at
    n = 16.  Its tokens must equal the same generate's with K4 plain (the
    kernel's selection is exact; its statistics are an ulp from PyTorch's);
    one prefill + decode step at beam 8 is held against the plain versions,
    its logits at ``logits_gate``'s gate and layer by layer at REL_TOL.  Not
    gated: the beams whose tokens equal the fully plain path's, from the
    same prompt embeddings, at beam 8 and at beam 5, which shows how far
    the chaos of the random-weight model carries the decode's rounding."""
    import torch

    from multimodalvc_tpu_torch.nn.llama import generate_beam
    from multimodalvc_tpu_torch.ops import beam_search, topk

    beams, name = WIDE_PHASE_BEAMS, "beam8_int8_kv"
    kw = dict(num_beams=beams, max_new_tokens=SHORT_TOKENS, kv_quant="int8")
    phase, (seqs, scores) = run_phase(table, name, lambda: system.generate(batch, **kw),
                                      layers=system.cfg.llama.num_layers)
    cfg = system.cfg
    check_output(name, seqs, scores, cfg.llama.vocab_size, SHORT_TOKENS, beams)
    output_digest(phase, name, seqs, scores)
    with mock.patch.object(beam_search, "beam_topk_columns", topk.beam_topk_columns_plain):
        p_seqs, p_scores = system.generate(batch, **kw)
    if not torch.equal(seqs, p_seqs):
        rows = int((seqs != p_seqs).any(dim=-1).any(dim=-1).sum())
        raise SmokeFailure(f"{name}: K4 made plain changes the tokens of {rows} rows")
    phase.update(new_tokens=SHORT_TOKENS, beams=beams, k4_plain_tokens_identical=True,
                 k4_plain_score_max_abs=max_err(scores, p_scores))

    def decode(k):
        with torch.inference_mode():
            return generate_beam(system.llama_module, emb, mask, eos_token_id=cfg.eos_token_id,
                                 pad_token_id=cfg.pad_token_id, num_beams=k,
                                 max_new_tokens=SHORT_TOKENS, ancestry_reorder=True,
                                 kv_quant="int8")[0]

    for k in (beams, BEAMS):
        got = decode(k)
        with plain_versions():
            want = decode(k)
        phase[f"beam{k}_beams_equal_fully_plain"] = int((got == want).all(dim=-1).sum())
        phase[f"beam{k}_beams"] = got.shape[0] * got.shape[1]
    print(f"  {name}: tokens identical with K4 plain (scores max_abs "
          f"{phase['k4_plain_score_max_abs']:.3e}); beams equal to the fully plain decode of "
          f"the same prompt: beam {beams} {phase[f'beam{beams}_beams_equal_fully_plain']} of "
          f"{phase[f'beam{beams}_beams']}, beam {BEAMS} "
          f"{phase[f'beam{BEAMS}_beams_equal_fully_plain']} of {phase[f'beam{BEAMS}_beams']}")
    checks = {}
    with torch.inference_mode():
        tokens = seqs[:, :, 0].reshape(-1, 1)
        got = prefill_and_step(system.llama_module, emb, mask, tokens, beams=beams, **INT8_KV)
        with plain_versions():
            want = prefill_and_step(system.llama_module, emb, mask, tokens, beams=beams, **INT8_KV)
        gate = logits_gate(system.llama_module, emb, mask, tokens, got[1], beams=beams, **INT8_KV)
        compare(checks, f"{name}/step_logits", got[1], want[1], gate["tol_rel_l2"])
        checks[f"{name}/step_logits"]["noise_floor_rel_l2"] = gate["noise_floor_rel_l2"]
        checks.update(layerwise(system.llama_module, emb, mask, tokens, name, beams))
    phase["step_check"] = checks
    return phase


def ngram_phase(table, system, batch) -> dict:
    """n-gram blocking (size 3) on the int8-weight system, int8 KV: K5 once
    per decode step and K4 never; no returned beam repeats a 3-gram; the same
    ``generate`` with only K5 plain gives identical sequences and scores, and
    K5 matches its plain version exactly on the log-probs of every step of
    that run."""
    import torch

    from multimodalvc_tpu_torch.ops import beam_search, topk

    gen_kw = dict(kv_quant="int8", no_repeat_ngram_size=3)
    phase, seqs, scores = serve(table, system, batch, "int8_ngram", SHORT_TOKENS, gen_kw)
    steps = phase["launches"]["ancestry_attention"] // system.cfg.llama.num_layers
    if phase["launches"]["beam_topk"] != steps:
        raise SmokeFailure(f"int8_ngram: K5 launched {phase['launches']['beam_topk']} times "
                           f"in {steps} decode steps")
    eos = system.cfg.eos_token_id
    for row in seqs.reshape(-1, SHORT_TOKENS).tolist():
        toks = row[: row.index(eos) + 1] if eos in row else row
        grams = [tuple(toks[i : i + 3]) for i in range(len(toks) - 2)]
        if len(grams) != len(set(grams)):
            raise SmokeFailure(f"int8_ngram: a beam repeats a 3-gram: {toks}")

    captured = []

    def plain_k5(logp, sc, n):
        captured.append((logp.clone(), sc.clone(), n))
        return topk.beam_topk_plain(logp, sc, n)

    def again():
        return system.generate(batch, num_beams=BEAMS, max_new_tokens=SHORT_TOKENS, **gen_kw)

    with mock.patch.object(beam_search, "beam_topk", plain_k5):
        p_seqs, p_scores = again()
    identical = bool(torch.equal(seqs, p_seqs) and torch.equal(scores, p_scores))
    deterministic = None
    if not identical:  # the kernel run once more: is the decode itself deterministic?
        r_seqs, r_scores = again()
        deterministic = bool(torch.equal(seqs, r_seqs) and torch.equal(scores, r_scores))
        if deterministic:
            raise SmokeFailure("int8_ngram: K5 made plain changes the sequences or scores")
    worst = 0.0
    for logp, sc, n in captured:
        (gv, gi), (wv, wi) = topk.beam_topk(logp, sc, n), topk.beam_topk_plain(logp, sc, n)
        if not torch.equal(gi, wi):
            raise SmokeFailure("int8_ngram: K5 and its plain version pick other candidates")
        worst = max(worst, max_err(gv, wv))
    if worst > 1e-6 or len(captured) != steps:
        raise SmokeFailure(f"int8_ngram: K5 on the phase's log-probs: max_err {worst:.3e}, "
                           f"{len(captured)} steps of {steps}")
    print(f"  int8_ngram: {steps} decode steps; K5 plain gives "
          f"{'identical' if identical else 'different'} sequences and scores"
          + ("" if deterministic is None else ", the decode is nondeterministic")
          + f"; K5 vs plain on the {len(captured)} steps' log-probs: max_err {worst:.1e}")
    phase.update(decode_steps=steps, k5_plain_identical=identical,
                 nondeterministic=deterministic is False, k5_steps_checked=len(captured),
                 k5_step_max_abs_err=worst)
    return phase


def quantized_phase(table, batch, mode, new_tokens, prompt, tokens, bf16_logits) -> dict:
    """A full-width system with ``mode`` weights, served with the int8 KV
    cache and the ancestry decode; one prefill + decode step held against
    the plain versions on the same quantized weights.  With int8 weights the
    n-gram phase follows on the same system.  Returns {phase name: record}."""
    import torch

    from multimodalvc_tpu_torch.nn.llama import prefill_split_cache

    system = build_system(mode)
    llama = system.llama_module
    name = f"{mode}_weights"
    system.generate(batch, num_beams=BEAMS, max_new_tokens=4, kv_quant="int8")  # warm-up
    phase, _, _ = serve(table, system, batch, name, new_tokens, dict(kv_quant="int8"))
    emb, mask = prompt
    with torch.inference_mode():
        # stage walls of the same inputs, after the measured run
        _, t_enc = wall(lambda: system.module.prompt_for_generation(batch))
        _, t_pre = wall(lambda: prefill_split_cache(
            llama, emb, mask, num_beams=BEAMS, max_new_tokens=new_tokens, **INT8_KV))
        steps = phase["launches"]["ancestry_attention"] // system.cfg.llama.num_layers
        decode_ms = (phase["generate_s"] - t_enc - t_pre) / max(steps, 1) * 1e3
        print(f"  {name}: encoders+prompt {t_enc * 1e3:.1f} ms, prefill {t_pre * 1e3:.1f} ms, "
              f"decode {decode_ms:.2f} ms/step over {steps} steps")
        phase.update(encoders_s=t_enc, prefill_s=t_pre, decode_ms_per_step=decode_ms,
                     decode_steps=steps)
        checks = {}
        got = prefill_and_step(llama, emb, mask, tokens, **INT8_KV)
        with plain_versions():
            want = prefill_and_step(llama, emb, mask, tokens, **INT8_KV)
        gate = logits_gate(llama, emb, mask, tokens, got[1], **INT8_KV)
        for label, a, c in zip(("prefill_logits", "step_logits"), got, want):
            compare(checks, f"{name}/{label}", a, c, gate["tol_rel_l2"])
        checks[f"{name}/step_logits"]["noise_floor_rel_l2"] = gate["noise_floor_rel_l2"]
        checks[f"{name}/step_logits"]["one_kernel_plain_rel_l2"] = isolate(
            llama, emb, mask, tokens, got[1],
            (f"{mode}_matmul", "ancestry_attention"))
        checks.update(layerwise(llama, emb, mask, tokens, name))
        # quantization error itself, not gated: against the bf16 weights
        phase["rel_l2_vs_bf16_weights"] = {
            label: rel_l2(a, c) for label, a, c in zip(("prefill_logits", "step_logits"),
                                                       got, bf16_logits)}
        print(f"  {name}: logits vs bf16 weights (not gated) {phase['rel_l2_vs_bf16_weights']}")
    phase["step_check"] = checks
    out = {name: phase}
    if mode == "int8":
        out["int8_ngram"] = ngram_phase(table, system, batch)
    del system, llama
    torch.cuda.empty_cache()
    return out


INT8_KV_GEN = dict(kv_quant="int8")
GATHER_GEN = dict(ancestry_reorder=False)  # bf16 KV, the gather reorder: K6 once a step


def profile_decode(table, system, batch, steps: int = 10, top: int = 12,
                   gen_kw=INT8_KV_GEN) -> dict:
    """Where a decode step's time goes, at the serving batch with the int8
    KV cache (or ``gen_kw``'s): generate() with 1 + ``steps`` new tokens
    against generate() with 1 (the prefill's token, no decode step),
    unprofiled (the median of three walls) and under torch.profiler (device
    time of every kernel, copy and memset); the differences over ``steps``
    are the decode steps' share, without the encoders and the prefill."""
    import statistics
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def gen(n):
        return system.generate(batch, num_beams=BEAMS, max_new_tokens=n, **gen_kw)

    def unprofiled(n):
        return statistics.median(wall(lambda: gen(n))[1] for _ in range(3))

    def profiled(n):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, t = wall(lambda: gen(n))
        us, count = Counter(), Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us[e.name] += e.time_range.elapsed_us()
                count[e.name] += 1
        return t, us, count

    reset_counts(table)
    gen(1 + steps)
    counts = read_counts(table)
    n = counts["beam_topk_columns"] + counts["beam_topk"]  # one candidate launch a step
    if n != steps:
        raise SmokeFailure(f"profile: {n} decode steps, expected {steps}")
    wall_ms = (unprofiled(1 + steps) - unprofiled(1)) / steps * 1e3
    (t_long, us_long, n_long), (t_short, us_short, n_short) = profiled(1 + steps), profiled(1)
    per_step = {k: (us_long[k] - us_short[k]) / steps / 1e3 for k in us_long}
    device_ms = sum(per_step.values())
    if device_ms <= 0:
        raise SmokeFailure("profile: torch.profiler recorded no device time")
    prof_wall_ms = (t_long - t_short) / steps * 1e3
    out = {
        "decode_ms_per_step": wall_ms, "profiled_ms_per_step": prof_wall_ms,
        "device_ms_per_step": device_ms, "idle_share_profiled": 1 - device_ms / prof_wall_ms,
        "idle_share_unprofiled": 1 - device_ms / wall_ms,
        "device_ops_per_step": (sum(n_long.values()) - sum(n_short.values())) / steps,
        "top_ms_per_step": dict(sorted(per_step.items(), key=lambda kv: -kv[1])[:top]),
        # K7's, K8's and the decode attention's kernels, summed by their
        # __global__ names (K2, K3, the merged entry)
        "kernel_ms_per_step": {name: sum(v for k, v in per_step.items() if f"{name}_kernel" in k)
                               for name in ("int8_matmul", "int4_matmul", "prompt_attention",
                                            "gen_attention", "ancestry_attention",
                                            "beam_topk_columns", "beam_topk", "gather_rows")},
    }
    print(f"  decode {wall_ms:.2f} ms/step ({prof_wall_ms:.2f} profiled), device "
          f"{device_ms:.3f} ms/step, idle share {out['idle_share_unprofiled']:.3f} "
          f"({out['idle_share_profiled']:.3f} profiled), {out['device_ops_per_step']:.0f} device "
          f"ops/step")
    print("  " + ", ".join(f"{k} {v:.3f} ms/step" for k, v in out["kernel_ms_per_step"].items()))
    for k, v in out["top_ms_per_step"].items():
        print(f"    {v:8.3f} ms/step  {k[:110]}")
    return out


def wrapper_host_us(llama, rounds: int = 5) -> dict:
    """Host time a call of K7's wrapper, beside ``F.linear`` on bf16 weights
    of the same shapes: one decode step's projections (every QuantDense of
    the LLaMA: 196 of the trunk and the unembed) on [40, d_in] bf16 inputs,
    issued from an idle device and timed to the last enqueue (the launch
    queue holds them all, so no call waits for the device); the median of
    ``rounds``, in us a call."""
    import statistics

    import torch
    import torch.nn.functional as F

    from multimodalvc_tpu_torch.nn.llama import QuantDense
    from multimodalvc_tpu_torch.ops.int8_matmul import int8_matmul

    dense = [m for m in llama.modules() if isinstance(m, QuantDense)]
    shapes = {tuple(m.w_q.shape) for m in dense}
    g = torch.Generator(device=DEV).manual_seed(9)
    xs = {d_in: torch.randn(BATCH * BEAMS, d_in, generator=g, device=DEV).to(torch.bfloat16)
          for d_in, _ in shapes}
    w16 = {(d_in, d_out): torch.zeros(d_out, d_in, dtype=torch.bfloat16, device=DEV)
           for d_in, d_out in shapes}
    calls = {
        "int8_matmul": [functools.partial(int8_matmul, xs[m.w_q.shape[0]], m.w_q, m.w_scale,
                                          out_dtype=m.dtype) for m in dense],
        "linear_bf16": [functools.partial(F.linear, xs[m.w_q.shape[0]], w16[tuple(m.w_q.shape)])
                        for m in dense],
    }

    def one_round(fns) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fn in fns:
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / len(fns) * 1e6

    out = {"calls_per_step": len(dense)}
    for name, fns in calls.items():
        one_round(fns)  # warm-up
        out[f"{name}_us"] = statistics.median(one_round(fns) for _ in range(rounds))
    print(f"  host time a call over {len(dense)} projections: int8_matmul "
          f"{out['int8_matmul_us']:.2f} us, F.linear bf16 {out['linear_bf16_us']:.2f} us")
    return out


def candidate_stage() -> dict:
    """The decode step's candidate stage at the serving shape [40, 128256]
    f32, CUDA-event ms: the row statistics in PyTorch (amax, subtract, exp,
    sum, log) and K4 given them, as the step ran before K4 took them itself;
    and K4 taking them itself (None where this tree's K4 takes no None).  It
    runs on an older tree too, to hold two trees' stages in one call."""
    import torch

    from multimodalvc_tpu_torch.ops.topk import beam_topk_columns

    g = torch.Generator(device=DEV).manual_seed(14)
    b, k, v, n = BATCH, BEAMS, 128256, 2 * BEAMS
    lf = torch.randn(b * k, v, generator=g, device=DEV) * 3.0
    scores = torch.randn(b, k, generator=g, device=DEV)

    def outside():
        row_max = lf.amax(dim=-1, keepdim=True)
        row_ls = torch.log(torch.exp(lf - row_max).sum(dim=-1, keepdim=True))
        return beam_topk_columns(lf, row_max, row_ls, scores, n)

    out = {"stats_outside_ms": time_ms(outside, iters=20), "stats_inside_ms": None}
    try:
        beam_topk_columns(lf, None, None, scores, n)
    except (AttributeError, TypeError):
        pass
    else:
        out["stats_inside_ms"] = time_ms(lambda: beam_topk_columns(lf, None, None, scores, n),
                                         iters=20)
    print(f"  candidate stage [40, 128256]: statistics in PyTorch + K4 "
          f"{out['stats_outside_ms']:.4f} ms, K4 with the statistics inside "
          f"{out['stats_inside_ms']}")
    return out


def profile_gather(table, batch) -> dict:
    """``--profile-gather``: the decode profile of the bf16-weight system on
    the gather path (bf16 KV, ``ancestry_reorder=False``), K6's launches
    among the device ops a step.  It runs on an older tree too (this file
    copied in), to hold two trees' steps in one call."""
    import torch

    system = build_system()
    system.generate(batch, num_beams=BEAMS, max_new_tokens=4, **GATHER_GEN)  # warm-up
    with torch.inference_mode():
        out = profile_decode(table, system, batch, gen_kw=GATHER_GEN)
    del system
    torch.cuda.empty_cache()
    return out


def profile_main(table, batch) -> dict:
    """``--profile``: the decode profile of the bf16-, int8- and int4-weight
    systems (int8 KV, ancestry), one system at a time, the host time of
    K7's wrapper on the int8 system's weights, and the candidate stage
    alone (``candidate_stage``)."""
    import torch

    out = {"candidate_stage": candidate_stage()}
    for mode in (None, "int8", "int4"):
        system = build_system(mode)
        system.generate(batch, num_beams=BEAMS, max_new_tokens=4, kv_quant="int8")  # warm-up
        with torch.inference_mode():
            out[f"{mode or 'bf16'}_weights"] = profile_decode(table, system, batch)
            if mode == "int8":
                out["int8_wrapper_host"] = wrapper_host_us(system.llama_module)
        del system
        torch.cuda.empty_cache()
    return out


# --plans: the decode-attention entries at the serving shapes under other
# chunk plans than decode_plan's: (batch, generated slots, valid, entry,
# [(prompt slots a chunk, generated slots a chunk, splits), ...]); 130
# prompt slots, int8 KV.  The first plan of a case is decode_plan's.
PLAN_CASES = [
    (8, SHORT_TOKENS, SHORT_TOKENS - 1, "merged",
     [(48, 8, 5), (48, 4, 7), (32, 6, 8), (64, 6, 6), (80, 16, 3), (48, 8, 3)]),
    (8, SHORT_TOKENS, SHORT_TOKENS - 1, "gen", [(0, 3, 6), (0, 4, 4), (0, 8, 2), (0, 16, 1)]),
    (8, SHORT_TOKENS, SHORT_TOKENS - 1, "prompt", [(48, 0, 3), (32, 0, 5), (80, 0, 2), (16, 0, 7)]),
    (8, 64, 63, "merged", [(80, 16, 6), (48, 16, 7), (80, 13, 7), (128, 22, 5)]),
    (48, 64, 41, "merged", [(80, 16, 3), (80, 16, 6), (80, 16, 2), (128, 22, 5), (48, 8, 7)]),
]


def plans_main() -> list:
    """``--plans``: time each entry of PLAN_CASES under each plan (the
    wrappers' ``decode_plan`` replaced by the plan), held against the plain
    version at DECODE_TOL; fails if the first plan is not decode_plan's."""
    import torch

    from multimodalvc_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device=DEV).manual_seed(12)
    beams, h, d, tp = BEAMS, 24, 128, 130
    out = []
    for b, slots, valid, entry, plans in PLAN_CASES:
        q, ((pk, pks), (pv, pvs)), mask, ((gk, gks), (gv, gvs)), anc = decode_inputs(
            b, slots, "int8", g)
        seg = (tp if entry != "gen" else 0, slots if entry != "prompt" else 0)
        if tuple(da.decode_plan(b, beams, h, 8, d, *seg)) != da.DecodePlan(
                plans[0][0], -(-seg[0] // plans[0][0]) if seg[0] else 0, plans[0][1],
                -(-seg[1] // plans[0][1]) if seg[1] else 0, plans[0][2]):
            raise SmokeFailure(f"--plans {entry} b{b} L{slots}: the first plan is not decode_plan's")
        kw = dict(beams=beams, scale=d ** -0.5)
        if entry == "merged":
            args = (q, pk, pv, mask, gk, gv, anc, valid)
            kw.update(prompt_k_scale=pks, prompt_v_scale=pvs, gen_k_scale=gks, gen_v_scale=gvs)
            fn, plain = da.ancestry_attention, da.ancestry_attention_plain
        elif entry == "gen":
            args, fn, plain = (q, gk, gv, anc, valid), da.gen_attention_ancestor, \
                da.gen_attention_ancestor_plain
            kw.update(k_scale=gks, v_scale=gvs)
        else:
            args, fn, plain = (q, pk, pv, mask), da.prompt_attention, da.prompt_attention_plain
            kw.update(k_scale=pks, v_scale=pvs)
        want = plain(*args, **kw)
        for cp, cg, splits in plans:
            plan = da.DecodePlan(cp, -(-seg[0] // cp) if seg[0] else 0, cg,
                                 -(-seg[1] // cg) if seg[1] else 0, splits)
            with mock.patch.object(da, "decode_plan", lambda *a, plan=plan: plan):
                got = fn(*args, **kw)
                err = max(max_err(a, c) for a, c in zip(
                    got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)))
                ms = time_ms(lambda: fn(*args, **kw), iters=20)
            name = f"{entry}/b{b}/L{slots}/valid{valid}/cp{cp}/cg{cg}/splits{splits}"
            print(f"  {name}: ms={ms:.4f} max_err={err:.3e}"
                  + (" (decode_plan's)" if (cp, cg, splits) == plans[0] else ""))
            if not err <= DECODE_TOL:
                raise SmokeFailure(f"--plans {name}: max_err {err:.3e}")
            out.append({"case": name, "ms": ms, "max_abs_err": err,
                        "decode_plan": (cp, cg, splits) == plans[0]})
    return out + topk_plans() + topk_forms()


# --plans, the top-k kernel: (entry, batch, V, statistics inside, [(cluster,
# ring stages or None for the deepest), ...]) at beam 5, n = 10; the first
# plan of a case is topk_plan's
TOPK_PLAN_CASES = [
    ("columns", BATCH, 128256, True, [(8, None), (8, 5), (16, None), (4, None)]),
    ("columns", 48, 128256, True, [(4, None), (2, None), (8, None), (16, None)]),
    ("columns", BATCH, 128256, False, [(8, None), (8, 5), (16, None), (4, None)]),
    ("columns", 48, 128256, False, [(4, None), (2, None), (8, None)]),
    ("logp", BATCH, 128256, False, [(8, None), (16, None)]),
]


def topk_plans() -> list:
    """Time K4 (statistics inside or given) and K5 on log-probs under each
    plan of TOPK_PLAN_CASES (the wrappers' ``topk_plan`` replaced), with how
    many clusters of it the card holds at once; each result equal to the
    plain version's (on the kernel's statistics, where it computes them).
    Fails if the first plan is not topk_plan's."""
    import ctypes

    import torch

    from multimodalvc_tpu_torch.ops import kernel_lib
    from multimodalvc_tpu_torch.ops import topk as tk

    g = torch.Generator(device=DEV).manual_seed(13)
    k, n = BEAMS, 2 * BEAMS
    lib = kernel_lib.load()
    out = []
    for entry, b, v, stats, plans in TOPK_PLAN_CASES:
        first = tk.plan_for(v, k, n, *plans[0])
        if tk.topk_plan(b, k, v, n) != first:
            raise SmokeFailure(f"--plans top-k {entry} b{b}: the first plan {first} is not "
                               f"topk_plan's {tk.topk_plan(b, k, v, n)}")
        x = torch.randn(b * k, v, generator=g, device=DEV) * 3.0
        scores = torch.randn(b, k, generator=g, device=DEV)
        stat_args = tk.row_stats(x) if entry == "columns" and not stats else (None, None)
        m, ls = torch.empty(b * k, device=DEV), torch.empty(b * k, device=DEV)
        if entry == "logp":
            x = x.reshape(b, k, v)
            fn = lambda: tk.beam_topk(x, scores, n)  # noqa: E731
            want = tk.beam_topk_plain(x, scores, n)
        else:
            fn = lambda: tk.beam_topk_columns(x, *stat_args, scores, n)  # noqa: E731
            want = tk.beam_topk_columns_plain(x, *stat_args, scores, n)
        for i, (cluster, stages) in enumerate(plans):
            plan = tk.plan_for(v, k, n, cluster, stages)
            clusters = ctypes.c_int(-1)
            lib.call("mmvc_beam_topk_max_clusters", int(entry == "columns"), b, k, v, n, *plan,
                     ctypes.addressof(clusters))
            with mock.patch.object(tk, "topk_plan", lambda *a, plan=plan: plan):
                if stats:  # the plain version on this plan's statistics
                    got = tk.beam_topk_columns(x, None, None, scores, n, stats_out=(m, ls))
                    want = tk.beam_topk_columns_plain(x, m, ls, scores, n)
                else:
                    got = fn()
                ms = time_ms(fn, iters=20)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise SmokeFailure(f"--plans top-k {entry} b{b} {plan}: differs from plain")
            name = (f"topk_{entry}/b{b}/{'stats_inside' if stats else 'stats_given'}/"
                    f"cluster{plan.cluster}/cols{plan.cols}/stages{plan.stages}"
                    f"of{tk.topk_chunks(plan.cols)}/summarized{plan.summary}")
            print(f"  {name}: ms={ms:.4f} max_active_clusters={clusters.value}"
                  + (" (topk_plan's)" if i == 0 else ""))
            out.append({"case": name, "ms": ms, "max_active_clusters": clusters.value,
                        "topk_plan": i == 0})
    return out


# --plans, K4's two forms past 16 beams (statistics inside, n = 2K): the
# wide instance on ``_wide_plan``'s cluster, where its block fits one, and
# the select form, at (batch, beams)
TOPK_FORM_CASES = ([(BATCH, k) for k in (17, 32, 48, 64, 80, 96, 100, 101, 102, 103, 104, 128)]
                   + [(48, 17), (48, 64)])


def topk_forms() -> list:
    """Time K4 on the wide instance and on the select form at
    TOPK_FORM_CASES, each equal to the plain version on its own statistics,
    and name the form ``topk_plan`` takes: where the two cross."""
    import torch

    from multimodalvc_tpu_torch.ops import topk as tk

    g = torch.Generator(device=DEV).manual_seed(14)
    v, out = 128256, []
    for b, k in TOPK_FORM_CASES:
        n = 2 * k
        x = torch.randn(b * k, v, generator=g, device=DEV) * 3.0
        scores = torch.randn(b, k, generator=g, device=DEV)
        forms = {"select": tk.select_plan(b, k, v)}
        if tk.topk_smem_bytes(k, n, min(tk.TOPK_CLUSTERS_AT_ONCE), 1) <= tk.TOPK_SMEM_MAX:
            forms["wide"] = tk._wide_plan(b, k, v, n)
        taken = tk.topk_plan(b, k, v, n)
        row = {"case": f"topk_forms/b{b}/beam{k}", "taken": type(taken).__name__}
        for form, plan in forms.items():
            row[f"{form}_ms"] = _form_ms(x, scores, n, plan, iters=20)
            row[f"{form}_plan"] = list(plan)
        print(f"  {row['case']}: " + " ".join(f"{f}={row[f + '_ms']:.4f} ms {forms[f]}"
                                               for f in forms) + f"; topk_plan takes {taken}")
        out.append(row)
        del x
    return out


# --phases: K4's phase times.  csrc/topk.cu built with MMVC_TOPK_MARKS reads
# %globaltimer at MARK(0) .. MARK(7) (thread 0 of each block; MARK(7) in the
# leader only); the times are medians over the blocks since the first block
# started, each phase ending at the mark of its index + 1.
PHASE_NAMES = [
    "phase A: stream, row max and sum",
    "warp and block combine, cluster exchange",
    "cluster combine, theta and the filter",
    "phase B: filter and champions",
    "warp lists",
    "block merge, gather, cluster barrier",
    "leader's merge",
]


def topk_phases() -> list:
    """``--phases``: build csrc/topk.cu with MMVC_TOPK_MARKS defined (its own
    library under build/) and time K4 at [40, 128256] with the statistics
    inside and given, at [240, 128256] inside, and at batch 8 inside at
    beam 64 and at the ceiling ``topk_max_beams()`` (the wide instance), on
    topk_plan's plans."""
    import ctypes
    import statistics

    import torch

    from multimodalvc_tpu_torch.ops import kernel_lib
    from multimodalvc_tpu_torch.ops import topk as tk

    out = REPO / "build" / "topk_phases"
    out.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernel_lib.find_nvcc(), *kernel_lib.NVCC_FLAGS, "-DMMVC_TOPK_MARKS",
                    "-shared", "-o", str(out / "lib.so"), str(kernel_lib.CSRC / "topk.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    entry = lib.mmvc_beam_topk_columns
    entry.argtypes, entry.restype = kernel_lib.SIGNATURES["mmvc_beam_topk_columns"], ctypes.c_int
    lib.mmvc_topk_marks.argtypes = [ctypes.c_void_p]
    g = torch.Generator(device=DEV).manual_seed(21)
    v = 128256
    rows = []
    for b, k, inside in ((BATCH, BEAMS, True), (BATCH, BEAMS, False), (48, BEAMS, True),
                         (BATCH, 64, True), (BATCH, tk.topk_max_beams(), True)):
        n = 2 * k
        x = torch.randn(b * k, v, generator=g, device=DEV) * 3.0
        scores = torch.randn(b, k, generator=g, device=DEV)
        m, ls = (t.reshape(-1).contiguous() for t in tk.row_stats(x))
        out_v = torch.empty(b, n, device=DEV)
        out_f = torch.empty(b, n, dtype=torch.int32, device=DEV)
        plan = tk.topk_plan(b, k, v, n)
        args = (x.data_ptr(), None if inside else m.data_ptr(), None if inside else ls.data_ptr(),
                scores.data_ptr(), None, None, out_v.data_ptr(), out_f.data_ptr(), b, k, v, n,
                *plan, torch.cuda.current_stream().cuda_stream)

        def call():
            if entry(*args):
                raise SmokeFailure("--phases: the marked kernel failed")

        ms = time_ms(call, iters=20)
        call()
        torch.cuda.synchronize()
        marks = (ctypes.c_ulonglong * (2048 * 8))()
        lib.mmvc_topk_marks(ctypes.addressof(marks))
        blocks = [[marks[i * 8 + j] for j in range(8)] for i in range(b * plan.cluster)]
        leaders = blocks[::plan.cluster]
        t0 = min(t[0] for t in blocks)
        at = [statistics.median((t[j] - t0) / 1e3 for t in (leaders if j == 7 else blocks))
              for j in range(8)]
        phases = {name: at[j + 1] - at[j] for j, name in enumerate(PHASE_NAMES)}
        phases["launch and drain"] = ms * 1e3 - at[7]
        name = f"K4/{b * k}x{v}/{'stats_inside' if inside else 'stats_given'}/{tuple(plan)}"
        print(f"  {name}: {ms * 1e3:.1f} us; " + "; ".join(f"{p} {u:.1f}" for p, u in phases.items()))
        rows.append({"case": name, "us": ms * 1e3, "phases_us": phases})
    return rows


def gather_bound(src, *outs) -> dict:
    """K6: each distinct source row read once (a beam reorder repeats some),
    each output row written once, and src."""
    distinct = len(set(src.tolist())) / src.shape[0]
    return bound(nbytes(*outs) * (1 + distinct) + nbytes(src))


# ---- the command line: train, validate, evaluate and generate from a manifest


# conf/<preset>.yaml as dotted overrides, so that the smoke needs no PyYAML
# (tests/test_torch_config.py holds each list equal to its file)
PRESETS = {
    "mms-llama": [
        "common.seed=1", "common.log_format=json", "common.log_interval=100",
        "common.compute_dtype=bfloat16", "mesh.data=-1", "mesh.fsdp=1", "mesh.tensor=1",
        "dataset.data=???", "dataset.train_subset=train", "dataset.valid_subset=test",
        "dataset.max_tokens=1000", "dataset.num_workers=3",
        "dataset.length_buckets=[100,200,300,400,500]", "optimization.max_update=30000",
        "optimization.lr=1.0e-4", "optimization.optimizer=adamw",
        "optimization.adam_betas=[0.9,0.98]", "optimization.weight_decay=0.01",
        "optimization.clip_norm=1.0", "optimization.update_freq=1",
        "optimization.lr_scheduler=cosine", "optimization.warmup_updates=500",
        "checkpoint.save_dir=checkpoints/mms-llama", "checkpoint.best_checkpoint_metric=loss",
        "checkpoint.patience=-1", "generation.beam=5", "generation.max_len=100",
        "generation.temperature=0.3", "task.name=avsr_training",
        "task.llm_path=meta-llama/Llama-3.2-3B", "task.noise_prob=0.25", "task.noise_wav=???",
        "task.max_video_frames=500", "task.max_label_tokens=96", "task.image_aug=true",
        "model.name=mms_llama_avsr", "model.queries_per_sec=3", "model.use_sr_predictor=true",
        "model.qformer_layers=2", "model.qformer_dim=1024", "model.modality_fuse=concat",
    ],
    "mms-speech-nollm": [
        "common.seed=1", "common.log_format=json", "common.log_interval=100", "mesh.data=-1",
        "dataset.data=???", "dataset.max_tokens=1000", "dataset.num_workers=3",
        "optimization.max_update=60000", "optimization.lr=2.0e-4",
        "optimization.lr_scheduler=cosine", "optimization.warmup_updates=1000",
        "optimization.clip_norm=1.0", "checkpoint.save_dir=checkpoints/mms-speech-nollm",
        "checkpoint.best_checkpoint_metric=mel_l1", "task.name=speech_training",
        "task.variant=nollm", "task.max_mel_frames=2400", "task.p_modality_av=0.5",
        "task.p_modality_video_only=0.25", "task.p_modality_audio_only=0.25",
        "model.name=mms_speech_nollm", "model.use_qformer=true", "model.queries_per_sec=3",
        "model.conformer_size=L", "model.modality_dropout=true",
    ],
    "mms-speech-nollm-moe": [
        "common.seed=1", "common.log_format=json", "common.log_interval=100", "mesh.expert=4",
        "mesh.data=-1", "dataset.data=???", "dataset.max_tokens=1000", "dataset.num_workers=3",
        "optimization.max_update=60000", "optimization.lr=2.0e-4",
        "optimization.lr_scheduler=cosine", "optimization.warmup_updates=1000",
        "optimization.clip_norm=1.0", "checkpoint.save_dir=checkpoints/mms-speech-nollm-moe",
        "checkpoint.best_checkpoint_metric=mel_l1", "task.name=speech_training",
        "task.variant=nollm", "task.max_mel_frames=2400", "task.p_modality_av=0.5",
        "task.p_modality_video_only=0.25", "task.p_modality_audio_only=0.25",
        "model.name=mms_speech_nollm", "model.use_qformer=true", "model.queries_per_sec=3",
        "model.conformer_size=L", "model.conformer_moe_experts=4", "model.modality_dropout=true",
    ],
    "mms-speech-nollm-e2e": [
        "common.seed=1", "common.log_format=json", "common.log_interval=100", "mesh.data=-1",
        "dataset.data=???", "dataset.batch_size=4", "dataset.num_workers=3",
        "optimization.max_update=100000", "checkpoint.save_dir=checkpoints/mms-speech-nollm-e2e",
        "checkpoint.best_checkpoint_metric=mel_l1", "checkpoint.save_interval_updates=5000",
        "checkpoint.keep_interval_updates=2", "task.name=e2e_gan_training",
        "task.variant=nollm", "task.max_mel_frames=2400", "task.stage1_freeze=true",
        "task.gen_lr=2.0e-4", "task.disc_lr=2.0e-4", "task.p_modality_av=0.5",
        "task.p_modality_video_only=0.25", "task.p_modality_audio_only=0.25",
        "model.name=mms_speech_nollm_e2e", "model.use_qformer=true", "model.queries_per_sec=3",
        "model.conformer_size=L", "model.modality_dropout=true",
    ],
    "avhubert-pretrain": [
        "common.seed=1", "common.log_format=json", "common.log_interval=200", "mesh.data=-1",
        "dataset.data=???", "dataset.max_tokens=1000", "dataset.num_workers=4",
        "optimization.max_update=400000", "optimization.lr=2.0e-3",
        "optimization.lr_scheduler=polynomial", "optimization.warmup_updates=32000",
        "optimization.clip_norm=1.0", "checkpoint.save_dir=checkpoints/avhubert-pretrain",
        "checkpoint.save_interval_updates=25000", "checkpoint.keep_interval_updates=2",
        "task.name=avhubert_pretraining", "model.name=av_hubert_pretrain",
        "model.num_classes=2004", "model.mask_prob=0.8", "model.mask_length=10",
    ],
    "hifigan-vocoder": [
        "common.seed=1", "common.log_interval=100", "mesh.data=-1", "dataset.data=???",
        "dataset.batch_size=64", "dataset.num_workers=4", "optimization.max_update=500000",
        "checkpoint.save_dir=checkpoints/hifigan", "checkpoint.best_checkpoint_metric=mel_l1",
        "checkpoint.patience=10", "task.name=vocoder_training", "task.segment_length=8320",
        "task.lr=1.0e-4", "model.name=hifigan_vocoder", "model.lr=1.0e-4",
        "model.betas=[0.8,0.99]", "model.weight_decay=1.0e-5", "model.lr_decay=0.999",
        "model.ema_decay=0.999", "model.mel_weight=45.0", "model.segment_length=8320",
    ],
}
# overrides appended to a preset's after the run's own (empty on the card; a
# rehearsal on the CPU shrinks the models here)
CLI_EXTRA = {name: [] for name in PRESETS}
CLI_DIR = REPO / "build" / "cli_corpus"
CLI_RUNS = REPO / "build" / "cli_runs"
CLI_CLIPS, CLI_SEED = 32, 5
CLI_WORDS = ("hello", "world", "speech", "video", "audio", "lips", "voice", "model")
CLI_TRAIN_UPDATES, CLI_RESUME_UPDATES = 6, 8  # cli_train_avsr: a run to 6, resumed to 8
CLI_MAX_TOKENS = 3200  # 8 clips of 16 s at bucket 400
CLI_LOADER_EPOCHS = 4  # cli_loader: one loader over 4 epochs' batches (16)
CLI_CONSTRAINT = "zq"  # forced into every other test clip's hypothesis by cli_eval (c)


def clip_frames() -> list:
    """CLI_CLIPS video lengths of 4-16 s at 25 fps, 8 in each of the length
    buckets 100-400 (the 500 bucket takes clips past 16 s)."""
    out = [100] * 8
    for b in (200, 300, 400):
        out += [b - 12 * j for j in range(8)]
    return out


def write_corpus() -> dict:
    """The manifest corpus of the cli phases under build/cli_corpus, from
    CLI_SEED with numpy: per clip a 96 x 96 uint8 mouth-ROI video (.npy, 25
    fps) and a 16 kHz int16 wav of the same length (a tone in noise), three
    words of transcript; a 5 s babble track; train (all clips), valid (two a
    bucket) and test (four a bucket) .tsv + .wrd."""
    import shutil

    import numpy as np
    from scipy.io import wavfile

    t0 = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    (CLI_DIR / "data").mkdir(parents=True)
    rng = np.random.default_rng(CLI_SEED)
    rows, labels = [], []
    for i, t_v in enumerate(clip_frames()):
        n = t_v * 640
        np.save(CLI_DIR / "data" / f"clip{i}.npy",
                rng.integers(0, 256, (t_v, 96, 96), dtype=np.uint8))
        wav = 0.1 * np.sin(2 * np.pi * (150 + 10 * i) * np.arange(n) / 16000) \
            + 0.02 * rng.standard_normal(n)
        wavfile.write(CLI_DIR / "data" / f"clip{i}.wav", 16000, (wav * 32767).astype(np.int16))
        rows.append(f"cli\tdata/clip{i}.npy\tdata/clip{i}.wav:{i}\t{t_v}\t{n}")
        labels.append(" ".join(rng.choice(CLI_WORDS, size=3)))
    babble = CLI_DIR / "babble.wav"
    wavfile.write(babble, 16000, (0.05 * rng.standard_normal(5 * 16000) * 32767).astype(np.int16))
    subsets = {"train": range(CLI_CLIPS),
               "valid": [b * 8 + j for b in range(4) for j in (0, 4)],
               "test": [b * 8 + j for b in range(4) for j in (1, 3, 5, 7)]}
    for subset, idx in subsets.items():
        (CLI_DIR / f"{subset}.tsv").write_text(
            f"{CLI_DIR}\n" + "".join(rows[i] + "\n" for i in idx))
        (CLI_DIR / f"{subset}.wrd").write_text("".join(labels[i] + "\n" for i in idx))
    size = sum(p.stat().st_size for p in CLI_DIR.rglob("*") if p.is_file())
    record = {"clips": CLI_CLIPS, "mb": size / 1e6, "write_s": time.perf_counter() - t0,
              "subsets": {k: len(v) for k, v in subsets.items()}, "babble": str(babble)}
    print(f"  cli_corpus: {CLI_CLIPS} clips ({min(clip_frames())}-{max(clip_frames())} frames), "
          f"{size / 1e6:.1f} MB in {record['write_s']:.1f} s under {CLI_DIR}")
    return record


def cli_config(preset: str, run: list):
    """The port's TrainRootConfig of ``preset`` (PRESETS) with the corpus and
    ``run`` overrides, then CLI_EXTRA[preset]."""
    from multimodalvc_tpu_torch.config import TrainRootConfig, apply_overrides, from_dict

    base = [f"dataset.data={CLI_DIR}", "common.log_interval=1", "common.log_format=simple"]
    return from_dict(TrainRootConfig, apply_overrides(
        {}, PRESETS[preset] + base + run + CLI_EXTRA[preset]))


class CliTap:
    """What a CLI run logs (log_stats: (prefix, step, stats)), and the
    seconds and GiB of each checkpoint file it writes (``writes``)."""

    def __init__(self, module):
        self.lines, self.writes, self.module = [], [], module

    def __enter__(self):
        from multimodalvc_tpu_torch.runtime.checkpoint import STATE_FILE, CheckpointManager

        real, real_write = self.module.log_stats, CheckpointManager._write

        def write(mgr, state, name):
            t0 = time.perf_counter()
            real_write(mgr, state, name)
            path = os.path.join(mgr._path(name), STATE_FILE)
            size = os.path.getsize(path) if os.path.exists(path) else 0
            self.writes.append((time.perf_counter() - t0, size / 2 ** 30))

        self._patches = [
            mock.patch.object(self.module, "log_stats",
                              lambda stats, step, prefix="train", fmt="simple": (
                                  self.lines.append((prefix, step, dict(stats))),
                                  real(stats, step, prefix, fmt))),
            mock.patch.object(CheckpointManager, "_write", write)]
        for p in self._patches:
            p.__enter__()
        return self

    def __exit__(self, *exc):
        for p in reversed(self._patches):
            p.__exit__(*exc)
        return False

    def of(self, prefix) -> list:
        return [stats for p, _, stats in self.lines if p == prefix]


def step_times(tap: CliTap) -> dict:
    """The mean step and wait-for-batch ms of a run's training steps after
    the first (its wait holds the workers' start), and the wait's share."""
    steps = tap.of("train")[1:] or tap.of("train")
    step = sum(s["step_ms"] for s in steps) / len(steps)
    wait = sum(s["data_ms"] for s in steps) / len(steps)
    return {"mean_step_ms": step, "mean_wait_ms": wait, "wait_share": wait / (wait + step),
            "ckpt_writes": len(tap.writes),
            "ckpt_write_s": sum(w[0] for w in tap.writes) / max(1, len(tap.writes)),
            "ckpt_gib": max((w[1] for w in tap.writes), default=0.0),
            "first_wait_ms": tap.of("train")[0]["data_ms"],
            "wait_ms": [s["data_ms"] for s in tap.of("train")],
            "step_ms": [s["step_ms"] for s in tap.of("train")]}


def sample_stages(ds, indices) -> dict:
    """The host ms a sample of each stage of ``AVSRDataset.__getitem__`` on
    ``indices`` (the video's decode and transform, the wav's read and noise
    mix, the Whisper features, the HiFi-GAN mel targets the speech tasks
    add), and of the batch's collation."""
    import numpy as np

    from multimodalvc_tpu_torch.data.audio import hifigan_mel_np, read_wav, whisper_features_np
    from multimodalvc_tpu_torch.data.manifest import resolve_path
    from multimodalvc_tpu_torch.data.video import load_video_frames, transform_video

    ms = {k: 0.0 for k in ("video_decode", "video_transform", "wav_read", "noise_mix",
                           "whisper_features", "hifigan_mel", "collate")}
    clock = time.perf_counter
    for i in indices:
        e, root = ds.manifest.entries[int(i)], ds.manifest.root
        t0 = clock()
        frames = load_video_frames(resolve_path(root, e.video_path))
        t1 = clock()
        transform_video(frames, crop_size=ds.cfg.image_crop_size, train=True, rng=ds.rng)
        t2 = clock()
        wav = read_wav(resolve_path(root, e.audio_path))
        t3 = clock()
        wav = ds.noise(wav) if ds.noise is not None else wav
        t4 = clock()
        whisper_features_np(wav)
        t5 = clock()
        hifigan_mel_np(wav)
        t6 = clock()
        for k, a, b in (("video_decode", t0, t1), ("video_transform", t1, t2),
                        ("wav_read", t2, t3), ("noise_mix", t3, t4),
                        ("whisper_features", t4, t5), ("hifigan_mel", t5, t6)):
            ms[k] += 1e3 * (b - a) / len(indices)
    samples = [ds[int(i)] for i in indices]
    t0 = clock()
    ds.collate(samples)
    ms["collate"] = 1e3 * (clock() - t0) / len(indices)
    return {k: float(np.round(v, 3)) for k, v in ms.items()}


def cli_loader_phase() -> dict:
    """The host cost of a 16 s AVSR sample by stage (``sample_stages``), then
    the port's loader over the train subset of the AVSR preset (noise and
    crops on) with the preset's 3 worker processes and with 0, pinned as
    the training loop pins them: the wait for the first batch (the workers'
    start), then samples/s over the next batches (CLI_LOADER_EPOCHS epochs'
    batches at CLI_MAX_TOKENS in one loader)."""
    import types

    import torch

    from multimodalvc_tpu_torch.data.dataset import BatchLoader
    from multimodalvc_tpu_torch.tasks import AVSRTask, AVSRTaskConfig
    from multimodalvc_tpu_torch.config import from_dict

    cfg = cli_config("mms-llama", ["task.llm_path=null", f"task.noise_wav={CLI_DIR}/babble.wav"])
    task_cfg = from_dict(AVSRTaskConfig, {k: v for k, v in cfg.task.items() if k != "name"})
    task_cfg.data = str(CLI_DIR)
    ds = AVSRTask.load_dataset(types.SimpleNamespace(cfg=task_cfg,
                                                     model_cfg=types.SimpleNamespace()), "train")
    batches = ds.batches(max_tokens=CLI_MAX_TOKENS, required_multiple=8, epoch=1)
    longest = [i for i, e in enumerate(ds.manifest.entries) if e.n_video_frames == 400]
    record = {"batches": len(batches), "samples": sum(len(b) for b in batches),
              "ms_a_16s_sample": sample_stages(ds, longest)}
    print(f"  cli_loader: host ms a 16 s sample by stage {record['ms_a_16s_sample']}")
    epochs = batches * CLI_LOADER_EPOCHS
    for workers in (cfg.dataset.num_workers, 0):
        t0 = time.perf_counter()
        marks = []
        for batch in BatchLoader(ds, epochs, num_workers=workers, epoch=1,
                                 pin_memory=torch.device(DEV).type == "cuda"):
            marks.append((time.perf_counter(), batch["video"].shape[0]))
        first = marks[0][0] - t0
        rest = sum(n for _, n in marks[1:]) / (marks[-1][0] - marks[0][0])
        record[f"workers_{workers}"] = {"first_batch_ms": 1e3 * first, "samples_per_s": rest,
                                        "ms_a_batch": 1e3 * (marks[-1][0] - marks[0][0])
                                        / (len(marks) - 1)}
        print(f"  cli_loader: {workers} workers, {len(epochs)} batches of <= 8 clips: the first "
              f"in {1e3 * first:.1f} ms, then {rest:.1f} samples/s "
              f"({record[f'workers_{workers}']['ms_a_batch']:.1f} ms a batch)")
    return record


def cli_k1_a_step(frames: int) -> int:
    """K1's launches in a training step of the full-width AVSR model: the 24
    Whisper layers, and the 24 AV-HuBERT layers at >= 256 video frames
    (``nn/layers.py: use_flash``)."""
    return 24 + (24 if frames >= 256 else 0)


def _trainable_flat(trainer):
    import torch

    return torch.cat([m.double().reshape(-1) for m in trainer.master.values()])


def cli_train_avsr(table) -> dict:
    """``cli.train.main`` on the AVSR preset at full width (random weights,
    ``task.llm_path=null``: the byte tokenizer): a run to CLI_TRAIN_UPDATES
    updates resumed to CLI_RESUME_UPDATES, beside a straight run to
    CLI_RESUME_UPDATES.  Checks: the first update's loss against
    ``Trainer.train_step`` from the same start on the batch collated
    directly from the dataset (bitwise the CLI's batch); K1 24 times a
    step in Whisper and 24 more in AV-HuBERT at >= 256 frames; the resumed
    run's losses and trainable leaves against the straight run's at
    REL_TOL; a validation WER logged; checkpoints written by the split
    runs: the first run's ``checkpoint_last`` (which the resumed run reads)
    and ``checkpoint_best``, the resumed run's ``checkpoint_last`` (which
    cli_eval reads): 4-5 writes of the full state.  The straight run's 2,
    which nothing reads, are not made."""
    import gc
    import shutil

    import torch

    from multimodalvc_tpu_torch.cli import train as cli_train
    from multimodalvc_tpu_torch.data.dataset import to_device, to_tensors
    from multimodalvc_tpu_torch.ops.attention import flash_attention
    from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager

    run_dirs = {k: CLI_RUNS / f"avsr_{k}" for k in ("split", "straight")}
    for d in run_dirs.values():
        shutil.rmtree(d, ignore_errors=True)

    def overrides(save_dir, max_update, best):
        # no best metric ("none") writes no checkpoint_best (a 7.81 GiB
        # file): only the first run writes one
        return ["task.llm_path=null", f"task.noise_wav={CLI_DIR}/babble.wav",
                f"dataset.max_tokens={CLI_MAX_TOKENS}", f"optimization.max_update={max_update}",
                "dataset.valid_wer_batches=1", "generation.max_len=16",
                f"checkpoint.save_dir={save_dir}",
                f"checkpoint.best_checkpoint_metric={'loss' if best else 'none'}"]

    made = []

    class Probe(cli_train.Trainer):
        """Trainer that keeps its first batch, its state before it, and each
        step's K1 launches and video length."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.first, self.k1 = None, []
            made.append(self)

        def train_step(self, batch):
            if self.first is None:
                self.first = ({k: v.clone() for k, v in batch.items()},
                              copy.deepcopy(self.state_dict(include_frozen=False)))
            before = flash_attention.launches
            out = super().train_step(batch)
            self.k1.append((flash_attention.launches - before, batch["video"].shape[1]))
            return out

    tasks = []
    real_build = cli_train.build_task

    def build_task(*a, **k):
        tasks.append(real_build(*a, **k))
        return tasks[-1]

    record, losses, leaves = {}, {}, {}
    with mock.patch.object(cli_train, "Trainer", Probe), \
            mock.patch.object(cli_train, "build_task", build_task):
        for name, save_dir, max_update in (("first", run_dirs["split"], CLI_TRAIN_UPDATES),
                                           ("resumed", run_dirs["split"], CLI_RESUME_UPDATES),
                                           ("straight", run_dirs["straight"], CLI_RESUME_UPDATES)):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(table)
            cfg = cli_config("mms-llama", overrides(save_dir, max_update, name == "first"))
            with CliTap(cli_train) as tap, (
                    ExitStack() if name != "straight"
                    else mock.patch.object(CheckpointManager, "_write", lambda *a: None)):
                val, t_run = wall(lambda: cli_train.main(cfg, device=DEV))
            trainer, task = made[-1], tasks[-1]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            losses[name] = [s["loss"] for s in tap.of("train")]
            wrong = [(n, t) for n, t in trainer.k1 if n != cli_k1_a_step(t)]
            if wrong:
                raise SmokeFailure(f"cli_train_avsr {name}: K1 launches (got, video frames) "
                                   f"{wrong} (24 a step, 48 at >= 256 frames)")
            if not tap.of("valid") or "wer" not in tap.of("valid")[-1]:
                raise SmokeFailure(f"cli_train_avsr {name}: no validation WER logged")
            if not all(math.isfinite(x) for x in losses[name]):
                raise SmokeFailure(f"cli_train_avsr {name}: losses {losses[name]}")
            for ck in {"first": ("checkpoint_last", "checkpoint_best"),
                       "resumed": ("checkpoint_last",)}.get(name, ()):
                if not (save_dir / ck / "state.pt").exists():
                    raise SmokeFailure(f"cli_train_avsr {name}: no {ck} under {save_dir}")
            times = step_times(tap)
            record[name] = {"losses": losses[name], "valid": tap.of("valid"), "wall_s": t_run,
                            "peak_gib": peak, "k1_a_step": trainer.k1, **times}
            print(f"  cli_train_avsr {name}: {len(losses[name])} updates in {t_run:.1f} s, "
                  f"{times['mean_step_ms']:.1f} ms a step, waiting {times['mean_wait_ms']:.1f} ms "
                  f"for a batch ({100 * times['wait_share']:.1f}%), peak {peak:.2f} GiB, "
                  f"{times['ckpt_writes']} checkpoint writes of {times['ckpt_gib']:.2f} GiB in "
                  f"{times['ckpt_write_s']:.1f} s each, valid "
                  f"{ {k: round(v, 4) for k, v in tap.of('valid')[-1].items()} }")
            if name == "first":
                # the CLI's first batch against the dataset's own collation
                # of that batch (worker draws: seeded by epoch 1, position 0)
                ds = task.load_dataset(cfg.dataset.train_subset)
                idx = ds.batches(max_tokens=cfg.dataset.max_tokens,
                                 required_multiple=cfg.dataset.required_batch_size_multiple,
                                 epoch=1)[0]
                ds.reseed(1, 0)
                direct = task.prepare_batch(to_device(to_tensors(ds.load_batch(idx)), DEV))
                cli_batch, start = trainer.first
                for k, v in direct.items():
                    if not torch.equal(v, cli_batch[k]):
                        raise SmokeFailure(f"cli_train_avsr: the CLI's first batch differs in {k}")
                trainer.load_state_dict(start)
                reset_counts(table)
                direct_loss = trainer.train_step(direct)["loss"]
                rel = abs(direct_loss - losses[name][0]) / abs(direct_loss)
                print(f"    first update: CLI loss {losses[name][0]:.6f}, Trainer.train_step on "
                      f"the directly collated batch {direct_loss:.6f} (rel {rel:.2e}, gate "
                      f"{REL_TOL:g})")
                if not rel <= REL_TOL:
                    raise SmokeFailure(f"cli_train_avsr: first update {rel:.3e} from the direct step")
                record["direct_first_loss"], record["direct_rel"] = direct_loss, rel
                record["launches"] = read_counts(table)
            else:
                leaves[name] = _trainable_flat(trainer)
            if name == "resumed":  # full-state checkpoints: keep cli_eval's alone
                shutil.rmtree(run_dirs["split"] / "checkpoint_best", ignore_errors=True)
            made.clear()
            tasks.clear()
            del trainer, task
    joined = losses["first"] + losses["resumed"]
    rel_losses = max(abs(a - b) / abs(b) for a, b in zip(joined, losses["straight"]))
    rel_leaves = rel_l2(leaves["resumed"], leaves["straight"])
    print(f"  cli_train_avsr: resumed vs straight run, losses rel {rel_losses:.2e}, trainable "
          f"leaves rel_l2 {rel_leaves:.2e} (gate {REL_TOL:g})")
    if len(joined) != len(losses["straight"]) or not (rel_losses <= REL_TOL
                                                      and rel_leaves <= REL_TOL):
        raise SmokeFailure(f"cli_train_avsr: resumed run {len(joined)} updates, losses rel "
                           f"{rel_losses:.3e}, leaves {rel_leaves:.3e} from the straight run")
    record.update(resume_losses_rel=rel_losses, resume_leaves_rel_l2=rel_leaves)
    shutil.rmtree(run_dirs["straight"], ignore_errors=True)  # its metadata alone
    del leaves
    gc.collect()
    torch.cuda.empty_cache()
    return record


CLI_EVAL_RUNS = {  # run -> (generation overrides, kernels that must launch)
    "a_int8_serving": (["generation.weight_quant=int8", "generation.kv_cache_quant=int8",
                        "generation.ancestry_decode=true", "generation.beam=5"],
                       ("flash_attention", "ancestry_attention", "int8_matmul",
                        "beam_topk_columns")),
    "b_int4_ngram": (["generation.weight_quant=int4", "generation.no_repeat_ngram_size=3"],
                     ("int4_matmul", "beam_topk")),
    "c_constraints": ([f"generation.constraints_file={CLI_RUNS}/constraints.txt",
                       "generation.constraints=unordered"], ("gather_rows",)),
}


def cli_eval_phase(table) -> dict:
    """``cli.eval.main`` from cli_train_avsr's resumed run's checkpoint over
    the test subset, once a CLI_EVAL_RUNS entry, at max_len 16.  Checks:
    each run writes wer.* and hypo-*.json and launches the kernels its
    options select; run (a)'s hypotheses equal the tokens of
    ``AVSRSystem.generate`` on the same batches collated directly, decoded
    by the same tokenizer; run (c) forces its phrase into every
    constrained clip's hypothesis."""
    import gc
    import shutil

    import torch

    from multimodalvc_tpu_torch.cli import eval as cli_eval
    from multimodalvc_tpu_torch.data.dataset import to_device, to_tensors

    (CLI_RUNS / "constraints.txt").write_text("".join(
        (CLI_CONSTRAINT if i % 2 == 0 else "") + "\n" for i in range(CLI_CLIPS)))
    tasks = []
    real_build = cli_eval.build_task

    def build_task(*a, **k):
        tasks.append(real_build(*a, **k))
        return tasks[-1]

    record = {}
    for name, (gen, must) in CLI_EVAL_RUNS.items():
        gc.collect()
        torch.cuda.empty_cache()
        results = CLI_RUNS / f"eval_{name}"
        shutil.rmtree(results, ignore_errors=True)
        cfg = cli_config("mms-llama", [
            "task.llm_path=null", "task.noise_wav=null", f"dataset.max_tokens={CLI_MAX_TOKENS}",
            f"checkpoint.save_dir={CLI_RUNS}/avsr_split", "checkpoint.restore_file=checkpoint_last",
            "generation.max_len=16", *gen])
        reset_counts(table)
        with mock.patch.object(cli_eval, "build_task", build_task):
            res, t_run = wall(lambda: cli_eval.main(cfg, str(results), device=DEV))
        launches = read_counts(table)
        task = tasks.pop()
        missing = [k for k in must if not launches[k]]
        if missing:
            raise SmokeFailure(f"cli_eval {name}: no launch of {missing} ({launches})")
        hypo = sorted(results.glob("hypo-*.json"))
        wer = sorted(results.glob("wer.*"))
        if len(hypo) != 1 or len(wer) != 1:
            raise SmokeFailure(f"cli_eval {name}: outputs {sorted(os.listdir(results))}")
        hyps = {r["id"]: r["hypo"] for r in json.loads(hypo[0].read_text())}
        record[name] = {"wall_s": t_run, "wer": res["wer"], "words": res["words"],
                        "launches": launches, "hypotheses": len(hyps)}
        print(f"  cli_eval {name}: WER {res['wer']:.2f} over {res['words']} words, "
              f"{len(hyps)} clips in {t_run:.1f} s; launches "
              f"{ {k: n for k, n in launches.items() if n} }")
        if name == "a_int8_serving":
            ds = task.load_dataset("test")
            tok, same = ds.tokenizer, 0
            for idx in ds.batches(max_tokens=cfg.dataset.max_tokens):
                batch = task.prepare_batch(to_device(to_tensors(ds.load_batch(idx)), DEV),
                                           train=False)
                batch = {k: v for k, v in batch.items() if k not in ("labels", "label_lengths")}
                seqs, _ = task.system.generate(batch, num_beams=5, max_new_tokens=16,
                                               kv_quant="int8", ancestry_reorder=True)
                for row, i in zip(seqs[:, 0].tolist(), idx):
                    toks = row[: row.index(task.model_cfg.eos_token_id)] \
                        if task.model_cfg.eos_token_id in row else row
                    if tok.decode(toks) != hyps[int(i)]:
                        raise SmokeFailure(f"cli_eval {name}: clip {int(i)}'s hypothesis differs "
                                           "from AVSRSystem.generate's")
                    same += 1
            record[name]["generate_equal"] = same
            print(f"    run (a): {same} hypotheses equal AVSRSystem.generate's on the directly "
                  "collated batches")
        if name == "c_constraints":
            ds = task.load_dataset("test")
            forced = [i for i in range(len(ds)) if i % 2 == 0]
            if any(CLI_CONSTRAINT not in hyps[i] for i in forced):
                raise SmokeFailure(f"cli_eval {name}: {CLI_CONSTRAINT!r} missing from "
                                   f"{[hyps[i] for i in forced if CLI_CONSTRAINT not in hyps[i]]}")
            record[name]["constrained"] = len(forced)
        del task
    shutil.rmtree(CLI_RUNS / "avsr_split", ignore_errors=True)
    return record


def cli_speech_run(table, name, preset, run, write: bool = True) -> dict:
    """One ``cli.train.main`` run of a speech preset: finite losses, a
    checkpoint (with ``write``; else the saves run without their files),
    the step ms and the wait for batches."""
    import gc
    import shutil

    import torch

    from multimodalvc_tpu_torch.cli import train as cli_train
    from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager

    gc.collect()
    torch.cuda.empty_cache()
    save_dir = CLI_RUNS / name
    shutil.rmtree(save_dir, ignore_errors=True)
    cfg = cli_config(preset, [f"checkpoint.save_dir={save_dir}", *run])
    torch.cuda.reset_peak_memory_stats()
    reset_counts(table)
    with CliTap(cli_train) as tap, (ExitStack() if write else mock.patch.object(
            CheckpointManager, "_write", lambda *a: None)):
        val, t_run = wall(lambda: cli_train.main(cfg, device=DEV))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = tap.of("train")
    bad = [s for s in steps + [val] for k, v in s.items() if not math.isfinite(v)]
    if len(steps) != cfg.optimization.max_update or bad or not tap.of("valid"):
        raise SmokeFailure(f"cli_train_speech {name}: {len(steps)} updates, non-finite {bad}")
    if write and not (save_dir / "checkpoint_last" / "state.pt").exists():
        raise SmokeFailure(f"cli_train_speech {name}: no checkpoint under {save_dir}")
    times = step_times(tap)
    keys = [k for k in steps[0] if k.startswith(("loss", "mel_l1"))]
    print(f"  cli_train_speech {name}: {len(steps)} updates in {t_run:.1f} s, "
          f"{times['mean_step_ms']:.1f} ms a step, waiting {times['mean_wait_ms']:.1f} ms "
          f"({100 * times['wait_share']:.1f}%), peak {peak:.2f} GiB, {times['ckpt_writes']} "
          f"checkpoint writes of {times['ckpt_gib']:.2f} GiB in {times['ckpt_write_s']:.1f} s "
          f"each, valid "
          f"{ {k: round(v, 4) for k, v in val.items()} }")
    return {"updates": [{k: s[k] for k in keys} for s in steps], "valid": val, "wall_s": t_run,
            "peak_gib": peak, "launches": read_counts(table), **times}


def cli_train_speech(table) -> dict:
    """The speech presets through ``cli.train.main`` at full width: the NoLLM
    head (4 updates, mel targets computed by ``hifigan_mel_np``), the E2E
    GAN's stages 1 and 2 (2 updates each; their 4 checkpoint writes, which
    nothing reads, not made) and the vocoder (3 updates)."""
    return {
        "nollm": cli_speech_run(table, "speech_nollm", "mms-speech-nollm",
                                ["optimization.max_update=4"]),
        "e2e_stage1": cli_speech_run(table, "e2e_stage1", "mms-speech-nollm-e2e",
                                     ["optimization.max_update=2"], write=False),
        "e2e_stage2": cli_speech_run(table, "e2e_stage2", "mms-speech-nollm-e2e",
                                     ["optimization.max_update=2", "task.stage1_freeze=false"],
                                     write=False),
        "vocoder": cli_speech_run(table, "vocoder", "hifigan-vocoder",
                                  ["optimization.max_update=3"]),
    }


def cli_generate_phase() -> dict:
    """``cli.generate``: ``synthesize`` at full width on one 16 s corpus clip
    from the NoLLM run's checkpoint and the vocoder run's (a finite wav of
    the clip's length), then ``vocode`` from the vocoder checkpoint of the
    mel that the NoLLM run's speech head gives for that clip (a finite wav
    of 160 samples a frame)."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from multimodalvc_tpu_torch.cli import generate as cli_generate

    clip = clip_frames().index(400)
    video, audio = CLI_DIR / "data" / f"clip{clip}.npy", CLI_DIR / "data" / f"clip{clip}.wav"
    out, mel = CLI_RUNS / "synth.wav", CLI_RUNS / "synth_mel.npy"
    nollm, voc = str(CLI_RUNS / "speech_nollm"), str(CLI_RUNS / "vocoder" / "checkpoint_last")
    _, t_syn = wall(lambda: cli_generate.main([
        "synthesize", "--video", str(video), "--audio", str(audio), "--preset", CLI_PRESET,
        "--checkpoint", nollm, "--vocoder-checkpoint", voc, "--out", str(out), "--device", DEV]))
    sr, wav = wavfile.read(out)
    if sr != 16000 or wav.shape != (400 * 640,) or not np.isfinite(wav).all():
        raise SmokeFailure(f"cli_generate synthesize: {sr} Hz, {wav.shape}")
    system = cli_generate.load_speech(nollm, CLI_PRESET, DEV)
    with torch.inference_mode():
        head = system(cli_generate.clip_batch(video, audio, system.cfg, CLI_PRESET, DEV))
    m = head["melspec"][0, : int(head["mel_lengths"][0])].float().cpu().numpy()
    np.save(mel, m)
    del system, head
    _, t_voc = wall(lambda: cli_generate.main([
        "vocode", "--mel", str(mel), "--checkpoint", voc, "--out", str(CLI_RUNS / "vocoded.wav"),
        "--device", DEV]))
    sr, vocoded = wavfile.read(CLI_RUNS / "vocoded.wav")
    if vocoded.shape != (m.shape[0] * 160,) or not np.isfinite(vocoded).all():
        raise SmokeFailure(f"cli_generate vocode: {vocoded.shape} from a mel {m.shape}")
    print(f"  cli_generate: synthesize {wav.shape[0] / 16000:.1f} s of speech in {t_syn:.1f} s "
          f"(mel {m.shape}), vocode in {t_voc:.1f} s")
    return {"synthesize_s": t_syn, "vocode_s": t_voc, "samples": int(wav.shape[0]),
            "mel_frames": int(m.shape[0])}


CLI_PRESET = ""  # synthesize's SpeechConfig preset: "" is the full width


def cli_phases(table) -> dict:
    """The command-line phases, each model freed before the next."""
    CLI_RUNS.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    phases = {"cli_corpus": write_corpus(), "cli_loader": cli_loader_phase(),
              "cli_train_avsr": cli_train_avsr(table), "cli_eval": cli_eval_phase(table),
              "cli_train_speech": cli_train_speech(table), "cli_generate": cli_generate_phase()}
    phases["cli_wall_s"] = time.perf_counter() - t0
    print(f"  cli phases: {phases['cli_wall_s']:.1f} s")
    return phases


# ---- the dummy_avsr task and the host C++ routines ------------------------------


DUMMY_UPDATES = 3
# the command line of cli_dummy_avsr after `python -m multimodalvc_tpu_torch.cli.train`
DUMMY_ARGV = ["task.name=dummy_avsr", "model.name=mms_llama_avsr",
              f"optimization.max_update={DUMMY_UPDATES}"]


def cli_dummy_avsr(table) -> dict:
    """``cli.train`` of ``task.name=dummy_avsr model.name=mms_llama_avsr
    optimization.max_update=3`` at full width (``AVSRConfig()``; the task's
    fabricated batch of 4: 100 video frames, a 30 s Whisper window, 24 label
    tokens), through ``cli.train``'s own parser and ``main``, with validation
    off, each update logged and no best metric; its one ``checkpoint_last``,
    which nothing reads, goes through the save path but is not written
    (``CheckpointManager._write`` a no-op, as in the tensor phases).
    Checks: the first update's loss against
    ``Trainer.train_step`` from the same start on the batch the task
    fabricates (bitwise the CLI's), at REL_TOL as cli_train_avsr; finite
    losses; K1 ``cli_k1_a_step(100)`` = 24 times a step (Whisper's 24 layers
    at 1500 frames; AV-HuBERT's 100 frames are under ``use_flash``'s 256);
    one save.  Prints the step and data ms, label tokens/s and the peak
    GiB."""
    import gc
    import shutil

    import torch

    from multimodalvc_tpu_torch.cli import train as cli_train
    from multimodalvc_tpu_torch.data.dataset import to_device, to_tensors
    from multimodalvc_tpu_torch.ops.attention import flash_attention
    from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager

    save_dir = CLI_RUNS / "dummy_avsr"
    shutil.rmtree(save_dir, ignore_errors=True)
    made, tasks, saves = [], [], []

    class Probe(cli_train.Trainer):
        """Trainer that keeps its first batch, its state before it and each
        step's K1 launches."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.first, self.k1 = None, []
            made.append(self)

        def train_step(self, batch):
            if self.first is None:
                self.first = ({k: v.clone() for k, v in batch.items()},
                              copy.deepcopy(self.state_dict(include_frozen=False)))
            before = flash_attention.launches
            out = super().train_step(batch)
            self.k1.append(flash_attention.launches - before)
            return out

    real_build = cli_train.build_task

    def build_task(*a, **k):
        tasks.append(real_build(*a, **k))
        return tasks[-1]

    cfg, _ = cli_train.parse_args(DUMMY_ARGV + [
        "dataset.disable_validation=true", "checkpoint.best_checkpoint_metric=none",
        f"checkpoint.save_dir={save_dir}", "common.log_interval=1"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(table)
    with mock.patch.object(cli_train, "Trainer", Probe), \
            mock.patch.object(cli_train, "build_task", build_task), CliTap(cli_train) as tap, \
            mock.patch.object(CheckpointManager, "_write", lambda mgr, state, name: saves.append(
                (name, len(state)))):
        _, t_run = wall(lambda: cli_train.main(cfg, device=DEV))
    launches = read_counts(table)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer, task = made[-1], tasks[-1]
    losses = [s["loss"] for s in tap.of("train")]
    want_k1, k1 = cli_k1_a_step(task.cfg.video_frames), list(trainer.k1)
    if k1 != [want_k1] * DUMMY_UPDATES:
        raise SmokeFailure(f"cli_dummy_avsr: K1 launches a step {k1} ({want_k1} each)")
    if len(losses) != DUMMY_UPDATES or not all(math.isfinite(x) for x in losses):
        raise SmokeFailure(f"cli_dummy_avsr: losses {losses}")
    if [name for name, _ in saves] != ["checkpoint_last"]:
        raise SmokeFailure(f"cli_dummy_avsr: saves {saves} (one checkpoint_last)")
    shutil.rmtree(save_dir, ignore_errors=True)
    times = step_times(tap)
    label_tokens = task.cfg.batch_size * task.cfg.label_tokens
    tokens_per_s = label_tokens / (times["mean_step_ms"] / 1e3)
    print(f"  cli_dummy_avsr: {len(losses)} updates in {t_run:.1f} s, losses "
          f"{[round(x, 4) for x in losses]}, step ms {[round(x, 1) for x in times['step_ms']]} "
          f"(mean of steps 2 on {times['mean_step_ms']:.1f}), data ms "
          f"{[round(x, 1) for x in times['wait_ms']]}, {tokens_per_s:.1f} label tokens/s "
          f"({label_tokens} a step), peak {peak:.2f} GiB, K1 {k1} a step, saves {saves} "
          "(not written)")
    # the task's own batch, straight from its dataset, from the CLI's start
    ds = task.load_dataset(cfg.dataset.train_subset)
    direct = task.prepare_batch(to_device(to_tensors(ds.load_batch(ds.batches()[0])), DEV))
    cli_batch, start = trainer.first
    for k, v in direct.items():
        if not torch.equal(v, cli_batch[k]):
            raise SmokeFailure(f"cli_dummy_avsr: the CLI's first batch differs in {k}")
    trainer.load_state_dict(start)
    direct_loss = trainer.train_step(direct)["loss"]
    rel = abs(direct_loss - losses[0]) / abs(direct_loss)
    print(f"    first update: CLI loss {losses[0]:.6f}, Trainer.train_step on the fabricated "
          f"batch {direct_loss:.6f} (rel {rel:.2e}, gate {REL_TOL:g})")
    if not rel <= REL_TOL:
        raise SmokeFailure(f"cli_dummy_avsr: first update {rel:.3e} from the direct step")
    record = {"losses": losses, "direct_first_loss": direct_loss, "direct_rel": rel,
              "wall_s": t_run, "peak_gib": peak, "label_tokens_per_s": tokens_per_s,
              "k1_a_step": k1, "launches": launches, **times}
    made.clear()
    tasks.clear()
    del trainer, task, start, cli_batch, direct
    gc.collect()
    torch.cuda.empty_cache()
    return record


NATIVE_SEED = 11
NATIVE_PAIRS = 10_000  # edit-distance word pairs, BLEU sentence pairs
NATIVE_SIZES = 1_000_000  # batch_by_size's clip lengths, the token blocks' sentences
NATIVE_ROUTING = (4, 8 * 2400)  # balanced_assignment: 4 experts (MoE preset), 8 x 2400 frames
NATIVE_NGRAM = (4000, 100, 3)  # ngram_banned_tokens: rows, tokens a row, n


def noisy_copies(rng, vocab: int, pairs: int):
    """``pairs`` (hypothesis, reference) id lists: references of 5-30 ids,
    each hypothesis its reference with 15% of the ids replaced and one in
    four missing its last."""
    import numpy as np

    out = []
    for _ in range(pairs):
        ref = rng.integers(0, vocab, rng.integers(5, 31))
        hyp = np.where(rng.random(len(ref)) < 0.15, rng.integers(0, vocab, len(ref)), ref)
        out.append((hyp[: len(hyp) - (rng.random() < 0.25)].tolist(), ref.tolist()))
    return out


def native_phase() -> dict:
    """The host C++ routines (``multimodalvc_tpu_torch.native``): the library
    built from the checkout with the host's g++, then each function against
    its plain Python twin at corpus size, both timed on the host:
    edit distance over NATIVE_PAIRS word pairs, ``batch_by_size`` over
    NATIVE_SIZES clip lengths (the AVSR preset's buckets, max_tokens
    CLI_MAX_TOKENS, multiples of 8), ``token_blocks_complete`` over
    NATIVE_SIZES sentences ('complete_doc', blocks of 1024), the BLEU of
    NATIVE_PAIRS sentence pairs (``BleuScorer`` on each twin's counts),
    ``ngram_banned_tokens`` at NATIVE_NGRAM.  Equal results, exactly; the
    balanced assignment (an auction against the plain greedy fill, as in
    the JAX package) at NATIVE_ROUTING: both fill every worker exactly, and
    the auction's total score is the greedy one's or better, up to its
    epsilon bound (max |score| / 4 over all jobs)."""
    import numpy as np

    from multimodalvc_tpu_torch import native

    t0 = time.perf_counter()
    lib = native.load()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(NATIVE_SEED)
    record = {"build_s": build_s, "library": Path(lib._name).name}
    print(f"  native: built {record['library']} with {native.compiler()} in {build_s:.2f} s")

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t)

    def compare(name, fast, plain, same, what):
        (got, ms), (want, plain_ms) = timed(fast), timed(plain)
        ok = same(got, want)
        record[name] = {"ms": ms, "plain_ms": plain_ms, "equal": ok, "size": what}
        print(f"  native {name} ({what}): C++ {ms:.1f} ms, plain {plain_ms:.1f} ms on the host, "
              f"{'equal' if ok else 'DIFFERENT'}")
        if not ok:
            raise SmokeFailure(f"native: {name} differs from its plain version")
        return got

    words = [f"w{i}" for i in range(1000)]
    pairs = [([words[i] for i in h], [words[i] for i in r])
             for h, r in noisy_copies(rng, len(words), NATIVE_PAIRS)]
    dist = compare("edit_distance", lambda: [native.edit_distance_native(h, r) for h, r in pairs],
                   lambda: [native.edit_distance_native_plain(h, r) for h, r in pairs],
                   lambda a, b: a == b, f"{NATIVE_PAIRS} word pairs")
    record["edit_distance"]["wer"] = 100.0 * sum(dist) / sum(len(r) for _, r in pairs)

    sizes = rng.integers(25, 500, NATIVE_SIZES)
    order = np.argsort(sizes, kind="stable")
    args = (sizes, order, [100, 200, 300, 400, 500], CLI_MAX_TOKENS, 0, 8)
    batches = compare("batch_by_size", lambda: native.batch_by_size_native(*args),
                      lambda: native.batch_by_size_native_plain(*args),
                      lambda a, b: len(a) == len(b) and all(map(np.array_equal, a, b)),
                      f"{NATIVE_SIZES} sizes")
    record["batch_by_size"]["batches"] = len(batches)

    sentences = rng.integers(1, 200, NATIVE_SIZES)
    compare("token_blocks_complete", lambda: native.token_blocks_complete(sentences, 1024, True),
            lambda: native.token_blocks_complete_plain(sentences, 1024, True),
            np.array_equal, f"{NATIVE_SIZES} sentences")

    def bleu(counts):
        scorer = native.BleuScorer(counts=counts)
        for h, r in id_pairs:
            scorer.add(h, r)
        return scorer

    id_pairs = noisy_copies(rng, 1000, NATIVE_PAIRS)
    scorer = compare("bleu", lambda: bleu(native.bleu_counts),
                     lambda: bleu(native.bleu_counts_plain),
                     lambda a, b: (a.score() == b.score() and np.array_equal(a.matches, b.matches)
                                   and np.array_equal(a.totals, b.totals)),
                     f"{NATIVE_PAIRS} sentence pairs")
    record["bleu"]["score"] = scorer.score()

    rows, length, n = NATIVE_NGRAM
    tokens = rng.integers(0, 20, (rows, length))
    bans = compare("ngram_banned_tokens", lambda: native.ngram_banned_tokens(tokens, n),
                   lambda: native.ngram_banned_tokens_plain(tokens, n), lambda a, b: a == b,
                   f"[{rows}, {length}], n = {n}")
    record["ngram_banned_tokens"]["bans"] = sum(map(len, bans))

    scores = rng.standard_normal(NATIVE_ROUTING).astype(np.float32)
    (auction, ms), (greedy, plain_ms) = (timed(lambda: native.balanced_assignment(scores)),
                                         timed(lambda: native.balanced_assignment_plain(scores)))
    total = lambda owner: float(scores.astype(np.float64)[owner, np.arange(scores.shape[1])].sum())
    cap = scores.shape[1] // scores.shape[0]
    slack = float(np.abs(scores).max()) / 4
    ok = (all((np.bincount(x, minlength=scores.shape[0]) == cap).all() for x in (auction, greedy))
          and total(auction) >= total(greedy) - slack)
    record["balanced_assignment"] = {"ms": ms, "plain_ms": plain_ms, "total": total(auction),
                                     "plain_total": total(greedy), "slack": slack, "ok": ok,
                                     "size": list(NATIVE_ROUTING)}
    print(f"  native balanced_assignment ({list(NATIVE_ROUTING)}): auction {ms:.1f} ms, greedy "
          f"(plain) {plain_ms:.1f} ms on the host; {cap} jobs a worker, total score "
          f"{total(auction):.3f} against the greedy {total(greedy):.3f} (slack {slack:.3f})")
    if not ok:
        raise SmokeFailure("native: the auction is unbalanced or under the greedy fill")
    record["wall_s"] = time.perf_counter() - t0
    return record


# ---- the paper's weights: the reference layouts, read back and imported -------


# the entries of AVSRModel a reference product checkpoint holds (the trainables)
PRODUCT_KEY = r"^encoder\.(afeat_1d_conv|qformer|avfeat_to_llm)\.|^llama\..*\.lora_[ab]$"
IMPORT_DIR = REPO / "build" / "import"
IMPORT_TOKENS = 16  # import_pretrained's int8 decode
DEMO_TOKENS = 32  # cli_demo's --max-len
# the folded weight-norm convs: the only entries an import rounds
FOLDED = ("encoder.avhubert.encoder.pos_conv.conv.weight",
          "encoder.sr_predictor.encoder.pos_conv.conv.weight")


def _layer_dots(rest: str) -> str:
    """A port path's ``layers_{i}.`` as the reference's ``layers.{i}.``."""
    import re

    return re.sub(r"(^|\.)layers_(\d+)\.", r"\1layers.\2.", rest)


def entries_under(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def hf_llama_state(sd) -> dict:
    """An AVSRModel state dict's LLaMA as an HF ``LlamaForCausalLM`` state
    dict (``model.*``, without the LoRA adapters, which HF's has not)."""
    out = {}
    for rest, x in entries_under(sd, "llama.").items():
        if ".lora_" not in rest:
            out["model." + _layer_dots(rest).replace(".base.weight", ".weight")] = x
    return out


def hf_whisper_state(sd) -> dict:
    """An AVSRModel state dict's Whisper as HF ``WhisperModel`` keys
    (``model.encoder.*``)."""
    return {"model.encoder." + _layer_dots(rest).replace(".ffn.", "."): x
            for rest, x in entries_under(sd, "encoder.whisper.").items()}


def fairseq_encoder_state(sd, src: str, dst: str) -> dict:
    """A port ``TransformerEncoder`` (under ``src``) as fairseq's wav2vec2
    encoder keys (under ``dst``), the positional conv weight-normed over
    dims (0, 1) as fairseq's (``weight_g`` = ||w||, ``weight_v`` = w), f32."""
    import torch

    out = {}
    for rest, x in entries_under(sd, src).items():
        x = x.float()
        if rest == "pos_conv.conv.weight":
            out[f"{dst}pos_conv.0.weight_v"] = x
            out[f"{dst}pos_conv.0.weight_g"] = torch.linalg.vector_norm(x, dim=(0, 1),
                                                                        keepdim=True)
        elif rest == "pos_conv.conv.bias":
            out[f"{dst}pos_conv.0.bias"] = x
        else:
            out[dst + _layer_dots(rest).replace(".ffn.", ".")] = x
    return out


def fairseq_avhubert_state(sd, seed: int = 3) -> dict:
    """An AVSRModel state dict's AV-HuBERT as a fairseq AV-HuBERT ``model``
    state dict in f32: the ResNet's conv3d stem [O, 1, 5, 7, 7] and
    ``frontend3D`` / ``trunk.layer{l}.{b}`` names, ``downsample.{0,1}``; and
    the audio stream's projection ``feature_extractor_audio.proj`` (104
    stacked filterbank features; random from ``seed``), which the port's
    video-only module has no entry for."""
    import re

    import torch

    out = {}
    for rest, x in entries_under(sd, "encoder.avhubert.video_resnet.").items():
        if rest == "frontend_conv.weight":
            x = x.unsqueeze(1)
        rest = re.sub(r"^frontend_(conv|bn|relu)\.",
                      lambda m: f"frontend3D.{dict(conv=0, bn=1, relu=2)[m[1]]}.", rest)
        rest = re.sub(r"^trunk\.layer(\d)_(\d)\.", r"trunk.layer\1.\2.", rest)
        rest = rest.replace("downsample_conv.", "downsample.0.").replace(
            "downsample_bn.", "downsample.1.")
        out["feature_extractor_video.resnet." + rest] = x if x.dtype == torch.long else x.float()
    for rest, x in entries_under(sd, "encoder.avhubert.").items():
        if rest.startswith(("video_proj.", "layer_norm.", "post_extract_proj.")):
            out[rest.replace("video_proj.", "feature_extractor_video.proj.")] = x.float()
    out.update(fairseq_encoder_state(sd, "encoder.avhubert.encoder.", "encoder."))
    d = out["feature_extractor_video.proj.weight"].shape[0]
    dev = out["layer_norm.weight"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    out["feature_extractor_audio.proj.weight"] = 0.02 * torch.randn(d, 104, generator=g, device=dev)
    out["feature_extractor_audio.proj.bias"] = torch.zeros(d, device=dev)
    return out


def sr_predictor_state(sd) -> dict:
    """An AVSRModel state dict's speech-rate predictor as its checkpoint
    (``sr_predictor.*``, the positional conv weight-normed)."""
    out = {f"sr_predictor.{rest}": x for rest, x in entries_under(sd, "encoder.sr_predictor.").items()
           if not rest.startswith("encoder.")}
    out.update(fairseq_encoder_state(sd, "encoder.sr_predictor.encoder.",
                                     "sr_predictor.encoder."))
    return out


_QFORMER_NAMES = [("self_attn.q_proj", "attention.self.query"),
                  ("self_attn.k_proj", "attention.self.key"),
                  ("self_attn.v_proj", "attention.self.value"),
                  ("self_attn.out_proj", "attention.output.dense"),
                  ("self_ln", "attention.output.LayerNorm"),
                  ("cross_attn.q_proj", "crossattention.self.query"),
                  ("cross_attn.k_proj", "crossattention.self.key"),
                  ("cross_attn.v_proj", "crossattention.self.value"),
                  ("cross_attn.out_proj", "crossattention.output.dense"),
                  ("cross_ln", "crossattention.output.LayerNorm"),
                  ("intermediate_query", "intermediate_query.dense"),
                  ("output_query", "output_query.dense"),
                  ("ffn_ln", "output_query.LayerNorm")]


def product_state(trainables) -> dict:
    """AVSRModel trainable entries (``PRODUCT_KEY``) as a reference product
    checkpoint's ``model``: the 50 -> 25 Hz conv, the Q-Former in vendored
    BERT names, ``query_tokens``, the projector and the peft LoRA adapters
    (``lora_A`` [r, in] = lora_a^T, ``lora_B`` [out, r] = lora_b^T)."""
    import re

    out = {}
    for key, x in trainables.items():
        if key.startswith("encoder.afeat_1d_conv."):
            out[key.removeprefix("encoder.")] = x
        elif key == "encoder.qformer.query_tokens":
            out["query_tokens"] = x
        elif key.startswith("encoder.qformer.embeddings_ln."):
            out["Qformer.bert.embeddings.LayerNorm." + key.rsplit(".", 1)[1]] = x
        elif key.startswith("encoder.qformer.layers_"):
            i, rest = re.fullmatch(r"encoder\.qformer\.layers_(\d+)\.(.*)", key).groups()
            base, leaf = rest.rsplit(".", 1)
            out[f"Qformer.bert.encoder.layer.{i}.{dict(_QFORMER_NAMES)[base]}.{leaf}"] = x
        elif key.startswith("encoder.avfeat_to_llm."):
            out[_layer_dots(key.removeprefix("encoder."))] = x
        else:
            i, proj, ab = re.fullmatch(r"llama\.layers_(\d+)\.self_attn\.(\w+)\.lora_([ab])",
                                       key).groups()
            out[f"llama.base_model.model.model.layers.{i}.self_attn.{proj}.lora_{ab.upper()}"
                f".default.weight"] = x.t().contiguous()
    return out


def read_pt(path) -> tuple:
    """``load_pt`` of ``path``: (the file, seconds, GiB on disk)."""
    from multimodalvc_tpu_torch.runtime import load_pt

    t0 = time.perf_counter()
    raw = load_pt(str(path))
    return raw, time.perf_counter() - t0, os.path.getsize(path) / 2 ** 30


def inspect_totals(path, state) -> dict:
    """``cli.inspect_checkpoint`` of ``path`` (its lines printed at depth 1):
    its key and parameter totals, which must be those of the ``state``
    written there."""
    from multimodalvc_tpu_torch.cli import inspect_checkpoint
    from multimodalvc_tpu_torch.runtime import flatten_state_dict

    keys, params = inspect_checkpoint.main([str(path), "--depth", "1"])
    flat = flatten_state_dict(state)
    want = (len(flat), sum(x.numel() for x in flat.values()))
    if (keys, params) != want:
        raise SmokeFailure(f"inspect_checkpoint {path.name}: {keys} keys / {params} params, the "
                           f"file holds {want[0]} / {want[1]}")
    return {"keys": keys, "params": params}


def import_pretrained(table) -> dict:
    """The full-width seed-0 bf16 AVSR system written out in the reference
    layouts (HF LLaMA-3.2-3B and HF Whisper-medium as state dicts, the
    fairseq AV-HuBERT-Large ``.pt`` with ``cfg``, the speech-rate predictor,
    and a product ``.pt`` of trainables drawn from seed 1 with ``args``),
    the two ``.pt`` read back through ``load_pt`` and imported into a fresh
    seed-2 system through the port's importers and ``merge_state``.  Checks:
    every entry equals its source bit for bit (the product's where it has
    one), but the folded positional convs (their max error printed); only
    ``audio_proj.*`` logged as absent; ``inspect_checkpoint``'s totals of
    both files; and with int8 weights both systems serve the same beam
    tokens and scores, bit for bit, with K1, the merged K2 + K3 entry, K7
    and K4."""
    import argparse
    import gc
    import re
    import shutil

    import torch

    from multimodalvc_tpu_torch.interop.avsr_import import (
        import_reference_avsr,
        import_sr_predictor,
        merge_state,
    )
    from multimodalvc_tpu_torch.nn.avhubert import import_torch_avhubert
    from multimodalvc_tpu_torch.nn.llama import import_hf_llama
    from multimodalvc_tpu_torch.nn.whisper import import_hf_whisper_encoder
    from multimodalvc_tpu_torch.runtime import flatten_state_dict

    shutil.rmtree(IMPORT_DIR, ignore_errors=True)
    IMPORT_DIR.mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    src = build_system(seed=0)
    sd = src.module.state_dict()
    g = torch.Generator(device=DEV).manual_seed(1)
    # the source's trainables drawn anew, as a fine-tuned product holds them
    trainables = {k: (0.02 * torch.randn(v.shape, generator=g, device=DEV)).to(v.dtype)
                  for k, v in sd.items() if re.search(PRODUCT_KEY, k)}
    merge_state(src.module, trainables)
    cfg = src.cfg
    t0 = time.perf_counter()
    av_state = fairseq_avhubert_state(sd)
    product = {k: v.float() for k, v in product_state(trainables).items()}  # f32 on disk, exact
    av_path, product_path = IMPORT_DIR / "avhubert_large.pt", IMPORT_DIR / "product.pt"
    torch.save({"model": av_state, "cfg": argparse.Namespace(
        encoder_layers=cfg.avhubert.encoder_layers, encoder_embed_dim=cfg.avhubert.encoder_embed_dim,
        modality_fuse="concat")}, av_path)
    torch.save({"model": product, "args": argparse.Namespace(
        llm_path="meta-llama/Llama-3.2-3B", qformer_layers=cfg.qformer_layers)}, product_path)
    write_s = time.perf_counter() - t0
    whisper, llama_state, sr_state = hf_whisper_state(sd), hf_llama_state(sd), sr_predictor_state(sd)
    record = {"write_s": write_s}
    del av_state, product, trainables
    torch.cuda.synchronize()

    dst = build_system(seed=2)
    m = dst.module
    files = {}
    absent = []
    t0 = time.perf_counter()
    raw_av, av_s, av_gib = read_pt(av_path)
    raw_product, product_s, product_gib = read_pt(product_path)
    n = merge_state(m.encoder.whisper, import_hf_whisper_encoder(whisper, cfg.whisper), absent)
    n += merge_state(m.encoder.avhubert, import_torch_avhubert(
        flatten_state_dict(raw_av["model"]), cfg.avhubert), absent)
    n += merge_state(m.encoder.sr_predictor, import_sr_predictor(sr_state), absent)
    n += merge_state(m.llama, import_hf_llama(llama_state, cfg.llama), absent)
    n += merge_state(m, import_reference_avsr(flatten_state_dict(raw_product["model"]),
                                              cfg.qformer_layers), absent)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    files["avhubert_large.pt"] = {"read_s": av_s, "gib": av_gib,
                                  **inspect_totals(av_path, raw_av["model"])}
    files["product.pt"] = {"read_s": product_s, "gib": product_gib,
                           **inspect_totals(product_path, raw_product["model"])}
    if sorted(absent) != ["audio_proj.bias", "audio_proj.weight"]:
        raise SmokeFailure(f"import_pretrained: entries logged absent {absent}")
    got = m.state_dict()
    entries = len(got)
    differ, folded = [], {}
    for key, x in got.items():
        want = sd[key]
        if key in FOLDED:
            folded[key] = max_err(x, want)
            if folded[key] > 2 ** -8 * float(want.abs().max()):
                differ.append(key)
        elif x.dtype != want.dtype or not torch.equal(x, want):
            differ.append(key)
    if differ:
        raise SmokeFailure(f"import_pretrained: {len(differ)} entries differ from their source, "
                           f"such as {differ[:4]}")
    print(f"  import_pretrained: {n} entries written in {import_s:.1f} s (the .pt reads "
          f"included), {entries} equal to their source bit for bit but the folded positional "
          f"convs (max error {folded}); logged absent {absent}; files {files}")
    del raw_av, raw_product, whisper, llama_state, sr_state, sd, got
    gc.collect()

    batch = make_batch()
    outs = {}
    for name, system in (("import_source_int8", src), ("import_imported_int8", dst)):
        system.enable_quantized_decode("int8")
        phase, seqs, scores = serve(table, system, batch, name, IMPORT_TOKENS,
                                    dict(kv_quant="int8", ancestry_reorder=True),
                                    expect=EXPECT["int8_weights"])
        outs[name] = (phase, seqs, scores)
    (_, s_seqs, s_scores), (_, i_seqs, i_scores) = outs.values()
    if not (torch.equal(s_seqs, i_seqs) and torch.equal(s_scores, i_scores)):
        raise SmokeFailure("import_pretrained: the imported system's int8 beams differ from "
                           "its source's")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  import_pretrained: int8 beam tokens and scores of the imported system equal its "
          f"source's bit for bit; peak {peak:.2f} GiB")
    record.update(entries_written=n, entries=entries, import_s=import_s,
                  folded_max_err=folded, absent=absent, files=files, peak_gib=peak,
                  **{name: phase for name, (phase, _, _) in outs.items()})
    del src, dst, outs
    gc.collect()
    torch.cuda.empty_cache()
    return record


def cli_init_from_pt(table) -> dict:
    """``cli.train.main`` on the AVSR preset at full width with
    ``checkpoint.init_from_pt`` = import_pretrained's product ``.pt``, 2
    updates, no validation, one checkpoint write.  Checks: before update 1
    the imported entries equal the file's bit for bit; K1 24 or 48 times a
    step, as in cli_train_avsr; finite losses; the checkpoint written."""
    import gc
    import shutil

    import torch

    from multimodalvc_tpu_torch.cli import train as cli_train
    from multimodalvc_tpu_torch.interop.avsr_import import import_reference_avsr
    from multimodalvc_tpu_torch.ops.attention import flash_attention
    from multimodalvc_tpu_torch.runtime import flatten_state_dict, load_pt

    save_dir = CLI_RUNS / "avsr_import"
    shutil.rmtree(save_dir, ignore_errors=True)
    path = IMPORT_DIR / "product.pt"
    want = import_reference_avsr(flatten_state_dict(load_pt(str(path))["model"]))
    seen = {}

    class Probe(cli_train.Trainer):
        """Trainer that holds the module's imported entries at its start and
        counts each step's K1 launches."""

        def __init__(self, loss_fn, module, *a, **k):
            own = module.state_dict()
            seen["differ"] = [key for key, x in want.items()
                              if not torch.equal(own[key], x.to(own[key].dtype).to(DEV))]
            seen["k1"] = []
            super().__init__(loss_fn, module, *a, **k)

        def train_step(self, batch):
            before = flash_attention.launches
            out = super().train_step(batch)
            seen["k1"].append((flash_attention.launches - before, batch["video"].shape[1]))
            return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = cli_config("mms-llama", [
        "task.llm_path=null", f"task.noise_wav={CLI_DIR}/babble.wav",
        f"dataset.max_tokens={CLI_MAX_TOKENS}", "optimization.max_update=2",
        "dataset.disable_validation=true", "dataset.valid_wer_batches=0",
        "checkpoint.best_checkpoint_metric=none", f"checkpoint.save_dir={save_dir}",
        f"checkpoint.init_from_pt={path}"])
    reset_counts(table)
    with mock.patch.object(cli_train, "Trainer", Probe), CliTap(cli_train) as tap:
        _, t_run = wall(lambda: cli_train.main(cfg, device=DEV))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [s["loss"] for s in tap.of("train")]
    if seen["differ"]:
        raise SmokeFailure(f"cli_init_from_pt: {len(seen['differ'])} imported entries differ "
                           f"from the file before update 1, such as {seen['differ'][:3]}")
    wrong = [(n, t) for n, t in seen["k1"] if n != cli_k1_a_step(t)]
    if wrong or len(seen["k1"]) != 2:
        raise SmokeFailure(f"cli_init_from_pt: K1 launches (got, video frames) {seen['k1']}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != 2:
        raise SmokeFailure(f"cli_init_from_pt: losses {losses}")
    if not (save_dir / "checkpoint_last" / "state.pt").exists() or len(tap.writes) != 1:
        raise SmokeFailure(f"cli_init_from_pt: {len(tap.writes)} checkpoint writes under {save_dir}")
    times = step_times(tap)
    print(f"  cli_init_from_pt: {len(want)} entries imported and equal to the file before update "
          f"1; {len(losses)} updates in {t_run:.1f} s ({times['mean_step_ms']:.1f} ms a step), "
          f"losses {[round(x, 4) for x in losses]}, K1 {seen['k1']}, peak {peak:.2f} GiB, one "
          f"checkpoint write of {times['ckpt_gib']:.2f} GiB in {times['ckpt_write_s']:.1f} s")
    return {"imported": len(want), "losses": losses, "wall_s": t_run, "peak_gib": peak,
            "k1_a_step": seen["k1"], "launches": read_counts(table), **times}


def cli_demo(table) -> dict:
    """``cli.demo.main`` on one 16 s corpus clip (.npy video, 16 kHz wav)
    from cli_init_from_pt's checkpoint at beam 5: ``generate()``'s GPU
    default (bf16 KV, the ancestry decode: K1, K3 and K4, and nothing else).
    Its transcript must equal the decode of ``AVSRSystem.generate`` on the
    same clip's batch, built here, with the same tokenizer."""
    import gc
    import shutil

    import torch

    from multimodalvc_tpu_torch.cli import demo as cli_demo_module
    from multimodalvc_tpu_torch.data.audio import read_wav, whisper_features_np
    from multimodalvc_tpu_torch.data.tokenizer import INSTRUCTION_TEXT, load_tokenizer
    from multimodalvc_tpu_torch.data.video import load_video_frames, transform_video

    clip = clip_frames().index(400)
    video, audio = CLI_DIR / "data" / f"clip{clip}.npy", CLI_DIR / "data" / f"clip{clip}.wav"
    tasks, decoded = [], []
    real_build = cli_demo_module.build_task

    def build_task(*a, **k):
        """The demo's task, its ``generate`` output kept."""
        task = real_build(*a, **k)
        generate = task.system.generate
        task.system.generate = lambda *a, **k: decoded.append(generate(*a, **k)) or decoded[-1]
        tasks.append(task)
        return task

    gc.collect()
    torch.cuda.empty_cache()
    argv = ["--config", "", "--video", str(video), "--audio", str(audio), "--beams", str(BEAMS),
            "--max-len", str(DEMO_TOKENS), "--device", DEV, *PRESETS["mms-llama"],
            *CLI_EXTRA["mms-llama"], "task.llm_path=null", f"dataset.data={CLI_DIR}",
            f"checkpoint.save_dir={CLI_RUNS}/avsr_import", "checkpoint.restore_file=checkpoint_last"]
    expect = {"flash_attention": ON, "gen_attention_ancestor/bf16": ON, "beam_topk_columns": ON}
    with mock.patch.object(cli_demo_module, "build_task", build_task):
        phase, text = run_phase(table, "cli_demo", lambda: cli_demo_module.main(argv), expect,
                                audio_s=SECONDS)
    task = tasks.pop()
    check_ancestry("cli_demo", phase["launches"], phase["pytorch_merges"],
                   task.model_cfg.llama.num_layers, 1)
    tok = load_tokenizer(None)
    frames = transform_video(load_video_frames(str(video)))[None]
    feats = whisper_features_np(read_wav(str(audio)))[None][:, :, : 2 * task.model_cfg.whisper.max_frames]
    batch = {"video": torch.from_numpy(frames).to(DEV),
             "video_lengths": torch.tensor([frames.shape[1]], dtype=torch.int32, device=DEV),
             "audio_feats": torch.from_numpy(feats.copy()).to(DEV),
             "instruction": torch.tensor([tok.encode(INSTRUCTION_TEXT)], device=DEV)}
    seqs, _ = task.system.generate(batch, num_beams=BEAMS, max_new_tokens=DEMO_TOKENS)
    row = seqs[0, 0].tolist()
    row = row[: row.index(tok.eos_token_id)] if tok.eos_token_id in row else row
    want = tok.decode(row)
    if text != want or not torch.equal(decoded[0][0][0, 0], seqs[0, 0]):
        raise SmokeFailure(f"cli_demo: transcript {text!r} (best beam {decoded[0][0][0, 0]}), "
                           f"AVSRSystem.generate's {want!r} ({seqs[0, 0]})")
    print(f"  cli_demo: the transcript ({len(text)} characters of {len(row)} tokens before EOS: "
          "the byte tokenizer decodes the ids under 256) and the best beam's tokens equal "
          "AVSRSystem.generate's on the clip's batch")
    del task, tasks
    shutil.rmtree(CLI_RUNS / "avsr_import", ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {**phase, "transcript": text, "beams": BEAMS, "max_len": DEMO_TOKENS}


# ---- AV-HuBERT pretraining: the label pipeline, cli.train, the seq2seq decode ----


PRETRAIN_DIR = REPO / "build" / "pretrain"
PRETRAIN_UPDATES, PRETRAIN_CLUSTERS, PRETRAIN_LAYER = 4, 500, 12
PRETRAIN_LAYERS, PRETRAIN_WIDTH = 24, 1024  # AV-HuBERT-Large (K1 once a layer at T >= 256)
S2S_BATCH, S2S_FRAMES, S2S_TOKENS, S2S_SEED = BATCH, SECONDS * 25, 64, 11
S2S_CONSTRAINTS = [[[17, 23]], [[5]], [[300, 301, 302]], [], [[40], [41]], [], [[999]], []]


def k1_layers(frames: int, layers: int) -> int:
    """K1's launches in ``layers`` AV-HuBERT layers at ``frames`` frames
    (``nn/layers.py: use_flash``: T >= 256)."""
    return layers if frames >= 256 else 0


def kmeans_run(table, name, argv) -> dict:
    """``cli.manifest_tools learn-kmeans`` (no kernel launches): its wall and
    each epoch's inertia."""
    from multimodalvc_tpu_torch.cli import manifest_tools

    reset_counts(table)
    km, t_fit = wall(lambda: manifest_tools.main(["learn-kmeans", *argv, "--device", DEV]))
    if any(read_counts(table).values()) or not all(map(math.isfinite, km.epoch_inertia)):
        raise SmokeFailure(f"{name}: launches {read_counts(table)}, inertia {km.epoch_inertia}")
    print(f"  {name}: {km.k} clusters in {t_fit:.2f} s, inertia by epoch "
          f"{[f'{x:.6g}' for x in km.epoch_inertia]}")
    return {"fit_s": t_fit, "inertia": km.epoch_inertia}


def km_rows(path, lengths, clusters, name) -> list:
    """The label rows of a .km file, checked: one a clip, ``lengths`` long,
    in [0, clusters)."""
    rows = [[int(x) for x in r.split()] for r in Path(path).read_text().splitlines()]
    if [len(r) for r in rows] != list(lengths) or not all(0 <= x < clusters
                                                          for r in rows for x in r):
        raise SmokeFailure(f"{name}: {len(rows)} rows of {[len(r) for r in rows][:4]}... labels, "
                           f"want {len(lengths)} of {list(lengths)[:4]}... in [0, {clusters})")
    return rows


def pretrain_kmeans_mfcc(table) -> dict:
    """(a) Iteration 1: k-means (PRETRAIN_CLUSTERS) on the MFCCs of the train
    clips, then the .km labels of train and valid beside the manifests."""
    from multimodalvc_tpu_torch.cli import manifest_tools
    from multimodalvc_tpu_torch.data.manifest import load_manifest

    centroids = str(PRETRAIN_DIR / "km_mfcc.npy")
    record = kmeans_run(table, "pretrain_kmeans_mfcc", [
        "--tsv", str(CLI_DIR / "train.tsv"), "--clusters", str(PRETRAIN_CLUSTERS),
        "--out", centroids])
    for subset in ("train", "valid"):
        n, t_dump = wall(lambda: manifest_tools.main([
            "dump-labels", "--tsv", str(CLI_DIR / f"{subset}.tsv"), "--centroids", centroids,
            "--out", str(CLI_DIR / f"{subset}.km"), "--device", DEV]))
        frames = [e.n_video_frames for e in load_manifest(str(CLI_DIR / f"{subset}.tsv")).entries]
        rows = km_rows(CLI_DIR / f"{subset}.km", [4 * f + 1 for f in frames], PRETRAIN_CLUSTERS,
                       f"pretrain_kmeans_mfcc {subset}")
        record[f"{subset}_labels"] = {"rows": n, "frames": sum(map(len, rows)), "dump_s": t_dump}
        print(f"    dump-labels {subset}: {n} rows, {sum(map(len, rows))} frames at 100 Hz in "
              f"{t_dump:.2f} s")
    return record


def pretrain_train(table) -> dict:
    """(b) ``cli.train`` on conf/avhubert-pretrain.yaml (PRESETS) at full width
    (AV-HuBERT-Large, 2004 classes, final_dim 256, mask_prob 0.8, length
    10; random weights from the preset's seed, bf16), max_tokens 1000, for
    PRETRAIN_UPDATES updates, one checkpoint and one validation.  Checks:
    K1 24 times in a step whose bucket is >= 256 frames and 0 in the others
    (and 24 a validation batch of such a bucket), at least one such step;
    finite losses; the ResNet's running statistics moved; the checkpoint
    equal, entry for entry, to the trainer's final state.  Records each
    step's masked share of the valid frames, its ms and the peak GiB."""
    import gc

    import torch

    from multimodalvc_tpu_torch.cli import train as cli_train
    from multimodalvc_tpu_torch.data.batching import bucket_for
    from multimodalvc_tpu_torch.data.dataset import PretrainDataset
    from multimodalvc_tpu_torch.models import avhubert_pretrain
    from multimodalvc_tpu_torch.ops.attention import flash_attention
    from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager

    made, masks = [], []

    class Probe(cli_train.Trainer):
        """Trainer that keeps each step's K1 launches and frames."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.k1 = []
            made.append(self)

        def train_step(self, batch):
            before = flash_attention.launches
            out = super().train_step(batch)
            self.k1.append((flash_attention.launches - before, batch["video"].shape[1]))
            return out

    real_mask = avhubert_pretrain.span_mask_from_uniforms

    def tapped_mask(u, t, lengths, span):
        mask = real_mask(u, t, lengths, span)
        masks.append(float(mask.sum()) / float(lengths.sum()))
        return mask

    save_dir = PRETRAIN_DIR / "ckpt"
    cfg = cli_config("avhubert-pretrain", [f"optimization.max_update={PRETRAIN_UPDATES}",
                                           f"checkpoint.save_dir={save_dir}"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(table)
    with mock.patch.object(cli_train, "Trainer", Probe), \
            mock.patch.object(avhubert_pretrain, "span_mask_from_uniforms", tapped_mask), \
            CliTap(cli_train) as tap:
        val, t_run = wall(lambda: cli_train.main(cfg, device=DEV))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = read_counts(table)
    trainer = made[-1]
    want = [(k1_layers(t, PRETRAIN_LAYERS), t) for _, t in trainer.k1]
    vds = PretrainDataset(str(CLI_DIR), cfg.dataset.valid_subset)
    valid_want = sum(k1_layers(bucket_for(max(vds.sizes()[i] for i in b), vds.buckets),
                               PRETRAIN_LAYERS)
                     for b in vds.batches(max_tokens=cfg.dataset.max_tokens,
                                          batch_size=cfg.dataset.batch_size))
    losses = [s["loss"] for s in tap.of("train")]
    if trainer.k1 != want or not any(t >= 256 for _, t in trainer.k1):
        raise SmokeFailure(f"pretrain_train: K1 a step (got, frames) {trainer.k1}, want {want}")
    if len(losses) != PRETRAIN_UPDATES or not all(map(math.isfinite, losses)):
        raise SmokeFailure(f"pretrain_train: losses {losses}")
    valid = tap.of("valid")
    if len(valid) != 1 or not math.isfinite(valid[0]["loss"]):
        raise SmokeFailure(f"pretrain_train: validations {valid}")
    state = trainer.state_dict()
    moved = [n for n in state["model"] if n.endswith("running_var")
             and not torch.equal(state["model"][n].float().cpu(),
                                 torch.ones_like(state["model"][n].float().cpu()))]
    if not moved:
        raise SmokeFailure("pretrain_train: the ResNet's running statistics did not move")
    saved = CheckpointManager(str(save_dir)).restore(map_location="cpu")
    same = saved["step"] == state["step"] and all(
        torch.equal(saved["model"][n], x.cpu()) for n, x in state["model"].items())
    if not same:
        raise SmokeFailure("pretrain_train: the checkpoint differs from the trainer's state")
    train_k1 = sum(n for n, _ in trainer.k1)
    if launches["flash_attention"] - train_k1 != valid_want or any(
            n for k, n in launches.items() if k != "flash_attention"):
        raise SmokeFailure(f"pretrain_train: launches {launches}; K1 {train_k1} in the steps "
                           f"and {valid_want} expected in validation")
    times = step_times(tap)
    record = {"wall_s": t_run, "peak_gib": peak, "losses": losses, "valid": valid,
              "k1_a_step": trainer.k1, "masked_share": masks[:PRETRAIN_UPDATES],
              "valid_k1": launches["flash_attention"] - train_k1, "launches": launches,
              "running_var_moved": len(moved), **times}
    print(f"  pretrain_train: {len(losses)} updates in {t_run:.1f} s, "
          f"{times['mean_step_ms']:.1f} ms a step (steps {[round(x, 1) for x in times['step_ms']]}"
          f" ms), waiting {times['mean_wait_ms']:.1f} ms for a batch, peak {peak:.2f} GiB, K1 a "
          f"step (launches, frames) {trainer.k1}, masked share "
          f"{[round(x, 4) for x in record['masked_share']]}, losses "
          f"{[round(x, 4) for x in losses]}, valid {valid[0]}, K1 in validation "
          f"{record['valid_k1']}, {len(moved)} running variances moved, checkpoint "
          f"{times['ckpt_gib']:.2f} GiB in {times['ckpt_write_s']:.1f} s, equal to the state")
    del trainer, state, saved
    made.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return record


def pretrain_dump_features(table) -> dict:
    """(c) ``dump-features --layer 12`` from pretrain_train's checkpoint over
    the train clips, unmasked, twice: at the tool's default f32 (the JAX
    tool's dtype; plain attention, no launches) and at ``--dtype bfloat16``
    (K1 12 times a clip padded to >= 256 frames).  Each dump finite, [sum T,
    1024], its .len the clips' frames; the bf16 dump's error against the
    f32 one."""
    import numpy as np

    from multimodalvc_tpu_torch.cli import manifest_tools
    from multimodalvc_tpu_torch.data.manifest import load_manifest

    frames = [e.n_video_frames for e in load_manifest(str(CLI_DIR / "train.tsv")).entries]
    k1 = sum(k1_layers(-(-f // 32) * 32, PRETRAIN_LAYER) for f in frames)
    record, dumps = {}, {}
    for dtype, expect in (("float32", {}), ("bfloat16", {"flash_attention": k1})):
        out = str(PRETRAIN_DIR / f"feats_{dtype}")
        phase, _ = run_phase(table, f"pretrain_dump_features_{dtype}", lambda: (
                manifest_tools.main([
                "dump-features", "--tsv", str(CLI_DIR / "train.tsv"),
                "--ckpt", str(PRETRAIN_DIR / "ckpt"), "--layer", str(PRETRAIN_LAYER),
                "--out", out, "--dtype", dtype, "--device", DEV])), expect,
            audio_s=sum(frames) / 25)
        feats, lens = manifest_tools._read_feature_dump(out)
        if lens != frames or feats.shape != (sum(frames), PRETRAIN_WIDTH) or not np.isfinite(
                feats).all():
            raise SmokeFailure(f"pretrain_dump_features {dtype}: {feats.shape}, lens "
                               f"{lens[:4]}...")
        phase.update(feature_std=float(feats.std()))
        record[dtype], dumps[dtype] = phase, feats
    diff = np.abs(dumps["bfloat16"] - dumps["float32"])
    record.update(frames=sum(frames), clips=len(frames), bf16_max_abs_err=float(diff.max()),
                  bf16_mean_abs_err=float(diff.mean()),
                  launches={k: n + record["bfloat16"]["launches"][k]
                            for k, n in record["float32"]["launches"].items()})
    print(f"    dump-features bf16 against f32: max abs error {diff.max():.4g}, mean "
          f"{diff.mean():.4g} (f32 feature std {dumps['float32'].std():.4g})")
    return record


def pretrain_kmeans_features(table) -> dict:
    """(d) Iteration 2: k-means (PRETRAIN_CLUSTERS) on the default (f32)
    dump's layer features, then the labels of both dumps: a row a clip, its
    frames long, in [0, PRETRAIN_CLUSTERS); the share of frames whose bf16
    label equals the f32 one."""
    import numpy as np

    from multimodalvc_tpu_torch.cli import manifest_tools

    centroids = str(PRETRAIN_DIR / "km_feats.npy")
    record = kmeans_run(table, "pretrain_kmeans_features", [
        "--features", str(PRETRAIN_DIR / "feats_float32"), "--clusters", str(PRETRAIN_CLUSTERS),
        "--out", centroids])
    labels = {}
    for dtype in ("float32", "bfloat16"):
        feats, km = str(PRETRAIN_DIR / f"feats_{dtype}"), PRETRAIN_DIR / f"train_{dtype}.km"
        n, t_dump = wall(lambda: manifest_tools.main([
            "dump-labels", "--features", feats, "--centroids", centroids, "--out", str(km),
            "--device", DEV]))
        _, lens = manifest_tools._read_feature_dump(feats)
        rows = km_rows(km, lens, PRETRAIN_CLUSTERS, f"pretrain_kmeans_features {dtype}")
        labels[dtype] = np.concatenate([np.asarray(r) for r in rows])
        record[f"{dtype}_labels"] = {"rows": n, "dump_s": t_dump,
                                     "clusters_used": len(set(labels[dtype].tolist()))}
    equal = float((labels["bfloat16"] == labels["float32"]).mean())
    record["bf16_labels_equal_share"] = equal
    print(f"    dump-labels --features: {record['float32_labels']['rows']} rows, "
          f"{record['float32_labels']['clusters_used']} clusters used; bf16 dump's labels equal "
          f"to the f32 dump's on {equal:.4f} of the frames")
    return record


def seq2seq_phase(table) -> dict:
    """(e) ``generate_seq2seq`` at the default ``Seq2SeqDecoderConfig`` (d
    768, 6 layers, 4 heads, FFN 3072, vocabulary 1000; random bf16 weights
    from S2S_SEED) on seeded encoder states [8, 400, 768], beam 5,
    S2S_TOKENS new tokens: once plain (K4 once a decode step; the cache
    leaves' head dim 192 keeps K6 off), its tokens equal to the same run
    under ``plain_versions()``; then with unordered constraints (no kernel:
    the constrained step's own top-k), each row's best beam holding its
    phrases."""
    import torch

    from multimodalvc_tpu_torch.nn.init import init_random_
    from multimodalvc_tpu_torch.nn.seq2seq import (
        Seq2SeqDecoder,
        Seq2SeqDecoderConfig,
        generate_seq2seq,
    )
    from multimodalvc_tpu_torch.ops.constraints import pack_constraints

    cfg = Seq2SeqDecoderConfig()
    decoder = Seq2SeqDecoder(cfg, device=DEV, dtype=torch.bfloat16).eval()
    init_random_(decoder, S2S_SEED)
    g = torch.Generator(device=DEV).manual_seed(S2S_SEED)
    enc = torch.randn(S2S_BATCH, S2S_FRAMES, cfg.d_model, generator=g, device=DEV).to(
        torch.bfloat16)
    lens = torch.tensor([S2S_FRAMES - 12 * i for i in range(S2S_BATCH)], dtype=torch.int32,
                        device=DEV)
    kw = dict(bos_token_id=0, max_new_tokens=S2S_TOKENS, num_beams=BEAMS)

    def run():
        return generate_seq2seq(decoder, enc, lens, **kw)

    phase, (seqs, scores) = run_phase(table, "seq2seq", run, {"beam_topk_columns": ON},
                                      audio_s=S2S_BATCH * SECONDS)
    check_output("seq2seq", seqs, scores, cfg.vocab_size, S2S_TOKENS)
    steps = phase["launches"]["beam_topk_columns"]
    with plain_versions():
        (pseqs, pscores), t_plain = wall(run)
    if not torch.equal(seqs, pseqs):
        bad = int((seqs != pseqs).flatten(1).any(dim=1).nonzero()[0])
        raise SmokeFailure(f"seq2seq: tokens differ from the plain versions' at row {bad}")
    cons = pack_constraints(S2S_CONSTRAINTS)
    phase_c, (cseqs, cscores) = run_phase(
        table, "seq2seq_constrained",
        lambda: generate_seq2seq(decoder, enc, lens, constraints=cons, **kw), {},
        audio_s=S2S_BATCH * SECONDS)
    check_output("seq2seq_constrained", cseqs, cscores, cfg.vocab_size, S2S_TOKENS)
    for row, phrases in zip(cseqs[:, 0].tolist(), S2S_CONSTRAINTS):
        if not all(contains(row, p) for p in phrases):
            raise SmokeFailure(f"seq2seq_constrained: best beam {row} lacks one of {phrases}")
    score_err = max_err(scores, pscores)
    print(f"    seq2seq: {steps} decode steps, tokens equal under plain_versions() ({t_plain:.3f} s"
          f", scores {score_err:.2e} apart); constrained: every phrase in its row's best beam")
    phase.update(decode_steps=steps, plain_s=t_plain, plain_tokens_equal=True,
                 plain_score_err=score_err, tokens_a_s=S2S_BATCH * steps / phase["generate_s"])
    output_digest(phase, "seq2seq", seqs, scores)
    return {"seq2seq": phase, "seq2seq_constrained": phase_c}


def pretrain_phases(table) -> dict:
    """The pretraining slice, (a)-(e), on the cli corpus (written first if it
    is not there); build/pretrain is removed after."""
    import shutil

    shutil.rmtree(PRETRAIN_DIR, ignore_errors=True)
    PRETRAIN_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    phases = {} if (CLI_DIR / "train.tsv").exists() else {"cli_corpus": write_corpus()}
    phases["pretrain_kmeans_mfcc"] = pretrain_kmeans_mfcc(table)
    phases["pretrain_train"] = pretrain_train(table)
    phases["pretrain_dump_features"] = pretrain_dump_features(table)
    phases["pretrain_kmeans_features"] = pretrain_kmeans_features(table)
    phases.update(seq2seq_phase(table))
    shutil.rmtree(PRETRAIN_DIR, ignore_errors=True)
    phases["pretrain_wall_s"] = time.perf_counter() - t0
    print(f"  pretraining phases: {phases['pretrain_wall_s']:.1f} s")
    return phases


def import_phases(table) -> dict:
    """The weight-import phases: import_pretrained, then cli_init_from_pt on
    its product ``.pt`` (with the cli corpus) and cli_demo from that run's
    checkpoint."""
    import shutil

    CLI_RUNS.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    phases = {} if (CLI_DIR / "train.tsv").exists() else {"cli_corpus": write_corpus()}
    phases["import_pretrained"] = import_pretrained(table)
    phases["cli_init_from_pt"] = cli_init_from_pt(table)
    phases["cli_demo"] = cli_demo(table)
    shutil.rmtree(IMPORT_DIR, ignore_errors=True)
    phases["import_wall_s"] = time.perf_counter() - t0
    print(f"  import phases: {phases['import_wall_s']:.1f} s")
    return phases


# ---- several ranks -----------------------------------------------------------------

PARALLEL_DIR = REPO / "build" / "parallel"
PARALLEL_UPDATES = 3  # parallel_nccl_1rank: cli.train updates a run
# parallel_data_2rank: updates, the first at lr 0 (the cosine warmup starts at
# 0), so the last two move the masters and the last loss sees them moved
PARALLEL_STEPS, PARALLEL_WARMUP = 3, 1
MOE_STEPS = 3  # parallel_moe_speech: updates
CHILD_TIMEOUT_S = 600
PARALLEL_BACKEND = "nccl"  # parallel_nccl_1rank's group (a CPU rehearsal: gloo)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_children(cmds, envs, name: str) -> None:
    """Run the commands side by side (each in its own session, so that a
    failure or the time limit stops it and what it started); fail the phase
    unless every one exits 0 in CHILD_TIMEOUT_S."""
    import signal

    procs = [subprocess.Popen(cmd, cwd=REPO, env={**os.environ, **env}, start_new_session=True)
             for cmd, env in zip(cmds, envs)]
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    codes = [proc.returncode for proc in procs]
    if any(codes):
        raise SmokeFailure(f"{name}: child processes exited {codes}")


def nccl_child(out: str) -> int:
    """In a ``torch.distributed.run`` launch of one process: ``cli.train`` on
    conf/mms-llama.yaml at full width over the cli corpus, PARALLEL_UPDATES
    updates with checkpoint writes off, first without a group (torchrun's
    WORLD_SIZE=1 starts none), then in the NCCL group of one that
    ``distributed_init(force=True)`` starts, which the CLI takes as a
    launcher's: its step is the distributed one.  Writes both runs'
    losses, K1 launches, walls and peaks to ``out``."""
    import gc

    import torch
    import torch.distributed as dist

    from multimodalvc_tpu_torch.cli import train as cli_train
    from multimodalvc_tpu_torch.parallel import distributed
    from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager

    table = kernels()
    runs = {}
    run = ["task.llm_path=null", f"task.noise_wav={CLI_DIR}/babble.wav",
           f"dataset.max_tokens={CLI_MAX_TOKENS}", f"optimization.max_update={PARALLEL_UPDATES}",
           "dataset.disable_validation=true", f"checkpoint.save_dir={PARALLEL_DIR}/nccl_run"]
    with mock.patch.object(CheckpointManager, "_write", lambda *a: None):
        for name in ("no_group", "nccl_group"):
            if name == "nccl_group":
                distributed.distributed_init(force=True)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(table)
            with CliTap(cli_train) as tap:
                _, t_run = wall(lambda: cli_train.main(cli_config("mms-llama", run), device=DEV))
            steps = tap.of("train")
            runs[name] = {"losses": [s["loss"] for s in steps],
                          "step_ms": [s["step_ms"] for s in steps],
                          "launches": read_counts(table), "wall_s": t_run,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                          "backend": dist.get_backend() if dist.is_initialized() else None,
                          "world_size": dist.get_world_size() if dist.is_initialized() else 1}
    distributed.destroy()
    Path(out).write_text(json.dumps(runs))
    return 0


def parallel_nccl_1rank(table) -> dict:
    """``nccl_child`` under ``python -m torch.distributed.run --standalone
    --nproc_per_node 1``.  Checks: the group run used NCCL at world size 1;
    its losses equal the run without a group to 1e-6 relative, update by
    update; both runs launched K1 the same times, 24 or more a step."""
    PARALLEL_DIR.mkdir(parents=True, exist_ok=True)
    out = PARALLEL_DIR / "nccl.json"
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    run_children([[sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", "1", str(REPO / "chip_smoke.py"), "--parallel-child",
                   "nccl", str(out)]], [{}], "parallel_nccl_1rank")
    runs = json.loads(out.read_text())
    plain, group = runs["no_group"], runs["nccl_group"]
    if (group["backend"] != PARALLEL_BACKEND or group["world_size"] != 1
            or plain["backend"] is not None):
        raise SmokeFailure(f"parallel_nccl_1rank: backends {plain['backend']}, "
                           f"{group['backend']} (world {group['world_size']})")
    if len(group["losses"]) != PARALLEL_UPDATES or len(plain["losses"]) != PARALLEL_UPDATES:
        raise SmokeFailure(f"parallel_nccl_1rank: updates {plain['losses']}, {group['losses']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(group["losses"], plain["losses"]))
    k1 = group["launches"]["flash_attention"]
    print(f"  parallel_nccl_1rank: {PARALLEL_UPDATES} cli.train updates in the NCCL group of "
          f"one, losses {group['losses']} vs {plain['losses']} without a group (rel {rel:.2e}, "
          f"gate 1e-06), step ms {[round(x, 1) for x in group['step_ms']]} vs "
          f"{[round(x, 1) for x in plain['step_ms']]}, K1 {k1}, peak {group['peak_gib']:.2f} GiB")
    if not all(math.isfinite(x) for x in group["losses"]) or not rel <= 1e-6:
        raise SmokeFailure(f"parallel_nccl_1rank: losses {rel:.3e} from the run without a group")
    if group["launches"] != plain["launches"] or k1 < cli_k1_a_step(0) * PARALLEL_UPDATES:
        raise SmokeFailure(f"parallel_nccl_1rank: launches {group['launches']} vs "
                           f"{plain['launches']}")
    return {**group, "no_group": plain, "losses_rel": rel, "wall_s": time.perf_counter() - t0}


def _masters_flat(trainer):
    import torch

    return torch.cat([m.reshape(-1) for m in trainer.master.values()])


def _data_steps(trainer, batch):
    """PARALLEL_STEPS updates: each one's loss and gnorm (the global norm of
    the gradient before the clip, so a wrong gradient scale shows in it
    although the clip and Adam hide it from the update), and the update of
    the trainable masters over them (after minus before, f32, flat)."""
    start = _masters_flat(trainer)
    metrics = [trainer.train_step(batch) for _ in range(PARALLEL_STEPS)]
    return {"losses": [m["loss"] for m in metrics], "gnorms": [m["gnorm"] for m in metrics],
            "update": _masters_flat(trainer) - start}


def _step_gaps(run, ref, key):
    return [abs(a - b) / abs(b) for a, b in zip(run[key], ref[key])]


def _data_gaps(run, ref) -> dict:
    """How far ``run`` lies from ``ref``: the largest relative gap of the
    losses and of the gnorms over the steps, and the update's relative L2."""
    return {"losses": max(_step_gaps(run, ref, "losses")),
            "gnorms": max(_step_gaps(run, ref, "gnorms")),
            "update": rel_l2(run["update"], ref["update"])}


def data_child(out: str) -> int:
    """One of two ranks of ``parallel_data_2rank`` (RANK, WORLD_SIZE 2 and
    LOCAL_RANK 0 from the parent: both bind cuda:0), joined over gloo: the
    full-width AVSR Trainer on its 4 rows of the training batch, without
    dropout, then its state saved and loaded back as a resume on the mesh
    does (rank 1 reseeds its CUDA generator from rank 0's state).  Writes
    its losses, gnorms, update, K1 launches, step walls, peak and what the
    resume restored to ``out``."""
    import torch

    from multimodalvc_tpu_torch.models import avsr
    from multimodalvc_tpu_torch.parallel import distributed
    from multimodalvc_tpu_torch.parallel.mesh import batch_group_rank, make_mesh

    distributed.distributed_init(backend="gloo")
    make_mesh({"data": 2})
    table = kernels()
    with mock.patch.object(avsr, "train_rng", lambda train, generator: None):
        task, trainer = build_trainer(flash=False, warmup=PARALLEL_WARMUP)
        full = task.prepare_batch(make_train_batch())
        rows = BATCH // 2
        r = batch_group_rank()
        mine = {k: v[r * rows:(r + 1) * rows] for k, v in full.items()}
        torch.cuda.reset_peak_memory_stats()
        reset_counts(table)
        run, t = wall(lambda: _data_steps(trainer, mine))
        launches = read_counts(table)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    masters = _masters_flat(trainer)
    saved = trainer.state_dict(include_frozen=False)
    # the file of a resume holds rank 0's generator state
    generator = saved["generator"].cpu().clone()
    torch.distributed.broadcast(generator, src=0)
    trainer.load_state_dict({**saved, "generator": generator})
    torch.save({**run, "update": run["update"].cpu(), "launches": launches,
                "step_ms": 1e3 * t / PARALLEL_STEPS, "peak_gib": peak,
                "n_tokens": int(mine["label_lengths"].sum()),
                "resume": {"masters_kept": bool(torch.equal(_masters_flat(trainer), masters)),
                           "generator": generator,
                           "restored": trainer.generator.get_state().cpu(),
                           "device": str(trainer.generator.device)}}, out)
    distributed.destroy()
    return 0


def parallel_data_2rank(table) -> dict:
    """Data parallelism at full width on the one card: first the one-process
    step on the whole batch (BATCH rows, PARALLEL_STEPS updates after a
    warmup of PARALLEL_WARMUP, no dropout), and the same from the same
    start with one bf16 ulp on 0.01% of the audio features, at two offsets
    (the noise floor of each compared quantity, the larger of the two);
    then two ranks (``data_child``) on its halves, whose valid label
    tokens differ.  Checks: the ranks' losses, gnorms and updates bitwise
    equal; the losses, the gnorms and the masters' update each within
    FLOOR_MARGIN x its own floor of the one-process step; K1 48 a step a
    rank; the resume on the mesh kept the masters, restored rank 0's
    generator state and reseeded rank 1's CUDA generator apart."""
    import gc

    import torch

    from multimodalvc_tpu_torch.models import avsr

    PARALLEL_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with mock.patch.object(avsr, "train_rng", lambda train, generator: None):
        task, trainer = build_trainer(flash=False, warmup=PARALLEL_WARMUP)
        batch = task.prepare_batch(make_train_batch())
        start = copy.deepcopy(trainer.state_dict(include_frozen=False))
        ref, t_one = wall(lambda: _data_steps(trainer, batch))
        peak_one = torch.cuda.max_memory_allocated() / 2 ** 30
        nudges, step_gaps = [], {}
        for offset in (0, 4999):
            trainer.load_state_dict(start)
            nudged = dict(batch)
            nudged["audio_feats"] = batch["audio_feats"].clone()
            flat = nudged["audio_feats"].view(-1)
            flat[offset::9973] = flat[offset::9973] * (1 + 2 ** -7)
            run = _data_steps(trainer, nudged)
            nudges.append(_data_gaps(run, ref))
            step_gaps[f"nudge{offset}"] = {k: _step_gaps(run, ref, k) for k in ("losses", "gnorms")}
    floor = {k: max(n[k] for n in nudges) for k in nudges[0]}
    ref["update"] = ref["update"].cpu()
    del task, trainer, start, batch, nudged, run
    gc.collect()
    torch.cuda.empty_cache()
    outs = [PARALLEL_DIR / f"data_rank{r}.pt" for r in range(2)]
    for o in outs:
        o.unlink(missing_ok=True)
    env = {"WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "LOCAL_RANK": "0"}
    t1 = time.perf_counter()
    run_children([[sys.executable, str(REPO / "chip_smoke.py"), "--parallel-child", "data",
                   str(o)] for o in outs], [{**env, "RANK": str(r)} for r in range(2)],
                 "parallel_data_2rank")
    t_ranks = time.perf_counter() - t1
    ranks = [torch.load(o, weights_only=False) for o in outs]
    a, b = ranks
    if (a["losses"] != b["losses"] or a["gnorms"] != b["gnorms"]
            or not torch.equal(a["update"], b["update"])):
        raise SmokeFailure("parallel_data_2rank: the two ranks differ")
    if a["n_tokens"] == b["n_tokens"]:
        raise SmokeFailure("parallel_data_2rank: the halves hold equal valid tokens")
    gaps = _data_gaps(a, ref)
    step_gaps["ranks"] = {k: _step_gaps(a, ref, k) for k in ("losses", "gnorms")}
    gates = {k: FLOOR_MARGIN * floor[k] for k in floor}
    k1 = [r["launches"]["flash_attention"] for r in ranks]
    print(f"  parallel_data_2rank: two gloo ranks on one card, {PARALLEL_STEPS} updates on "
          f"{BATCH // 2} rows each ({a['n_tokens']} and {b['n_tokens']} label tokens): losses "
          f"{a['losses']} vs one process {ref['losses']}, gnorms {a['gnorms']} vs "
          f"{ref['gnorms']}, update norm {float(a['update'].norm()):.4e} vs "
          f"{float(ref['update'].norm()):.4e}; gaps "
          + ", ".join(f"{k} {gaps[k]:.2e} (floor {floor[k]:.2e}, gate {gates[k]:.2e})"
                      for k in gaps)
          + f"; {a['step_ms']:.1f} ms a step a rank (one process "
          f"{1e3 * t_one / PARALLEL_STEPS:.1f} ms), peak {a['peak_gib']:.2f} / "
          f"{b['peak_gib']:.2f} GiB a rank ({peak_one:.2f} one process), K1 {k1}")
    if not all(gaps[k] <= gates[k] for k in gaps):
        raise SmokeFailure(f"parallel_data_2rank: gaps {gaps} from the one-process step "
                           f"(gates {gates})")
    wrong = [r["launches"] for r in ranks
             if r["launches"] != {**{k: 0 for k in r["launches"]},
                                  "flash_attention": ENCODER_FLASH * PARALLEL_STEPS}]
    if wrong:
        raise SmokeFailure(f"parallel_data_2rank: launches {wrong} (K1 {ENCODER_FLASH} a step)")
    ra, rb = a["resume"], b["resume"]
    if not (ra["masters_kept"] and rb["masters_kept"] and ra["device"].startswith("cuda")
            and torch.equal(ra["restored"], ra["generator"])
            and torch.equal(rb["generator"], ra["generator"])
            and not torch.equal(rb["restored"], ra["generator"])):
        raise SmokeFailure(f"parallel_data_2rank: the resume on two ranks ({ra['device']}): "
                           f"masters kept {ra['masters_kept']} / {rb['masters_kept']}")
    print(f"  parallel_data_2rank: resumed on both ranks ({ra['device']} generators, rank 1 "
          "reseeded apart)")
    return {"losses": a["losses"], "one_process_losses": ref["losses"], "gnorms": a["gnorms"],
            "one_process_gnorms": ref["gnorms"], "gaps": gaps, "noise_floor": floor,
            "nudges": nudges, "step_gaps": step_gaps, "gates": gates, "step_ms_a_rank": a["step_ms"],
            "one_process_step_ms": 1e3 * t_one / PARALLEL_STEPS,
            "peak_gib_a_rank": [r["peak_gib"] for r in ranks], "one_process_peak_gib": peak_one,
            "n_tokens": [r["n_tokens"] for r in ranks], "launches": a["launches"],
            "ranks_wall_s": t_ranks, "wall_s": time.perf_counter() - t0}


def parallel_moe_speech(table) -> dict:
    """conf/mms-speech-nollm-moe.yaml with ``mesh.expert=1`` (all four
    experts on the card) at full width, built by ``cli.train``'s
    ``build_task`` and trained by its ``Trainer`` on the speech training
    batch: the step-1 gradients against K1 plain at the run's noise floor
    (``gradient_gate``), then MOE_STEPS updates with every launch count 0
    before the first.  Checks: K1 SPEECH_FLASH a step, 12 with a gradient;
    the mel L1 finite and moving; each block's expert bank took tokens.
    Prints the tokens each expert of the first block took and the overflow
    share over the blocks."""
    import gc

    import torch

    from multimodalvc_tpu_torch.cli import train as cli_train
    from multimodalvc_tpu_torch.parallel.expert import BaseMoELayer
    from multimodalvc_tpu_torch.parallel.mesh import mesh_scope
    from multimodalvc_tpu_torch.runtime.trainer import Trainer

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = cli_config("mms-speech-nollm-moe", ["mesh.expert=1", "model.max_video_frames=400",
                                              "optimization.warmup_updates=2"])
    with mesh_scope(cli_train.mesh_sizes(cfg)):  # the caller's mesh current again after
        task = cli_train.build_task(cfg, DEV)
        task.init_random(cfg.common.seed)
        trainer = Trainer(task.make_loss_fn(), task.module, cfg.optimization,
                          task.frozen_patterns(), seed=cfg.common.seed)
        banks = [m for m in task.module.modules() if isinstance(m, BaseMoELayer)]
        blocks = [m for m in task.module.modules() if type(m).__name__ == "ConformerBlock"]
        if not banks or len(banks) != len(blocks):
            raise SmokeFailure(f"parallel_moe_speech: {len(banks)} expert banks in {len(blocks)} "
                               "Conformer blocks")
        raw = make_speech_train_batch()
        gate_batch = {**task.prepare_batch(raw, train=False),
                      "modality_mode": torch.tensor(0, dtype=torch.int32, device=DEV)}
        record = gradient_gate(trainer, gate_batch, "parallel_moe_speech")
        torch.cuda.reset_peak_memory_stats()
        metrics, walls, loads = [], [], []
        reset_counts(table)
        with GradLaunches() as grads:
            for _ in range(MOE_STEPS):
                m, t_step = wall(lambda: trainer.train_step(task.prepare_batch(raw)))
                metrics.append(m)
                walls.append(t_step)
                loads.append([{k: v.tolist() for k, v in b.load.items()} for b in banks])
        launches = read_counts(table)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_k1_launches("parallel_moe_speech", launches, grads.n, MOE_STEPS,
                          CONFORMER_GRAD_LAUNCHES)
        losses = [m["mel_l1"] for m in metrics]
        if not all(math.isfinite(x) for x in losses) or len(set(losses)) < 2:
            raise SmokeFailure(f"parallel_moe_speech: mel L1 {losses} (finite, moving)")
        last = loads[-1]
        tokens = sum(sum(b["tokens"]) + b["overflow"] for b in last)
        overflow = sum(b["overflow"] for b in last) / tokens
        if any(sum(b["tokens"]) == 0 for b in last):
            raise SmokeFailure("parallel_moe_speech: an expert bank took no token")
        step_s = sum(walls[1:]) / len(walls[1:])
        print(f"  parallel_moe_speech: {MOE_STEPS} updates, mel L1 "
              f"{[round(x, 4) for x in losses]}, {1e3 * step_s:.1f} ms a step, peak "
              f"{peak:.2f} GiB; block 0's experts took {last[0]['tokens']} tokens, "
              f"{100 * overflow:.2f}% of the tokens overflowed")
        record.update(mel_l1=losses, step_ms=[1e3 * x for x in walls], mean_step_ms=1e3 * step_s,
                      peak_gib=peak, launches=launches, expert_tokens=[b["tokens"] for b in last],
                      overflow_share=overflow, k1_grad_launches_a_step=grads.n // MOE_STEPS,
                      wall_s=time.perf_counter() - t0)
        del task, trainer, banks
        gc.collect()
        torch.cuda.empty_cache()
        return record


# ---- the tensor axis: two gloo ranks sharing the card ----------------------------

TENSOR_RUN = ["task.llm_path=null", f"task.noise_wav={CLI_DIR}/babble.wav",
              f"dataset.max_tokens={CLI_MAX_TOKENS}", f"optimization.max_update={PARALLEL_UPDATES}",
              "optimization.warmup_updates=2", "dataset.disable_validation=true",
              f"checkpoint.save_dir={PARALLEL_DIR}/tensor_run"]
# the input changes whose effects on a one-process run are the tensor
# phases' noise floor: one bf16 ulp on every 9973rd audio feature from each
# offset (parallel_data_2rank's), and DITHER, one bf16 ulp either way on
# every feature: the tensor split rounds every split product differently,
# a change of every element, not of 0.01% of them
DITHER = "dither"
PERTURBATIONS = (0, 2500, 4999, DITHER)


def perturb(x, how):
    """``x`` changed by ``how`` (PERTURBATIONS): an offset's nudges or the
    dither (its signs seeded)."""
    import torch

    if how == DITHER:
        g = torch.Generator(device=x.device).manual_seed(17)
        sign = torch.randint(0, 2, x.shape, generator=g, device=x.device) * 2 - 1
        return x * (1 + 2 ** -7 * sign)
    x = x.clone()
    flat = x.view(-1)
    flat[how::9973] = flat[how::9973] * (1 + 2 ** -7)
    return x


def whole_masters_flat(trainer):
    """The trainable masters, whole (a tensor-split leaf's slices gathered,
    collective), as one f32 vector."""
    import torch

    model = trainer.state_dict(include_frozen=False)["model"]
    return torch.cat([model[n].float().reshape(-1) for n in trainer.master])


def split_bytes(module, trainer) -> dict:
    """Each tensor-split leaf's bytes on this rank (the module's weight, and
    a trainable one's f32 master and optimizer moments) against the whole
    leaf's."""
    from multimodalvc_tpu_torch.parallel.tensor import tensor_dim

    held = whole = 0
    leaves = 0
    for n, p in module.named_parameters():
        if tensor_dim(p) is None:
            continue
        leaves += 1
        n_whole = math.prod(p.whole_shape)
        held += p.numel() * p.element_size()
        whole += n_whole * p.element_size()
        if n in trainer.master:
            state = [trainer.master[n]] + [t[n] for t in trainer.optimizer.state.values()]
            held += sum(t.numel() * t.element_size() for t in state)
            whole += len(state) * 4 * n_whole
    return {"leaves": leaves, "held_gib": held / 2 ** 30, "whole_gib": whole / 2 ** 30}


def tensor_avsr_run(table, tensor: bool = False, change=None) -> dict:
    """``cli.train.main`` on conf/mms-llama.yaml at full width over the cli
    corpus (TENSOR_RUN: PARALLEL_UPDATES updates, no validation, checkpoint
    writes off), dropout on, with ``mesh.tensor=2`` where ``tensor``;
    ``change``: the training batches' audio features perturbed
    (``perturb``).  Its losses,
    gnorms, the trainable masters' update, K1's launches, the step walls
    and the peak, and on a tensor axis the split leaves' bytes."""
    import gc

    import torch

    from multimodalvc_tpu_torch import tasks
    from multimodalvc_tpu_torch.cli import train as cli_train
    from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager

    kept = {}

    class Kept(cli_train.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            kept["trainer"], kept["start"] = self, whole_masters_flat(self)

    prepare = tasks.AVSRTask.prepare_batch

    def nudged(self, batch, train=True):
        out = prepare(self, batch, train)
        if train and change is not None:
            out["audio_feats"] = perturb(out["audio_feats"], change)
        return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(table)
    with mock.patch.object(CheckpointManager, "_write", lambda *a: None), \
            mock.patch.object(cli_train, "Trainer", Kept), \
            mock.patch.object(tasks.AVSRTask, "prepare_batch", nudged), CliTap(cli_train) as tap:
        run = TENSOR_RUN + (["mesh.tensor=2"] if tensor else [])
        _, t_run = wall(lambda: cli_train.main(cli_config("mms-llama", run), device=DEV))
    steps = tap.of("train")
    trainer = kept["trainer"]
    out = {"losses": [s["loss"] for s in steps], "gnorms": [s["gnorm"] for s in steps],
           "update": (whole_masters_flat(trainer) - kept["start"]).cpu(),
           "launches": read_counts(table), "step_ms": [s["step_ms"] for s in steps],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "wall_s": t_run,
           "bytes": split_bytes(trainer.module, trainer)}
    del kept, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def nollm_trainer(mesh=None):
    """The NoLLM task at full width (``speech_config()``, bf16, random from
    SPEECH_SEED), split on ``mesh``'s tensor axis where one is given, its
    ``Trainer`` (the conf/mms-speech-nollm.yaml optimizer, warmup
    PARALLEL_WARMUP) and the raw speech training batch."""
    import torch

    from multimodalvc_tpu_torch.config.configs import OptimizationConfig
    from multimodalvc_tpu_torch.parallel.tensor import split_tensor_parallel_
    from multimodalvc_tpu_torch.runtime.trainer import Trainer
    from multimodalvc_tpu_torch.tasks import SpeechTask, SpeechTaskConfig

    task = SpeechTask(SpeechTaskConfig(variant="nollm"), speech_config(), dtype=torch.bfloat16,
                      device=DEV)
    task.init_random(SPEECH_SEED)
    if mesh is not None:
        split_tensor_parallel_(task.module, mesh)
    opt = OptimizationConfig(lr=2e-4, lr_scheduler="cosine", warmup_updates=PARALLEL_WARMUP,
                             max_update=60000, clip_norm=1.0)
    trainer = Trainer(task.make_loss_fn(), task.module, opt, task.frozen_patterns())
    return task, trainer, make_speech_train_batch()


def tensor_speech_run(table, tensor: bool = False, change=None) -> dict:
    """``SpeechTask("nollm")`` at full width (``speech_config()``, bf16,
    random from SPEECH_SEED), split on {tensor 2} where ``tensor``, into
    ``Trainer`` (the conf/mms-speech-nollm.yaml optimizer, warmup
    PARALLEL_WARMUP): PARALLEL_STEPS updates on the speech training batch,
    its modality mode drawn a step as the task draws it, dropout on;
    ``change``: the audio features perturbed.  Its mel L1s, gnorms, the masters'
    update, K1's launches (and those through ``FlashAttentionGrad``), the
    step walls, the peak and the split leaves' bytes."""
    import gc

    import torch

    from multimodalvc_tpu_torch.parallel.mesh import make_mesh

    gc.collect()
    torch.cuda.empty_cache()
    task, trainer, raw = nollm_trainer(make_mesh({"tensor": 2}) if tensor else None)
    if change is not None:
        raw = {**raw, "audio_feats": perturb(raw["audio_feats"], change)}
    start = whole_masters_flat(trainer)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(table)
    metrics, walls = [], []
    with GradLaunches() as grads:
        for _ in range(PARALLEL_STEPS):
            batch = task.prepare_batch(raw)
            m, t_step = wall(lambda: trainer.train_step(batch))
            metrics.append(m)
            walls.append(t_step)
    out = {"losses": [m["mel_l1"] for m in metrics], "gnorms": [m["gnorm"] for m in metrics],
           "update": (whole_masters_flat(trainer) - start).cpu(), "launches": read_counts(table),
           "grad_launches": grads.n, "step_ms": [1e3 * x for x in walls],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "bytes": split_bytes(task.module, trainer)}
    del task, trainer, start
    gc.collect()
    torch.cuda.empty_cache()
    return out


TENSOR_RUNS = {"tensor_avsr": tensor_avsr_run, "tensor_speech": tensor_speech_run}


def tensor_child(what: str, out: str) -> int:
    """A child process of ``tensor_phase``, written to ``out``:
    ``tensor_avsr`` / ``tensor_speech``, one of its two ranks (RANK,
    WORLD_SIZE 2 and LOCAL_RANK 0 from the parent: both bind cuda:0),
    joined over gloo (NCCL refuses two ranks on one card), the run on
    {tensor 2}."""
    import torch

    from multimodalvc_tpu_torch.parallel import distributed

    table = kernels()
    distributed.distributed_init(backend="gloo")
    torch.save(TENSOR_RUNS[what](table, tensor=True), out)
    distributed.destroy()
    return 0


def tensor_phase(table, name: str, what: str) -> dict:
    """The one-process run in the smoke's own process, after the earlier
    phases (none of what they leave moves it: the speech models read
    ``avsr.train_rng`` at each call, and a finished ``cli.train`` leaves the
    caller's mesh current), and its noise
    floor: the largest gap of each compared quantity from the same start
    with the inputs changed by PERTURBATIONS (``parallel_data_2rank``'s
    nudges at three offsets, and a one-ulp dither of every feature) or with
    K1's plain version (another correct rounding of every attention).  The tensor
    split rounds every split product differently: the NoLLM head, which
    does not amplify a change into chaos as the AVSR model does, reads it
    as a change of every element, not of 0.01% of them (its step-3 loss
    sat at 0.7-1.3x the nudges' floor, PR 20's calls 3-9).  Then the two
    ranks of ``tensor_child(what)``.
    Checks: the ranks' losses, gnorms and
    updates bitwise equal; each within FLOOR_MARGIN x its floor of
    the one-process run; each rank's K1 launches the one-process run's (every
    attention on its local heads through K1, none on a plain one), and its
    split leaves half of the whole bytes."""
    import torch

    PARALLEL_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    one = TENSOR_RUNS[what]
    ref, *others = [one(table)] + [one(table, change=c) for c in PERTURBATIONS]
    with plain_versions(["flash_attention"]):
        others.append(one(table))
    sources = [_data_gaps(run, ref) for run in others]  # PERTURBATIONS, then K1 plain
    floor = {k: max(n[k] for n in sources) for k in sources[0]}
    outs = [PARALLEL_DIR / f"{what}_rank{r}.pt" for r in range(2)]
    for o in outs:
        o.unlink(missing_ok=True)
    env = {"WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "LOCAL_RANK": "0"}
    t1 = time.perf_counter()
    run_children([[sys.executable, str(REPO / "chip_smoke.py"), "--parallel-child", what,
                   str(o)] for o in outs], [{**env, "RANK": str(r)} for r in range(2)], name)
    t_ranks = time.perf_counter() - t1
    a, b = (torch.load(o, weights_only=False) for o in outs)
    if (a["losses"] != b["losses"] or a["gnorms"] != b["gnorms"]
            or not torch.equal(a["update"], b["update"])):
        raise SmokeFailure(f"{name}: the two ranks differ")
    gaps = _data_gaps(a, ref)
    # FLOOR_MARGIN, as parallel_data_2rank: the split's own rounding (a split
    # the CPU tests hold to the one-process steps) lands at 0.77-1.18x the
    # largest floor source, the same bits in every run since the NoLLM step
    # repeats itself (three --parallel runs on an H100), where a fault (a split leaf's
    # gradient unscaled, a dropout mask sliced wrong, a bias added twice)
    # lands at 10-10,000x
    gates = {k: FLOOR_MARGIN * floor[k] for k in floor}
    steps = len(ref["losses"])
    k1 = [r["launches"]["flash_attention"] // steps for r in (a, b)]
    print(f"  {name}: two gloo ranks on one card at {{tensor 2}}, {steps} updates: losses "
          f"{a['losses']} vs one process {ref['losses']}, gnorms {a['gnorms']} vs "
          f"{ref['gnorms']}, update norm {float(a['update'].norm()):.4e} vs "
          f"{float(ref['update'].norm()):.4e}; gaps "
          + ", ".join(f"{k} {gaps[k]:.2e} (floor {floor[k]:.2e}: nudges "
                      + " / ".join(f"{n[k]:.2e}" for n in sources[:-2])
                      + f", dither {sources[-2][k]:.2e}, K1 plain {sources[-1][k]:.2e}; "
                      f"gate {gates[k]:.2e})" for k in gaps)
          + f"; split leaves {a['bytes']['leaves']}: {a['bytes']['held_gib']:.3f} / "
          f"{b['bytes']['held_gib']:.3f} GiB a rank of {a['bytes']['whole_gib']:.3f} whole; "
          f"peak {a['peak_gib']:.2f} / {b['peak_gib']:.2f} GiB a rank ({ref['peak_gib']:.2f} one "
          f"process); step ms {[round(x, 1) for x in a['step_ms']]} a rank vs "
          f"{[round(x, 1) for x in ref['step_ms']]}; K1 {k1} a step a rank "
          f"({ref['launches']['flash_attention'] // steps} one process)")
    if not all(math.isfinite(x) for x in a["losses"]) or len(a["losses"]) != steps:
        raise SmokeFailure(f"{name}: losses {a['losses']}")
    if not all(gaps[k] <= gates[k] for k in gaps):
        raise SmokeFailure(f"{name}: gaps {gaps} from the one-process run (gates {gates})")
    if any(r["launches"] != ref["launches"] for r in (a, b)) or not k1[0]:
        raise SmokeFailure(f"{name}: launches {a['launches']} / {b['launches']} a rank vs "
                           f"{ref['launches']} in one process")
    if "grad_launches" in ref and not (a["grad_launches"] == b["grad_launches"]
                                       == ref["grad_launches"] > 0):
        raise SmokeFailure(f"{name}: K1 launches with a gradient {a['grad_launches']} / "
                           f"{b['grad_launches']} vs {ref['grad_launches']}")
    for r in (a, b):
        if not (r["bytes"]["leaves"] and 2 * r["bytes"]["held_gib"] == r["bytes"]["whole_gib"]):
            raise SmokeFailure(f"{name}: split leaves {r['bytes']} (half the whole bytes)")
    return {"losses": a["losses"], "one_process_losses": ref["losses"], "gnorms": a["gnorms"],
            "one_process_gnorms": ref["gnorms"], "gaps": gaps, "noise_floor": floor,
            "nudges": sources[:-2], "dither_gaps": sources[-2], "k1_plain_gaps": sources[-1],
            "gates": gates, "step_ms_a_rank": a["step_ms"],
            "one_process_step_ms": ref["step_ms"],
            "peak_gib_a_rank": [r["peak_gib"] for r in (a, b)],
            "one_process_peak_gib": ref["peak_gib"], "split": a["bytes"],
            "launches": a["launches"], "k1_a_step_a_rank": k1[0],
            "k1_grad_a_step_a_rank": a.get("grad_launches", 0) // steps,
            "ranks_wall_s": t_ranks, "wall_s": time.perf_counter() - t0}


def parallel_tensor_avsr(table) -> dict:
    """``cli.train`` on the mms-llama preset at full width with
    ``mesh.tensor=2`` on two gloo ranks (``tensor_phase``): the Whisper,
    AV-HuBERT, Q-Former and speech-rate attentions and FFNs, the AV-HuBERT
    projection, the LLaMA MLP's gate and up and its embedding split; K1 on
    8 of 16 heads a rank in the encoders."""
    return tensor_phase(table, "parallel_tensor_avsr", "tensor_avsr")


def parallel_tensor_speech(table) -> dict:
    """The NoLLM head at full width on {tensor 2} (``tensor_phase``): K1
    with a gradient on 4 of Conformer-L's 8 heads a rank."""
    return tensor_phase(table, "parallel_tensor_speech", "tensor_speech")


def parallel_phases(table) -> dict:
    """The several-rank phases (the corpus written first if absent);
    build/parallel removed after."""
    import shutil

    t0 = time.perf_counter()
    phases = {} if (CLI_DIR / "train.tsv").exists() else {"cli_corpus": write_corpus()}
    phases["parallel_nccl_1rank"] = parallel_nccl_1rank(table)
    phases["parallel_data_2rank"] = parallel_data_2rank(table)
    phases["parallel_moe_speech"] = parallel_moe_speech(table)
    phases["parallel_tensor_avsr"] = parallel_tensor_avsr(table)
    phases["parallel_tensor_speech"] = parallel_tensor_speech(table)
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    phases["parallel_wall_s"] = time.perf_counter() - t0
    print(f"  parallel phases: {phases['parallel_wall_s']:.1f} s")
    return phases


# ---- remat, the other optimizers, data preparation --------------------------------


REMAT_STEPS = 3  # train_avsr_remat's steps after the step-1 comparison
# the six optimizers besides adamw / adam, 3 updates each in train_optimizers
NEW_OPTIMIZERS, OPTIMIZER_STEPS, OPTIMIZER_RTOL = (
    ("adafactor", "lamb", "adagrad", "adamax", "nag", "sgd"), 3, 1e-5)
PRETRAIN_REMAT_UPDATES = 2
PREP_DIR = REPO / "build" / "prep"


def _set_remat(module, cls, on: bool) -> int:
    """Turn remat on or off in every ``cls`` (a LlamaModel's config, a
    TransformerEncoder's flag) of ``module``; returns how many there are."""
    from multimodalvc_tpu_torch.nn.llama import LlamaModel

    found = [m for m in module.modules() if isinstance(m, cls)]
    for m in found:
        if cls is LlamaModel:
            m.cfg.remat = on
        else:
            m.remat = on
    return len(found)


def _step1(trainer, batch, table) -> dict:
    """Step 1's loss and trainable gradients (one f32 vector), the dropout
    generator's state after them (seeded 9), K1's launches (with a gradient
    apart), and the memory the step took above what was allocated before."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(table)
    gen = torch.Generator(device=DEV).manual_seed(9)
    with GradLaunches() as grads:
        loss, _ = trainer.loss_fn(batch, gen)
        got = torch.autograd.grad(loss, list(trainer.params.values()), allow_unused=True)
    flat = torch.cat([(torch.zeros_like(p) if g is None else g).float().reshape(-1)
                      for g, p in zip(got, trainer.params.values())])
    del got
    return {"loss": loss.detach(), "grads": flat, "generator": gen.get_state(),
            "k1": read_counts(table)["flash_attention"], "k1_grad": grads.n,
            "step_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}


def remat_gate(name, plain, again, remat, same) -> dict:
    """Remat's result against the plain one's: bit for bit (``same``, each
    check True) where the plain step repeated (``again``) is bit for bit
    itself; else, where an op of the step is not deterministic on the card,
    within FLOOR_MARGIN times the relative L2 between the two plain runs."""
    import torch

    deterministic = bool(torch.equal(plain, again))
    floor, rel = rel_l2(again, plain), rel_l2(remat, plain)
    out = {"deterministic": deterministic, "noise_floor_rel_l2": floor, "rel_l2": rel,
           "max_abs_diff": float((plain - remat).abs().max())}
    if deterministic and not all(same.values()):
        raise SmokeFailure(f"{name}: with remat the step differs from without: {same}, rel L2 "
                           f"{rel:.3e} (the plain step repeats bit for bit)")
    if not deterministic and not rel <= FLOOR_MARGIN * floor:
        raise SmokeFailure(f"{name}: with remat {rel:.3e} from the plain step, whose repeat "
                           f"differs by {floor:.3e} (gate {FLOOR_MARGIN}x)")
    if not deterministic:
        print(f"    {name}: the plain step does not repeat bit for bit (rel L2 {floor:.3e}); "
              f"remat within {rel:.3e}")
    return out


def train_avsr_remat(table, flash_peak_gib=None) -> tuple:
    """The ``train_avsr_flash`` system (K1 with its gradient in the trunk)
    with ``LlamaConfig.remat``, the LoRA dropout at the preset's 0.05.
    Step 1 (loss, gradients, the dropout generator after it) without and
    with remat on the same module must be equal bit for bit; K1 76 times
    without (28 with a gradient) and 104 with (56: each trunk layer's
    forward runs again in the backward); the step's memory above the model
    lower with remat.  Then REMAT_STEPS ``train_step``s with remat: K1 104 a
    step, finite losses, the step wall, tokens/s and the peak GiB, below
    that of two more steps without remat on the same trainer (their wall
    beside, and the training forward's alone) and below
    ``flash_peak_gib`` (train_avsr_flash's, which holds a copy of the frozen
    leaves beside) where given.  Returns the record and (task, trainer,
    batch) for train_optimizers."""
    import gc

    import torch

    from multimodalvc_tpu_torch.nn.llama import LlamaModel

    gc.collect()
    torch.cuda.empty_cache()
    task, trainer = build_trainer(True, remat=True)
    batch = task.prepare_batch(make_train_batch())
    if _set_remat(trainer.module, LlamaModel, False) != 1:
        raise SmokeFailure("train_avsr_remat: no LLaMA in the AVSR module")
    (plain, t_plain) = wall(lambda: _step1(trainer, batch, table))
    again = _step1(trainer, batch, table)["grads"]  # is the step deterministic?
    _set_remat(trainer.module, LlamaModel, True)
    (remat, t_remat) = wall(lambda: _step1(trainer, batch, table))
    same = {"loss": bool(torch.equal(plain["loss"], remat["loss"])),
            "grads": bool(torch.equal(plain["grads"], remat["grads"])),
            "generator": bool(torch.equal(plain["generator"], remat["generator"]))}
    gate = remat_gate("train_avsr_remat", plain["grads"], again, remat["grads"], same)
    del again
    print(f"    step 1 without / with remat: loss {float(plain['loss']):.6f} / "
          f"{float(remat['loss']):.6f}, gradients max |diff| {gate['max_abs_diff']:.3e} over "
          f"{plain['grads'].numel()}, equal {same}; K1 {plain['k1']} / {remat['k1']} "
          f"({plain['k1_grad']} / {remat['k1_grad']} with a gradient); the step's memory "
          f"{plain['step_gib']:.2f} / {remat['step_gib']:.2f} GiB, {1e3 * t_plain:.1f} / "
          f"{1e3 * t_remat:.1f} ms")
    # each trunk layer's attention (K1 through FlashAttentionGrad) runs again
    want = (ENCODER_FLASH + TRUNK_FLASH, TRUNK_FLASH, ENCODER_FLASH + 2 * TRUNK_FLASH,
            2 * TRUNK_FLASH)
    got = (plain["k1"], plain["k1_grad"], remat["k1"], remat["k1_grad"])
    if got != want:
        raise SmokeFailure(f"train_avsr_remat: K1 (without, with a gradient; with remat, with a "
                           f"gradient) {got}, want {want}")
    if not remat["step_gib"] < plain["step_gib"]:
        raise SmokeFailure(f"train_avsr_remat: the step took {remat['step_gib']:.2f} GiB with "
                           f"remat, {plain['step_gib']:.2f} without")
    record = {"step1_equal": same, "step1_gate": gate, "step1_loss": float(plain["loss"]),
              "k1_step1": {"plain": plain["k1"], "plain_grad": plain["k1_grad"],
                           "remat": remat["k1"], "remat_grad": remat["k1_grad"]},
              "step1_gib": {"plain": plain["step_gib"], "remat": remat["step_gib"]},
              "step1_ms": {"plain": 1e3 * t_plain, "remat": 1e3 * t_remat}}
    del plain, remat
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(table)
    metrics, walls = [], []
    with GradLaunches() as grads:
        for step in range(REMAT_STEPS):
            m, t_step = wall(lambda: trainer.train_step(batch))
            metrics.append(m)
            walls.append(t_step)
            print(f"    step {step + 1}: loss {m['loss']:.4f} gnorm {m['gnorm']:.3e} "
                  f"{1e3 * t_step:.1f} ms")
    launches = read_counts(table)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # two more steps without remat in the same state of the card, and the
    # training forward alone (what the recompute repeats, and more)
    _set_remat(trainer.module, LlamaModel, False)
    torch.cuda.reset_peak_memory_stats()
    plain_walls = [wall(lambda: trainer.train_step(batch))[1] for _ in range(2)]
    t_plain_step = sum(plain_walls) / len(plain_walls)
    plain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _set_remat(trainer.module, LlamaModel, True)
    gen = torch.Generator(device=DEV).manual_seed(9)
    forward_walls = [wall(lambda: trainer.loss_fn(batch, gen)[0].detach())[1] for _ in range(2)]
    t_forward = forward_walls[-1]
    print(f"    steps without remat: {[round(1e3 * x, 1) for x in plain_walls]} ms, peak "
          f"{plain_peak:.2f} GiB; the training forward alone {1e3 * t_forward:.1f} ms")
    want_k1 = (ENCODER_FLASH + 2 * TRUNK_FLASH) * REMAT_STEPS
    wrong = {k: n for k, n in launches.items() if n != (want_k1 if k == "flash_attention" else 0)}
    if wrong or grads.n != 2 * TRUNK_FLASH * REMAT_STEPS:
        raise SmokeFailure(f"train_avsr_remat: launches {wrong} (K1 {want_k1} expected), "
                           f"{grads.n} through FlashAttentionGrad")
    losses = [m["loss"] for m in metrics]
    if not all(map(math.isfinite, losses)):
        raise SmokeFailure(f"train_avsr_remat: losses {losses}")
    if not peak < plain_peak or (flash_peak_gib is not None and not peak < flash_peak_gib):
        raise SmokeFailure(f"train_avsr_remat: peak {peak:.2f} GiB, a step without remat "
                           f"{plain_peak:.2f}, train_avsr_flash's {flash_peak_gib}")
    step_s = sum(walls[1:]) / len(walls[1:])
    b, t = batch["instruction"].shape[0], INSTRUCTION + task.model_cfg.max_queries + TRAIN_LABELS
    record.update(losses=losses, step_ms=[1e3 * x for x in walls], mean_step_ms=1e3 * step_s,
                  seq_tokens_per_s=b * t / step_s, peak_gib=peak, plain_step_ms=1e3 * t_plain_step,
                  plain_steps_ms=[1e3 * x for x in plain_walls], forward_ms=1e3 * t_forward,
                  plain_step_peak_gib=plain_peak, flash_peak_gib=flash_peak_gib, launches=launches,
                  k1_grad_launches_a_step=grads.n // REMAT_STEPS)
    print(f"  phase train_avsr_remat: {1e3 * step_s:.1f} ms a step (steps 2-{REMAT_STEPS}), "
          f"{b * t / step_s:.0f} sequence tokens/s, peak {peak:.2f} GiB (a step without remat "
          f"{1e3 * t_plain_step:.1f} ms, {plain_peak:.2f} GiB; the forward {1e3 * t_forward:.1f} "
          f"ms; train_avsr_flash "
          f"{flash_peak_gib if flash_peak_gib is None else round(flash_peak_gib, 2)} GiB), K1 "
          f"{launches['flash_attention'] // REMAT_STEPS} a step, "
          f"{grads.n // REMAT_STEPS} with a gradient")
    return record, (task, trainer, batch)


def profile_remat(top: int = 10) -> dict:
    """Where remat's extra time goes in the train_avsr_remat step: one
    ``train_step`` with and one without ``LlamaConfig.remat`` (after a warm
    step of each) under torch.profiler: the wall, the device time summed
    over kernels, copies and memsets, the device's idle share, the device
    ops, and the kernels whose time grew most with remat."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multimodalvc_tpu_torch.nn.llama import LlamaModel

    task, trainer = build_trainer(True, remat=True)
    batch = task.prepare_batch(make_train_batch())
    out, device = {}, {}
    for remat in (True, False):
        _set_remat(trainer.module, LlamaModel, remat)
        trainer.train_step(batch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, t = wall(lambda: trainer.train_step(batch))
        us, n = Counter(), 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us[e.name] += e.time_range.elapsed_us()
                n += 1
        device_ms = sum(us.values()) / 1e3
        if device_ms <= 0:
            raise SmokeFailure("profile_remat: torch.profiler recorded no device time")
        tag = "remat" if remat else "plain"
        device[tag] = us
        out[tag] = {"wall_ms": 1e3 * t, "device_ms": device_ms, "device_ops": n,
                    "idle_share": 1 - device_ms / (1e3 * t)}
        print(f"  profile_remat {tag}: {1e3 * t:.1f} ms profiled, device {device_ms:.1f} ms, "
              f"idle share {out[tag]['idle_share']:.3f}, {n} device ops")
    grew = {k: (device["remat"][k] - device["plain"].get(k, 0)) / 1e3 for k in device["remat"]}
    out["grew_ms"] = dict(sorted(grew.items(), key=lambda kv: -kv[1])[:top])
    for k, v in out["grew_ms"].items():
        print(f"    +{v:8.3f} ms  {k[:110]}")
    return out


def _cpu(tensors) -> dict:
    return {n: t.detach().float().cpu().clone() for n, t in tensors.items()}


def train_optimizers(table, built) -> dict:
    """The six optimizers besides adamw / adam (NEW_OPTIMIZERS) on
    train_avsr_remat's full-width trainer, each from the same masters with
    the phase's AdamW settings at a fixed learning rate: OPTIMIZER_STEPS
    ``train_step``s; finite losses; the frozen leaves (and buffers) bit for
    bit; each optimizer's state GiB beside AdamW's two moments.  Its first
    update is held against the same optimizer on the CPU in f32 on the same
    gradients and masters: each trainable leaf within OPTIMIZER_RTOL of its
    largest element."""
    import dataclasses
    import gc

    import torch

    from multimodalvc_tpu_torch.runtime.trainer import Leaves, build_optimizer

    task, trainer, batch = built
    start = {n: m.clone() for n, m in trainer.master.items()}
    frozen = {n: x.clone() for n, x in trainer.module.state_dict().items()
              if n not in trainer.master}
    numel = sum(m.numel() for m in start.values())
    record = {"trainable": numel, "adamw_state_gib": 8 * numel / 2 ** 30}
    for name in NEW_OPTIMIZERS:
        with torch.no_grad():
            for n, m in trainer.master.items():
                m.copy_(start[n])
        trainer._copy_to_module()
        cfg = dataclasses.replace(trainer.opt_cfg, optimizer=name, lr_scheduler="fixed")
        opt = trainer.optimizer = build_optimizer(cfg, trainer.master, trainer.leaves)
        first, real = {}, opt.update

        def update(grads, params, first=first, real=real):
            if first:
                return real(grads, params)
            first.update(grads=_cpu(grads), before=_cpu(params))
            moved = real(grads, params)
            first["after"] = _cpu(params)
            return moved

        opt.update = update
        reset_counts(table)
        torch.cuda.reset_peak_memory_stats()
        metrics, t_run = wall(lambda: [trainer.train_step(batch) for _ in range(OPTIMIZER_STEPS)])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [m["loss"] for m in metrics]
        if not all(map(math.isfinite, losses)):
            raise SmokeFailure(f"train_optimizers {name}: losses {losses}")
        unchanged(f"train_optimizers {name}", trainer.module, frozen)
        state_gib = sum(t.numel() * t.element_size() for kind in opt.state.values()
                        for t in kind.values()) / 2 ** 30
        before = first["before"]
        cpu = build_optimizer(cfg, before, Leaves(before,
                                                  reversed_layout=trainer.leaves.reversed_layout))
        cpu.update(first["grads"], before)
        worst, moved = 0.0, 0
        for n, want in before.items():
            got = first["after"][n]
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            worst = max(worst, err / scale if scale else err)
            moved += int(not torch.equal(got, start[n].cpu()))
        if not worst <= OPTIMIZER_RTOL or not moved:
            raise SmokeFailure(f"train_optimizers {name}: update 1 {worst:.3e} from the CPU's "
                               f"(gate {OPTIMIZER_RTOL}), {moved} leaves moved")
        record[name] = {"losses": losses, "wall_s": t_run, "state_gib": state_gib,
                        "state_kinds": list(opt.state), "peak_gib": peak,
                        "update1_rel_err": worst, "leaves_moved": moved,
                        "launches": read_counts(table)["flash_attention"]}
        print(f"  train_optimizers {name}: losses {[round(x, 4) for x in losses]}, "
              f"{1e3 * t_run / OPTIMIZER_STEPS:.1f} ms a step, state {state_gib:.3f} GiB "
              f"{list(opt.state)} (AdamW {record['adamw_state_gib']:.3f}), update 1 "
              f"{worst:.2e} from the CPU's, {moved}/{len(before)} leaves moved, peak "
              f"{peak:.2f} GiB")
        del first, cpu, before
    del start, frozen
    gc.collect()
    torch.cuda.empty_cache()
    return record


def pretrain_remat(table) -> dict:
    """PRETRAIN_REMAT_UPDATES AV-HuBERT-Large pretraining updates
    (conf/avhubert-pretrain.yaml at full width, bf16, the corpus's k-means
    labels) on two train batches of the 300 / 400 buckets, through
    ``Trainer`` with the encoder's ``remat``, against the same updates
    without (the trainer's state put back in between), under torch's
    deterministic algorithms: losses, grad norms, masters and the ResNet's
    running statistics equal bit for bit where the plain run repeats
    itself bit for bit (``remat_gate``); K1 24 times a step without remat
    and 48 with (24 of them the recompute); the peak GiB of each."""
    import gc

    import torch

    from multimodalvc_tpu_torch.cli import train as cli_train
    from multimodalvc_tpu_torch.data.batching import bucket_for
    from multimodalvc_tpu_torch.data.dataset import to_device
    from multimodalvc_tpu_torch.nn.layers import TransformerEncoder
    from multimodalvc_tpu_torch.runtime.trainer import Trainer

    cfg = cli_config("avhubert-pretrain", [])
    gc.collect()
    torch.cuda.empty_cache()
    task = cli_train.build_task(cfg, DEV)
    ds = task.load_dataset(cfg.dataset.train_subset)
    task.init_random(cfg.common.seed)
    trainer = Trainer(task.make_loss_fn(), task.module, cfg.optimization, task.frozen_patterns(),
                      seed=cfg.common.seed)
    sizes = ds.sizes()
    picked = [b for b in ds.batches(max_tokens=cfg.dataset.max_tokens, epoch=1)
              if bucket_for(max(sizes[i] for i in b), ds.buckets) >= 300][:PRETRAIN_REMAT_UPDATES]
    batches = [task.prepare_batch(to_device(raw, DEV)) for raw, _ in zip(
        cli_train.loader(cfg, ds, picked, DEV, epoch=1), picked)]
    frames = [b["video"].shape[1] for b in batches]

    def snapshot(state):
        if isinstance(state, dict):
            return {k: snapshot(v) for k, v in state.items()}
        return state.clone() if isinstance(state, torch.Tensor) else copy.deepcopy(state)

    start = snapshot(trainer.state_dict())
    runs = {}
    # deterministic algorithms where torch has them (cuDNN's ResNet
    # backward is not, by default), so that the plain run repeats itself and
    # remat can be held to it bit for bit; the ops without one are named
    was = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for remat in (False, "again", True):  # the plain run twice: does it repeat?
                if _set_remat(task.module, TransformerEncoder, remat is True) != 1:
                    raise SmokeFailure("pretrain_remat: no AV-HuBERT encoder")
                trainer.load_state_dict(start)
                reset_counts(table)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                with GradLaunches() as grads:
                    metrics, t_run = wall(lambda: [trainer.train_step(b) for b in batches])
                peak = torch.cuda.max_memory_allocated()
                state = trainer.state_dict()
                # kept on the host: the next run's peak sees none of them
                runs[remat] = {"metrics": metrics, "wall_s": t_run, "k1": read_counts(table),
                               "k1_grad": grads.n, "peak_gib": peak / 2 ** 30,
                               "step_gib": (peak - base) / 2 ** 30,
                               "model": {n: t.to("cpu", copy=True)
                                         for n, t in state["model"].items()}}
                del state
    finally:
        torch.backends.cudnn.deterministic = was[0]
        torch.use_deterministic_algorithms(was[1])
    nondeterministic = sorted({str(w.message).split(" does not have a deterministic")[0]
                               for w in caught if "deterministic" in str(w.message)})
    if nondeterministic:
        print(f"    pretrain_remat: ops without a deterministic implementation: "
              f"{nondeterministic}")
    plain, remat = runs[False], runs[True]
    same_metrics = plain["metrics"] == remat["metrics"]
    differ = [n for n, t in plain["model"].items() if not torch.equal(t, remat["model"][n])]

    def flat(run):
        return torch.cat([t.float().reshape(-1) for t in run["model"].values()]
                         + [torch.tensor([m["gnorm"] for m in run["metrics"]])])

    gate = remat_gate("pretrain_remat", flat(plain), flat(runs["again"]), flat(remat),
                      {"metrics": same_metrics, "entries": not differ})
    layers = k1_layers(min(frames), PRETRAIN_LAYERS) * len(batches)
    want = (layers, layers, 2 * layers, 2 * layers)
    got = (plain["k1"]["flash_attention"], plain["k1_grad"], remat["k1"]["flash_attention"],
           remat["k1_grad"])
    others = {k: n for run in (plain, remat) for k, n in run["k1"].items()
              if n and k != "flash_attention"}
    losses = [m["loss"] for m in plain["metrics"]]
    print(f"  pretrain_remat: {len(batches)} updates at {frames} frames; losses "
          f"{[round(x, 5) for x in losses]} (remat {[round(m['loss'], 5) for m in remat['metrics']]}"
          f"), metrics equal {same_metrics}, {len(differ)} of {len(plain['model'])} entries "
          f"differ; {plain['wall_s']:.2f} (again {runs['again']['wall_s']:.2f}) / "
          f"{remat['wall_s']:.2f} s, peak {plain['peak_gib']:.2f} / {remat['peak_gib']:.2f} GiB "
          f"({plain['step_gib']:.2f} / {remat['step_gib']:.2f} above the state) without / with "
          f"remat; K1 {got}")
    if not all(map(math.isfinite, losses)):
        raise SmokeFailure(f"pretrain_remat: losses {losses}")
    if got != want or others:
        raise SmokeFailure(f"pretrain_remat: K1 (without, with a gradient; with remat, with a "
                           f"gradient) {got}, want {want}; other launches {others}")
    record = {"frames": frames, "losses": losses, "nondeterministic_ops": nondeterministic,
              "equal": {"metrics": same_metrics,
                                                            "entries_differing": len(differ)},
              "gate": gate,
              **{f"{k}_{tag}": runs[r][k] for r, tag in ((False, "plain"), ("again", "again"),
                                                          (True, "remat"))
                 for k in ("wall_s", "peak_gib", "step_gib", "k1_grad")},
              "launches": remat["k1"], "plain_launches": plain["k1"]}
    del task, trainer, start, runs, plain, remat, batches
    gc.collect()
    torch.cuda.empty_cache()
    return record


def _tool(*argv) -> str:
    """``cli.manifest_tools`` in this process: what it prints."""
    import contextlib
    import io

    from multimodalvc_tpu_torch.cli import manifest_tools

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        manifest_tools.main([str(a) for a in argv])
    print("    manifest_tools " + " ".join(str(a) for a in argv[:1]) + ": "
          + out.getvalue().strip().replace("\n", "; "))
    return out.getvalue()


def _prep_layout() -> list:
    """The cli corpus as a raw layout under PREP_DIR: video/clipN.npy (linked)
    beside a copy of clipN.wav, text/clipN.txt from the transcripts.  Returns
    the corpus's (frames, samples, words) a clip."""
    import shutil

    shutil.rmtree(PREP_DIR, ignore_errors=True)
    (PREP_DIR / "video").mkdir(parents=True)
    (PREP_DIR / "text").mkdir()
    rows = (CLI_DIR / "train.tsv").read_text().splitlines()[1:]
    words = (CLI_DIR / "train.wrd").read_text().splitlines()
    clips = []
    for row, text in zip(rows, words):
        _, video, audio, frames, samples = row.split("\t")[:5]
        stem = Path(video).stem
        os.symlink(CLI_DIR / video, PREP_DIR / "video" / f"{stem}.npy")
        shutil.copy(CLI_DIR / audio.split(":")[0], PREP_DIR / "video" / f"{stem}.wav")
        (PREP_DIR / "text" / f"{stem}.txt").write_text(text)
        clips.append((stem, int(frames), int(samples), text))
    return clips


def prep_tools(table) -> dict:
    """Every manifest_tools subcommand that prepares data, over the cli
    corpus laid out raw under PREP_DIR: ``generate`` (the rows equal to the
    corpus's own: frames, samples, transcripts), ``split``, ``hours`` (the
    corpus's total), ``normalize-rates`` (in [1, 2]), ``update-paths``,
    ``filter-language``, ``make-babble``; ``generate-mels`` (each file equal
    to the mel that ``AVSRDataset`` computes on the fly for the clip, before
    the files exist); ``align-mouth`` on a corpus clip with synthetic
    landmarks (one detection missing); then a ``quantize_tree`` round trip of
    the full-width bf16 AVSR state dict on the card (its error, size ratio,
    and one leaf's codes equal to the CPU's).  No kernel launches."""
    import gc

    import numpy as np
    import torch

    from multimodalvc_tpu_torch.data.dataset import AVSRDataset, AVSRDatasetConfig
    from multimodalvc_tpu_torch.data.roi import default_mean_face
    from multimodalvc_tpu_torch.runtime import quantization

    t0 = time.perf_counter()
    reset_counts(table)
    clips = _prep_layout()
    _tool("generate", "--root", PREP_DIR, "--video-dir", "video", "--text-dir", "text",
          "--out-tsv", PREP_DIR / "all.tsv", "--workers", 4)
    lines = (PREP_DIR / "all.tsv").read_text().splitlines()[1:]
    got = sorted((Path(r.split("\t")[1]).stem, int(r.split("\t")[3]), int(r.split("\t")[4]), w)
                 for r, w in zip(lines, (PREP_DIR / "all.wrd").read_text().splitlines()))
    if got != sorted(clips):
        raise SmokeFailure(f"prep_tools generate: rows {got[:2]}..., the corpus's "
                           f"{sorted(clips)[:2]}...")
    split = PREP_DIR / "split"
    split.mkdir()
    _tool("split", "--tsv", PREP_DIR / "all.tsv", "--out-dir", split, "--valid-frac", 0.125,
          "--test-frac", 0.125)
    counts = {s: len((split / f"{s}.tsv").read_text().splitlines()) - 1
              for s in ("train", "valid", "test")}
    hours = _tool("hours", "--tsv", PREP_DIR / "all.tsv")
    total = sum(c[2] for c in clips)
    _tool("normalize-rates", "--tsv", PREP_DIR / "all.tsv", "--out", PREP_DIR / "norm.tsv")
    rates = [float(r.split("\t")[5]) for r in
             (PREP_DIR / "norm.tsv").read_text().splitlines()[1:]]
    _tool("update-paths", "--tsv", PREP_DIR / "all.tsv", "--old", str(PREP_DIR),
          "--new", "/data/corpus", "--out", PREP_DIR / "moved.tsv")
    moved = (PREP_DIR / "moved.tsv").read_text()
    german = {c[0] for i, c in enumerate(clips) if i % 4 == 0}
    (PREP_DIR / "meta.csv").write_text("id,language\n" + "".join(
        f"{c[0]},{'de' if c[0] in german else 'en'}\n" for c in clips))
    _tool("filter-language", "--tsv", PREP_DIR / "all.tsv", "--wrd", PREP_DIR / "all.wrd",
          "--meta", PREP_DIR / "meta.csv", "--language", "de", "--out", PREP_DIR / "de.tsv")
    kept = sorted(Path(r.split("\t")[1]).stem
                  for r in (PREP_DIR / "de.tsv").read_text().splitlines()[1:])
    _tool("make-babble", "--tsv", PREP_DIR / "all.tsv", "--n", 30, "--out",
          PREP_DIR / "babble.wav")
    from multimodalvc_tpu_torch.data.audio import read_wav

    babble = read_wav(str(PREP_DIR / "babble.wav"))
    checks = {"split": sum(counts.values()) == len(clips) and counts["valid"] == 4,
              "hours": f"total samples: {total}" in hours,
              "rates": len(rates) == len(clips) and all(1.0 <= r <= 2.0 for r in rates),
              "update_paths": str(PREP_DIR) not in moved and "/data/corpus/video/" in moved,
              "filter_language": kept == sorted(german),
              "babble": len(babble) == max(c[2] for c in clips)
              and 0.9 < float(np.abs(babble).max()) <= 0.95 + 1e-4}
    # the dataset's on-the-fly mels, then the offline files
    ds = AVSRDataset(AVSRDatasetConfig(manifest_dir=str(PREP_DIR), subset="all",
                                       with_text_labels=False, with_mel_targets=True))
    fly = {Path(e.audio_path).stem: ds[i]["target_mel"] for i, e in enumerate(ds.manifest.entries)}
    # one worker: a Pool forked from this process (CUDA and torch's threads
    # up) is not what a user runs
    _, t_mels = wall(lambda: _tool("generate-mels", "--tsv", PREP_DIR / "all.tsv", "--workers", 1))
    mel_err = max(float(np.abs(np.load(PREP_DIR / "video" / f"{s}_mel_100hz_128bands.npy")
                               - m).max()) for s, m in fly.items())
    checks["mels"] = len(fly) == len(clips) and mel_err <= 1e-5
    # align-mouth: the mean face scaled into a corpus clip's frames
    stem, frames = clips[0][0], clips[0][1]
    lms = np.stack([default_mean_face(256) * 0.3 + 10.0 + 0.1 * i for i in range(frames)])
    lms[3] = np.nan
    np.save(PREP_DIR / "lm.npy", lms.astype(np.float32))
    _tool("align-mouth", "--video", PREP_DIR / "video" / f"{stem}.npy", "--landmarks",
          PREP_DIR / "lm.npy", "--crop", 48, "--out", PREP_DIR / "roi.npy")
    rois = np.load(PREP_DIR / "roi.npy")
    checks["align_mouth"] = rois.shape == (frames, 48, 48) and bool(np.isfinite(rois).all())
    tools_s = time.perf_counter() - t0
    # quantize_tree over the full-width state dict
    system = build_system()
    sd = system.module.state_dict()
    (q, t_q) = wall(lambda: quantization.quantize_tree(sd))
    (back, t_dq) = wall(lambda: quantization.dequantize_tree(q, torch.bfloat16))
    rel, orig, packed = 0.0, 0, 0
    for n, x in sd.items():
        orig += x.numel() * x.element_size()
        node = q[n]
        packed += sum(t.numel() * t.element_size() for t in node.values()) \
            if isinstance(node, dict) else x.numel() * x.element_size()
        if isinstance(node, dict):  # the codes' error in f32, leaf by leaf
            got = quantization.dequantize_tree(node)
            rel = max(rel, float((got - x.float()).abs().max())
                      / max(float(x.float().abs().max()), 1e-12))
            del got
    same_bf16 = all(back[n].dtype == x.dtype for n, x in sd.items() if x.is_floating_point())
    name = "llama.embed_tokens.weight" if "llama.embed_tokens.weight" in sd else max(
        sd, key=lambda n: sd[n].numel())
    cpu = quantization.quantize_tree({name: sd[name].cpu()})[name]
    same_codes = all(torch.equal(cpu[k], q[name][k].cpu()) for k in cpu)
    # half a step of the channel's scale at most
    checks["quantize"] = (same_codes and same_bf16 and rel <= 0.5 / 127 * (1 + 1e-5)
                          and orig / packed > 1.9)
    launches = read_counts(table)
    record = {"checks": checks, "split": counts, "kept": len(kept), "mel_max_abs_err": mel_err,
              "generate_mels_s": t_mels, "tools_s": tools_s, "quantize_s": t_q,
              "dequantize_s": t_dq,
              "quantize_rel_err": rel, "quantize_ratio": orig / packed,
              "quantize_codes_equal_cpu": same_codes, "state_gib": orig / 2 ** 30,
              "launches": launches}
    print(f"  prep_tools: {len(clips)} clips, checks {checks}; mels max |err| {mel_err:.2e} "
          f"({t_mels:.2f} s); quantize_tree of {orig / 2 ** 30:.2f} GiB in {t_q:.2f} s (back to "
          f"bf16 in {t_dq:.2f} s): max rel "
          f"err {rel:.3e}, {orig / packed:.3f}x smaller, {name}'s codes equal the CPU's "
          f"{same_codes}; tools {tools_s:.1f} s")
    del system, sd, q, back
    gc.collect()
    torch.cuda.empty_cache()
    if not all(checks.values()) or any(launches.values()):
        raise SmokeFailure(f"prep_tools: checks {checks}, launches {launches}")
    return record


def optim_phases(table, flash_peak_gib=None) -> dict:
    """train_avsr_remat, train_optimizers on its trainer, pretrain_remat
    (after the corpus and its k-means labels where absent)."""
    import gc

    phases = {}
    phases["train_avsr_remat"], built = train_avsr_remat(table, flash_peak_gib)
    phases["train_optimizers"] = train_optimizers(table, built)
    del built
    gc.collect()
    if not (CLI_DIR / "train.km").exists():
        phases["cli_corpus"] = write_corpus()
        PRETRAIN_DIR.mkdir(parents=True, exist_ok=True)
        phases["pretrain_kmeans_mfcc"] = pretrain_kmeans_mfcc(table)
    phases["pretrain_remat"] = pretrain_remat(table)
    return phases


def serving_phases(table, batch) -> tuple:
    """The AVSR serving phases: bf16 weights, then int8 and int4 weights."""
    phases, checks, prompt, tokens, bf16_logits = bf16_weight_phases(table, batch)
    phases.update(quantized_phase(table, batch, "int8", NEW_TOKENS, prompt, tokens, bf16_logits))
    phases.update(quantized_phase(table, batch, "int4", SHORT_TOKENS, prompt, tokens, bf16_logits))
    return phases, checks


def main() -> int:
    start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the GPU", file=sys.stderr)
        return 2
    if not (REPO / "multimodalvc_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: run from the repository root; no multimodalvc_tpu_torch in {REPO}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from multimodalvc_tpu_torch.ops import kernel_lib

    card = card_line()
    print(f"card: {card}")
    lib = kernel_lib.load()
    print(f"kernels built in {lib.build_s:.1f} s -> {lib.path.name}")
    print(lib.log.strip())

    if "--parallel-child" in sys.argv[1:]:
        what, out = sys.argv[sys.argv.index("--parallel-child") + 1:][:2]
        if what.startswith("tensor_"):
            return tensor_child(what, out)
        return {"nccl": nccl_child, "data": data_child}[what](out)
    if "--parallel" in sys.argv[1:]:
        results = []
        check_flash(results, TENSOR_FLASH_CASES)
        check_flash_grad(results, only=[CONFORMER_TENSOR_GRAD])
        phases = parallel_phases(kernels())
        print(json.dumps({"cases": results, "phases": phases}))
        print(f"smoke --parallel: {time.perf_counter() - start:.1f} s, the kernels' build "
              "included")
        print(card)
        return 0
    if "--profile-gather" in sys.argv[1:]:
        print(json.dumps({"profile_gather": profile_gather(kernels(), make_batch())}))
        print(card)
        return 0
    if "--profile" in sys.argv[1:]:
        print(json.dumps({"profile": profile_main(kernels(), make_batch())}))
        print(card)
        return 0
    if "--plans" in sys.argv[1:]:
        print(json.dumps({"plans": plans_main()}))
        print(card)
        return 0
    if "--phases" in sys.argv[1:]:
        print(json.dumps({"phases": topk_phases()}))
        print(card)
        return 0
    if "--train" in sys.argv[1:]:
        results = []
        check_flash_grad(results)
        table = kernels()
        phases = {name: train_phase(table, name, flash)
                  for name, flash in (("train_avsr", False), ("train_avsr_flash", True))}
        print(json.dumps({"cases": results, "phases": phases}))
        print(card)
        return 0
    if "--speech" in sys.argv[1:]:
        results, checks = [], {}
        check_flash(results, SPEECH_FLASH_CASES)
        phases = speech_phases(kernels(), checks)
        print(json.dumps({"cases": results, "phases": phases, "checks": checks}))
        print(card)
        return 0
    if "--speech-train" in sys.argv[1:]:
        results = []
        check_flash_grad(results, only=[CONFORMER_GRAD])
        phases = speech_train_phases(kernels())
        print(json.dumps({"cases": results, "phases": phases}))
        print(f"smoke --speech-train: {time.perf_counter() - start:.1f} s, the kernels' build "
              "included")
        print(card)
        return 0
    if "--digests" in sys.argv[1:]:
        phases, _ = serving_phases(kernels(), make_batch())
        print(json.dumps({"digests": {name: p["output_sha256"] for name, p in phases.items()
                                      if "output_sha256" in p}}))
        print(card)
        return 0
    if "--cli" in sys.argv[1:]:
        phases = cli_phases(kernels())
        print(json.dumps({"phases": phases}))
        print(f"smoke --cli: {time.perf_counter() - start:.1f} s, the kernels' build included")
        print(card)
        return 0
    if "--import" in sys.argv[1:]:
        phases = import_phases(kernels())
        print(json.dumps({"phases": phases}))
        print(f"smoke --import: {time.perf_counter() - start:.1f} s, the kernels' build included")
        print(card)
        return 0
    if "--pretrain" in sys.argv[1:]:
        results = []
        check_flash_grad(results, only=[PRETRAIN_GRAD])
        check_topk_small_vocab(results)
        phases = pretrain_phases(kernels())
        print(json.dumps({"cases": results, "phases": phases}))
        print(f"smoke --pretrain: {time.perf_counter() - start:.1f} s, the kernels' build "
              "included")
        print(card)
        return 0
    if "--optim" in sys.argv[1:]:
        phases = optim_phases(kernels())
        print(json.dumps({"phases": phases}))
        print(f"smoke --optim: {time.perf_counter() - start:.1f} s, the kernels' build included")
        print(card)
        return 0
    if "--adamw" in sys.argv[1:]:
        results = []
        check_adamw(results)
        phases = {"train_speech_nollm": train_speech_phase(kernels(), "nollm")}
        print(json.dumps({"cases": results, "phases": phases}))
        print(f"smoke --adamw: {time.perf_counter() - start:.1f} s, the kernels' build included")
        print(card)
        return 0
    if "--selftest" in sys.argv[1:]:
        print(json.dumps({"selftest": selftest_phase()}))
        print(card)
        return 0
    if "--profile-remat" in sys.argv[1:]:
        print(json.dumps({"profile_remat": profile_remat()}))
        print(card)
        return 0
    if "--dummy" in sys.argv[1:]:
        phases = {"cli_dummy_avsr": cli_dummy_avsr(kernels()), "native": native_phase()}
        print(json.dumps({"phases": phases}))
        print(f"smoke --dummy: {time.perf_counter() - start:.1f} s, the kernels' build included")
        print(card)
        return 0
    if "--prep" in sys.argv[1:]:
        phases = {"cli_corpus": write_corpus(), "prep_tools": prep_tools(kernels())}
        print(json.dumps({"phases": phases}))
        print(f"smoke --prep: {time.perf_counter() - start:.1f} s, the kernels' build included")
        print(card)
        return 0
    if "--beam5" in sys.argv[1:]:
        results = []  # the cases an older tree has too: beam 5, K4 to beam 12
        check_decode(results, wide=False)
        check_decode(results, "bf16", wide=False)
        check_merged(results, wide=False)
        check_topk(results, wide=False)
        print(json.dumps({"cases": results}))
        print(card)
        return 0

    results = []
    print("kernel checks (kernel vs plain PyTorch, same inputs, CUDA-event ms):")
    for check in (check_flash, lambda r: check_flash(r, SPEECH_FLASH_CASES),
                  lambda r: check_flash(r, TENSOR_FLASH_CASES), check_flash_grad,
                  check_decode, lambda r: check_decode(r, "bf16"),
                  check_merged, check_topk, check_beam_topk, check_gather_rows,
                  check_int8_matmul, check_int4_matmul):
        check(results)
        torch.cuda.empty_cache()
    failed = [r["name"] for r in results if not r["ok"]]
    if failed:
        raise SmokeFailure(f"kernel checks failed: {failed}")
    print("selftest (multimodalvc_tpu_torch.ops.selftest.run_all on the card):")
    selftest = selftest_phase()

    table = kernels()
    batch = make_batch()
    print(f"serving: AVSRConfig() full width, random weights (seed 0), batch {BATCH}, "
          f"{SECONDS} s, beam {BEAMS}")
    phases, checks = serving_phases(table, batch)
    phases["selftest"] = selftest
    print(f"training: AVSRConfig() full width, batch {BATCH} x {SECONDS} s, {TRAIN_LABELS} label "
          f"tokens, {TRAIN_STEPS} steps on one batch")
    for name, flash in (("train_avsr", False), ("train_avsr_flash", True)):
        phases[name] = train_phase(table, name, flash)
    print("remat and the other optimizers: train_avsr_flash with LlamaConfig.remat; adafactor, "
          "lamb, adagrad, adamax, nag and sgd on its trainer")
    phases["train_avsr_remat"], built = train_avsr_remat(
        table, phases["train_avsr_flash"]["peak_gib"])
    phases["train_optimizers"] = train_optimizers(table, built)
    del built
    print(f"speech synthesis: SpeechConfig() full width (Conformer-L, HiFi-GAN), random weights "
          f"(seed {SPEECH_SEED}), batch {BATCH} x {SECONDS} s, bf16")
    phases.update(speech_phases(table, checks))
    print(f"speech training: SpeechConfig() full width, batch {BATCH} x {SECONDS} s (E2E "
          f"{E2E_BATCH}), bf16 trunk; the vocoder f32 at {VOCODER_BATCH} x 8320 samples")
    phases.update(speech_train_phases(table))
    print(f"command line: manifest corpus of {CLI_CLIPS} clips; cli.train, cli.eval and "
          "cli.generate at full width")
    phases.update(cli_phases(table))
    print(f"the dummy_avsr task: cli.train {' '.join(DUMMY_ARGV)} at full width")
    phases["cli_dummy_avsr"] = cli_dummy_avsr(table)
    print("weight import: the reference layouts of the full-width system, read back and imported; "
          "cli.train with checkpoint.init_from_pt; cli.demo")
    phases.update(import_phases(table))
    print("AV-HuBERT pretraining: k-means labels, cli.train on conf/avhubert-pretrain.yaml at "
          "full width, dump-features, iteration-2 labels; the seq2seq decoder's beam decode")
    phases.update(pretrain_phases(table))
    phases["pretrain_remat"] = pretrain_remat(table)
    print("data preparation: every manifest_tools subcommand over the corpus laid out raw; "
          "quantize_tree of the full-width state dict")
    phases["prep_tools"] = prep_tools(table)
    print("host C++ routines: multimodalvc_tpu_torch.native built with g++, each function "
          "against its plain version at corpus size")
    phases["native"] = native_phase()
    print("several ranks: cli.train in an NCCL group of one under torch.distributed.run; two "
          "data-parallel gloo ranks on the card at full width; the MoE Conformer preset; "
          "two gloo ranks at {tensor 2}: cli.train on mms-llama and the NoLLM head")
    phases.update(parallel_phases(table))

    summary = []
    for name, (fn, attr, src, replaces, phase, on_path) in table.items():
        mine = [r for r in results if r["name"].startswith(name + "/") or r["name"] == name]
        # times and bound of the first case: the shape the serving path gives it
        summary.append({
            "name": name, "route": "cuda", "source": f"multimodalvc_tpu_torch/{src}",
            "replaces": replaces, "phase": phase, "on_path": on_path,
            "launches": phases[phase]["launches"][name],
            "speech_launches": phases["speech_nollm"]["mode0"]["launches"][name],
            **{f"{p}_launches": phases[p]["launches"][name]
               for p in ("cli_dummy_avsr", "train_avsr_remat", "pretrain_train", "pretrain_remat",
                         "pretrain_dump_features", "seq2seq", "seq2seq_constrained",
                         "prep_tools", "parallel_nccl_1rank", "parallel_data_2rank",
                         "parallel_moe_speech", "parallel_tensor_avsr",
                         "parallel_tensor_speech")},
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            **{k: mine[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "case": mine[0]["name"],
        })
    print(json.dumps({"cases": results}))
    print(json.dumps({"phases": phases, "checks": checks}))
    print(f"smoke: {time.perf_counter() - start:.1f} s, the kernels' build included")
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
