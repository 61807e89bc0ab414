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
   K8 with a cold L2, as the decode finds their weights).
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

Prints JSON lines with the kernel checks and the phases, the smoke's own
wall, then the ``{"kernels": [...]}`` summary, then the card line, then, as the last line,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Needs a CUDA device and the repository around it; it does not fall
back to the CPU.

``python3 chip_smoke.py --train`` runs only ``check_flash_grad`` and the two
training phases.

``python3 chip_smoke.py --speech`` runs only K1's speech cases and the five
speech phases.

``python3 chip_smoke.py --speech-train`` runs only K1's Conformer-L
gradient case and the four speech training phases.

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

import functools
import hashlib
import itertools
import json
import math
import subprocess
import sys
import time
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
    buffer, no causal mask)."""
    return [("trunk", (BATCH, 24, train_prompt_len(), 128), True),
            ("trunk", (BATCH, 24, 512, 128), True),
            (CONFORMER_GRAD, (BATCH, 8, 2400, 64), False)]


CONFORMER_GRAD = "conformer_l"


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
    the ceiling also on the select form.  ``library_ms`` is
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


def build_trainer(flash: bool):
    """The training slice's entry points at full width: ``AVSRTask`` (bf16
    random weights from seed 0, ``use_flash_prefill`` as given), its loss
    and frozen patterns into ``Trainer`` with the conf/mms-llama.yaml
    optimizer (AdamW, betas (0.9, 0.98), weight decay 0.01, clip 1.0,
    cosine) and a warmup of TRAIN_WARMUP updates."""
    import torch

    from multimodalvc_tpu_torch.config.configs import OptimizationConfig
    from multimodalvc_tpu_torch.models.avsr import AVSRConfig
    from multimodalvc_tpu_torch.runtime.trainer import Trainer
    from multimodalvc_tpu_torch.tasks import AVSRTask, AVSRTaskConfig

    cfg = AVSRConfig()
    cfg.max_video_frames = SECONDS * 25
    cfg.llama.use_flash_prefill = True if flash else None
    t0 = time.perf_counter()
    task = AVSRTask(AVSRTaskConfig(), cfg, dtype=torch.bfloat16, device=DEV)
    task.system.init_random(seed=0)
    opt = OptimizationConfig(lr=1e-4, optimizer="adamw", adam_betas=(0.9, 0.98),
                             weight_decay=0.01, clip_norm=1.0, lr_scheduler="cosine",
                             warmup_updates=TRAIN_WARMUP, max_update=30000)
    trainer = Trainer(task.make_loss_fn(), task.system.module, opt, task.frozen_patterns())
    torch.cuda.synchronize()
    print(f"trainer: {'flash' if flash else 'plain'} trunk attention, built in "
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


def train_speech_phase(table, variant: str) -> dict:
    """SpeechTask(variant) -> Trainer at full width (bf16, seed 0), the
    step-1 gradients gated against K1 plain first, then SPEECH_TRAIN_STEPS
    steps on one batch, its modality mode drawn a step as the task draws
    it; with every launch count 0 before the first step and read after the
    last.  Checks: K1 SPEECH_FLASH times a step, 12 of them with a
    gradient; the frozen leaves bit for bit; every Conformer running
    statistic moved; the losses finite and the last below the first.  Then
    one step timed by stage (``step_split``)."""
    import gc

    import torch

    from multimodalvc_tpu_torch.config.configs import OptimizationConfig
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
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_k1_launches(name, launches, grads.n, SPEECH_TRAIN_STEPS, CONFORMER_GRAD_LAUNCHES)
    unchanged(name, task.module, frozen)
    now = task.module.state_dict()
    still = [n for n, x in stats.items() if torch.equal(now[n], x)]
    if not stats or still:
        raise SmokeFailure(f"{name}: running statistics that did not move: {still[:3]}")
    losses = [m["mel_l1"] for m in metrics]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SmokeFailure(f"{name}: mel L1 {losses} (finite, the last below the first)")
    step_s = sum(walls[1:]) / len(walls[1:])
    split = step_split(trainer, batch)
    record.update(mel_l1=losses, modes=modes, step_ms=[1e3 * x for x in walls],
                  mean_step_ms=1e3 * step_s, audio_s_per_s=BATCH * SECONDS / step_s,
                  peak_gib=peak, launches=launches, k1_launches_a_step=SPEECH_FLASH,
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
    for check in (check_flash, lambda r: check_flash(r, SPEECH_FLASH_CASES), check_flash_grad,
                  check_decode, lambda r: check_decode(r, "bf16"),
                  check_merged, check_topk, check_beam_topk, check_gather_rows,
                  check_int8_matmul, check_int4_matmul):
        check(results)
        torch.cuda.empty_cache()
    failed = [r["name"] for r in results if not r["ok"]]
    if failed:
        raise SmokeFailure(f"kernel checks failed: {failed}")

    table = kernels()
    batch = make_batch()
    print(f"serving: AVSRConfig() full width, random weights (seed 0), batch {BATCH}, "
          f"{SECONDS} s, beam {BEAMS}")
    phases, checks = serving_phases(table, batch)
    print(f"training: AVSRConfig() full width, batch {BATCH} x {SECONDS} s, {TRAIN_LABELS} label "
          f"tokens, {TRAIN_STEPS} steps on one batch")
    for name, flash in (("train_avsr", False), ("train_avsr_flash", True)):
        phases[name] = train_phase(table, name, flash)
    print(f"speech synthesis: SpeechConfig() full width (Conformer-L, HiFi-GAN), random weights "
          f"(seed {SPEECH_SEED}), batch {BATCH} x {SECONDS} s, bf16")
    phases.update(speech_phases(table, checks))
    print(f"speech training: SpeechConfig() full width, batch {BATCH} x {SECONDS} s (E2E "
          f"{E2E_BATCH}), bf16 trunk; the vocoder f32 at {VOCODER_BATCH} x 8320 samples")
    phases.update(speech_train_phases(table))

    summary = []
    for name, (fn, attr, src, replaces, phase, on_path) in table.items():
        mine = [r for r in results if r["name"].startswith(name + "/") or r["name"] == name]
        # times and bound of the first case: the shape the serving path gives it
        summary.append({
            "name": name, "route": "cuda", "source": f"multimodalvc_tpu_torch/{src}",
            "replaces": replaces, "phase": phase, "on_path": on_path,
            "launches": phases[phase]["launches"][name],
            "speech_launches": phases["speech_nollm"]["mode0"]["launches"][name],
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
