#!/usr/bin/env python3
"""Smoke run of the PyTorch port (multimodalvc_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Prints the card (``nvidia-smi`` name and power limit) and builds the CUDA
   kernels from ``multimodalvc_tpu_torch/csrc`` with nvcc.
2. Holds each kernel (K1 flash_attention, K2 prompt_attention and K3
   gen_attention_ancestor with int8 and bf16 KV, K4 beam_topk_columns, K5
   beam_topk / beam_topk_from_logits, K6 gather_rows, K7 int8_matmul, K8
   int4_matmul) against its plain PyTorch version at the serving shapes, with
   edge cases, and times both, the one PyTorch call that computes the same
   function where there is one, and the card's bound for the work (K7 and
   K8 with a cold L2, as the decode finds their weights).
3. Serves batches through the full-width AVSR path (Whisper-medium,
   AV-HuBERT-Large, Q-Former, LLaMA-3.2-3B with random weights from seed 0):
   batch 8, 16 s, beam 5, in ten phases:
   - bf16 weights, int8 KV with the ancestry decode (16 new tokens), with the
     encoders and one prefill + decode step held against the plain versions;
   - bf16 weights, bf16 KV through ``generate()``'s defaults (the ancestry
     decode on the GPU), and bf16 KV with the gather reorder (16 tokens
     each), with two decode steps from one prefill through both caches;
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

Prints JSON lines with the kernel checks and the phases, then the
``{"kernels": [...]}`` summary, then the card line, then, as the last line,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Needs a CUDA device and the repository around it; it does not fall
back to the CPU.

``python3 chip_smoke.py --profile`` runs no checks: it profiles the decode
steps of the bf16-, int8- and int4-weight systems with ``torch.profiler``
and prints the device time per step by kernel (K7's and K8's apart) and the
device's idle share, and the host time a call of K7's wrapper beside
``F.linear``'s.
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
          + "".join(f" {k}={v:.4f}" for k, v in extra.items() if isinstance(v, float)))


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


def check_flash(results):
    """K1 at FLASH_CASES against its plain version, at FLASH_TOL and
    FLASH_REL_TOL, with exact zeros on every row with no valid key; the
    reading of the same check on the plain version with each window's last
    key tile dropped must fail it.  Each case reports the kernel's TFLOP/s
    and share of its bound, and ``library_ms``: SDPA with the same boolean
    mask (key window, causality)."""
    import torch
    import torch.nn.functional as F

    from multimodalvc_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=DEV).manual_seed(0)
    for case in FLASH_CASES:
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


def check_decode(results, kv="int8"):
    """K2 and K3 with an int8 (or bf16) KV cache at the decode shapes of
    batch 8 (the serving phases: 40 query rows, 16 generated slots, valid
    15) and batch 48 (64 slots, valid 41 and 0); beam 5, 24 query / 8 kv
    heads, d=128, 130 prompt slots, a batch element with no valid prompt
    slot.  Tolerance 5e-2 on out, m and l (the JAX selftest's)."""
    import torch

    from multimodalvc_tpu_torch.ops.decode_attention import (
        gen_attention_ancestor,
        gen_attention_ancestor_plain,
        prompt_attention,
        prompt_attention_plain,
    )

    g = torch.Generator(device=DEV).manual_seed(1 if kv == "int8" else 5)
    beams, h, hkv, d, tp = BEAMS, 24, 8, 128, 130
    scale = d ** -0.5

    def cache(shape):  # (values, scales or None)
        if kv == "int8":
            return _int8_kv(shape, g)
        return torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16), None

    for b, slots, valids in ((8, SHORT_TOKENS, (SHORT_TOKENS - 1,)), (48, 64, (41, 0))):
        q = torch.randn(b * beams, h, d, generator=g, device=DEV).to(torch.bfloat16)
        (pk, pks), (pv, pvs) = cache((b, hkv, tp, d)), cache((b, hkv, tp, d))
        pad = torch.randint(0, 60, (b,), generator=g, device=DEV)
        mask = (torch.arange(tp, device=DEV)[None, :] >= pad[:, None]).to(torch.int32)
        mask[3] = 0  # a batch element with no valid prompt slot
        kw = dict(beams=beams, scale=scale, k_scale=pks, v_scale=pvs)
        run = lambda: prompt_attention(q, pk, pv, mask, **kw)  # noqa: E731
        plain = lambda: prompt_attention_plain(q, pk, pv, mask, **kw)  # noqa: E731
        got = run()
        err = max(max_err(a, c) for a, c in zip(got, plain()))
        moved = tuple(x for x in (pk, pv, pks, pvs, mask) if x is not None)
        record(results, f"prompt_attention/{kv}/{b * beams}x{h}x{d}", err, 5e-2,
               ms=time_ms(run), plain_ms=time_ms(plain),
               **prompt_bound(q, moved, got, mask, beams))

        (gk, gks), (gv, gvs) = cache((b * beams, slots, hkv, d)), cache((b * beams, slots, hkv, d))
        anc = torch.randint(0, beams, (b * beams, slots), generator=g, device=DEV).to(torch.int32)
        kw = dict(beams=beams, scale=scale, k_scale=gks, v_scale=gvs)
        moved = tuple(x for x in (gk, gv, gks, gvs, anc) if x is not None)
        for valid in valids:
            run = lambda: gen_attention_ancestor(q, gk, gv, anc, valid, **kw)  # noqa: E731
            plain = lambda: gen_attention_ancestor_plain(q, gk, gv, anc, valid, **kw)  # noqa: E731
            got, want = run(), plain()
            err = max(max_err(a, c) for a, c in zip(got, want))
            if valid == 0 and not (bool((got[0] == 0).all()) and bool((got[1] == -1e30).all())
                                   and bool((got[2] == 0).all())):
                raise SmokeFailure(f"gen_attention_ancestor {kv}: valid_len 0 must give "
                                   "(0, -1e30, 0)")
            record(results, f"gen_attention_ancestor/{kv}/{b * beams}x{slots}x{hkv}x{d}/"
                   f"valid{valid}", err, 5e-2, ms=time_ms(run), plain_ms=time_ms(plain),
                   **gen_bound(q, moved, got, valid, slots))


def check_topk(results):
    """K4 at the serving shapes [8*5, 128256] and [48*5, 128256], n = 2K =
    10, with three winners in one column, rows that tie everywhere, and ties
    across columns.  Indices must be identical; values within 1e-6."""
    import torch

    from multimodalvc_tpu_torch.ops.topk import (
        _candidates,
        beam_topk_columns,
        beam_topk_columns_plain,
    )

    g = torch.Generator(device=DEV).manual_seed(2)
    k, v, n = BEAMS, 128256, 2 * BEAMS
    for b in (BATCH, 48):
        logits = torch.randn(b * k, v, generator=g, device=DEV) * 3.0
        scores = torch.randn(b, k, generator=g, device=DEV)
        logits[0, 999], logits[1, 999], logits[3, 999] = 40.0, 39.5, 39.0  # 3 winners, 1 column
        logits[k + 3] = logits[k + 2]  # batch 1: two beams tie on every candidate
        scores[1, 3] = scores[1, 2]
        logits[2 * k, 100] = logits[2 * k, 5000] = 45.0  # batch 2: a tie across chunks
        logits[3 * k, 3] = logits[3 * k, 7] = 50.0  # batch 3: 4-way tie, 2 rows x 2 columns
        logits[3 * k + 1] = logits[3 * k]
        scores[3, 1] = scores[3, 0]
        row_max = logits.amax(dim=-1, keepdim=True)
        row_ls = torch.log(torch.exp(logits - row_max).sum(dim=-1, keepdim=True))
        run = lambda: beam_topk_columns(logits, row_max, row_ls, scores, n)  # noqa: E731
        plain = lambda: beam_topk_columns_plain(logits, row_max, row_ls, scores, n)  # noqa: E731
        (gv, gi), (wv, wi) = run(), plain()
        if not torch.equal(gi, wi):
            bad = int((gi != wi).any(dim=1).nonzero()[0])
            raise SmokeFailure(f"beam_topk_columns: indices differ at batch {bad}: "
                               f"{gi[bad].tolist()} vs {wi[bad].tolist()}")
        if wi[3, :4].tolist() != [3, 7, v + 3, v + 7]:
            raise SmokeFailure(f"beam_topk_columns: tie order {wi[3, :4].tolist()}")
        cand = _candidates(logits, row_max, row_ls, scores).reshape(b, -1)
        record(results, f"beam_topk_columns/{b * k}x{v}", max_err(gv, wv), 1e-6,
               library=lambda: torch.topk(cand, n), ms=time_ms(run),
               plain_ms=time_ms(plain, iters=3),
               **topk_bound(logits, (row_max, row_ls, scores), 4, (gv, gi)))


def topk_bound(x, small, ops_per_value, out) -> dict:
    """K4/K5: one read of the candidates' source ``x`` and of the per-row
    scalars, the outputs written once; ``ops_per_value`` f32 operations on
    every value (the normalise, the add, the clamp), outside the tensor cores."""
    return bound(nbytes(x, *small, *out), ops_per_value * x.numel(), F32_FLOPS)


def _planted(b, k, v, g, scale=3.0):
    """Log-probs [B, K, V] f32 with ties across rows and across 2048-column
    chunks, and -1e7 "banned" entries (what the n-gram block writes)."""
    import torch

    logp = torch.randn(b, k, v, generator=g, device=DEV) * scale - 12.0
    scores = torch.randn(b, k, generator=g, device=DEV)
    ban = torch.rand(b, k, v, generator=g, device=DEV) < 0.01
    logp = logp.masked_fill(ban, -1.0e7)
    logp[0, 0, 999] = logp[0, 2, 999] = 9.0  # batch 0: a tie across rows, one column
    scores[0, 2] = scores[0, 0]
    logp[1, 3, 100] = logp[1, 3, 5000] = 8.0  # batch 1: a tie across chunks
    logp[2, 1] = logp[2, 0]  # batch 2: two beams tie on every candidate
    scores[2, 1] = scores[2, 0]
    logp[3, 4, :] = -1.0e7  # batch 3: a beam with every token banned
    logp[3, 0, 2047] = logp[3, 0, 2048] = 7.5  # and a tie on a chunk boundary
    return logp, scores


def check_beam_topk(results, only=None):
    """K5 at the n-gram phase's shape [8, 5, 128256] and the JAX selftest's
    [4, 5, 128256], f32 and bf16 log-probs with planted ties and bans, and
    from raw logits at [240, 128256] and [240, 128250] (V % 8 != 0); n = 10.
    Indices must be identical; values within 1e-6.  ``library_ms`` is
    ``torch.topk`` on the prebuilt candidate row, without the add that K5
    fuses."""
    import torch

    from multimodalvc_tpu_torch.ops.topk import (
        _candidates,
        beam_topk,
        beam_topk_from_logits,
        beam_topk_from_logits_plain,
        beam_topk_plain,
    )

    g = torch.Generator(device=DEV).manual_seed(10)
    k, n = BEAMS, 2 * BEAMS
    cases = [("f32", "logp/8x5x128256", 8, 128256, torch.float32),
             ("f32", "logp/4x5x128256", 4, 128256, torch.float32),
             ("bf16", "logp_bf16/4x5x128256", 4, 128256, torch.bfloat16),
             ("from_logits", "from_logits/240x128256", 48, 128256, None),
             ("from_logits_v_odd", "from_logits/240x128250", 48, 128250, None)]
    for key, name, b, v, dtype in cases:
        if only is not None and key != only:
            continue
        logp, scores = _planted(b, k, v, g)
        if dtype is not None:
            logp = logp.to(dtype)
            run = lambda: beam_topk(logp, scores, n)  # noqa: E731
            plain = lambda: beam_topk_plain(logp, scores, n)  # noqa: E731
            cand = logp.float() + scores[:, :, None]
            small, ops, x = (scores,), 2, logp
        else:
            x = (logp.reshape(b * k, v) * 0.25).contiguous()  # raw logits
            row_max = x.amax(dim=-1, keepdim=True)
            row_ls = torch.log(torch.exp(x - row_max).sum(dim=-1, keepdim=True))
            run = lambda: beam_topk_from_logits(x, row_max, row_ls, scores, n)  # noqa: E731
            plain = lambda: beam_topk_from_logits_plain(x, row_max, row_ls, scores, n)  # noqa: E731
            cand = _candidates(x, row_max, row_ls, scores)
            small, ops = (row_max, row_ls, scores), 4
        cand = cand.reshape(b, -1)
        (gv, gi), (wv, wi) = run(), plain()
        torch.cuda.synchronize()
        if not torch.equal(gi, wi):
            bad = int((gi != wi).any(dim=1).nonzero()[0])
            raise SmokeFailure(f"beam_topk {name}: indices differ at batch {bad}: "
                               f"{gi[bad].tolist()} vs {wi[bad].tolist()}")
        if dtype is not None and wi[0, :2].tolist() != [999, 2 * v + 999]:
            raise SmokeFailure(f"beam_topk {name}: tie order {wi[0, :2].tolist()}")
        record(results, f"beam_topk/{name}", max_err(gv, wv), 1e-6,
               library=lambda: torch.topk(cand, n), ms=time_ms(run),
               plain_ms=time_ms(plain, iters=3), **topk_bound(x, small, ops, (gv, gi)))


def check_gather_rows(results):
    """K6 at the serving phases' leaves, bf16: the gather reorder's
    generated KV [40, 16, 8, 128] and the full cache [40, 8, 146, 128]; and
    [B*K, 64, 8, 128] for batch 8 and 48; with repeated and permuted source
    rows.  Exact."""
    import torch

    from multimodalvc_tpu_torch.ops.beam_gather import gather_rows, gather_rows_plain

    g = torch.Generator(device=DEV).manual_seed(6)
    for rows, shape in ((8 * BEAMS, (SHORT_TOKENS, 8, 128)), (8 * BEAMS, (8, 146, 128)),
                        (8 * BEAMS, (64, 8, 128)), (48 * BEAMS, (64, 8, 128))):
        x = torch.randn(rows, *shape, generator=g, device=DEV).to(torch.bfloat16)
        perm = torch.randperm(rows, generator=g, device=DEV).to(torch.int32)
        src = perm.clone()
        src[rows // 2:] = perm[: rows - rows // 2]  # a permuted half, then repeats of it
        run = lambda: gather_rows(x, src)  # noqa: E731
        plain = lambda: gather_rows_plain(x, src)  # noqa: E731
        got = run()
        name = "x".join(str(i) for i in (rows, *shape))
        if not torch.equal(got, plain()):
            raise SmokeFailure(f"gather_rows [{name}]: rows differ")
        library = lambda: torch.index_select(x, 0, src)  # noqa: E731
        # each selected row read once and written once
        record(results, f"gather_rows/{name}", max_err(got, plain()), 0.0,
               library=library, ms=time_ms(run), plain_ms=time_ms(plain),
               **bound(2 * nbytes(got) + nbytes(src)))


# A rotation of weight copies at least this large (two 50 MB L2s) finds
# every copy cold at its next use, as the decode does, which streams ~3.2 GB
# of int8 weight a step.
COLD_BYTES = 100e6


def time_cold(calls) -> float:
    """``time_ms`` of ``calls`` taken in turn, each copy used once a round."""
    it = itertools.cycle(calls)
    return time_ms(lambda: next(it)(), iters=max(10, 2 * len(calls)))


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
    from multimodalvc_tpu_torch.ops.decode_attention import gen_attention_ancestor, prompt_attention
    from multimodalvc_tpu_torch.ops.int8_matmul import int4_matmul, int8_matmul
    from multimodalvc_tpu_torch.ops.topk import beam_topk, beam_topk_columns

    da = "multimodalvc_tpu/ops/decode_attention.py"
    return {
        "flash_attention": (flash_attention, "launches", "csrc/flash_attention.cu",
                            "multimodalvc_tpu/ops/attention.py:328", "int8_weights", True),
        "prompt_attention/int8": (prompt_attention, "launches", "csrc/decode_attention.cu",
                                  f"{da}:370", "int8_weights", True),
        # no serving path runs K2 on a bf16 cache (the JAX package's neither:
        # a bf16 prompt segment is plain einsums), so no phase may launch it;
        # its check above is its only use
        "prompt_attention/bf16": (prompt_attention, "launches_bf16", "csrc/decode_attention.cu",
                                  f"{da}:370", "bf16_kv_ancestry", False),
        "gen_attention_ancestor/int8": (gen_attention_ancestor, "launches",
                                        "csrc/decode_attention.cu", f"{da}:195", "int8_weights",
                                        True),
        "gen_attention_ancestor/bf16": (gen_attention_ancestor, "launches_bf16",
                                        "csrc/decode_attention.cu", f"{da}:195",
                                        "bf16_kv_ancestry", True),
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
    "bf16_weights": {"flash_attention": ON, "prompt_attention/int8": ON,
                     "gen_attention_ancestor/int8": ON, "beam_topk_columns": ON},
    "bf16_kv_ancestry": {"flash_attention": ON, "gen_attention_ancestor/bf16": ON,
                         "beam_topk_columns": ON},
    "bf16_kv_gather": {"flash_attention": ON, "beam_topk_columns": ON, "gather_rows": ON},
    "bf16_constrained": {"flash_attention": ON, "gather_rows": ON},
    # no encoders and no flash prefill (the cache spans T + L slots, t != tkv)
    "bf16_full_cache": {"beam_topk_columns": ON, "gather_rows": ON},
    "int8_weights": {"flash_attention": ON, "prompt_attention/int8": ON,
                     "gen_attention_ancestor/int8": ON, "beam_topk_columns": ON,
                     "int8_matmul": ON},
    "int8_ngram": {"flash_attention": ON, "prompt_attention/int8": ON,
                   "gen_attention_ancestor/int8": ON, "beam_topk": ON, "int8_matmul": ON},
    "int4_weights": {"flash_attention": ON, "prompt_attention/int8": ON,
                     "gen_attention_ancestor/int8": ON, "beam_topk_columns": ON,
                     "int4_matmul": ON},
}


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
        (llama, "prompt_attention", decode_attention.prompt_attention_plain),
        (llama, "gen_attention_ancestor", decode_attention.gen_attention_ancestor_plain),
        (llama, "int8_matmul", int8_matmul.int8_matmul_plain),
        (llama, "int4_matmul", int8_matmul.int4_matmul_plain),
        (beam_gather, "gather_rows", beam_gather.gather_rows_plain),
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


def check_output(name, seqs, scores, vocab, new_tokens):
    import torch

    if tuple(seqs.shape) != (BATCH, BEAMS, new_tokens) or tuple(scores.shape) != (BATCH, BEAMS):
        raise SmokeFailure(f"{name}: output shapes {tuple(seqs.shape)}, {tuple(scores.shape)}")
    if not bool(torch.isfinite(scores).all()):
        raise SmokeFailure(f"{name}: non-finite beam scores")
    if not bool(((seqs >= 0) & (seqs < vocab)).all()):
        raise SmokeFailure(f"{name}: token ids out of range")
    if not bool((scores[:, :-1] >= scores[:, 1:]).all()):
        raise SmokeFailure(f"{name}: beam scores not sorted")


def run_phase(table, name, call, expect=None, audio_s=BATCH * SECONDS) -> tuple:
    """Run ``call`` once with every launch count set to 0 just before it and
    read just after; fails unless the launches meet ``expect`` (default
    ``EXPECT[name]``).  Returns (the phase's record, what ``call`` returned)."""
    reset_counts(table)
    out, t_gen = wall(call)
    launches = read_counts(table)
    expect = EXPECT[name] if expect is None else expect
    wrong = {k: (n, expect.get(k, 0)) for k, n in launches.items()
             if not (n > 0 if expect.get(k, 0) == ON else n == expect.get(k, 0))}
    if wrong:
        raise SmokeFailure(f"{name}: launches (got, expected) {wrong}")
    rtf = audio_s / t_gen
    print(f"  phase {name}: {t_gen:.3f} s, realtime factor {rtf:.1f}x, launches "
          f"{ {k: n for k, n in launches.items() if n} }")
    return {"generate_s": t_gen, "realtime_factor": rtf, "launches": launches}, out


def serve(table, system, batch, name, new_tokens, gen_kw, expect=None) -> tuple:
    """A ``generate`` phase with its output checked: (record, sequences,
    scores)."""
    phase, (seqs, scores) = run_phase(table, name, lambda: system.generate(
        batch, num_beams=BEAMS, max_new_tokens=new_tokens, **gen_kw), expect)
    check_output(name, seqs, scores, system.cfg.llama.vocab_size, new_tokens)
    phase["new_tokens"] = new_tokens
    return phase, seqs, scores


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def compare(out, name, got, want, tol):
    """Record kernel-vs-plain (or cache-vs-cache) agreement; fail above tol."""
    rel = rel_l2(got, want)
    out[name] = {"max_abs": max_err(got, want), "rel_l2": rel, "tol_rel_l2": tol}
    print(f"  {name}: max_abs={out[name]['max_abs']:.3e} rel_l2={rel:.3e} (tol {tol:g})")
    if not rel <= tol:
        raise SmokeFailure(f"{name}: the two paths disagree (rel {rel:.3e})")


def prefill_and_step(llama, emb, mask, tokens, **cache_kw):
    """One prefill and one decode step of every beam: (first logits, step logits)."""
    from multimodalvc_tpu_torch.nn.llama import decode_step, prefill_split_cache

    first, cache, lens = prefill_split_cache(
        llama, emb, mask, num_beams=BEAMS, max_new_tokens=SHORT_TOKENS, **cache_kw)
    logits, _ = decode_step(llama, tokens, lens.repeat_interleave(BEAMS)[:, None], cache)
    return first, logits


INT8_KV = dict(ancestry_reorder=True, kv_quant="int8")


def logits_gate(llama, emb, mask, tokens, logits, **cache_kw) -> dict:
    """The gate for end-to-end decode-step logits on these weights and this
    cache: the noise floor, the relative L2 by which one bf16 ulp on every
    9973rd prompt-embedding value moves ``logits`` (what rounding alone does
    here), times FLOOR_MARGIN, and at least REL_TOL.  Fails if the floor
    exceeds FLOOR_MAX."""
    nudged = emb.clone()
    flat = nudged.view(-1)
    flat[::9973] = flat[::9973] * (1 + 2 ** -7)
    floor = rel_l2(prefill_and_step(llama, nudged, mask, tokens, **cache_kw)[1], logits)
    tol = max(REL_TOL, FLOOR_MARGIN * floor)
    print(f"    noise floor (one bf16 ulp on 0.01% of the prompt): rel_l2={floor:.3e}, "
          f"logits gate {tol:.3e} (floor limit {FLOOR_MAX:g})")
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


def layerwise(llama, emb, mask, tokens, name) -> dict:
    """One decode step, layer by layer: each layer's update (output minus
    input) from the same input and cache, through the kernels and through
    the plain versions, then the final norm and unembed.  Gated at REL_TOL."""
    from multimodalvc_tpu_torch.nn.llama import prefill_split_cache

    _, cache, lens = prefill_split_cache(
        llama, emb, mask, num_beams=BEAMS, max_new_tokens=SHORT_TOKENS, **INT8_KV)
    pos = lens.repeat_interleave(BEAMS)[:, None]
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
    return phase


def long_form_phase(table, system, flash_per_generate: int) -> dict:
    """``generate_long_form`` on a 32 s clip (800 frames, chunk_frames 400,
    mel [8, 80, 3200]), int8 KV: two ``generate`` calls, K1 twice as often as
    one, and one merged token row per sample."""
    import numpy as np

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
            kv_quant="int8"), expect, audio_s=BATCH * 2 * SECONDS)
    vocab = system.cfg.llama.vocab_size
    if len(calls) != 2:
        raise SmokeFailure(f"long_form: {len(calls)} generate calls, expected 2")
    if len(rows) != BATCH or not all(isinstance(r, np.ndarray) and r.ndim == 1 and len(r)
                                     and (r >= 0).all() and (r < vocab).all() for r in rows):
        raise SmokeFailure(f"long_form: expected {BATCH} merged token rows")
    phase.update(generate_calls=len(calls), merged_lengths=[len(r) for r in rows])
    return phase


def ensemble_phase(table, system, batch, flash_per_generate: int) -> dict:
    """Two bf16 systems (seeds 0 and 1), int8 KV, ancestry: each member runs
    its own encoders (K1 twice as often as one system), K2/K3 in both, K4
    on the averaged log-probs."""
    import torch

    member = build_system(seed=1)
    expect = {**EXPECT["bf16_weights"], "flash_attention": 2 * flash_per_generate}
    phase, _, _ = serve(table, system, batch, "bf16_ensemble2", SHORT_TOKENS,
                        dict(kv_quant="int8", ensemble=[member]), expect)
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
    flash = phases["bf16_weights"]["launches"]["flash_attention"]
    phases["bf16_constrained"] = constrained_phase(table, system, batch)
    phases["bf16_full_cache"] = full_cache_phase(table, system, emb, mask)
    phases["long_form"] = long_form_phase(table, system, flash)
    phases["bf16_ensemble2"] = ensemble_phase(table, system, batch, flash)
    del system, llama, enc
    torch.cuda.empty_cache()
    return phases, checks, (emb, mask), tokens, bf16_logits


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
    steps = phase["launches"]["prompt_attention/int8"] // system.cfg.llama.num_layers
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
        steps = phase["launches"]["prompt_attention/int8"] // system.cfg.llama.num_layers
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
            (f"{mode}_matmul", "prompt_attention", "gen_attention_ancestor"))
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


def profile_decode(table, system, batch, steps: int = 10, top: int = 12) -> dict:
    """Where a decode step's time goes, at the serving batch with the int8
    KV cache: generate() with 1 + ``steps`` new tokens against generate()
    with 1 (the prefill's token, no decode step), unprofiled (the median of
    three walls) and under torch.profiler (device time of every kernel,
    copy and memset); the differences over ``steps`` are the decode steps'
    share, without the encoders and the prefill."""
    import statistics
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def gen(n):
        return system.generate(batch, num_beams=BEAMS, max_new_tokens=n, kv_quant="int8")

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
    n = read_counts(table)["prompt_attention/int8"] // system.cfg.llama.num_layers
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
        # K7's and K8's kernels, summed by their __global__ names
        "kernel_ms_per_step": {name: sum(v for k, v in per_step.items() if f"{name}_kernel" in k)
                               for name in ("int8_matmul", "int4_matmul")},
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


def profile_main(table, batch) -> dict:
    """``--profile``: the decode profile of the bf16-, int8- and int4-weight
    systems (int8 KV, ancestry), one system at a time, and the host time of
    K7's wrapper on the int8 system's weights."""
    import torch

    out = {}
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


def main() -> int:
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

    if "--profile" in sys.argv[1:]:
        print(json.dumps({"profile": profile_main(kernels(), make_batch())}))
        print(card)
        return 0

    results = []
    print("kernel checks (kernel vs plain PyTorch, same inputs, CUDA-event ms):")
    for check in (check_flash, check_decode, lambda r: check_decode(r, "bf16"), check_topk,
                  check_beam_topk, check_gather_rows, check_int8_matmul, check_int4_matmul):
        check(results)
        torch.cuda.empty_cache()
    failed = [r["name"] for r in results if not r["ok"]]
    if failed:
        raise SmokeFailure(f"kernel checks failed: {failed}")

    table = kernels()
    batch = make_batch()
    print(f"serving: AVSRConfig() full width, random weights (seed 0), batch {BATCH}, "
          f"{SECONDS} s, beam {BEAMS}")
    phases, checks, prompt, tokens, bf16_logits = bf16_weight_phases(table, batch)
    phases.update(quantized_phase(table, batch, "int8", NEW_TOKENS, prompt, tokens, bf16_logits))
    phases.update(quantized_phase(table, batch, "int4", SHORT_TOKENS, prompt, tokens, bf16_logits))

    summary = []
    for name, (fn, attr, src, replaces, phase, on_path) in table.items():
        mine = [r for r in results if r["name"].startswith(name + "/") or r["name"] == name]
        # times and bound of the first case: the shape the serving path gives it
        summary.append({
            "name": name, "route": "cuda", "source": f"multimodalvc_tpu_torch/{src}",
            "replaces": replaces, "phase": phase, "on_path": on_path,
            "launches": phases[phase]["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            **{k: mine[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "case": mine[0]["name"],
        })
    print(json.dumps({"cases": results}))
    print(json.dumps({"phases": phases, "checks": checks}))
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
