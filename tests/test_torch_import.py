"""The port stands alone: it imports no JAX, its wrappers run the plain
versions only for CPU tensors, and its kernel loader never falls back."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch_parity  # noqa: F401  (pins torch to one thread)

from multimodalvc_tpu_torch.ops import (
    attention,
    beam_gather,
    decode_attention,
    int8_matmul,
    kernel_lib,
    topk,
)

REPO = Path(__file__).resolve().parent.parent
SLICE_MODULES = [
    "multimodalvc_tpu_torch",
    "multimodalvc_tpu_torch.criterions.gan",
    "multimodalvc_tpu_torch.criterions.mel",
    "multimodalvc_tpu_torch.interop.from_flax",
    "multimodalvc_tpu_torch.models.avsr",
    "multimodalvc_tpu_torch.models.speech",
    "multimodalvc_tpu_torch.models.vocoder",
    "multimodalvc_tpu_torch.nn.avhubert",
    "multimodalvc_tpu_torch.nn.conformer",
    "multimodalvc_tpu_torch.nn.hifigan",
    "multimodalvc_tpu_torch.nn.init",
    "multimodalvc_tpu_torch.nn.layers",
    "multimodalvc_tpu_torch.nn.llama",
    "multimodalvc_tpu_torch.nn.modules",
    "multimodalvc_tpu_torch.nn.qformer",
    "multimodalvc_tpu_torch.nn.resnet",
    "multimodalvc_tpu_torch.nn.whisper",
    "multimodalvc_tpu_torch.nn.wn_conv",
    "multimodalvc_tpu_torch.ops.attention",
    "multimodalvc_tpu_torch.ops.beam_gather",
    "multimodalvc_tpu_torch.ops.beam_search",
    "multimodalvc_tpu_torch.ops.constraints",
    "multimodalvc_tpu_torch.ops.decode_attention",
    "multimodalvc_tpu_torch.ops.dynamic_conv",
    "multimodalvc_tpu_torch.ops.int8_matmul",
    "multimodalvc_tpu_torch.ops.interpolate",
    "multimodalvc_tpu_torch.ops.kernel_lib",
    "multimodalvc_tpu_torch.ops.stft",
    "multimodalvc_tpu_torch.ops.topk",
    "multimodalvc_tpu_torch.tasks",
]


def test_port_imports_without_jax():
    code = "import sys\n" + "".join(f"import {m}\n" for m in SLICE_MODULES) + (
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'multimodalvc_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernel_lib, "find_nvcc", lambda: None)
    monkeypatch.setattr(kernel_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernel_lib, "_LOADED", None)
    with pytest.raises(kernel_lib.KernelBuildError, match="nvcc not found"):
        kernel_lib.load()
    assert not list(tmp_path.iterdir())


def _refuse_load():
    raise AssertionError("a CPU tensor reached the kernel loader")


COUNTERS = [
    (attention.flash_attention, "launches"),
    (decode_attention.prompt_attention, "launches"),
    (decode_attention.prompt_attention, "launches_bf16"),
    (decode_attention.gen_attention_ancestor, "launches"),
    (decode_attention.gen_attention_ancestor, "launches_bf16"),
    (decode_attention.ancestry_attention, "launches"),
    (topk.beam_topk_columns, "launches"),
    (beam_gather.gather_rows, "launches"),
    (int8_matmul.int8_matmul, "launches"),
    (int8_matmul.int4_matmul, "launches"),
]


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    monkeypatch.setattr(kernel_lib, "load", _refuse_load)
    before = [getattr(w, name) for w, name in COUNTERS]
    x = torch.randn(1, 2, 8, 16)
    attention.flash_attention(x, x, x)
    q = torch.randn(2, 4, 16)
    kv, sc = decode_attention.quantize_kv(torch.randn(1, 2, 5, 16))
    for k_sc in (sc, None):
        decode_attention.prompt_attention(q, kv, kv, torch.ones(1, 5, dtype=torch.int32),
                                          beams=2, scale=0.25, k_scale=k_sc, v_scale=k_sc)
    gk, gs = decode_attention.quantize_kv(torch.randn(2, 3, 2, 16))
    for g_sc in (gs, None):
        decode_attention.gen_attention_ancestor(q, gk, gk, torch.zeros(2, 3, dtype=torch.int32),
                                                2, beams=2, scale=0.25, k_scale=g_sc,
                                                v_scale=g_sc)
    decode_attention.ancestry_attention(
        q, kv, kv, torch.ones(1, 5, dtype=torch.int32), gk, gk, torch.zeros(2, 3, dtype=torch.int32),
        2, beams=2, scale=0.25, prompt_k_scale=sc, prompt_v_scale=sc, gen_k_scale=gs,
        gen_v_scale=gs)
    logits = torch.randn(4, 32)
    topk.beam_topk_columns(logits, logits.amax(-1), logits.amax(-1), torch.zeros(2, 2), 3)
    beam_gather.gather_rows(torch.randn(4, 2, 128), torch.tensor([1, 0], dtype=torch.int32))
    w = torch.randn(256, 128)
    int8_matmul.int8_matmul(torch.randn(3, 256), *int8_matmul.quantize_kernel(w))
    int8_matmul.int4_matmul(torch.randn(3, 256), *int8_matmul.quantize_kernel_int4(w))
    assert [getattr(w, name) for w, name in COUNTERS] == before


KINDS = ["flash", "prompt", "prompt_bf16", "gen", "gen_bf16", "merged", "topk", "gather", "int8",
         "int4"]


@pytest.mark.parametrize("which", KINDS)
def test_non_cpu_tensors_never_take_the_plain_version(monkeypatch, which):
    """A tensor that is not on the CPU goes to the kernel path, whose operand
    check refuses anything but a CUDA tensor: there is no silent fallback."""
    monkeypatch.setattr(kernel_lib, "load", _refuse_load)
    meta = dict(device="meta")
    bf16 = which.endswith("_bf16")
    kv_type = torch.bfloat16 if bf16 else torch.int8
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        if which == "flash":
            x = torch.empty(1, 2, 8, 64, dtype=torch.bfloat16, **meta)
            attention.flash_attention(x, x, x)
        elif which.startswith("prompt"):
            q = torch.empty(2, 4, 16, dtype=torch.bfloat16, **meta)
            kv = torch.empty(1, 2, 5, 16, dtype=kv_type, **meta)
            sc = None if bf16 else torch.empty(1, 2, 5, **meta)
            decode_attention.prompt_attention(q, kv, kv, torch.empty(1, 5, dtype=torch.int32, **meta),
                                              beams=2, scale=0.25, k_scale=sc, v_scale=sc)
        elif which.startswith("gen"):
            q = torch.empty(2, 4, 16, dtype=torch.bfloat16, **meta)
            kv = torch.empty(2, 3, 2, 16, dtype=kv_type, **meta)
            sc = None if bf16 else torch.empty(2, 3, 2, **meta)
            decode_attention.gen_attention_ancestor(
                q, kv, kv, torch.empty(2, 3, dtype=torch.int32, **meta), 2, beams=2, scale=0.25,
                k_scale=sc, v_scale=sc)
        elif which == "merged":
            q = torch.empty(2, 4, 16, dtype=torch.bfloat16, **meta)
            pk = torch.empty(1, 2, 5, 16, dtype=torch.int8, **meta)
            gk = torch.empty(2, 3, 2, 16, dtype=torch.int8, **meta)
            ps, gs = torch.empty(1, 2, 5, **meta), torch.empty(2, 3, 2, **meta)
            decode_attention.ancestry_attention(
                q, pk, pk, torch.empty(1, 5, dtype=torch.int32, **meta), gk, gk,
                torch.empty(2, 3, dtype=torch.int32, **meta), 2, beams=2, scale=0.25,
                prompt_k_scale=ps, prompt_v_scale=ps, gen_k_scale=gs, gen_v_scale=gs)
        elif which == "topk":
            logits = torch.empty(4, 32, **meta)
            topk.beam_topk_columns(logits, torch.empty(4, **meta), torch.empty(4, **meta),
                                   torch.empty(2, 2, **meta), 3)
        elif which == "gather":
            beam_gather.gather_rows(torch.empty(4, 2, 128, dtype=torch.bfloat16, **meta),
                                    torch.empty(2, dtype=torch.int32, **meta))
        elif which == "int8":
            int8_matmul.int8_matmul(torch.empty(3, 256, dtype=torch.bfloat16, **meta),
                                    torch.empty(256, 128, dtype=torch.int8, **meta),
                                    torch.empty(128, **meta))
        else:
            int8_matmul.int4_matmul(torch.empty(3, 256, dtype=torch.bfloat16, **meta),
                                    torch.empty(128, 128, dtype=torch.int8, **meta),
                                    torch.empty(2, 128, **meta))
