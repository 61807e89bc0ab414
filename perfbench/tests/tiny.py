"""A tiny configuration and mixes of the benchmark's shape, for CPU tests."""
import copy
import json
from pathlib import Path

import torch

from perfbench.harness import Context

ROOT = Path(__file__).resolve().parents[2]


def config(name: str = "speech_nollm", dtype: str = "float32") -> dict:
    c = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    m = c["model"]
    m["whisper"] = {"n_mels": 80, "d_model": 64, "num_layers": 2, "num_heads": 4, "ffn_dim": 128,
                    "max_frames": 64}
    m["avhubert"].update(encoder_embed_dim=64, encoder_layers=2, encoder_attention_heads=4,
                         encoder_ffn_dim=128)
    m["llama"] = {"hidden_size": 64}
    m.update(qformer_dim=32, queries_per_sec=2, max_video_frames=16, conformer_size="S",
             proj_mid_dim=48, head_dim=144, max_mel_frames=80, image_size=24)
    m["conformer"] = {"num_blocks": 3, "attention_dim": 144, "attention_heads": 4,
                      "linear_units": 2048, "dropout_rate": 0.1, "cnn_kernel": 31}
    m["vocoder"]["upsample_initial_channel"] = 16
    c["dtype"] = dtype
    if "vocoder_dtype" in c and c["system"] == "e2e":
        c["vocoder_dtype"] = dtype
    return c


def mix(name: str) -> dict:
    m = json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json").read_text())
    m = copy.deepcopy(m)
    m.update(min_s=0.2, max_s=0.6, buckets=[8, 16])
    if m["runner"] == "train":
        m.update(pool=8, max_tokens=32, trace_steps=2)
    else:
        m.update(pool=12, batch=4, compare_clips=4, trace_steps=3)
    return m


def context(config_name: str, mix_name: str, seed: int = 2 ** 31 + 5, limits=None,
            dtype: str = "float32", seconds: float = 3.0) -> Context:
    """A window long enough for a pass over the tiny pool on a loaded CPU.
    One thread a test process: several workers share the CPU."""
    torch.set_num_threads(1)
    return Context(cell={"name": f"tiny_{config_name}_{mix_name}", "chips": 1},
                   config=config(config_name, dtype), mix=mix(mix_name), seed=seed,
                   seconds=seconds,
                   trace=False, device="cpu", limits=limits or {})
