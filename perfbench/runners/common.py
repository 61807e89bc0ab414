"""What the runners share: the port's configuration from a configuration
file, the seeded weights of both sides, the card's description, the
comparison numbers."""
from __future__ import annotations

import subprocess
from typing import Dict, List, Sequence

import torch

from perfbench import weights
from perfbench.reference import model as ref
from perfbench.workload import sub_seed

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_speech_config(model: Dict):
    """The port's ``SpeechConfig`` of a configuration file's ``model``; the
    Conformer the port derives from ``conformer_size`` must be the file's."""
    from multimodalvc_tpu_torch.models.speech import SpeechConfig
    from multimodalvc_tpu_torch.nn.avhubert import AVHubertConfig
    from multimodalvc_tpu_torch.nn.conformer import ConformerConfig
    from multimodalvc_tpu_torch.nn.llama import LlamaConfig
    from multimodalvc_tpu_torch.nn.whisper import WhisperEncoderConfig

    conf = ConformerConfig.sized(model["conformer_size"])
    for k, v in model["conformer"].items():
        if getattr(conf, k) != v:
            raise ValueError(f"conformer_size {model['conformer_size']}: {k} {getattr(conf, k)} "
                             f"in the port, {v} in the configuration file")
    keys = ("qformer_layers", "qformer_dim", "modality_fuse", "queries_per_sec",
            "use_sr_predictor", "sr_predictor_layers", "max_video_frames", "modality_dropout",
            "conformer_size", "proj_mid_dim", "head_dim", "max_mel_frames")
    return SpeechConfig(whisper=WhisperEncoderConfig(**model["whisper"]),
                        avhubert=AVHubertConfig(**model["avhubert"]),
                        llama=LlamaConfig(**model["llama"]),
                        **{k: model[k] for k in keys})


def port_hifigan_config(model: Dict, in_channels: int):
    from multimodalvc_tpu_torch.nn.hifigan import HifiGanConfig

    v = model["vocoder"]
    return HifiGanConfig(in_channels=in_channels,
                         resblock_kernel_sizes=tuple(v["resblock_kernel_sizes"]),
                         resblock_dilations=tuple(tuple(d) for d in v["resblock_dilations"]),
                         upsample_factors=tuple(v["upsample_factors"]),
                         upsample_kernel_sizes=tuple(v["upsample_kernel_sizes"]),
                         upsample_initial_channel=v["upsample_initial_channel"])


def reference_spec(model: Dict, part: str):
    """(name, shape, kind) of the reference ``part`` built on the meta device."""
    with torch.device("meta"):
        return weights.spec(ref.build(model, part))


def seeded_state(model: Dict, part: str, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The weights of ``part`` from the run's seed."""
    return weights.make(reference_spec(model, part), sub_seed(seed, "weights", part), device,
                        dtype)


def reference_module(model: Dict, part: str, seed: int, device, dtype) -> torch.nn.Module:
    """The f32 reference ``part`` on ``device``, holding the run's weights (as
    made in ``dtype``, the program's)."""
    with torch.device(device):
        module = ref.build(model, part)
    weights.load_into(module, seeded_state(model, part, seed, device, dtype))
    return module.eval()


class exact_f32:
    """TF32 off for products and convolutions while the reference runs."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.old


def card(device: str) -> Dict:
    """The device block of the result line (without the peak)."""
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def sync(device: str):
    return torch.cuda.synchronize if device != "cpu" else (lambda: None)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def norm_gap(got: Sequence[float], want: Sequence[float], keep: Sequence[bool] = None) -> float:
    """The worst leaf's |got - want| over the larger of its ``want`` and the
    median leaf's ``want`` (leaves with ``keep`` False left out)."""
    keep = [True] * len(want) if keep is None else keep
    pairs = [(g, w) for g, w, k in zip(got, want, keep) if k]
    med = sorted(w for _, w in pairs)[len(pairs) // 2]
    return max(abs(g - w) / max(w, med, 1e-30) for g, w in pairs)


def percentile(values: List[float], q: float) -> float:
    """The q-quantile by linear interpolation between order statistics
    (numpy's default), over every value."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
