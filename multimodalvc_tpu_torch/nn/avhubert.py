"""AV-HuBERT encoder, video-only path (the frozen lip-reading backbone).

Port of ``multimodalvc_tpu/nn/avhubert.py:AVHubertModel`` as the AVSR
encoder calls it, in the large recipe (concat fuse, PReLU ResNet, pre-LN):
ResNet front end -> video_proj; the missing audio stream contributes zeros;
concat -> LayerNorm -> post_extract_proj -> a wav2vec2-style transformer.
``import_torch_avhubert`` reads a fairseq AV-HuBERT checkpoint's weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from .state_maps import (
    as_tensor,
    put_batch_norm,
    put_linear,
    put_norm,
    put_pos_conv,
    put_transformer_layers,
)
from .layers import TransformerEncoder
from .resnet import ResEncoder


@dataclass
class AVHubertConfig:
    encoder_embed_dim: int = 1024  # large
    encoder_layers: int = 24
    encoder_attention_heads: int = 16
    encoder_ffn_dim: int = 4096
    conv_pos: int = 128
    conv_pos_groups: int = 16

    @classmethod
    def large(cls):
        return cls()

    @classmethod
    def tiny(cls):  # for tests
        return cls(
            encoder_embed_dim=64,
            encoder_layers=2,
            encoder_attention_heads=4,
            encoder_ffn_dim=128,
        )


class AVHubertModel(nn.Module):
    def __init__(self, cfg: AVHubertConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.encoder_embed_dim
        self.video_resnet = ResEncoder(**kw)
        self.video_proj = nn.Linear(512, d, **kw)
        self.layer_norm = nn.LayerNorm(2 * d, eps=1e-5, **kw)
        self.post_extract_proj = nn.Linear(2 * d, d, **kw)
        self.encoder = TransformerEncoder(
            d, cfg.encoder_layers, cfg.encoder_attention_heads, cfg.encoder_ffn_dim,
            conv_pos=cfg.conv_pos, conv_pos_groups=cfg.conv_pos_groups, **kw,
        )

    def forward(self, audio: Optional[torch.Tensor] = None, video: Optional[torch.Tensor] = None,
                *, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if audio is not None or video is None:
            raise NotImplementedError("the port serves the video-only path")
        v = self.video_proj(self.video_resnet(video))
        # the reference concatenates audio first; a missing stream is zeros
        x = self.layer_norm(torch.cat([torch.zeros_like(v), v], dim=-1))
        return self.encoder(self.post_extract_proj(x), lengths=lengths)


# ---- the fairseq weight import ----------------------------------------------------


def map_resnet(state: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A reference ``ResEncoder`` state dict (``frontend3D.*`` and
    ``trunk.layer{1..4}.{0,1}.*``, under ``prefix``, e.g.
    ``feature_extractor_video.resnet.`` in an AV-HuBERT checkpoint) as
    ``nn/resnet.py: ResEncoder``'s state dict.  The conv3d stem [O, 1, kT,
    kH, kW] becomes the tap-stacked conv2d [O, kT, kH, kW] (time tap k as
    input channel k); BatchNorm statistics go to ``running_mean`` /
    ``running_var``, PReLU slopes to ``weight``."""
    pre = prefix.rstrip(".")
    out: Dict[str, torch.Tensor] = {}
    stem = as_tensor(state[f"{pre}.frontend3D.0.weight"])
    out["frontend_conv.weight"] = stem.reshape(stem.shape[0], *stem.shape[2:])
    put_batch_norm(out, state, f"{pre}.frontend3D.1", "frontend_bn")
    out["frontend_relu.weight"] = as_tensor(state[f"{pre}.frontend3D.2.weight"])
    for li in range(1, 5):
        for b in range(2):
            src, dst = f"{pre}.trunk.layer{li}.{b}", f"trunk.layer{li}_{b}"
            for cn in ("conv1", "conv2"):
                out[f"{dst}.{cn}.weight"] = as_tensor(state[f"{src}.{cn}.weight"])
            for bn in ("bn1", "bn2"):
                put_batch_norm(out, state, f"{src}.{bn}", f"{dst}.{bn}")
            for rl in ("relu1", "relu2"):
                out[f"{dst}.{rl}.weight"] = as_tensor(state[f"{src}.{rl}.weight"])
            if f"{src}.downsample.0.weight" in state:
                out[f"{dst}.downsample_conv.weight"] = as_tensor(state[f"{src}.downsample.0.weight"])
                put_batch_norm(out, state, f"{src}.downsample.1", f"{dst}.downsample_bn")
    return out


def import_torch_avhubert(state: Mapping, cfg: AVHubertConfig) -> Dict[str, torch.Tensor]:
    """A fairseq AV-HuBERT ``model`` state dict as ``AVHubertModel``'s state
    dict: the ResNet (``map_resnet``), the projections, the LayerNorms and
    the transformer with its weight-normed positional conv folded.  The
    audio stream's ``audio_proj`` is read and returned, as the JAX import
    does, though this video-only module has no such entry."""
    out = {f"video_resnet.{k}": v
           for k, v in map_resnet(state, "feature_extractor_video.resnet.").items()}
    put_linear(out, state, "feature_extractor_video.proj", "video_proj")
    put_linear(out, state, "feature_extractor_audio.proj", "audio_proj")
    put_norm(out, state, "layer_norm", "layer_norm")
    if "post_extract_proj.weight" in state:
        put_linear(out, state, "post_extract_proj", "post_extract_proj")
    put_pos_conv(out, state, "encoder.pos_conv.0", "encoder.pos_conv.conv")
    put_norm(out, state, "encoder.layer_norm", "encoder.layer_norm")
    put_transformer_layers(out, state, "encoder", "encoder", cfg.encoder_layers)
    return out
