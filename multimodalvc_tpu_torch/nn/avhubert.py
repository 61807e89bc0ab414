"""AV-HuBERT encoder: the lip-reading backbone of the AVSR system and the
trunk of the masked-prediction pretraining.

Port of ``multimodalvc_tpu/nn/avhubert.py:AVHubertModel``: the audio stream
(a linear projection of the stacked log filterbanks, ``audio_proj``) and
the video stream (the ResNet front end -> ``video_proj``); a missing stream
contributes zeros; the "concat" fuse (audio first) -> LayerNorm(2D) ->
``post_extract_proj``, or the "add" fuse -> LayerNorm(D); then a
wav2vec2-style transformer, pre-LN or post-LN.  ``features(train=True)``
runs the ResNet's BatchNorms on batch statistics (the pretraining model's
forward).

Flax creates ``audio_proj`` only where audio reaches the init: the AVSR
system's video-only encoder has no such leaf, the pretraining model has
one.  The port says which by ``audio`` at construction, so each caller's
state dict holds its JAX twin's leaves and no other.
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

FUSE_MODES = ("concat", "add")


@dataclass
class AVHubertConfig:
    encoder_embed_dim: int = 1024  # large
    encoder_layers: int = 24
    encoder_attention_heads: int = 16
    encoder_ffn_dim: int = 4096
    audio_feat_dim: int = 104  # 26-dim fbank x 4-frame stack
    modality_fuse: str = "concat"
    layer_norm_first: bool = True  # large recipe
    sub_encoder_layers: int = 0  # read by no module, as in the JAX package
    conv_pos: int = 128
    conv_pos_groups: int = 16
    dropout: float = 0.0
    resnet_relu_type: str = "prelu"
    remat: bool = False  # rematerialise each encoder layer in the backward
    sequence_parallel: bool = False  # ring attention over the mesh's sequence axis

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


def check_ported(cfg: AVHubertConfig) -> None:
    """Raise for the options the port does not run."""
    if cfg.modality_fuse not in FUSE_MODES:
        raise ValueError(f"modality_fuse {cfg.modality_fuse!r} not in {FUSE_MODES}")


class AVHubertModel(nn.Module):
    """``audio``: whether the audio stream exists (``audio_proj``), as the
    flax init creates it only when given audio.  On a tensor axis the two
    projections are row-parallel with no column partner (the JAX rule for
    ``o_proj`` matches their names): each rank takes its slice of the
    input features."""

    TENSOR_FORMS = {"video_proj": "row_scatter", "audio_proj": "row_scatter"}

    def __init__(self, cfg: AVHubertConfig, audio: bool = False, device=None, dtype=None):
        super().__init__()
        check_ported(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        d = cfg.encoder_embed_dim
        self.video_resnet = ResEncoder(cfg.resnet_relu_type, **kw)
        self.video_proj = nn.Linear(512, d, **kw)
        if audio:
            self.audio_proj = nn.Linear(cfg.audio_feat_dim, d, **kw)
        fused = 2 * d if cfg.modality_fuse == "concat" else d
        self.layer_norm = nn.LayerNorm(fused, eps=1e-5, **kw)
        if fused != d:
            self.post_extract_proj = nn.Linear(fused, d, **kw)
        self.encoder = TransformerEncoder(
            d, cfg.encoder_layers, cfg.encoder_attention_heads, cfg.encoder_ffn_dim,
            dropout=cfg.dropout, layer_norm_first=cfg.layer_norm_first, conv_pos=cfg.conv_pos,
            conv_pos_groups=cfg.conv_pos_groups, sequence_parallel=cfg.sequence_parallel,
            remat=cfg.remat, **kw)

    def features(self, audio: Optional[torch.Tensor], video: Optional[torch.Tensor],
                 train: bool = False) -> torch.Tensor:
        """The fused front end: [B, T, D] after the LayerNorm (and
        ``post_extract_proj`` for the concat fuse)."""
        if audio is None and video is None:
            raise ValueError("at least one modality required")
        if audio is not None and not hasattr(self, "audio_proj"):
            raise ValueError("this AV-HuBERT was built without the audio stream (audio=False)")
        v = None if video is None else self.video_proj(self.video_resnet(video, train))
        a = None if audio is None else self.audio_proj(audio.to(self.audio_proj.weight.dtype))
        a = torch.zeros_like(v) if a is None else a
        v = torch.zeros_like(a) if v is None else v
        # the reference concatenates audio first
        x = torch.cat([a, v], dim=-1) if self.cfg.modality_fuse == "concat" else a + v
        x = self.layer_norm(x)
        return self.post_extract_proj(x) if hasattr(self, "post_extract_proj") else x

    def forward(self, audio: Optional[torch.Tensor] = None, video: Optional[torch.Tensor] = None,
                *, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The evaluation forward (the AVSR system's frozen encoder)."""
        return self.encoder(self.features(audio, video), lengths=lengths)


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
    does, though a video-only module (``audio=False``) has no such entry."""
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
