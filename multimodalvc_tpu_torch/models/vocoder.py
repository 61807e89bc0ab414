"""Standalone HiFi-GAN vocoder, inference half.

Port of ``multimodalvc_tpu/models/vocoder.py``: ``VocoderModel.generate``
takes a mel [B, T, 128] to a waveform [B, T * 160].  The GAN training step,
its optimizer, the discriminators and the torch-checkpoint import are not
ported yet, nor the config fields that only they read.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..nn.hifigan import HifiGanConfig, HifiGanGenerator
from ..nn.init import init_random_


@dataclass
class VocoderConfig:
    generator: HifiGanConfig = field(default_factory=HifiGanConfig)


class VocoderModel:
    """The generator, built on ``device`` (the card unless the caller passes
    "cpu") in ``dtype``; its flax ``params`` load through the bridge into
    ``generator`` (``interop/from_flax.py: load_flax_variables``)."""

    def __init__(self, cfg: VocoderConfig = None, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or VocoderConfig()
        self.generator = HifiGanGenerator(self.cfg.generator, device=device, dtype=dtype).eval()

    def init_random(self, seed: int = 0) -> None:
        """Random weights from ``seed`` (``init_random_``): each g = ||v||."""
        init_random_(self.generator, seed)

    @torch.inference_mode()
    def generate(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, 128] (cast to the generator's dtype) -> waveform [B, T * 160]."""
        return self.generator(mel.to(self.generator.conv_pre.v.dtype))[..., 0]
