"""Standalone HiFi-GAN vocoder: inference and the GAN training step.

Port of ``multimodalvc_tpu/models/vocoder.py``.  ``VocoderModel.generate``
takes a mel [B, T, 128] to a waveform [B, T * 160].  Training
(``init_state``, then ``train_step``) is the JAX step, eagerly:

- the discriminators (``nn/hifigan.py: HifiGanDiscriminator``) update on the
  real waveform and the detached fake, the spectral norm's power iteration
  on the real pass only; the LS-GAN loss;
- the generator then updates through the *updated* discriminators on 45 x
  the mel L1 (``ops/stft.py: hifigan_log_mel`` of the fake and the real
  waveform) + feature matching + the adversarial loss;
- each side has its own ``optax.adamw`` (``runtime/trainer.py: AdamW``:
  betas (0.8, 0.99), weight decay 1e-5 on every leaf) with the staircase
  decay lr * 0.999 ** (updates // steps_per_epoch) of its own count;
- then the EMA of the generator, ema = 0.999 ema + 0.001 params, in f32;
  ``valid_step`` scores the EMA generator.

The generator runs once a step: the JAX step runs it twice on the same
parameters (once for the detached fake, once under the generator's
gradient), which gives the same fake.  Both modules train through f32
masters (``trainable_leaves``).  ``import_torch_checkpoint`` loads a
reference generator checkpoint (a raw state dict, ``{"generator": ...}``,
or a trainer's dict with ``ema_generator``) with ``torch.load(...,
weights_only=True)``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from ..criterions.gan import discriminator_update_, generator_gan_loss, step_metrics
from ..nn.hifigan import (
    HifiGanConfig,
    HifiGanDiscriminator,
    HifiGanGenerator,
    import_torch_generator,
)
from ..nn.init import init_random_
from ..ops.stft import hifigan_log_mel
from ..runtime.trainer import (
    AdamW,
    apply_gradients_,
    copy_masters_,
    exponential_decay,
    trainable_leaves,
)


@dataclass
class VocoderConfig:
    generator: HifiGanConfig = field(default_factory=HifiGanConfig)
    lr: float = 1e-4
    betas: Tuple[float, float] = (0.8, 0.99)
    weight_decay: float = 1e-5
    lr_decay: float = 0.999  # per-epoch exponential decay
    steps_per_epoch: int = 1000  # the updates between two decays
    mel_weight: float = 45.0
    ema_decay: float = 0.999
    segment_length: int = 8320
    sample_rate: int = 16000
    # the discriminator stack (the reference's: MPD periods 2, 3, 5, 7, 11 and
    # a 3-scale MSD at widths up to 1024); smaller values build a test stack
    disc_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    disc_scales: int = 3
    disc_channels_cap: int = 1024


class VocoderModel:
    """The generator, built on ``device`` (the card unless the caller passes
    "cpu") in ``dtype``; its flax ``params`` load through the bridge into
    ``generator`` (``interop/from_flax.py: load_flax_variables``).
    ``init_state`` adds what training needs."""

    def __init__(self, cfg: VocoderConfig = None, dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg or VocoderConfig()
        self.device = torch.device(device)
        self.generator = HifiGanGenerator(self.cfg.generator, device=device, dtype=dtype).eval()
        self.discriminator: Optional[HifiGanDiscriminator] = None

    def init_random(self, seed: int = 0) -> None:
        """Random weights from ``seed`` (``init_random_``): each g = ||v||."""
        init_random_(self.generator, seed)

    # -- training state --------------------------------------------------------

    def init_state(self, seed: int = 0) -> None:
        """The GAN state of the JAX ``init_state``: the discriminators (f32,
        random from ``seed``, their spectral vectors included), the f32
        masters and an AdamW of each side, the EMA (a copy of the
        generator's current weights) and the step count."""
        cfg = self.cfg
        self.discriminator = HifiGanDiscriminator(
            tuple(cfg.disc_periods), cfg.disc_scales, cfg.disc_channels_cap,
            device=self.device, dtype=torch.float32).eval()
        init_random_(self.discriminator, seed)
        self.reset_optimizers()

    def reset_optimizers(self) -> None:
        """Masters, optimizers and EMA from the modules' current weights
        (after a load of either module)."""
        cfg = self.cfg
        schedule = exponential_decay(cfg.lr, cfg.steps_per_epoch, cfg.lr_decay)
        _, self.gen_params, self.gen_master = trainable_leaves(self.generator, [])
        _, self.disc_params, self.disc_master = trainable_leaves(self.discriminator, [])
        self.gen_opt = AdamW(self.gen_master, schedule, cfg.betas, cfg.weight_decay)
        self.disc_opt = AdamW(self.disc_master, schedule, cfg.betas, cfg.weight_decay)
        self.ema = {n: m.clone() for n, m in self.gen_master.items()}
        self.step = 0

    # -- steps -------------------------------------------------------------------

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One GAN step on mel [B, T, 128] (natural-log) and wav [B, T * 160,
        1]: loss_gen, loss_disc, loss_mel, loss_fm and loss_adv."""
        cfg = self.cfg
        mel = batch["mel"].to(self.generator.conv_pre.v.dtype)
        wav = batch["wav"].float()
        fake = self.generator(mel).float()
        d_loss = discriminator_update_(self.discriminator, self.disc_params, self.disc_master,
                                       self.disc_opt, wav, fake)
        g_loss, aux = generator_gan_loss(self.discriminator, fake, wav, cfg.mel_weight,
                                         cfg.sample_rate)
        apply_gradients_(g_loss, self.gen_params, self.gen_master, self.gen_opt)
        with torch.no_grad():
            for n, e in self.ema.items():
                e.copy_(e * cfg.ema_decay + self.gen_master[n] * (1.0 - cfg.ema_decay))
        self.step += 1
        return step_metrics(g_loss, d_loss, aux)

    @torch.no_grad()
    def valid_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The mel L1 of the EMA generator's waveform against the real one."""
        mel = batch["mel"].to(self.generator.conv_pre.v.dtype)
        ema = {n: e.to(self.gen_params[n].dtype) for n, e in self.ema.items()}
        fake = functional_call(self.generator, ema, (mel,)).float()
        sr = self.cfg.sample_rate
        mel_l1 = (hifigan_log_mel(fake[..., 0], sr=sr)
                  - hifigan_log_mel(batch["wav"][..., 0].float(), sr=sr)).abs().mean()
        return {"mel_l1": float(mel_l1)}

    @torch.inference_mode()
    def generate(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, 128] (cast to the generator's dtype) -> waveform [B, T * 160]."""
        return self.generator(mel.to(self.generator.conv_pre.v.dtype))[..., 0]

    # -- checkpoints ---------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """generator and discriminator (the f32 masters, the spectral
        buffers), both optimizers, the EMA and the step."""
        disc = dict(self.discriminator.state_dict())
        disc.update(self.disc_master)
        return {"generator": dict(self.gen_master), "discriminator": disc,
                "gen_opt": self.gen_opt.state_dict(), "disc_opt": self.disc_opt.state_dict(),
                "ema": self.ema, "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        with torch.no_grad():
            for n, x in state["generator"].items():
                self.gen_master[n].copy_(x)
            own = self.discriminator.state_dict()
            for n, x in state["discriminator"].items():
                (self.disc_master if n in self.disc_master else own)[n].copy_(x)
            for n, x in state["ema"].items():
                self.ema[n].copy_(x)
        copy_masters_(self.gen_params, self.gen_master)
        copy_masters_(self.disc_params, self.disc_master)
        self.gen_opt.load_state_dict(state["gen_opt"])
        self.disc_opt.load_state_dict(state["disc_opt"])
        self.step = int(state["step"])

    def import_torch_checkpoint(self, path: str, use_ema: bool = True) -> Dict[str, torch.Tensor]:
        """Load a reference vocoder .pt into ``generator``: a raw state dict,
        ``{"generator": ...}`` or ``{"model": ...}``, or a trainer's dict
        whose ``ema_generator`` is taken first with ``use_ema``; a DDP
        ``module.`` prefix is dropped.  Returns the loaded state_dict."""
        raw = torch.load(path, map_location="cpu", weights_only=True)
        state = raw
        for key in (("ema_generator",) if use_ema else ()) + ("generator", "model"):
            if isinstance(raw.get(key), dict):
                state = raw[key]
                break
        flat = {k.removeprefix("module."): v for k, v in _flatten(state).items()}
        sd = import_torch_generator(flat, self.cfg.generator)
        self.generator.load_state_dict(sd, strict=True)
        return sd


def _flatten(state, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict of tensors as one flat dict of "."-joined names."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out
