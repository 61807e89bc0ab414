"""The E2E GAN trainer: HiFi-GAN losses over the whole speech model.

Port of ``multimodalvc_tpu/criterions/gan.py``: ``E2EGanTrainer`` owns the
step of a waveform-emitting model (``models/speech.py: SpeechE2EModel``)
with two optimizers, as the JAX trainer does in one compiled step:

1. one training forward of the model (dropout from the trainer's
   generator, the Conformer's BatchNorm on batch statistics) to the
   waveform, cut with the real one to t = min(predicted, real) samples;
2. the discriminators update on the real waveform (the spectral norm's power
   iteration on this pass only) and the detached prediction;
3. the generator loss, 45 x the mel L1 + feature matching + adversarial,
   through the *updated* discriminators, is differentiated back through the
   same forward (the JAX ``jax.vjp`` of step 1: one forward and one
   backward a step, no second forward).

Each side has a plain ``optax.adamw`` at a constant learning rate (betas
(0.8, 0.99), weight decay 1e-5).  The model's side is masked by the
stage's frozen patterns (the JAX ``multi_transform`` with ``set_to_zero``):
a frozen leaf takes no gradient and no update.  The trainable leaves train
through f32 masters, so the trunk may run in bf16 beside an f32 generator;
the discriminators and the STFT are f32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..nn.hifigan import (
    HifiGanDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_adv_loss,
)
from ..nn.init import init_random_
from ..ops.stft import hifigan_log_mel
from ..runtime.trainer import (
    AdamW,
    apply_gradients_,
    copy_masters_,
    no_weight_grad,
    trainable_leaves,
)
from .mel import compute_mcd, compute_ssim


def discriminator_update_(disc: HifiGanDiscriminator, params, masters, opt: AdamW,
                          real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """The discriminators' half of a GAN step: the LS-GAN loss on the real
    waveform (the spectral norm's power iteration runs on this pass) and on
    the detached fake, then one ``opt`` update of ``masters``.  Returns the
    loss."""
    scores_real, _ = disc(real, update_sn=True)
    scores_fake, _ = disc(fake.detach())
    loss = discriminator_loss(scores_real, scores_fake)
    apply_gradients_(loss, params, masters, opt)
    return loss


def generator_gan_loss(disc: HifiGanDiscriminator, fake: torch.Tensor, real: torch.Tensor,
                       mel_weight: float, sample_rate: int = 16000):
    """The generator's half: mel_weight x the mel L1 of the two waveforms'
    log-mels + feature matching + the adversarial loss, through ``disc``
    (whose weights take no gradient: the loss reaches ``fake`` only).
    Returns (total, {"loss_mel", "loss_fm", "loss_adv"})."""
    with no_weight_grad(disc):
        with torch.no_grad():
            mel_real = hifigan_log_mel(real[..., 0], sr=sample_rate)
            _, feats_real = disc(real)
        loss_mel = (hifigan_log_mel(fake[..., 0], sr=sample_rate) - mel_real).abs().mean()
        scores_fake, feats_fake = disc(fake)
        loss_fm = feature_loss(feats_real, feats_fake)
        loss_adv = generator_adv_loss(scores_fake)
    total = mel_weight * loss_mel + loss_fm + loss_adv
    return total, {"loss_mel": loss_mel, "loss_fm": loss_fm, "loss_adv": loss_adv}


def step_metrics(g_loss, d_loss, aux) -> Dict[str, float]:
    """A GAN step's losses as Python numbers."""
    out = {"loss_gen": g_loss, "loss_disc": d_loss, **aux}
    return {k: float(v.detach()) for k, v in out.items()}


@dataclass
class E2EGanConfig:
    mel_weight: float = 45.0
    gen_lr: float = 2e-4
    disc_lr: float = 2e-4
    betas: Tuple[float, float] = (0.8, 0.99)
    weight_decay: float = 1e-5
    # the discriminator stack (see models/vocoder.py: VocoderConfig)
    disc_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    disc_scales: int = 3
    disc_channels_cap: int = 1024


class E2EGanTrainer:
    """The dual-optimizer GAN step of ``model`` (batch -> {"waveform",
    "mel_lengths"}, with ``train`` and ``generator`` arguments), the leaves
    that ``frozen_patterns`` match held still.  The discriminators are built
    on the model's device in f32, random from ``seed``, as is the dropout
    generator."""

    def __init__(self, cfg: E2EGanConfig, model: torch.nn.Module,
                 frozen_patterns: Optional[List[str]] = None, seed: int = 0):
        self.cfg, self.model = cfg, model
        device = next(model.parameters()).device
        self.discriminator = HifiGanDiscriminator(
            tuple(cfg.disc_periods), cfg.disc_scales, cfg.disc_channels_cap,
            device=device, dtype=torch.float32).eval()
        init_random_(self.discriminator, seed)
        self.frozen_patterns = list(frozen_patterns or [])
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.reset_optimizers()

    def reset_optimizers(self) -> None:
        """Masters and optimizers from the modules' current weights (after a
        load of either), and the step count 0."""
        cfg = self.cfg
        self.mask, self.gen_params, self.gen_master = trainable_leaves(
            self.model, self.frozen_patterns)
        _, self.disc_params, self.disc_master = trainable_leaves(self.discriminator, [])
        self.gen_opt = AdamW(self.gen_master, lambda _: cfg.gen_lr, cfg.betas, cfg.weight_decay)
        self.disc_opt = AdamW(self.disc_master, lambda _: cfg.disc_lr, cfg.betas,
                              cfg.weight_decay)
        self.step = 0

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One step: loss_gen, loss_disc, loss_mel, loss_fm and loss_adv."""
        pred = self.model(batch, train=True, generator=self.generator)["waveform"].float()
        gt = batch["waveform"].float()
        t = min(pred.shape[1], gt.shape[1])
        pred, gt = pred[:, :t], gt[:, :t]
        d_loss = discriminator_update_(self.discriminator, self.disc_params, self.disc_master,
                                       self.disc_opt, gt, pred)
        g_loss, aux = generator_gan_loss(self.discriminator, pred, gt, self.cfg.mel_weight)
        apply_gradients_(g_loss, self.gen_params, self.gen_master, self.gen_opt)
        self.step += 1
        return step_metrics(g_loss, d_loss, aux)

    @torch.no_grad()
    def synthesize(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The evaluation waveform of one batch [B, max_mel_frames * 160, 1]."""
        return self.model(batch, train=False)["waveform"]

    @torch.no_grad()
    def valid_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """mel_l1, mcd and ssim of the evaluation waveform's log-mel against
        the real waveform's, over t = min(predicted, real) samples."""
        wav = self.synthesize(batch).float()
        gt = batch["waveform"].float()
        t = min(wav.shape[1], gt.shape[1])
        mel_pred, mel_gt = hifigan_log_mel(wav[:, :t, 0]), hifigan_log_mel(gt[:, :t, 0])
        return {"mel_l1": float((mel_pred - mel_gt).abs().mean()),
                "mcd": float(compute_mcd(mel_pred, mel_gt)),
                "ssim": float(compute_ssim(mel_pred, mel_gt))}

    # -- checkpoints ---------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """model (the trainable leaves' f32 masters and every other entry of
        its state_dict: the frozen leaves, the BatchNorm statistics),
        discriminator (masters and spectral buffers), both optimizers, the
        step and the dropout generator's state."""
        model = {n: x for n, x in self.model.state_dict().items() if n not in self.gen_master}
        model.update(self.gen_master)
        disc = {n: x for n, x in self.discriminator.state_dict().items()
                if n not in self.disc_master}
        disc.update(self.disc_master)
        return {"model": model, "discriminator": disc, "gen_opt": self.gen_opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict(), "step": self.step,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        with torch.no_grad():
            for key, module, masters in (("model", self.model, self.gen_master),
                                         ("discriminator", self.discriminator, self.disc_master)):
                own = module.state_dict()
                for n, x in state[key].items():
                    (masters if n in masters else own)[n].copy_(x)
        copy_masters_(self.gen_params, self.gen_master)
        copy_masters_(self.disc_params, self.disc_master)
        self.gen_opt.load_state_dict(state["gen_opt"])
        self.disc_opt.load_state_dict(state["disc_opt"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"].cpu())
