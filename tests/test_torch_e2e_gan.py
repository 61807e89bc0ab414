"""The port's E2E GAN trainer against the JAX package's
(``criterions/gan.py``, ``tasks.py: E2EGanTask``) at SpeechConfig.tiny()
with 20 mel frames, a 32-channel generator and the test discriminator stack
(``channels_cap`` 16, periods (2, 3), three scales), in f32: the two halves
of a step on a given waveform (the discriminators' update; the generator
loss and its gradient with respect to the waveform), then whole steps of
stage 1 (the trunk frozen) and stage 2 (the encoders frozen), with every
dropout rate at 0 on both sides: each loss, which leaves moved, the leaves
and the running statistics after, the trunk unchanged in stage 1; a
checkpoint round trip; ``valid_step`` and ``synthesize``."""
import dataclasses
import functools
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_speech import _batch
from test_torch_speech_train import zero_dropout
from torch_parity import loaded, max_err, randomize, t, to_numpy_tree

from multimodalvc_tpu import tasks as jtasks
from multimodalvc_tpu.criterions import gan as jgan
from multimodalvc_tpu.criterions.mel import compute_mcd, compute_ssim
from multimodalvc_tpu.models import speech as jsp
from multimodalvc_tpu.nn import hifigan as jhg
from multimodalvc_tpu.ops.stft import hifigan_log_mel
from multimodalvc_tpu.runtime import trainer as jtrainer
from multimodalvc_tpu_torch import tasks as ttasks
from multimodalvc_tpu_torch.criterions import gan as tgan
from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict, load_flax_variables
from multimodalvc_tpu_torch.models import speech as tsp
from multimodalvc_tpu_torch.nn import hifigan as thg
from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager
from multimodalvc_tpu_torch.runtime.trainer import AdamW

# f32 through the trunk, the generator, the discriminators and the STFT: the
# halves' losses to rel 1e-5; the waveform gradient of the generator loss to
# 1e-4 of its largest element; one discriminator update's change to rel L2
# 1e-4.  Whole steps: the losses to rel 1e-4 (the generator's terms run
# through the discriminators' first AdamW update, whose rounding-sized
# gradient elements move them 4.9e-5 at step 1); the change of the trainable
# leaves over two steps to rel L2 5e-3 (measured 2.4e-3 in stage 1 and
# 2.5e-3 in stage 2) and per leaf to 5e-2 of its move plus 1e-4 of the whole
# (measured 2.7e-2 on the audio conv after a video-only step, whose gradient
# is zero, then an audio-only one: Adam's normalisation of gradients that
# agree to ~1e-3 in this random setup, where they reach 1e15); both AdamWs at
# eps 1e-3 (at 1e-6, as in tests/test_torch_vocoder_train.py, the leaves
# part by 8e-3 of their move in stage 1 and 1.6e-2 in stage 2); the running
# statistics to 1e-4.  The whole steps take ~70 s a stage on one CPU worker
# (the JAX step's compile), so they are slow-tier; the halves hold the
# step's arithmetic in the default tier.
LOSS_RTOL, STEP_RTOL, GRAD_RTOL, DISC_RTOL = 1e-5, 1e-4, 1e-4, 1e-4
PARAM_RTOL, LEAF_RTOL, FLOOR, STATS_TOL = 5e-3, 5e-2, 1e-4, 1e-4
ADAM_EPS = 1e-3
TASK = dict(vocoder_initial_channels=32, vocoder_resblock_kernels=(3,), disc_periods=(2, 3),
            disc_scales=3, disc_channels_cap=16)
MEL_FRAMES, WAVE = 20, 2500  # the real waveform is shorter than the 3200-sample buffer


def e2e_batch(cfg):
    batch = _batch(cfg)
    rng = np.random.default_rng(4)
    batch["waveform"] = (0.1 * rng.standard_normal((2, WAVE, 1))).astype(np.float32)
    batch["target_mel"] = np.asarray(hifigan_log_mel(jnp.asarray(batch["waveform"][..., 0])))
    batch["target_mel_lengths"] = np.asarray([WAVE // 160, 10], np.int32)
    return batch


def _disc_pair(seed=0):
    """A discriminator stack of one period (2: a reflect pad at 1001
    samples) and two scales (the spectral norm, the average pool), cap 8."""
    jd = jhg.HifiGanDiscriminator(periods=(2,), n_scales=2, channels_cap=8)
    real, fake = (0.2 * np.random.default_rng(seed + i).standard_normal((2, 1001, 1))
                  .astype(np.float32) for i in range(2))
    variables = to_numpy_tree(jd.init(jax.random.PRNGKey(seed), jnp.asarray(real)))
    td = thg.HifiGanDiscriminator((2,), 2, 8, device="cpu")
    load_flax_variables(td, variables)
    return jd, variables, td, real, fake


def test_discriminator_half_matches_jax():
    """The JAX step's disc_loss_fn and its AdamW update on the real and the
    detached fake waveform, against ``discriminator_update_``."""
    jd, variables, td, real, fake = _disc_pair()
    cfg = jgan.E2EGanConfig()
    opt = optax.adamw(cfg.disc_lr, b1=cfg.betas[0], b2=cfg.betas[1],
                      weight_decay=cfg.weight_decay)

    def disc_loss_fn(params, spectral):
        (s_real, _), new = jd.apply({"params": params, "spectral": spectral}, jnp.asarray(real),
                                    update_sn=True, mutable=["spectral"])
        (s_fake, _), _ = jd.apply({"params": params, "spectral": new["spectral"]},
                                  jnp.asarray(fake), mutable=["spectral"])
        return jhg.discriminator_loss(s_real, s_fake), new["spectral"]

    (want_loss, spectral), grads = jax.jit(jax.value_and_grad(disc_loss_fn, has_aux=True))(
        variables["params"], variables["spectral"])
    upd, _ = opt.update(grads, opt.init(variables["params"]), variables["params"])
    want = flax_to_state_dict({"params": to_numpy_tree(optax.apply_updates(
        variables["params"], upd)), "spectral": to_numpy_tree(spectral)})
    start = {n: x.clone() for n, x in td.state_dict().items()}

    params = dict(td.named_parameters())
    masters = {n: p.detach().clone() for n, p in params.items()}
    got_loss = tgan.discriminator_update_(td, params, masters, AdamW(
        masters, lambda _: cfg.disc_lr, cfg.betas, cfg.weight_decay), t(real),
        t(fake).requires_grad_())
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    got = td.state_dict()
    moved = sum(float((want[n] - start[n]).norm()) ** 2 for n in params) ** 0.5
    err = sum(float((got[n] - want[n]).norm()) ** 2 for n in params) ** 0.5
    assert 0 < err <= DISC_RTOL * moved or err == 0
    for n in got:
        if ".sn_" in n:
            assert max_err(want[n].numpy(), got[n]) < 1e-5, n
            assert not torch.equal(got[n], start[n]), n


def test_generator_half_matches_jax():
    """The JAX step's wav_loss_fn (45 x mel L1 + feature matching +
    adversarial through the discriminators) and its gradient with respect to
    the waveform, against ``generator_gan_loss``."""
    jd, variables, td, real, fake = _disc_pair(seed=2)

    def wav_loss_fn(wav):
        mel_pred = hifigan_log_mel(wav[..., 0])
        mel_gt = jax.lax.stop_gradient(hifigan_log_mel(jnp.asarray(real)[..., 0]))
        loss_mel = jnp.mean(jnp.abs(mel_pred - mel_gt))
        s_fake, f_fake = jd.apply(variables, wav)
        _, f_real = jd.apply(variables, jnp.asarray(real))
        loss_fm = jhg.feature_loss(jax.lax.stop_gradient(f_real), f_fake)
        loss_adv = jhg.generator_adv_loss(s_fake)
        return 45.0 * loss_mel + loss_fm + loss_adv, {"loss_mel": loss_mel, "loss_fm": loss_fm,
                                                      "loss_adv": loss_adv}

    (want, aux), want_grad = jax.jit(jax.value_and_grad(wav_loss_fn, has_aux=True))(
        jnp.asarray(fake))
    wav = t(fake).requires_grad_()
    got, got_aux = tgan.generator_gan_loss(td, wav, t(real), 45.0)
    (grad,) = torch.autograd.grad(got, [wav])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    for k in aux:
        np.testing.assert_allclose(float(got_aux[k].detach()), float(aux[k]), rtol=LOSS_RTOL)
    assert max_err(want_grad, grad) <= GRAD_RTOL * float(np.abs(np.asarray(want_grad)).max())
    # the discriminators' weights took no gradient and keep requiring one
    assert all(p.grad is None and p.requires_grad for p in td.parameters())


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(jgan, "optax", types.SimpleNamespace(
        **{k: getattr(optax, k) for k in ("multi_transform", "set_to_zero", "apply_updates")},
        adamw=functools.partial(optax.adamw, eps=ADAM_EPS)))


def _tasks(stage1: bool):
    jcfg = dataclasses.replace(jsp.SpeechConfig.tiny(), max_mel_frames=MEL_FRAMES)
    jtask = jtasks.E2EGanTask(jtasks.E2EGanTaskConfig(stage1_freeze=stage1, **TASK), jcfg)
    batch = e2e_batch(jcfg)
    jtrainer_, state = jtask.make_trainer(jax.random.PRNGKey(0),
                                          {**batch, "modality_mode": np.int32(0)})
    state = state.replace(collections=randomize(state.collections))
    tcfg = dataclasses.replace(tsp.SpeechConfig.tiny(), max_mel_frames=MEL_FRAMES)
    ttask = ttasks.E2EGanTask(ttasks.E2EGanTaskConfig(stage1_freeze=stage1, **TASK), tcfg,
                              device="cpu")
    loaded(ttask.model, {"params": state.gen_params, **state.collections})
    zero_dropout(ttask.model)
    trainer = ttask.make_trainer(seed=0)
    load_flax_variables(trainer.discriminator, {"params": to_numpy_tree(state.disc_params),
                                                "spectral": to_numpy_tree(state.spectral)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgan, "AdamW", functools.partial(AdamW, eps=ADAM_EPS))
        trainer.reset_optimizers()
    return jtask, jtrainer_, state, ttask, trainer, batch


@pytest.mark.slow
@pytest.mark.parametrize("stage1", [True, False], ids=["stage1", "stage2"])
def test_e2e_steps_match_jax(no_jax_dropout, stage1):
    jtask, jt, state, ttask, trainer, batch = _tasks(stage1)
    assert ttask.frozen_patterns() == jtask.frozen_patterns()
    assert trainer.gen_opt.eps == trainer.disc_opt.eps == ADAM_EPS
    init_state = state
    gen_start = {n: m.clone() for n, m in trainer.gen_master.items()}
    frozen = {n: p.clone() for n, p in ttask.model.named_parameters()
              if n not in trainer.gen_master}
    step = jax.jit(jt.train_step)
    for i in range(2):
        jb = jtask.prepare_batch(batch)
        tb = ttask.prepare_batch({k: t(v) for k, v in batch.items()})
        assert int(tb["modality_mode"]) == int(jb["modality_mode"])
        state, jm = step(state, {k: jnp.asarray(v) for k, v in jb.items()})
        tm = trainer.train_step(tb)
        assert set(tm) == set(jm) == {"loss_gen", "loss_disc", "loss_mel", "loss_fm", "loss_adv"}
        for k in jm:
            rtol = LOSS_RTOL if (i, k) == (0, "loss_disc") else STEP_RTOL
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=rtol, err_msg=f"{i} {k}")
    # the model's leaves: the JAX mask's trainable ones moved, the rest did not
    want = flax_to_state_dict({"params": to_numpy_tree(state.gen_params)})
    start = flax_to_state_dict({"params": to_numpy_tree(init_state.gen_params)})
    mask = flax_to_state_dict({"params": jax.tree.map(
        lambda p, m: np.full(np.shape(p), m), to_numpy_tree(init_state.gen_params), jt._frozen_mask)})
    assert set(trainer.gen_master) == {n for n, m in mask.items() if bool(m.all())}
    assert all(n.startswith("generator.") for n in trainer.gen_master) == stage1
    assert any(n.startswith("trunk.head.") for n in trainer.gen_master) != stage1
    assert not any(n.startswith(("trunk.encoder.whisper.", "trunk.encoder.avhubert."))
                   for n in trainer.gen_master)
    for n, p in ttask.model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]) and torch.equal(want[n], start[n]), n
    rows = [(n, float((want[n] - start[n]).norm()), float((m - want[n]).norm()))
            for n, m in trainer.gen_master.items()]
    total = sum(x * x for _, x, _ in rows) ** 0.5
    assert total > 0 and all(not torch.equal(trainer.gen_master[n], gen_start[n])
                             for n in trainer.gen_master if n.startswith("generator.ups_0"))
    assert sum(e * e for *_, e in rows) ** 0.5 <= PARAM_RTOL * total
    for n, moved, err in rows:
        assert err <= LEAF_RTOL * moved + FLOOR * total, (n, err, moved)
    dwant = flax_to_state_dict({"params": to_numpy_tree(state.disc_params)})
    dstart = flax_to_state_dict({"params": to_numpy_tree(init_state.disc_params)})
    dmoved = sum(float((dwant[n] - dstart[n]).norm()) ** 2 for n in trainer.disc_master) ** 0.5
    derr = sum(float((trainer.disc_master[n] - dwant[n]).norm()) ** 2
               for n in trainer.disc_master) ** 0.5
    assert 0 < dmoved and derr <= PARAM_RTOL * dmoved
    # the running statistics moved in both stages (the frozen trunk trains too)
    sd = ttask.model.state_dict()
    for path, stat in jax.tree_util.tree_flatten_with_path(
            to_numpy_tree(state.collections["batch_stats"]))[0]:
        names = [p.key for p in path]
        key = ".".join(names[:-1]) + (".running_mean" if names[-1] == "mean" else ".running_var")
        assert max_err(stat, sd[key]) < STATS_TOL, key


def test_checkpoint_valid_and_synthesize(tmp_path):
    """A checkpoint round trip resumes to the same step bit for bit;
    ``valid_step`` scores the evaluation waveform as the JAX valid_step
    does."""
    cfg = dataclasses.replace(tsp.SpeechConfig.tiny(), max_mel_frames=MEL_FRAMES)
    batch = e2e_batch(cfg)

    def make():
        task = ttasks.E2EGanTask(ttasks.E2EGanTaskConfig(stage1_freeze=False, **TASK),
                                 dataclasses.replace(cfg), device="cpu")
        task.init_random(1)
        return task, task.make_trainer(seed=3)

    task, a = make()
    tb = task.prepare_batch({k: t(v) for k, v in batch.items()})
    a.train_step(tb)
    manager = CheckpointManager(str(tmp_path / "e2e"))
    manager.save(a.state_dict(), a.step)
    _, b = make()
    b.load_state_dict(manager.restore())
    assert a.train_step(tb) == b.train_step(tb)
    for (n, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), n
    wav = a.synthesize(tb)
    assert wav.shape == (2, MEL_FRAMES * 160, 1) and float(wav.abs().max()) <= 1.0
    got = a.valid_step(tb)
    mel_p = hifigan_log_mel(jnp.asarray(wav[:, :WAVE, 0].numpy()))
    mel_g = hifigan_log_mel(jnp.asarray(batch["waveform"][..., 0]))
    want = {"mel_l1": jnp.mean(jnp.abs(mel_p - mel_g)), "mcd": compute_mcd(mel_p, mel_g),
            "ssim": compute_ssim(mel_p, mel_g)}
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, err_msg=k)
