"""The port's vocoder GAN step against the JAX package's
(``models/vocoder.py``) at tests/test_vocoder_train.py's tiny generator (32
channels, x160, one MRF kernel) and a test discriminator stack
(``channels_cap`` 16, periods (2, 3), three scales), in f32: three steps
with each loss term, both sides' leaves, the spectral vectors and the EMA
after, the learning rate across a decay boundary (two updates an epoch),
``valid_step``; a checkpoint round trip that resumes to the same steps;
``import_torch_checkpoint`` on a synthetic reference checkpoint in its three
layouts; and the restored configuration fields."""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import t, to_numpy_tree

from multimodalvc_tpu.models import vocoder as jvoc
from multimodalvc_tpu.nn import conformer as jconf
from multimodalvc_tpu.nn import hifigan as jhg
from multimodalvc_tpu.ops.stft import hifigan_log_mel
from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict, load_flax_variables
from multimodalvc_tpu_torch.models import vocoder as tvoc
from multimodalvc_tpu_torch.nn import conformer as tconf
from multimodalvc_tpu_torch.nn import hifigan as thg
from multimodalvc_tpu_torch.runtime.checkpoint import CheckpointManager

# f32 GAN steps summed in other orders.  Both sides' AdamW take eps 1e-6 in
# the parity runs (the config has no eps; optax's default is 1e-8): at 1e-8
# the first update moves every element by lr times the sign of its gradient,
# and one conv_pre element whose gradient is rounding-sized flips between
# the packages (2e-3 of the generator's move after one step), which the GAN
# carries to 3e-3 in the losses by step 3; at 1e-6 the losses agree to ~3e-6
# through step 3.  Each loss term to rel 1e-5; the leaves' change over three
# steps to rel L2 2e-3 on each side and per leaf to 1e-2 of its move plus
# 1e-4 of the side's (Adam's normalisation, as
# tests/test_torch_speech_train.py); the EMA by value, to 4 f32 ulps of its
# largest element (its change, 1e-3 of the generator's a step, sits at the
# rounding of 0.999 x ema: measured 3.6e-7 at |ema| 2.2); the spectral
# vectors to 1e-5
ADAM_EPS = 1e-6
LOSS_RTOL, PARAM_RTOL, LEAF_RTOL, FLOOR, SN_TOL = 1e-5, 2e-3, 1e-2, 1e-4, 1e-5
GEN = dict(in_channels=128, upsample_initial_channel=32, upsample_factors=(10, 4, 2, 2),
           upsample_kernel_sizes=(20, 8, 4, 4), resblock_kernel_sizes=(3,),
           resblock_dilations=((1, 3, 5),))
DISC = dict(disc_periods=(2, 3), disc_scales=3, disc_channels_cap=16)
STEPS = 3


def configs(**kw):
    j = jvoc.VocoderConfig(generator=jhg.HifiGanConfig(**GEN), segment_length=1600,
                           steps_per_epoch=2, lr=1e-3, **DISC, **kw)
    p = tvoc.VocoderConfig(generator=thg.HifiGanConfig(**GEN), segment_length=1600,
                           steps_per_epoch=2, lr=1e-3, **DISC, **kw)
    return j, p


def make_batch(b=2, segment=1600, seed=0):
    wav = (np.random.default_rng(seed).standard_normal((b, segment)) * 0.1).astype(np.float32)
    return {"mel": np.asarray(hifigan_log_mel(jnp.asarray(wav))), "wav": wav[..., None]}


def port_model(jcfg_state, pcfg):
    """The port's VocoderModel on the JAX state's weights."""
    state = jcfg_state
    voc = tvoc.VocoderModel(pcfg, device="cpu")
    load_flax_variables(voc.generator, {"params": to_numpy_tree(state.gen_params)})
    voc.init_state(0)
    load_flax_variables(voc.discriminator, {"params": to_numpy_tree(state.disc_params),
                                            "spectral": to_numpy_tree(state.spectral)})
    voc.reset_optimizers()
    return voc


@pytest.fixture(scope="module")
def runs():
    jcfg, pcfg = configs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvoc, "optax", types.SimpleNamespace(
            exponential_decay=optax.exponential_decay,
            adamw=functools.partial(optax.adamw, eps=ADAM_EPS)))
        mp.setattr(tvoc, "AdamW", functools.partial(tvoc.AdamW, eps=ADAM_EPS))
        jm = jvoc.VocoderModel(jcfg)
        state = jm.init_state(jax.random.PRNGKey(0), mel_frames=10)
        voc = port_model(state, pcfg)
    assert voc.gen_opt.eps == voc.disc_opt.eps == ADAM_EPS
    batch = make_batch()
    step = jax.jit(jm.train_step)
    jstates, jmetrics, tmetrics = [state], [], []
    for _ in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jstates.append(state)
        jmetrics.append({k: float(v) for k, v in m.items()})
        tmetrics.append(voc.train_step({k: t(v) for k, v in batch.items()}))
    return jm, jstates, jmetrics, voc, tmetrics, batch


def test_losses_match_jax(runs):
    _, _, jmetrics, _, tmetrics, _ = runs
    for i, (want, got) in enumerate(zip(jmetrics, tmetrics)):
        assert set(got) == set(want) == {"loss_gen", "loss_disc", "loss_mel", "loss_fm",
                                         "loss_adv"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                       err_msg=f"step {i + 1} {k}")


def _compare_side(want, got, start):
    """The leaves' change (flax trees, as state_dicts) to PARAM_RTOL as a
    whole and LEAF_RTOL + FLOOR per leaf."""
    rows = [(n, float((want[n] - start[n]).double().norm()),
             float((got[n].double() - want[n].double()).norm())) for n in want]
    total = sum(m * m for _, m, _ in rows) ** 0.5
    assert total > 0
    assert sum(e * e for *_, e in rows) ** 0.5 <= PARAM_RTOL * total
    for n, moved, err in rows:
        assert err <= LEAF_RTOL * moved + FLOOR * total, (n, err, moved)


def test_leaves_and_ema_match_jax(runs):
    _, jstates, _, voc, _, _ = runs
    first, last = jstates[0], jstates[-1]
    sd = lambda tree: flax_to_state_dict({"params": to_numpy_tree(tree)})  # noqa: E731
    _compare_side(sd(last.gen_params), voc.gen_master, sd(first.gen_params))
    _compare_side(sd(last.disc_params), voc.disc_master, sd(first.disc_params))
    for n, e in sd(last.ema_params).items():
        bound = 4 * np.finfo(np.float32).eps * max(1.0, float(e.abs().max()))
        assert float((voc.ema[n] - e).abs().max()) <= bound, n
    assert any(not torch.equal(voc.ema[n], e) for n, e in sd(first.ema_params).items())
    # the generator module holds its masters
    for n, p in voc.gen_params.items():
        assert torch.equal(p, voc.gen_master[n])
    spectral = flax_to_state_dict({"params": to_numpy_tree(last.disc_params),
                                   "spectral": to_numpy_tree(last.spectral)})
    for k, x in voc.discriminator.state_dict().items():
        if ".sn_" in k:
            assert float((x - spectral[k]).abs().max()) < SN_TOL, k
    assert voc.step == int(last.step) == STEPS


def test_learning_rate_decays_at_the_epoch_boundary(runs):
    """Two updates an epoch: updates 1-2 at lr, update 3 at lr * 0.999, the
    count each optimizer's own (optax's staircase exponential_decay)."""
    jm, *_ , voc, _, _ = runs
    sched = optax.exponential_decay(1e-3, transition_steps=2, decay_rate=0.999, staircase=True)
    for count in range(7):
        np.testing.assert_allclose(voc.gen_opt.schedule(count), float(sched(count)), rtol=1e-6)
    assert voc.gen_opt.count == voc.disc_opt.count == STEPS
    assert voc.gen_opt.lr == pytest.approx(1e-3 * 0.999)


def test_valid_step_matches_jax(runs):
    jm, jstates, _, voc, _, batch = runs
    want = jm.valid_step(jstates[-1], {k: jnp.asarray(v) for k, v in batch.items()})
    got = voc.valid_step({k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(got["mel_l1"], float(want["mel_l1"]), rtol=1e-4)


def test_checkpoint_resumes_to_the_same_steps(tmp_path):
    """state_dict -> CheckpointManager -> a fresh model: the next two steps
    are bit for bit those of the model that went on."""
    jcfg, pcfg = configs()
    state = jvoc.VocoderModel(jcfg).init_state(jax.random.PRNGKey(1), mel_frames=10)
    batch = {k: t(v) for k, v in make_batch(seed=2).items()}
    a = port_model(state, pcfg)
    a.train_step(batch)
    manager = CheckpointManager(str(tmp_path / "voc"))
    manager.save(a.state_dict(), a.step)
    b = tvoc.VocoderModel(pcfg, device="cpu")
    b.init_state(5)
    b.load_state_dict(manager.restore())
    assert b.step == a.step == 1
    for _ in range(2):
        assert a.train_step(batch) == b.train_step(batch)
    for sa, sb in ((a.generator, b.generator), (a.discriminator, b.discriminator)):
        for (n, x), y in zip(sa.state_dict().items(), sb.state_dict().values()):
            assert torch.equal(x, y), n
    assert all(torch.equal(a.ema[n], b.ema[n]) for n in a.ema)


def _reference_generator_state(voc, seed=3):
    """A reference (soft-vc) generator state dict of ``voc``'s shapes."""
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, x in voc.generator.state_dict().items():
        mod, leaf = name.rsplit(".", 1)
        src = mod.replace("ups_", "ups.").replace("resblocks_", "resblocks.") \
            .replace(".convs1_", ".convs1.").replace(".convs2_", ".convs2.")
        if leaf == "v":
            state[f"{src}.weight_v"] = torch.randn(x.shape, generator=g)
        elif leaf == "g":
            state[f"{src}.weight_g"] = torch.rand(x.shape[0], 1, 1, generator=g) + 0.5
        else:
            state[f"{src}.{leaf}"] = torch.randn(x.shape, generator=g)
    return state


@pytest.mark.parametrize("layout", ["raw", "generator", "trainer_ema", "ddp"])
def test_import_torch_checkpoint_matches_jax(tmp_path, layout):
    jcfg, pcfg = configs()
    voc = tvoc.VocoderModel(pcfg, device="cpu")
    ref = _reference_generator_state(voc)
    other = _reference_generator_state(voc, seed=4)
    saved = {"raw": ref, "generator": {"generator": ref},
             "trainer_ema": {"generator": other, "ema_generator": ref},
             "ddp": {"model": {f"module.{k}": v for k, v in ref.items()}}}[layout]
    path = str(tmp_path / "v.pt")
    torch.save(saved, path)
    got = voc.import_torch_checkpoint(path)
    want = flax_to_state_dict(to_numpy_tree(jvoc.VocoderModel(jcfg).import_torch_checkpoint(path)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    assert torch.equal(voc.generator.conv_pre.v, ref["conv_pre.weight_v"])
    if layout == "trainer_ema":  # use_ema=False takes the generator
        voc.import_torch_checkpoint(path, use_ema=False)
        assert torch.equal(voc.generator.conv_pre.v, other["conv_pre.weight_v"])


def test_restored_config_fields_match_jax():
    """The fields the training code reads are back, with the JAX defaults:
    VocoderConfig's training fields and ConformerConfig.dropout_rate.
    HifiGanConfig.sample_rate stays out: no code of either package reads it
    (the STFT's rate is VocoderConfig.sample_rate).  The Conformer's
    moe_capacity_factor came back with the expert FFN."""
    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)
                if f.default is not dataclasses.MISSING}

    assert fields(tvoc.VocoderConfig) == fields(jvoc.VocoderConfig)
    assert fields(tconf.ConformerConfig) == fields(jconf.ConformerConfig)
    want = fields(jhg.HifiGanConfig)
    del want["sample_rate"]
    assert fields(thg.HifiGanConfig) == want


def test_vocoder_task_prepare_batch_matches_jax():
    """VocoderTask: the segment's mel frames and samples, as the JAX task
    cuts them."""
    from multimodalvc_tpu import tasks as jtasks
    from multimodalvc_tpu_torch import tasks as ttasks

    rng = np.random.default_rng(9)
    batch = {"target_mel": rng.standard_normal((2, 70, 128)).astype(np.float32),
             "waveform": rng.standard_normal((2, 11000, 1)).astype(np.float32)}
    jtask = jtasks.VocoderTask(jtasks.VocoderTaskConfig(segment_length=3200, lr=3e-4))
    ttask = ttasks.VocoderTask(ttasks.VocoderTaskConfig(segment_length=3200, lr=3e-4),
                               device="cpu")
    assert ttask.model_cfg.lr == jtask.model_cfg.lr == 3e-4
    assert ttask.model_cfg.segment_length == jtask.model_cfg.segment_length == 3200
    want = jtask.prepare_batch(batch)
    got = ttask.prepare_batch({k: t(v) for k, v in batch.items()})
    assert set(got) == set(want) == {"mel", "wav"}
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())
    assert got["mel"].shape == (2, 20, 128) and got["wav"].shape == (2, 3200, 1)
