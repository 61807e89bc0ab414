"""Encoder-side parity through the weight bridge: the port's Whisper, ResNet,
AV-HuBERT, speech-rate predictor, Q-Former, projector, resize and prompt
assembly against the flax modules on the same weights and numpy inputs;
and the pretraining forms: post-LN stacks and ``output_layer``, the audio
stream and the "add" fuse, the ResNet in training mode (batch statistics
and the running-statistics update), with each caller's state-dict keys
those of its flax init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import loaded, max_err, randomize, t

from multimodalvc_tpu.models import avsr as javsr
from multimodalvc_tpu.nn import avhubert as javh
from multimodalvc_tpu.nn import modules as jmod
from multimodalvc_tpu.nn import qformer as jqf
from multimodalvc_tpu.nn import resnet as jres
from multimodalvc_tpu.nn import whisper as jwh
from multimodalvc_tpu.ops import interpolate as jinterp
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.nn import avhubert as tavh
from multimodalvc_tpu_torch.nn import modules as tmod
from multimodalvc_tpu_torch.nn import qformer as tqf
from multimodalvc_tpu_torch.nn import resnet as tres
from multimodalvc_tpu_torch.nn import whisper as twh
from multimodalvc_tpu_torch.ops import interpolate as tinterp

# f32 through a few layers of LayerNorm/GELU/conv: the two frameworks differ
# in summation order and in erf/tanh implementations (~1e-6 relative per
# op), which a few layers bring to ~1e-5 of unit-scale activations
TOL = 1e-4
KEY = jax.random.PRNGKey(0)


def _init(flax_module, *args, **kwargs):
    return randomize(jax.jit(flax_module.init)(KEY, *args, **kwargs))


def _apply(flax_module, variables, *args, **kwargs):
    return jax.jit(flax_module.apply)(variables, *args, **kwargs)


@pytest.mark.parametrize("max_frames", [64, 600], ids=["short", "padded_to_1024"])
def test_whisper_encoder(max_frames):
    kw = dict(n_mels=80, d_model=32, num_layers=2, num_heads=4, ffn_dim=64, max_frames=max_frames)
    mel = np.random.default_rng(0).standard_normal((2, 80, 2 * max_frames)).astype(np.float32)
    jm = jwh.WhisperEncoder(jwh.WhisperEncoderConfig(**kw))
    v = _init(jm, jnp.asarray(mel))
    want = _apply(jm, v, jnp.asarray(mel))
    got = loaded(twh.WhisperEncoder(twh.WhisperEncoderConfig(**kw)), v)(t(mel))
    assert max_err(want, got) < TOL


def test_resnet_front_end():
    video = np.random.default_rng(1).standard_normal((2, 6, 24, 24, 1)).astype(np.float32)
    jm = jres.ResEncoder()
    v = _init(jm, jnp.asarray(video))
    want = _apply(jm, v, jnp.asarray(video))
    got = loaded(tres.ResEncoder(), v)(t(video))
    assert max_err(want, got) < TOL


def test_avhubert_video_only():
    rng = np.random.default_rng(2)
    video = rng.standard_normal((2, 6, 24, 24, 1)).astype(np.float32)
    lengths = np.asarray([6, 3], np.int32)
    jm = javh.AVHubertModel(javh.AVHubertConfig.tiny())
    v = _init(jm, video=jnp.asarray(video), lengths=jnp.asarray(lengths))
    want = _apply(jm, v, video=jnp.asarray(video), lengths=jnp.asarray(lengths))
    got = loaded(tavh.AVHubertModel(tavh.AVHubertConfig.tiny()), v)(
        video=t(video), lengths=t(lengths))
    assert max_err(want, got) < TOL


def test_speech_rate_predictor():
    x = np.random.default_rng(3).standard_normal((2, 9, 64)).astype(np.float32)
    jm = jmod.SpeechRatePredictor(2)
    v = _init(jm, jnp.asarray(x))
    want = _apply(jm, v, jnp.asarray(x))
    got = loaded(tmod.SpeechRatePredictor(64, 2), v)(t(x))
    assert max_err(want, got) < TOL


def test_qformer():
    rng = np.random.default_rng(4)
    kw = dict(num_layers=2, hidden_size=32, num_heads=2, intermediate_size=64,
              encoder_width=48, max_queries=10)
    enc = rng.standard_normal((2, 12, 48)).astype(np.float32)
    qlens, elens = np.asarray([10, 4], np.int32), np.asarray([12, 7], np.int32)
    jm = jqf.QFormer(jqf.QFormerConfig(**kw))
    args = dict(query_lens=jnp.asarray(qlens), enc_lens=jnp.asarray(elens))
    v = _init(jm, jnp.asarray(enc), **args)
    want = _apply(jm, v, jnp.asarray(enc), **args)
    got = loaded(tqf.QFormer(tqf.QFormerConfig(**kw)), v)(
        t(enc), query_lens=t(qlens), enc_lens=t(elens))
    assert max_err(want, got) < TOL


def test_projector():
    x = np.random.default_rng(5).standard_normal((2, 5, 32)).astype(np.float32)
    jm = jmod.Projector(hidden_dim=24, output_dim=16)
    v = _init(jm, jnp.asarray(x))
    got = loaded(tmod.Projector(32, 24, 16), v)(t(x))
    assert max_err(_apply(jm, v, jnp.asarray(x)), got) < 1e-5


@pytest.mark.parametrize("align_corners", [False, True])
def test_linear_resize_batched(align_corners):
    x = np.random.default_rng(6).standard_normal((3, 10, 4)).astype(np.float32)
    src, tgt = np.asarray([10, 7, 1], np.int32), np.asarray([19, 3, 5], np.int32)
    want = jinterp.linear_resize_batched(jnp.asarray(x), jnp.asarray(src), jnp.asarray(tgt), 20,
                                         align_corners=align_corners)
    got = tinterp.linear_resize_batched(t(x), t(src), t(tgt), 20, align_corners=align_corners)
    assert max_err(want, got) < 1e-6
    np.testing.assert_array_equal(
        np.asarray(jinterp.length_mask(jnp.asarray(tgt), 20)),
        tinterp.length_mask(t(tgt), 20).numpy())


def test_assemble_left_padded():
    rng = np.random.default_rng(7)
    pad = np.full((4,), -1.0, np.float32)
    inst = rng.standard_normal((3, 3, 4)).astype(np.float32)
    queries = rng.standard_normal((3, 5, 4)).astype(np.float32)
    q_lens = np.asarray([5, 2, 0], np.int32)
    want_e, want_m, _ = javsr.assemble_left_padded(
        jnp.asarray(pad), jnp.asarray(inst), jnp.asarray(queries), jnp.asarray(q_lens))
    got_e, got_m = tavsr.assemble_left_padded(t(pad), t(inst), t(queries), t(q_lens))
    assert max_err(want_e, got_e) == 0.0
    np.testing.assert_array_equal(np.asarray(want_m), got_m.numpy())
    assert got_m.dtype == torch.int32


# ---- the pretraining forms: post-LN, output_layer, the audio stream, train mode ----


@pytest.mark.parametrize("output_layer", [None, 1, 2], ids=["all", "layer1", "layer2"])
@pytest.mark.parametrize("layer_norm_first", [True, False], ids=["pre_ln", "post_ln"])
def test_transformer_encoder_forms(layer_norm_first, output_layer):
    """Pre- and post-LN stacks (the outer LayerNorm after / before the
    layers), and the state after layer N without the final LayerNorm."""
    from multimodalvc_tpu.nn import layers as jlayers
    from multimodalvc_tpu_torch.nn import layers as tlayers

    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    lengths = np.asarray([9, 5], np.int32)
    kw = dict(num_layers=2, num_heads=4, ffn_dim=64, layer_norm_first=layer_norm_first,
              conv_pos=4, conv_pos_groups=4)
    jm = jlayers.TransformerEncoder(**kw)
    v = _init(jm, jnp.asarray(x), lengths=jnp.asarray(lengths))
    want = jax.jit(lambda v, x: jm.apply(v, x, lengths=jnp.asarray(lengths),
                                         output_layer=output_layer))(v, jnp.asarray(x))
    tm = loaded(tlayers.TransformerEncoder(32, **kw), v)
    got = tm(t(x), lengths=t(lengths), output_layer=output_layer)
    assert max_err(want, got) < TOL


@pytest.mark.parametrize("layer_norm_first", [True, False], ids=["pre_ln", "post_ln"])
def test_transformer_encoder_dropout_replays(layer_norm_first):
    """Training dropout: the stack's input, then each layer's attention and
    FFN branches, masked by ``layers.dropout`` with draws in that order from
    the generator passed; the forward written out with those draws from a
    generator of the same seed gives the same bits.  No generator drops
    nothing.  (The JAX masks come from another RNG, so the placement is held
    here, the arithmetic against JAX in test_transformer_encoder_forms.)"""
    from multimodalvc_tpu_torch.nn import layers as tlayers

    rate = 0.25
    rng = np.random.default_rng(12)
    x = t(rng.standard_normal((2, 9, 32)).astype(np.float32))
    lengths = t(np.asarray([9, 5], np.int32))
    torch.manual_seed(0)
    tm = tlayers.TransformerEncoder(32, 2, 4, 64, dropout=rate, layer_norm_first=layer_norm_first,
                                    conv_pos=4, conv_pos_groups=4)
    with torch.no_grad():
        got = tm(x, lengths=lengths, dropout_rng=torch.Generator().manual_seed(3))
        plain = tm(x, lengths=lengths)

        def replay(g):
            def drop(h):
                return tlayers.dropout(h, rate, g)

            h = x * (torch.arange(9)[None, :, None] < lengths[:, None, None])
            h = h + tm.pos_conv(h)
            h = drop(h if layer_norm_first else tm.layer_norm(h))
            for layer in tm.layers:
                ln1, ln2 = layer.self_attn_layer_norm, layer.final_layer_norm
                if layer_norm_first:
                    h = h + drop(layer.self_attn(ln1(h), kv_lens=lengths))
                    h = h + drop(layer.ffn(ln2(h)))
                else:
                    h = ln1(h + drop(layer.self_attn(h, kv_lens=lengths)))
                    h = ln2(h + drop(layer.ffn(h)))
            return tm.layer_norm(h) if layer_norm_first else h

        assert torch.equal(got, replay(torch.Generator().manual_seed(3)))
        assert torch.equal(plain, replay(None))
        assert not torch.equal(got, plain)


AV_FORMS = {  # name -> (config overrides, audio, video)
    "concat_audio_video": ({}, True, True),
    "concat_audio_only": ({}, True, False),
    "add_audio_video_post_ln": ({"modality_fuse": "add", "layer_norm_first": False}, True, True),
    "add_video_only_relu": ({"modality_fuse": "add", "resnet_relu_type": "relu"}, False, True),
}


@pytest.mark.parametrize("form", sorted(AV_FORMS))
def test_avhubert_streams_and_fuses(form):
    """The audio stream (``audio_proj`` on stacked filterbanks), the "add"
    fuse (no ``post_extract_proj``), post-LN layers and the plain-ReLU
    ResNet: the port's state dict holds the flax init's leaves exactly (the
    video-only AVSR form none of ``audio_proj``), and the outputs agree.
    The audio-only forward runs on a model of both streams (the flax init
    given both), as the pretraining model is built."""
    import dataclasses

    over, with_audio, with_video = AV_FORMS[form]
    rng = np.random.default_rng(9)
    audio = rng.standard_normal((2, 6, 104)).astype(np.float32) if with_audio else None
    video = rng.standard_normal((2, 6, 24, 24, 1)).astype(np.float32) if with_video else None
    lengths = np.asarray([6, 4], np.int32)
    jcfg = dataclasses.replace(javh.AVHubertConfig.tiny(), **over)
    tcfg = dataclasses.replace(tavh.AVHubertConfig.tiny(), **over)
    jm = javh.AVHubertModel(jcfg)
    args = dict(audio=None if audio is None else jnp.asarray(audio),
                video=None if video is None else jnp.asarray(video),
                lengths=jnp.asarray(lengths))
    init_args = dict(args, video=jnp.asarray(np.zeros((2, 6, 24, 24, 1), np.float32))) \
        if video is None else args
    v = _init(jm, **init_args)
    want = _apply(jm, v, **args)
    tm = loaded(tavh.AVHubertModel(tcfg, audio=with_audio), v)
    assert ("audio_proj.weight" in tm.state_dict()) == with_audio
    assert ("post_extract_proj.weight" in tm.state_dict()) == (tcfg.modality_fuse == "concat")
    got = tm(audio=None if audio is None else t(audio), video=None if video is None else t(video),
             lengths=t(lengths))
    assert max_err(want, got) < TOL


def test_avsr_avhubert_keeps_its_state_dict():
    """The AVSR system's video-only AV-HuBERT: no audio stream, the keys of
    the JAX video-only init, with ``remat`` too (its gradients:
    tests/test_torch_remat.py), and
    ``sequence_parallel`` (ring attention) building the same keys with its
    self-attention flagged."""
    video = np.zeros((1, 4, 24, 24, 1), np.float32)
    jm = javh.AVHubertModel(javh.AVHubertConfig.tiny())
    shapes = jax.eval_shape(jm.init, KEY, video=jnp.asarray(video))
    from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict

    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = set(flax_to_state_dict(template))
    assert set(tavh.AVHubertModel(tavh.AVHubertConfig.tiny()).state_dict()) == want
    avsr = set(tavsr.AVSRSystem(tavsr.AVSRConfig.tiny(), device="cpu").module.state_dict())
    assert avsr >= {f"encoder.avhubert.{k}" for k in want}
    assert not any("audio_proj" in k for k in avsr)
    remat = tavh.AVHubertModel(tavh.AVHubertConfig(**{**vars(tavh.AVHubertConfig.tiny()),
                                                      "remat": True}))
    assert set(remat.state_dict()) == want and remat.encoder.remat
    ring = tavh.AVHubertModel(tavh.AVHubertConfig(**{**vars(tavh.AVHubertConfig.tiny()),
                                                     "sequence_parallel": True}))
    assert set(ring.state_dict()) == want
    assert all(layer.self_attn.sequence_parallel for layer in ring.encoder.layers)


@pytest.mark.parametrize("relu_type", ["prelu", "relu"])
def test_resnet_train_mode_two_steps(relu_type):
    """Training mode: flax's batch statistics over all B x T frames (the
    biased variance) normalise, and the running statistics move as 0.9 ra +
    0.1 batch; two steps in a row, outputs and statistics after each."""
    rng = np.random.default_rng(10)
    videos = [rng.standard_normal((2, 5, 24, 24, 1)).astype(np.float32) for _ in range(2)]
    jm = jres.ResEncoder(relu_type=relu_type)
    v = _init(jm, jnp.asarray(videos[0]))
    tm = loaded(tres.ResEncoder(relu_type), v)
    step = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))
    for video in videos:
        want, new = step(v, jnp.asarray(video))
        v = {**v, **new}
        got = tm(t(video), train=True)
        assert max_err(want, got) < TOL
        sd = tm.state_dict()
        for path, stat in jax.tree_util.tree_flatten_with_path(new["batch_stats"])[0]:
            names = [p.key for p in path]
            key = ".".join(names[:-1]) + (".running_mean" if names[-1] == "mean"
                                           else ".running_var")
            assert max_err(stat, sd[key]) < 1e-5, key
    # evaluation reads the moved statistics and moves nothing
    before = {k: x.clone() for k, x in tm.state_dict().items()}
    assert max_err(_apply(jm, v, jnp.asarray(videos[0])), tm(t(videos[0]))) < TOL
    assert all(torch.equal(x, before[k]) for k, x in tm.state_dict().items())


def test_resnet_bf16_running_statistics_follow_an_f32_ema(monkeypatch):
    """A bf16 ResEncoder keeps its BatchNorms in f32 (flax keeps
    ``batch_stats`` in f32), so over many training steps each running
    statistic follows the momentum-0.9 EMA of its batch statistics computed
    in f64 from the same inputs; bf16 buffers would round the steps away."""
    tm = tres.ResEncoder("prelu", dtype=torch.bfloat16)
    norms = [m for m in tm.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(norms) == 20
    assert all(x.dtype == torch.float32 for m in norms for x in (
        m.weight, m.bias, m.running_mean, m.running_var))
    ema = {id(m): [m.running_mean.double().clone(), m.running_var.double().clone()]
           for m in norms}
    real = tres.batch_norm_train_

    def follow(h, norm, **kw):
        x = h.double().transpose(0, 1).flatten(1)
        mean, var = x.mean(dim=1), x.var(dim=1, unbiased=False)
        stats = ema[id(norm)]
        stats[0] = 0.9 * stats[0] + 0.1 * mean
        stats[1] = 0.9 * stats[1] + 0.1 * var
        return real(h, norm, **kw)

    monkeypatch.setattr(tres, "batch_norm_train_", follow)
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for _ in range(40):
            video = 0.5 + 0.2 * rng.standard_normal((1, 4, 16, 16, 1)).astype(np.float32)
            tm(t(video), train=True)
    for m in norms:
        mean, var = ema[id(m)]
        # f32 against f64: the one-pass variance and the f32 EMA, ~1e-6 relative
        assert torch.allclose(m.running_mean.double(), mean, rtol=1e-4, atol=1e-6)
        assert torch.allclose(m.running_var.double(), var, rtol=1e-4, atol=1e-6)
