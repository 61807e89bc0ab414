"""The HiFi-GAN generator through the weight bridge: the port's
weight-normalized convs, the generator (mel input with and without
``lengths``, unit input) and ``VocoderModel.generate`` against the flax
modules on the same weights (each g scaled away from ||v||) and numpy
inputs; the bridge's round trip of the generator tree."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import loaded, max_err, t

from multimodalvc_tpu.models import vocoder as jvoc
from multimodalvc_tpu.nn import hifigan as jhg
from multimodalvc_tpu.nn import wn_conv as jwn
from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict, state_dict_to_flax
from multimodalvc_tpu_torch.models import vocoder as tvoc
from multimodalvc_tpu_torch.nn import hifigan as thg
from multimodalvc_tpu_torch.nn import wn_conv as twn

TOL = 1e-4
KEY = jax.random.PRNGKey(0)
# a small generator: x8 upsampling (4 * 2), two MRF kernels
SMALL = dict(in_channels=12, upsample_initial_channel=16, upsample_factors=(4, 2),
             upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3, 5),
             resblock_dilations=((1, 3), (1, 2)))


def _scaled_g(variables, seed=1):
    """Every weight-norm g times a factor in [0.5, 1.5): W != v."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if str(path[-1].key) == "g":
            return (x * (0.5 + rng.random(x.shape))).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _nwc_to_ncw(x):
    return t(x).transpose(1, 2)


@pytest.mark.parametrize("stride,padding,dilation,groups", [(1, 3, 1, 1), (2, 1, 1, 2),
                                                            (1, 6, 3, 1)])
def test_wn_conv1d(stride, padding, dilation, groups):
    x = np.random.default_rng(0).standard_normal((2, 17, 8)).astype(np.float32)
    jm = jwn.WNConv1d(6, 7, stride=stride, padding=padding, dilation=dilation, groups=groups)
    v = _scaled_g(jm.init(KEY, jnp.asarray(x)))
    want = jm.apply(v, jnp.asarray(x))
    tm = loaded(twn.WNConv1d(8, 6, 7, stride, padding, dilation, groups), v)
    with torch.no_grad():
        got = tm(_nwc_to_ncw(x)).transpose(1, 2)
    assert max_err(want, got) < 1e-5


@pytest.mark.parametrize("stride,kernel,padding", [(10, 20, 5), (4, 8, 2), (2, 4, 1), (3, 3, 0)])
def test_wn_conv_transpose1d(stride, kernel, padding):
    """Output length (T - 1) * stride - 2 * padding + K; the norm over the
    input channel."""
    x = np.random.default_rng(1).standard_normal((2, 9, 8)).astype(np.float32)
    jm = jwn.WNConvTranspose1d(5, kernel, stride=stride, padding=padding)
    v = _scaled_g(jm.init(KEY, jnp.asarray(x)))
    assert v["params"]["g"].shape == (8,)
    want = jm.apply(v, jnp.asarray(x))
    tm = loaded(twn.WNConvTranspose1d(8, 5, kernel, stride, padding), v)
    with torch.no_grad():
        got = tm(_nwc_to_ncw(x)).transpose(1, 2)
    assert got.shape[1] == (9 - 1) * stride - 2 * padding + kernel
    assert max_err(want, got) < 1e-5


def test_weight_norm_floor():
    v = torch.zeros(3, 2, 4)
    assert torch.equal(twn.weight_norm_kernel(v, torch.ones(3)), v)


@pytest.fixture(scope="module")
def generator():
    mel = np.random.default_rng(2).standard_normal((2, 11, 12)).astype(np.float32)
    jm = jhg.HifiGanGenerator(jhg.HifiGanConfig(**SMALL))
    variables = _scaled_g(jax.jit(jm.init)(KEY, jnp.asarray(mel)))
    return jm, variables, mel


@pytest.mark.parametrize("lengths", [None, [11, 6]], ids=["whole_buffer", "lengths"])
def test_generator(generator, lengths):
    jm, variables, mel = generator
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    want = jax.jit(lambda v, m: jm.apply(v, m, lengths=None if lens is None else
                                          jnp.asarray(lens)))(variables, jnp.asarray(mel))
    tm = loaded(thg.HifiGanGenerator(thg.HifiGanConfig(**SMALL)), variables)
    with torch.no_grad():
        got = tm(t(mel), lengths=None if lens is None else t(lens))
    assert got.shape == (2, 11 * 8, 1)
    assert max_err(want, got) < TOL
    if lens is not None:
        # past the last valid frame only conv_post's bias reaches the output
        bias = torch.tanh(tm.conv_post.bias)
        assert torch.equal(got[1, 6 * 8 + 3:, 0], bias.expand(11 * 8 - 6 * 8 - 3))


def test_generator_units():
    units = np.random.default_rng(3).integers(0, 21, (2, 7)).astype(np.int32)
    cfg = dict(SMALL, unit_nums=20)
    jm = jhg.HifiGanGenerator(jhg.HifiGanConfig(**cfg))
    variables = _scaled_g(jax.jit(jm.init)(KEY, jnp.asarray(units)))
    assert variables["params"]["lut"].shape == (21, 12)
    want = jax.jit(jm.apply)(variables, jnp.asarray(units))
    tm = loaded(thg.HifiGanGenerator(thg.HifiGanConfig(**cfg)), variables)
    with torch.no_grad():
        got = tm(t(units))
    assert max_err(want, got) < TOL


def test_vocoder_generate(generator):
    jm, variables, mel = generator
    jcfg = jvoc.VocoderConfig(generator=jhg.HifiGanConfig(**SMALL))
    want = jvoc.VocoderModel(jcfg).generate(variables["params"], jnp.asarray(mel))
    voc = tvoc.VocoderModel(tvoc.VocoderConfig(generator=thg.HifiGanConfig(**SMALL)),
                            device="cpu")
    loaded(voc.generator, variables)
    got = voc.generate(t(mel))
    assert got.shape == (2, 11 * 8)
    assert max_err(want, got) < TOL
    # the training fields are back with the GAN step that reads them
    assert [f.name for f in dataclasses.fields(tvoc.VocoderConfig)] == \
        [f.name for f in dataclasses.fields(jvoc.VocoderConfig)]


def test_vocoder_init_random_is_weight_v():
    """Random weights: g = ||v||, so each conv's W is its v."""
    voc = tvoc.VocoderModel(tvoc.VocoderConfig(generator=thg.HifiGanConfig(**SMALL)),
                            device="cpu")
    voc.init_random(0)
    conv = voc.generator.ups_0
    assert torch.allclose(conv.weight(torch.float32), conv.v, atol=1e-7)
    assert voc.generate(torch.randn(1, 5, 12)).abs().max() <= 1.0


def test_generator_tree_round_trip(generator):
    """The vocoder's generator tree: a strict load, then the module's
    state_dict back to the flax tree bit for bit, with the v leaves
    transposed on the way (conv [K, I, O] -> [O, I, K], transposed conv
    [K, O, I] -> [I, O, K])."""
    _, variables, _ = generator
    params = jax.tree.map(np.asarray, variables["params"])
    voc = tvoc.VocoderModel(tvoc.VocoderConfig(generator=thg.HifiGanConfig(**SMALL)),
                            device="cpu")
    loaded(voc.generator, variables)
    sd = voc.generator.state_dict()
    assert tuple(sd["ups_0.v"].shape) == (16, 8, 8)  # [I, O, K]
    assert tuple(sd["conv_pre.v"].shape) == (16, 12, 7)  # [O, I, K]
    assert tuple(flax_to_state_dict({"params": params})["ups_0.v"].shape) == (16, 8, 8)
    back = state_dict_to_flax(sd, params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
