"""The speech head's Conformer through the weight bridge: the port's
ConformerEncoder against the flax one with the depthwise, lightweight and
dynamic conv modules, on rows shorter than the buffer (BatchNorm statistics
randomized); the lightweight and dynamic convs alone; the positional table;
and the expert FFN's refusal."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import loaded, max_err, randomize, t

from multimodalvc_tpu.nn import conformer as jconf
from multimodalvc_tpu_torch.nn import conformer as tconf
from multimodalvc_tpu_torch.ops import dynamic_conv as tdc

# the JAX ops package re-exports the function under the module's name
jdc = importlib.import_module("multimodalvc_tpu.ops.dynamic_conv")
TOL = 1e-4  # f32 through two blocks of LayerNorm / attention / conv / BatchNorm
KEY = jax.random.PRNGKey(0)
SMALL = dict(num_blocks=2, attention_dim=48, attention_heads=4, linear_units=96)


@pytest.mark.parametrize("conv_type", ["depthwise", "lightweight", "dynamic"])
def test_conformer_encoder(conv_type):
    """[2, 40, 40] -> [2, 40, 48] (input_proj: the widths differ), rows of 40
    and 23 frames; the padded frames must not reach the valid ones."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, 40)).astype(np.float32)
    lens = np.asarray([40, 23], np.int32)
    jcfg = jconf.ConformerConfig.sized("S", conv_type=conv_type, **SMALL)
    jm = jconf.ConformerEncoder(jcfg)
    args = (jnp.asarray(x),)
    variables = randomize(jax.jit(lambda k: jm.init(k, *args, lengths=jnp.asarray(lens)))(KEY))
    assert "batch_stats" in variables
    want = jax.jit(lambda v: jm.apply(v, *args, lengths=jnp.asarray(lens)))(variables)
    tm = loaded(tconf.ConformerEncoder(tconf.ConformerConfig.sized("S", conv_type=conv_type,
                                                                   **SMALL), 40), variables)
    assert hasattr(tm, "input_proj")
    with torch.no_grad():
        got = tm(t(x), lengths=t(lens))
        # garbage past row 1's frames changes nothing in its valid frames
        noisy = t(x).clone()
        noisy[1, 23:] = 1e3
        got_noisy = tm(noisy, lengths=t(lens))
    assert max_err(want, got) < TOL
    assert (got_noisy[1, :23] - got[1, :23]).abs().max() < 1e-5


def test_conformer_encoder_same_width_has_no_input_proj():
    tm = tconf.ConformerEncoder(tconf.ConformerConfig.sized("S", **SMALL), 48)
    assert not hasattr(tm, "input_proj")
    x = torch.randn(1, 5, 48)
    assert tm.eval()(x).shape == (1, 5, 48)


def test_conformer_sizes():
    for size in "SML":
        j, p = jconf.ConformerConfig.sized(size), tconf.ConformerConfig.sized(size)
        assert (j.num_blocks, j.attention_dim, j.attention_heads, j.cnn_kernel) == \
            (p.num_blocks, p.attention_dim, p.attention_heads, p.cnn_kernel)
    np.testing.assert_array_equal(jconf.espnet_positional_encoding(50, 16),
                                  tconf.espnet_positional_encoding(50, 16))
    table = tconf.positional_table(50, 16, torch.device("cpu"))
    assert tuple(table.shape) == (50, 16)
    np.testing.assert_array_equal(table.numpy(), jconf.espnet_positional_encoding(50, 16))


def test_expert_ffn_is_refused():
    """The expert FFN is no longer refused: with moe_experts > 1 a block
    holds the expert bank ``ff_moe`` in place of ``ff``, under the JAX
    init's names and shapes (the weight bridge moves its leaves as they
    are)."""
    from multimodalvc_tpu_torch.interop.from_flax import flax_to_state_dict

    cfg = dict(moe_experts=4, **SMALL)
    jm = jconf.ConformerBlock(jconf.ConformerConfig.sized("S", **cfg))
    x = jnp.zeros((1, 6, SMALL["attention_dim"]))
    shapes = jax.eval_shape(lambda k: jm.init(k, x), KEY)
    want = {k: tuple(v.shape) for k, v in flax_to_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)).items()}
    block = tconf.ConformerBlock(tconf.ConformerConfig.sized("S", **cfg))
    got = {k: tuple(v.shape) for k, v in block.state_dict().items()}
    assert got == want
    assert "ff_moe.experts_w1" in got and not any(k.startswith("ff.") for k in got)


@pytest.mark.parametrize("padding_left", [None, 3, 6])
def test_dynamic_conv(padding_left):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 12)).astype(np.float32)
    w = rng.standard_normal((2, 11, 3, 7)).astype(np.float32)
    want = jdc.dynamic_conv(jnp.asarray(x), jnp.asarray(w), padding_left=padding_left)
    got = tdc.dynamic_conv(t(x), t(w), padding_left=padding_left)
    assert max_err(want, got) < 1e-5
    raw = jdc.dynamic_conv(jnp.asarray(x), jnp.asarray(w), padding_left, softmax=False)
    assert max_err(raw, tdc.dynamic_conv(t(x), t(w), padding_left, softmax=False)) < 1e-5


@pytest.mark.parametrize("padding_left", [None, 3])
def test_lightweight_conv(padding_left):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, 12)).astype(np.float32)
    w = rng.standard_normal((4, 7)).astype(np.float32)
    want = jdc.lightweight_conv(jnp.asarray(x), jnp.asarray(w), padding_left=padding_left)
    got = tdc.lightweight_conv(t(x), t(w), padding_left=padding_left)
    assert max_err(want, got) < 1e-5
    np.testing.assert_array_equal(np.asarray(jdc.shifted_stack(jnp.asarray(x), 7, 2)),
                                  tdc.shifted_stack(t(x), 7, 2).numpy())


def test_conv_heads_must_divide_channels():
    with pytest.raises(ValueError, match="not divisible"):
        tdc.lightweight_conv(torch.randn(1, 5, 10), torch.randn(4, 3))
