"""The HiFi-GAN discriminators of the port against the JAX package's
(``nn/hifigan.py``, ``nn/wn_conv.py``) through the weight bridge, at test
widths (``channels_cap`` 16, periods (2, 3), three scales: a reflect pad
in each period discriminator, spectral norm on scale 0 with grouped convs,
the average pool between scales): the scores, every feature map, the three
LS-GAN losses, the spectral u and v after an ``update_sn`` pass (and their
bridge, which reorders v), ``avg_pool_1d``, ``WNConv2d`` and the reference
checkpoint import."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import max_err, t

from multimodalvc_tpu.nn import hifigan as jhg
from multimodalvc_tpu.nn import wn_conv as jwn
from multimodalvc_tpu_torch.interop.from_flax import (
    flax_to_state_dict,
    load_flax_variables,
    state_dict_to_flax_variables,
)
from multimodalvc_tpu_torch.nn import hifigan as thg
from multimodalvc_tpu_torch.nn import wn_conv as twn

# f32 convs over a few hundred samples, summed in other orders: the scores,
# the feature maps and the losses to 1e-5 of their largest magnitude (the
# JAX init's he-normal kernels grow the activations to O(1e3) by the last
# layers); the power iteration's unit vectors u and v to 1e-6
TOL, SN_TOL = 1e-5, 1e-6


def close(want, got) -> bool:
    return max_err(want, got) <= TOL * max(1.0, float(np.abs(np.asarray(want)).max()))


PERIODS, SCALES, CAP = (2, 3), 3, 16


def _scaled_g(variables, seed=1):
    """Every weight-norm g times a factor in [0.5, 1.5): W != v."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if str(path[-1].key) == "g":
            return (x * (0.5 + rng.random(x.shape))).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def waves(b=2, n=301, seed=0):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.standard_normal((b, n, 1))).astype(np.float32) for _ in range(2)]


@pytest.fixture(scope="module")
def discs():
    real, _ = waves()
    jd = jhg.HifiGanDiscriminator(periods=PERIODS, n_scales=SCALES, channels_cap=CAP)
    variables = _scaled_g(jax.tree.map(np.asarray, jd.init(jax.random.PRNGKey(0),
                                                           jnp.asarray(real))))
    td = thg.HifiGanDiscriminator(PERIODS, SCALES, CAP, device="cpu")
    load_flax_variables(td, variables)
    return jd, variables, td


def _channels_last(f):
    return f.permute(0, 2, 3, 1) if f.ndim == 4 else f.transpose(1, 2)


def test_scores_and_features_match_jax(discs):
    jd, variables, td = discs
    real, _ = waves()
    scores, feats = jd.apply(variables, jnp.asarray(real))
    with torch.no_grad():
        got_s, got_f = td(t(real))
    assert len(got_s) == len(scores) == len(PERIODS) + SCALES
    for w, g in zip(scores, got_s):
        assert close(w, g)
    for wf, gf in zip(feats, got_f):
        assert len(wf) == len(gf)
        for w, g in zip(wf, gf):
            assert close(w, _channels_last(g))
    # 301 samples: the period-2 and -3 discriminators reflect-pad to 302 and 303
    assert got_f[0][0].shape[2:] == (51, 2) and got_f[1][0].shape[2:] == (34, 3)


def test_losses_match_jax(discs):
    jd, variables, td = discs
    real, fake = waves(seed=3)
    sr, fr = jd.apply(variables, jnp.asarray(real))
    sf, ff = jd.apply(variables, jnp.asarray(fake))
    with torch.no_grad():
        tsr, tfr = td(t(real))
        tsf, tff = td(t(fake))
    for want, got in [(jhg.feature_loss(fr, ff), thg.feature_loss(tfr, tff)),
                      (jhg.discriminator_loss(sr, sf), thg.discriminator_loss(tsr, tsf)),
                      (jhg.generator_adv_loss(sf), thg.generator_adv_loss(tsf))]:
        np.testing.assert_allclose(float(got), float(want), rtol=TOL)


def test_spectral_update_matches_jax(discs):
    """A pass with ``update_sn`` runs one power iteration on scale 0's convs
    and stores u and v; a pass without it leaves them; the bridge carries
    them both ways (v reordered between (K, I/g) and (I/g, K))."""
    jd, variables, _ = discs
    td = thg.HifiGanDiscriminator(PERIODS, SCALES, CAP, device="cpu")
    load_flax_variables(td, variables)
    real, fake = waves(seed=5)
    (scores, _), new = jd.apply(variables, jnp.asarray(real), update_sn=True, mutable=["spectral"])
    before = {k: v.clone() for k, v in td.state_dict().items() if ".sn_" in k}
    with torch.no_grad():
        got, _ = td(t(real), update_sn=True)
        after = {k: v.clone() for k, v in td.state_dict().items() if ".sn_" in k}
        td(t(fake))
    assert len(before) == 2 * 8 and all(not torch.equal(before[k], after[k]) for k in before)
    assert all(torch.equal(after[k], v) for k, v in td.state_dict().items() if ".sn_" in k)
    for w, g in zip(scores, got):
        assert close(w, g)
    want_sd = flax_to_state_dict({"params": variables["params"], "spectral": new["spectral"]})
    for k in after:
        assert max_err(want_sd[k].numpy(), after[k]) < SN_TOL, k
    # the grouped conv's v really is reordered: (K, I/g) = (41, 4) there
    conv = td.msd_0.convs_1
    assert tuple(conv.v.shape) == (16, 4, 41) and conv.sn_v.shape == (164,)
    flat = np.asarray(new["spectral"]["msd_0"]["convs_1"]["v"])
    assert not np.allclose(flat, after["msd_0.convs_1.sn_v"].numpy(), atol=1e-3)
    # and back in the flax order
    back = state_dict_to_flax_variables(td.state_dict(), {**variables, **new})
    jax.tree.map(lambda w, g: np.testing.assert_allclose(g, w, atol=SN_TOL), new["spectral"],
                 back["spectral"])


def test_discriminator_tree_round_trips_bit_for_bit(discs):
    _, variables, td = discs
    back = state_dict_to_flax_variables(td.state_dict(), variables)
    for k in ("params", "spectral"):
        jax.tree.map(np.testing.assert_array_equal, back[k], variables[k])


def test_sigma_is_not_made_positive():
    """u v^T flipped: sigma changes sign, so does W (torch's spectral_norm
    would not be told: it makes no such promise either; the JAX one divides
    as is)."""
    conv = twn.SNConv1d(3, 4, 5, device="cpu")
    torch.manual_seed(0)
    with torch.no_grad():
        conv.v.normal_()
        conv.sn_u.normal_()
        conv.sn_v.normal_()
        x = torch.randn(1, 3, 20)
        y = conv(x)
        conv.sn_u.neg_()
        assert torch.allclose(conv(x) - conv.bias[:, None], -(y - conv.bias[:, None]), atol=1e-6)


@pytest.mark.parametrize("window,stride,padding,n", [(4, 2, 2, 301), (4, 2, 2, 8), (3, 1, 1, 7)])
def test_avg_pool_1d_matches_jax(window, stride, padding, n):
    x = np.random.default_rng(2).standard_normal((2, n, 3)).astype(np.float32)
    want = jwn.avg_pool_1d(jnp.asarray(x), window, stride, padding)
    got = twn.avg_pool_1d(t(x), window, stride, padding)
    assert got.shape == want.shape
    assert max_err(want, got) < 1e-6


def test_wn_conv2d_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 20, 3, 4)).astype(np.float32)  # NHWC
    jm = jwn.WNConv2d(6, (5, 1), stride=(3, 1), padding=(2, 0))
    variables = _scaled_g(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), jnp.asarray(x))))
    tm = twn.WNConv2d(4, 6, (5, 1), (3, 1), (2, 0), device="cpu")
    load_flax_variables(tm, variables)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert close(want, got)


def _reference_state(td: thg.HifiGanDiscriminator, seed=7):
    """A reference (soft-vc) discriminator state dict of ``td``'s shapes,
    random: weight_v / weight_g [O, 1, ...] / bias, and on scale 0
    weight_orig / weight_u / weight_v."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(*shape, generator=g)  # noqa: E731
    state = {}
    for name, m in td.named_modules():
        if not isinstance(m, (twn.WNConv2d, twn.WNConv1d, twn.SNConv1d)):
            continue
        kind, i, rest = name.split("_", 2)[0], name.split(".")[0].split("_")[1], name.split(".")[1]
        layer = rest.replace("convs_", "convs.")
        src = f"{kind}.discriminators.{i}.{layer}"
        state[f"{src}.bias"] = rand(*m.bias.shape)
        if isinstance(m, twn.SNConv1d):
            state[f"{src}.weight_orig"] = rand(*m.v.shape)
            state[f"{src}.weight_u"] = rand(*m.sn_u.shape)
            state[f"{src}.weight_v"] = rand(*m.sn_v.shape)
        else:
            state[f"{src}.weight_v"] = rand(*m.v.shape)
            state[f"{src}.weight_g"] = rand(m.g.shape[0], *([1] * (m.v.ndim - 1)))
    return state


def test_import_torch_discriminator_matches_jax():
    """The five periods and three scales of the reference at cap 8."""
    td = thg.HifiGanDiscriminator(channels_cap=8, device="cpu")
    state = _reference_state(td)
    got = thg.import_torch_discriminator(state)
    td.load_state_dict(got, strict=True)
    want = flax_to_state_dict(jax.tree.map(
        np.asarray, jhg.import_torch_discriminator({k: v.numpy() for k, v in state.items()})))
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    x = torch.randn(1, 200, 1)
    with torch.no_grad():
        s, _ = td(x, update_sn=True)
    assert all(bool(torch.isfinite(v).all()) for v in s)
