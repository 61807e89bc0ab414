"""The AVSR encoder's other configurations through the weight bridge: the
port's AVSREncoder against the flax one in every fuse mode ("concat", "add",
"cross-att"), with and without the speech-rate predictor, with modality
dropout in modes 0 / 1 / 2; the cross-attention fusion alone; and the
default configuration's tree."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import loaded, max_err, randomize, t

from multimodalvc_tpu.models import avsr as javsr
from multimodalvc_tpu.nn import modules as jmod
from multimodalvc_tpu_torch.interop import from_flax
from multimodalvc_tpu_torch.models import avsr as tavsr
from multimodalvc_tpu_torch.nn import modules as tmod

TOL = 1e-4  # f32 through both encoders, the fusion, the Q-Former and the projector
KEY = jax.random.PRNGKey(0)


def _inputs(cfg, b=2):
    rng = np.random.default_rng(0)
    t_v = cfg.max_video_frames
    return (rng.standard_normal((b, cfg.whisper.n_mels, 2 * cfg.whisper.max_frames))
            .astype(np.float32),
            rng.standard_normal((b, t_v, 24, 24, 1)).astype(np.float32),
            np.asarray([t_v, t_v // 2 + 1], np.int32))


def _configs(fuse, sr):
    kw = dict(modality_fuse=fuse, use_sr_predictor=sr, modality_dropout=True)
    return (dataclasses.replace(javsr.AVSRConfig.tiny(), **kw),
            dataclasses.replace(tavsr.AVSRConfig.tiny(), **kw))


@pytest.mark.parametrize("sr", [True, False], ids=["sr", "no_sr"])
@pytest.mark.parametrize("fuse", ["concat", "add", "cross-att"])
def test_encoder_fuse_modes(fuse, sr):
    """Queries and query lengths in modes 0, 1 and 2 (one jitted apply, the
    mode a traced scalar); modes 1 and 2 move the queries."""
    jcfg, tcfg = _configs(fuse, sr)
    audio, video, lens = _inputs(jcfg)
    jm = javsr.AVSREncoder(jcfg)
    args = (jnp.asarray(audio), jnp.asarray(video), jnp.asarray(lens))
    variables = randomize(jax.jit(jm.init)(KEY, *args))
    apply = jax.jit(lambda v, mode: jm.apply(v, *args, modality_mode=mode))
    tm = loaded(tavsr.AVSREncoder(tcfg), variables)
    assert hasattr(tm, "sr_predictor") == sr and hasattr(tm, "fusion") == (fuse == "cross-att")
    assert tcfg.max_queries == jcfg.max_queries == (80 if sr else 40)
    got = {}
    for mode in (0, 1, 2):
        want_q, want_lens = apply(variables, jnp.asarray(mode, jnp.int32))
        with torch.no_grad():
            got[mode], got_lens = tm(t(audio), t(video), t(lens),
                                     modality_mode=torch.tensor(mode))
        np.testing.assert_array_equal(np.asarray(want_lens), got_lens.numpy())
        assert max_err(want_q, got[mode]) < TOL, mode
    assert (got[1] - got[0]).abs().max() > 1e-3 and (got[2] - got[0]).abs().max() > 1e-3


def test_multimodal_attention():
    rng = np.random.default_rng(3)
    audio = rng.standard_normal((2, 9, 32)).astype(np.float32)
    video = rng.standard_normal((2, 9, 32)).astype(np.float32)
    lens = np.asarray([9, 4], np.int32)
    jm = jmod.MultimodalAttention(num_heads=4)
    args = (jnp.asarray(audio), jnp.asarray(video))
    v = randomize(jm.init(KEY, *args, kv_lens=jnp.asarray(lens)))
    want = jax.jit(lambda v: jm.apply(v, *args, kv_lens=jnp.asarray(lens)))(v)
    with torch.no_grad():
        got = loaded(tmod.MultimodalAttention(32, num_heads=4), v)(t(audio), t(video),
                                                                   kv_lens=t(lens))
    assert max_err(want, got) < 1e-5


def _state_dict_shapes(shapes):
    """The state_dict names and shapes the bridge gives a flax tree of
    ``ShapeDtypeStruct`` leaves (zero-stride arrays: nothing is allocated)."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        names = tuple(str(p.key) for p in path)
        x = np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), s.shape, (0,) * len(s.shape))
        name, y = from_flax._convert(names[-1], x)
        out[".".join(names[:-1] + (name,))] = tuple(y.shape)
    for path, s in jax.tree_util.tree_flatten_with_path(shapes.get("batch_stats", {}))[0]:
        base = ".".join(str(p.key) for p in path[:-1])
        out[f"{base}.{from_flax._STATS[str(path[-1].key)]}"] = tuple(s.shape)
        out[f"{base}.num_batches_tracked"] = ()
    return out


def test_default_tree_unchanged():
    """AVSRConfig()'s encoder: the port's tree (built on the meta device) has
    the flax tree's leaves and shapes, with no mask embeddings and no
    fusion, and the concat width into the Q-Former."""
    jcfg, tcfg = javsr.AVSRConfig(), tavsr.AVSRConfig()
    assert (tcfg.modality_fuse, tcfg.use_sr_predictor, tcfg.modality_dropout,
            tcfg.max_queries, tcfg.fused_dim) == ("concat", True, False, 120, 2048)
    shapes = jax.eval_shape(
        javsr.AVSREncoder(jcfg).init, KEY, jax.ShapeDtypeStruct((1, 80, 3000), jnp.float32),
        jax.ShapeDtypeStruct((1, 8, 88, 88, 1), jnp.float32),
        jax.ShapeDtypeStruct((1,), jnp.int32))
    got = {k: tuple(x.shape) for k, x in
           tavsr.AVSREncoder(tcfg, device="meta").state_dict().items()}
    assert got == _state_dict_shapes(shapes)
    assert not any(k.startswith(("audio_mask_emb", "video_mask_emb", "fusion.")) for k in got)
    assert got["qformer.layers_0.cross_attn.k_proj.weight"] == (1024, 2048)
