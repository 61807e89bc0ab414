"""The port's quantize_tree / dequantize_tree against the JAX module's: the
int8 codes and f32 scales bit for bit (2-D, 3-D and 1-D leaves, a channel of
zeros, a leaf under min_size kept exact), the dequantized values, and the
error / size ratio."""
import numpy as np
import pytest
import torch

from multimodalvc_tpu.runtime import quantization as jq
from multimodalvc_tpu_torch.runtime import quantization as tq


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    w[:, 3] = 0.0  # a channel of zeros: the 1e-12 floor
    return {"layer": {"w": w, "conv": (rng.standard_normal((8, 16, 40)) * 3).astype(np.float32),
                      "b": rng.standard_normal(96).astype(np.float32)},
            "emb": [rng.standard_normal(5000).astype(np.float32) * 0.01],
            "count": np.arange(6000, dtype=np.int64)}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(tree.copy())


@pytest.mark.parametrize("min_size", [4096, 64])
def test_codes_and_scales_equal_the_jax_module(min_size):
    tree = _tree()
    want = jq.quantize_tree(tree, min_size=min_size)
    got = tq.quantize_tree(_torch(tree), min_size=min_size)
    for path in (("layer", "w"), ("layer", "conv"), ("layer", "b"), ("emb", 0)):
        w, g = want, got
        for k in path:
            w, g = w[k], g[k]
        if isinstance(w, dict):
            assert g[tq._QKEY].dtype == torch.int8 and g["scale"].dtype == torch.float32
            np.testing.assert_array_equal(g[tq._QKEY].numpy(), w[jq._QKEY], err_msg=str(path))
            np.testing.assert_array_equal(g["scale"].numpy(), w["scale"], err_msg=str(path))
        else:  # under min_size: exact
            assert isinstance(g, torch.Tensor) and np.array_equal(g.numpy(), w), path
    assert torch.equal(got["count"], torch.arange(6000))
    back, jback = tq.dequantize_tree(got), jq.dequantize_tree(want)
    np.testing.assert_array_equal(back["layer"]["w"].numpy(), jback["layer"]["w"])
    np.testing.assert_array_equal(back["emb"][0].numpy(), jback["emb"][0])
    assert tq.dequantize_tree(got, torch.bfloat16)["layer"]["conv"].dtype == torch.bfloat16


def test_error_and_ratio_equal_the_jax_module():
    tree = _tree(1)
    got, want = tq.quantization_error(_torch(tree)), jq.quantization_error(tree)
    assert got[0] == pytest.approx(want[0], rel=1e-6) and got[0] < 1 / 127
    assert got[1] == pytest.approx(want[1], rel=1e-9) and got[1] > 1.0


def test_bf16_leaves_are_quantized_as_their_f32_values():
    """A bf16 state dict: each leaf quantized as its f32 value (the JAX
    module leaves numpy's bfloat16, which is not of kind "f", exact)."""
    w = torch.randn(64, 128, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    got = tq.quantize_tree({"w": w})["w"]
    want = jq.quantize_tree({"w": w.float().numpy()})["w"]
    np.testing.assert_array_equal(got[tq._QKEY].numpy(), want[jq._QKEY])
    np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
