"""Post-training scalar quantization of nested dicts of tensors.

Port of ``multimodalvc_tpu/runtime/quantization.py`` over the port's trees:
nested dicts (and lists / tuples) of tensors, such as a ``state_dict`` or a
checkpoint.  ``quantize_tree`` maps each floating leaf of at least
``min_size`` elements to {int8 codes, f32 scales}: symmetric, per channel on
the last axis (a scale for each element of a 1-D leaf), the channel's amax
floored at 1e-12, scale = amax / 127, codes round(x / scale) clipped to
[-127, 127], on the leaf's device (a bf16 leaf as its f32 values, where the
JAX module leaves numpy's bfloat16, not of kind "f", exact).  Smaller leaves (norms, biases) and other leaves stay as
they are.  ``dequantize_tree`` restores codes * scale in ``dtype``.  Codes
and scales are the JAX package's bit for bit (both compute in f32 and round
half to even).  A storage and transfer format (checkpoint compression):
int8 serving runs through ``nn/llama.py: quantize_llama_params`` and K7 / K8.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

_QKEY = "__int8__"


def _quantize_leaf(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel (last axis) int8 quantization of an f32
    tensor."""
    # a 1-D leaf is all channels: a scale for each element, as in the JAX
    # module (its max over no axes)
    amax = x.abs().amax(dim=tuple(range(x.ndim - 1)), keepdim=True) if x.ndim > 1 else x.abs()
    amax = torch.clamp(amax, min=1e-12)
    # a tensor divisor: a CUDA division by a Python number multiplies by its
    # rounded reciprocal, which is not numpy's amax / 127 to the bit
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {_QKEY: q, "scale": scale}


def _is_quantized(node: Any) -> bool:
    return isinstance(node, dict) and _QKEY in node


def _map(fn, node):
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        vals = [_map(fn, v) for v in node]
        return vals if isinstance(node, list) else tuple(vals)
    return fn(node)


def quantize_tree(tree: Any, min_size: int = 4096) -> Any:
    """int8-quantize the floating tensors of ``tree`` with >= ``min_size``
    elements (smaller leaves stay exact)."""

    def q(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() \
                and leaf.numel() >= min_size:
            return _quantize_leaf(leaf.detach().float())
        return leaf

    return _map(q, tree)


def dequantize_tree(tree: Any, dtype=torch.float32) -> Any:
    """The tree with each quantized leaf replaced by codes * scale in
    ``dtype``."""
    if _is_quantized(tree):
        return (tree[_QKEY].float() * tree["scale"]).to(dtype)
    if isinstance(tree, dict):
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [dequantize_tree(v, dtype) for v in tree]
        return vals if isinstance(tree, list) else tuple(vals)
    return tree


def _leaves(tree: Any) -> list:
    out = []
    _map(out.append, tree)
    return out


def quantization_error(tree: Any, min_size: int = 4096) -> Tuple[float, float]:
    """(max relative error, compression ratio) of quantize -> dequantize:
    the largest |x - dequant(quant(x))| / max|x| over the floating leaves,
    and the bytes of the tree over those of its quantized form."""
    q = quantize_tree(tree, min_size)
    deq = dequantize_tree(q)
    max_rel, orig_bytes = 0.0, 0
    for a, b in zip(_leaves(tree), _leaves(deq)):
        if not isinstance(a, torch.Tensor):
            continue
        orig_bytes += a.numel() * a.element_size()
        if a.is_floating_point() and a.numel():
            denom = max(float(a.detach().abs().max()), 1e-12)
            max_rel = max(max_rel, float((a.detach().float() - b.float()).abs().max()) / denom)
    q_bytes = sum(t.numel() * t.element_size() for t in _leaves(q) if isinstance(t, torch.Tensor))
    return max_rel, orig_bytes / max(q_bytes, 1)
