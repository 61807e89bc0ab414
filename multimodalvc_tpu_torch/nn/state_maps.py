"""Helpers that write a reference checkpoint's entries into a state dict in
the port's layout: the shared vocabulary of the weight importers
(``nn/whisper.py``, ``nn/avhubert.py``, ``nn/llama.py`` and
``interop/``).  Each ``put_*`` copies one module's entries from the
reference name ``src`` of ``state`` to the port's name ``dst`` of ``out``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def as_tensor(x) -> torch.Tensor:
    """A state-dict value (a tensor, or a numpy array or scalar) as a tensor."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def f32_numpy(x) -> np.ndarray:
    """A state-dict value as an f32-or-wider numpy array (bf16 widened)."""
    x = as_tensor(x).detach().cpu()
    return (x.float() if x.dtype in (torch.bfloat16, torch.float16) else x).numpy()


def put_linear(out: StateDict, state: Mapping, src: str, dst: str, bias: bool = True) -> None:
    out[f"{dst}.weight"] = as_tensor(state[f"{src}.weight"])
    if bias:
        out[f"{dst}.bias"] = as_tensor(state[f"{src}.bias"])


put_norm = put_linear  # LayerNorm: weight and bias under the same names


def put_batch_norm(out: StateDict, state: Mapping, src: str, dst: str) -> None:
    """BatchNorm affine and running statistics; ``num_batches_tracked``
    starts at 0, as the flax bridge gives it."""
    put_linear(out, state, src, dst)
    out[f"{dst}.running_mean"] = as_tensor(state[f"{src}.running_mean"])
    out[f"{dst}.running_var"] = as_tensor(state[f"{src}.running_var"])
    out[f"{dst}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def fold_weight_norm(state: Mapping, src: str) -> torch.Tensor:
    """A fairseq weight-normed conv (``weight_g`` / ``weight_v``, norm over
    every dim but the last: torch ``dim=2``) folded to its plain weight
    ``g * v / max(||v||, 1e-12)``, in numpy f32 as the JAX import folds it."""
    v = f32_numpy(state[f"{src}.weight_v"])
    g = f32_numpy(state[f"{src}.weight_g"])
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    return torch.from_numpy(g * v / np.maximum(norm, 1e-12))


def put_pos_conv(out: StateDict, state: Mapping, src: str, dst: str) -> None:
    """The transformer's positional conv: weight-normed (folded) or plain."""
    if f"{src}.weight_v" in state:
        out[f"{dst}.weight"] = fold_weight_norm(state, src)
    else:
        out[f"{dst}.weight"] = as_tensor(state[f"{src}.weight"])
    out[f"{dst}.bias"] = as_tensor(state[f"{src}.bias"])


def put_transformer_layers(out: StateDict, state: Mapping, src: str, dst: str,
                           num_layers: int) -> None:
    """The fairseq / wav2vec2 encoder layers ``{src}.layers.{i}`` as
    ``{dst}.layers_{i}`` of ``nn/layers.py: TransformerEncoder``."""
    for i in range(num_layers):
        s, d = f"{src}.layers.{i}", f"{dst}.layers_{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put_linear(out, state, f"{s}.self_attn.{proj}", f"{d}.self_attn.{proj}")
        put_norm(out, state, f"{s}.self_attn_layer_norm", f"{d}.self_attn_layer_norm")
        put_linear(out, state, f"{s}.fc1", f"{d}.ffn.fc1")
        put_linear(out, state, f"{s}.fc2", f"{d}.ffn.fc2")
        put_norm(out, state, f"{s}.final_layer_norm", f"{d}.final_layer_norm")
