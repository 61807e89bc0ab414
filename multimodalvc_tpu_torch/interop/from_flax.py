"""Weight bridge between a flax variables tree (numpy leaves) and a torch
state_dict, in both directions (``flax_to_state_dict``, ``state_dict_to_flax``).

The port's modules carry the flax module names, so a tree path maps to a
state_dict key by joining with dots; only the leaf names and layouts change:

- Dense ``kernel`` [in, out]             -> ``weight`` [out, in]
- Conv1d ``kernel`` [K, in/groups, out]   -> ``weight`` [out, in/groups, K]
  (the grouped positional conv included)
- Conv2d ``kernel`` [kH, kW, in, out]     -> ``weight`` [out, in, kH, kW]
  (the ResNet stem keeps its tap-stacked 5-input-channel form)
- LayerNorm / BatchNorm / RMSNorm ``scale`` and Embed ``embedding`` and
  PReLU ``alpha``                         -> ``weight``
- BatchNorm running statistics (``batch_stats`` ``mean`` / ``var``)
                                          -> ``running_mean`` / ``running_var``
                                             (+ ``num_batches_tracked`` = 0)
- Weight-normalized conv ``v`` (and only a leaf named ``v``): Conv1d
  [K, I/g, O] -> [O, I/g, K], ConvTranspose1d [K, O, I] -> [I, O, K] (one
  transpose for both), Conv2d [kH, kW, I, O] -> [O, I, kH, kW]; its ``g``
  keeps its layout.  A spectral-normalized conv's ``v`` moves the same way.
- The ``spectral`` collection's ``u`` [O] and ``v`` [K * I/g] (the power
  iteration's vectors) -> the buffers ``sn_u`` and ``sn_v``, ``v``
  reordered from the flax flattening (K, I/g) to torch's (I/g, K).
- LoRA ``lora_a`` [in, r] / ``lora_b`` [r, out], ``sr_token``,
  ``query_tokens``, ``light_weights`` [H, K], ``audio_mask_emb``,
  ``video_mask_emb`` and the generator's ``lut`` keep their names and
  layouts.
- The quantized leaves of ``QuantDense`` (``w_q``, ``w_packed``,
  ``w_scale``) cross untransposed, in the flax [d_in, d_out] layout and
  their packed formats, so both packages serve from one checkpoint byte for
  byte.  bf16 leaves (the quantized tree's embedding table) stay bf16.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_RENAME = {"scale": "weight", "embedding": "weight", "alpha": "weight"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _leaves(val, path)
        else:
            yield path, np.asarray(val)


def _convert(name: str, x: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "v":
        if x.ndim == 3:
            return "v", x.transpose(2, 1, 0)
        if x.ndim == 4:
            return "v", x.transpose(3, 2, 0, 1)
        raise ValueError(f"weight-norm v of rank {x.ndim}")
    if name == "kernel":
        if x.ndim == 2:
            return "weight", x.T
        if x.ndim == 3:
            return "weight", x.transpose(2, 1, 0)
        if x.ndim == 4:
            return "weight", x.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {x.ndim}")
    return _RENAME.get(name, name), x


def _tensor(x: np.ndarray) -> torch.Tensor:
    if x.dtype.name == "bfloat16":  # ml_dtypes: torch.from_numpy does not take it
        return torch.from_numpy(np.array(x).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _sn_order(v: np.ndarray, kernel_shape, to_torch: bool) -> np.ndarray:
    """A spectral ``v`` vector between the flax order (K, I/g) and torch's
    (I/g, K), for a conv kernel of torch shape [O, I/g, K]."""
    _, i, k = kernel_shape
    return (v.reshape(k, i).T if to_torch else v.reshape(i, k).T).reshape(-1)


def flax_to_state_dict(variables: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Convert ``{"params": ..., "batch_stats": ..., "spectral": ...}`` to a
    state_dict whose keys are the module paths joined by dots (``prefix`` is
    prepended)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, x in _leaves(variables.get("params", {})):
        name, y = _convert(path[-1], x)
        sd[prefix + ".".join(path[:-1] + (name,))] = _tensor(y)
    for path, x in _leaves(variables.get("batch_stats", {})):
        base = prefix + ".".join(path[:-1])
        sd[f"{base}.{_STATS[path[-1]]}"] = _tensor(x)
        sd[f"{base}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    for path, x in _leaves(variables.get("spectral", {})):
        base = prefix + ".".join(path[:-1])
        if path[-1] == "v":
            x = _sn_order(x, sd[f"{base}.v"].shape, to_torch=True)
        sd[f"{base}.sn_{path[-1]}"] = _tensor(x)
    return sd


def load_flax_variables(module: torch.nn.Module, variables: Mapping[str, Any],
                        prefix: str = "") -> None:
    """Load a flax variables tree into ``module``, strictly: every parameter
    and buffer must be covered and every leaf used."""
    module.load_state_dict(flax_to_state_dict(variables, prefix), strict=True)


def state_dict_to_flax(sd: Mapping[str, torch.Tensor],
                       template: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``flax_to_state_dict``: the ``params`` of the flax tree
    ``template`` (its nested names and leaf names; ``params`` only) with each
    leaf taken from ``sd`` and put back in the flax layout, as numpy f32 (or
    the tensor's own numpy type)."""

    def leaf(path, like):
        name = path[-1]
        key = ".".join(path[:-1] + (_convert(name, np.asarray(like))[0],))
        x = sd[key].detach().cpu()
        x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        if name == "kernel":
            x = x.T if x.ndim == 2 else x.transpose(2, 1, 0) if x.ndim == 3 else \
                x.transpose(2, 3, 1, 0)
        elif name == "v":
            x = x.transpose(2, 1, 0) if x.ndim == 3 else x.transpose(2, 3, 1, 0)
        return x

    def walk(tree, prefix):
        return {k: walk(v, prefix + (str(k),)) if isinstance(v, Mapping) else
                leaf(prefix + (str(k),), v) for k, v in tree.items()}

    return walk(template, ())


def state_dict_to_flax_variables(sd: Mapping[str, torch.Tensor],
                                 template: Mapping[str, Any]) -> Dict[str, Any]:
    """``state_dict_to_flax`` for a whole variables tree: ``{"params": ...}``
    and, where ``template`` has them, the BatchNorm ``batch_stats`` (``mean``
    / ``var`` from ``running_mean`` / ``running_var``) and the ``spectral``
    vectors (``u`` / ``v`` from ``sn_u`` / ``sn_v``, ``v`` back in the flax
    order)."""
    out = {"params": state_dict_to_flax(sd, template["params"])}

    def stat(path):
        return sd[".".join(path[:-1] + (_STATS[path[-1]],))]

    def spectral(path):
        base = ".".join(path[:-1])
        x = sd[f"{base}.sn_{path[-1]}"].detach().cpu().numpy()
        return _sn_order(x, sd[f"{base}.v"].shape, to_torch=False) if path[-1] == "v" else x

    def walk(tree, prefix, leaf):
        return {k: walk(v, prefix + (str(k),), leaf) if isinstance(v, Mapping) else
                np.asarray(leaf(prefix + (str(k),))) for k, v in tree.items()}

    if "batch_stats" in template:
        out["batch_stats"] = walk(template["batch_stats"], (),
                                  lambda p: stat(p).detach().cpu().numpy())
    if "spectral" in template:
        out["spectral"] = walk(template["spectral"], (), spectral)
    return out
