"""Which leaves the tensor and fsdp axes split, and along which dims.

Port of ``multimodalvc_tpu/parallel/sharding.py``: the ordered rule table
``TRANSFORMER_TP_RULES`` (path regex -> partition spec, first match wins),
``_spec_fits`` and the fsdp fallback of ``infer_param_specs`` (a leaf
whose largest dim is at least ``FSDP_MIN_SIZE`` is split along its largest
dim that the fsdp size divides, the first of equal ones; smaller leaves
stay whole).  A rule whose spec does not fit the mesh falls back as in JAX.

The rules read the flax tree: "/"-joined paths ending in ``kernel``,
``embedding``, ``scale``, ``bias``, ... and the flax layouts ([in, out]
Dense kernels, [K, in/g, out] conv kernels).  The port's modules carry the
flax module names (``interop/from_flax.py``), so ``param_specs`` maps each
``state_dict`` name to its flax path (dots to slashes, ``weight`` to
``kernel`` / ``embedding`` / ``scale`` / ``alpha`` by module type) and its
shape to the flax layout, applies the rules there, and returns the split
dims in the port's (torch) layout: ``LeafSpec(tensor, fsdp)``.

The JAX rules' quirks stay as they are: the LLaMA ``q/k/v/o_proj`` kernels
(``.../q_proj/base/kernel``) and the Conformer's ``w_1`` / ``w_2`` match no
rule; ``intermediate_query`` and ``output_query`` both match the column
rule (``query``); ``video_proj`` and ``audio_proj`` match the row rule
(``o_proj``); any leaf whose name ends in ``b`` (``lora_b``,
``mask_emb``) is kept whole.

The tensor split is held by the modules themselves
(``parallel/tensor.py: split_tensor_parallel_``); the fsdp split by the
trainer, which keeps only its share of the f32 master and the optimizer
state (ZeRO-3 for the optimizer state, ``runtime/trainer.py``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from torch import nn

FSDP_MIN_SIZE = 1024

Spec = Tuple[Optional[str], ...]
Rule = Tuple[str, Spec]

# Dense kernels are [in, out]: column-parallel projections split the out
# dim, row-parallel (output) projections the in dim
TRANSFORMER_TP_RULES: List[Rule] = [
    (r".*(q_proj|k_proj|v_proj|query|key|value|wq|wk|wv)/kernel$", ("fsdp", "tensor")),
    (r".*(gate_proj|up_proj|fc1|w1|w3|intermediate)/.*kernel$", ("fsdp", "tensor")),
    (r".*(o_proj|out_proj|wo|fc2|w2|output_proj)/kernel$", ("tensor", "fsdp")),
    (r".*embed_tokens/embedding$", ("tensor", "fsdp")),
    (r".*lm_head/kernel$", ("fsdp", "tensor")),
    (r".*(bias|scale|b)$", ()),
    (r".*experts.*kernel$", ("expert", "fsdp", "tensor")),
    (r".*experts_w\d$", ("expert",)),
    (r".*expert_centroids$", ()),
]
_COMPILED = [(re.compile(rx), spec) for rx, spec in TRANSFORMER_TP_RULES]


def fsdp_fallback_spec(shape: Sequence[int], fsdp_size: int) -> Spec:
    """The largest dim the fsdp size divides, over "fsdp"; small leaves
    whole (``_fsdp_fallback_spec``)."""
    if fsdp_size <= 1 or not shape or max(shape) < FSDP_MIN_SIZE:
        return ()
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] % fsdp_size == 0:
            return tuple("fsdp" if i == d else None for i in range(len(shape)))
    return ()


def spec_fits(shape: Sequence[int], spec: Spec, sizes: Mapping[str, int]) -> bool:
    """Every axis of more than one device divides its dim (``_spec_fits``)."""
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        size = sizes.get(axis, 1) if axis is not None else 1
        if size > 1 and dim % size != 0:
            return False
    return True


def infer_spec(path: str, shape: Sequence[int], sizes: Mapping[str, int]) -> Spec:
    """The partition spec of the flax leaf ``path`` of ``shape`` on a mesh of
    ``sizes``: the first rule that matches, if it fits, else the fallback."""
    for rx, spec in _COMPILED:
        if rx.match(path):
            if spec_fits(shape, spec, sizes):
                return spec
            break
    return fsdp_fallback_spec(shape, sizes.get("fsdp", 1))


# torch dim of each flax dim: Dense [in, out] <- [out, in]; conv [K, in/g,
# out] <- [out, in/g, K]; conv2d [kH, kW, in, out] <- [out, in, kH, kW]
_TO_TORCH = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def flax_leaf(module: nn.Module, name: str, ndim: int) -> Tuple[str, Tuple[int, ...]]:
    """(the flax leaf name, the torch dim of each flax dim) of ``module``'s
    parameter ``name`` (the inverse of the weight bridge's renames)."""
    same = tuple(range(ndim))
    if name == "v" and ndim in (3, 4):  # a weight-normalized conv's direction
        return name, _TO_TORCH[ndim]
    if name != "weight":
        return name, same
    if isinstance(module, nn.Embedding) or getattr(module, "flax_leaf", None) == "embedding":
        return "embedding", same
    if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)) or \
            getattr(module, "flax_leaf", None) == "kernel":
        return "kernel", _TO_TORCH[ndim]
    if isinstance(module, nn.PReLU):
        return "alpha", same
    return "scale", same  # LayerNorm, BatchNorm, RMSNorm


@dataclass(frozen=True)
class LeafSpec:
    """The torch dims along which the tensor and the fsdp axes split a leaf
    (None: whole on that axis)."""

    tensor: Optional[int] = None
    fsdp: Optional[int] = None


def param_specs(module: nn.Module, sizes: Mapping[str, int]) -> Dict[str, LeafSpec]:
    """The ``LeafSpec`` of each parameter of ``module`` (by ``state_dict``
    name) on a mesh of ``sizes``, from the rules applied to its flax path
    and its whole shape (a tensor-split parameter's ``whole_shape``)."""
    out = {}
    for mod_name, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            shape = tuple(getattr(p, "whole_shape", p.shape))
            leaf, to_torch = flax_leaf(mod, name, len(shape))
            path = "/".join(filter(None, (mod_name.replace(".", "/"), leaf)))
            spec = infer_spec(path, tuple(shape[d] for d in to_torch), sizes)
            dims = {axis: to_torch[i] for i, axis in enumerate(spec)
                    if axis in ("tensor", "fsdp") and sizes.get(axis, 1) > 1}
            out[f"{mod_name}.{name}" if mod_name else name] = LeafSpec(dims.get("tensor"),
                                                                       dims.get("fsdp"))
    return out
