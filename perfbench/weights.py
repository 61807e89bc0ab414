"""Seeded weights by parameter name and shape, made on the device.

The names, shapes and kinds come from the plain reference built on the meta
device (``reference/model.py``, whose names are the port's).  Each kind is
drawn in one call a dtype: matrices, convolutions, embeddings and learned
tokens N(0, 0.02) in one ``randn``; the mask embeddings U[0, 1) in one
``rand``; norms 1, biases 0, PReLU 0.25 and the BatchNorm statistics (0, 1)
in one ``repeat_interleave``; then each weight-normalised conv's g = ||v||,
so that its weight is its v.  The same state dict loads into the port and,
in f32, into the reference.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from perfbench.reference import model as ref


def _kind(mod: nn.Module, name: str) -> Tuple[str, float]:
    """("normal", std) / ("uniform", 0) / ("const", value) / ("norm_g", 0)."""
    if isinstance(mod, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)):
        if name in ("weight", "running_var"):
            return "const", 1.0
        return "const", 0.0
    if isinstance(mod, nn.PReLU):
        return "const", 0.25
    if name == "bias":
        return "const", 0.0
    if name.endswith("mask_emb"):
        return "uniform", 0.0
    if isinstance(mod, ref.WNConv) and name == "g":
        return "norm_g", 0.0
    return "normal", 0.02


def spec(module: nn.Module) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, kind, value) of every parameter and float buffer that
    the state dict holds, in ``named_modules`` order."""
    out = []
    for mname, mod in module.named_modules():
        pre = f"{mname}." if mname else ""
        for n, p in mod.named_parameters(recurse=False):
            out.append((pre + n, tuple(p.shape)) + _kind(mod, n))
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            for n in ("running_mean", "running_var"):
                out.append((pre + n, (mod.num_features,)) + _kind(mod, n))
    return out


def make(module_spec, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The state dict of ``module_spec`` from ``seed`` on ``device``: random
    leaves in ``dtype``; constants, BatchNorm statistics and g in f32 (the
    port keeps its BatchNorms in f32 and casts the rest on load); each g is
    rounded to ``dtype``, so that the port and the reference hold the same."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    numel = {k: sum(int(torch.Size(s).numel()) for _, s, kind, _ in module_spec if kind == k)
             for k in ("normal", "uniform")}
    normal = torch.randn(numel["normal"], generator=g, device=device, dtype=dtype).mul_(0.02)
    uniform = torch.rand(numel["uniform"], generator=g, device=device, dtype=dtype)
    consts = [(n, s, v) for n, s, kind, v in module_spec if kind == "const"]
    values = torch.tensor([v for _, _, v in consts], device=device)
    counts = torch.tensor([int(torch.Size(s).numel()) for _, s, _ in consts], device=device)
    const = torch.repeat_interleave(values, counts)
    out: Dict[str, torch.Tensor] = {}
    at = {"normal": 0, "uniform": 0, "const": 0}
    src = {"normal": normal, "uniform": uniform, "const": const}
    for name, shape, kind, _ in module_spec:
        if kind == "norm_g":
            continue
        n = int(torch.Size(shape).numel())
        out[name] = src[kind][at[kind]:at[kind] + n].view(shape)
        at[kind] += n
    for name, shape, kind, _ in module_spec:
        if kind == "norm_g":
            v = out[name[:-1] + "v"].float()
            out[name] = v.flatten(1).norm(dim=1).to(dtype)
    return out


def load_into(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` into ``module``'s parameters and BatchNorm statistics by
    name (each cast to the module's dtype for it); every one of them must be
    in ``state``, and nothing else."""
    own = dict(module.named_parameters())
    for mname, mod in module.named_modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            pre = f"{mname}." if mname else ""
            own[pre + "running_mean"], own[pre + "running_var"] = mod.running_mean, mod.running_var
            mod.num_batches_tracked.zero_()
    missing, extra = sorted(set(own) - set(state)), sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing[:5]}, unexpected {extra[:5]}")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(state[name])
