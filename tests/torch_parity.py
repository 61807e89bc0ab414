"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs on the CPU (interpret-mode Pallas or its plain reference)
and the port runs its plain PyTorch versions, all in f32.
"""
from __future__ import annotations

import jax
import numpy as np
import torch

from multimodalvc_tpu_torch.interop.from_flax import (
    load_flax_variables,
    state_dict_to_flax_variables,
)

torch.set_num_threads(1)  # tier-1 runs several xdist workers on the same cores


def to_numpy_tree(variables):
    return jax.tree.map(np.asarray, variables)


def randomize(variables, seed: int = 1):
    """Give the init tree's degenerate leaves real values: LoRA ``lora_b``
    (zero-initialised) and the BatchNorm running statistics (0 / 1), so the
    parity tests exercise them."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        x = np.asarray(x)
        if name == "lora_b":
            return (rng.standard_normal(x.shape) * 0.05).astype(x.dtype)
        if name == "mean":
            return (rng.standard_normal(x.shape) * 0.1).astype(x.dtype)
        if name == "var":
            return (0.5 + rng.random(x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def loaded(torch_module: torch.nn.Module, variables) -> torch.nn.Module:
    """``torch_module`` with the flax ``variables`` loaded, in eval mode."""
    load_flax_variables(torch_module, to_numpy_tree(variables))
    return torch_module.eval()


def jax_variables(init, batch, torch_module: torch.nn.Module):
    """``torch_module``'s weights as the flax variables tree that ``init(key,
    batch)`` lays out, as numpy copies, each leaf of the init's shape: both
    packages start from the same weights without compiling the JAX init."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), batch)
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    out = jax.tree.map(np.array, state_dict_to_flax_variables(torch_module.state_dict(), template))
    want = jax.tree_util.tree_leaves({k: template[k] for k in out})
    for (path, x), like in zip(jax.tree_util.tree_leaves_with_path(out), want, strict=True):
        if x.shape != like.shape:
            raise ValueError(f"{jax.tree_util.keystr(path)}: {x.shape}, the init's {like.shape}")
    return out


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def max_err(jax_out, torch_out) -> float:
    a = np.asarray(jax_out, dtype=np.float64)
    b = torch_out.detach().double().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) if a.size else 0.0
