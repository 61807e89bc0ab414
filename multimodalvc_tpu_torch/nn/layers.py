"""Shared building blocks of the encoders.

Port of ``multimodalvc_tpu/nn/layers.py``.  Submodules carry the flax
module names (``q_proj``, ``self_attn_layer_norm``, ``layers_0``, ...), so
the weight bridge (``interop/from_flax.py``) maps trees by path.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention, flash_attention
from ..ops.ring_attention import ring_attention
from ..parallel.collectives import all_gather, all_reduce_sum, shard_of
from ..parallel.mesh import BATCH_AXES, active_mesh
from ..parallel.tensor import heads_within, input_shard, split_head_attention


def use_flash(tq: int, tk: int, head_dim: int, x: torch.Tensor) -> bool:
    """The flash kernel runs for bf16 CUDA activations ``x`` at encoder
    lengths; f32 ones (an f32 feature dump) take the plain attention."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        return False
    return tq >= 256 and tk >= 256 and head_dim % 64 == 0


def gelu_exact(x):
    """erf GELU (torch F.gelu default; flax gelu(approximate=False))."""
    return F.gelu(x)


def gelu_tanh(x):
    """tanh GELU (flax ``nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


def dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: each element kept with probability 1 - ``rate``
    and scaled by 1 / (1 - rate), else zero; the mask is drawn from ``rng``
    (a generator on x's device).  No ``rng`` (evaluation) or a zero rate is
    the identity."""
    if rng is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def sharded_dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator],
                    shard: Optional[Tuple[int, int]]) -> torch.Tensor:
    """``dropout`` of ``x``, the slice ``shard`` = (rank, size) of the last
    dim of a tensor-split activation: the whole activation's mask is drawn
    (the generator's stream stays the one-rank run's) and sliced.  Without
    ``shard``, ``dropout``."""
    if shard is None or rng is None or rate == 0.0:
        return dropout(x, rate, rng)
    rank, size = shard
    n = x.shape[-1]
    whole = torch.rand(x.shape[:-1] + (n * size,), generator=rng, device=x.device)
    keep = whole[..., rank * n:(rank + 1) * n] >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def remat(fn, *args, rng: Optional[torch.Generator] = None, **kwargs):
    """``fn(*args, **kwargs)`` with its activations rematerialised in the
    backward (the JAX ``nn.remat``): ``torch.utils.checkpoint`` (not
    reentrant) keeps the inputs only and runs ``fn`` again in the backward.
    The dropout draws of ``fn`` come from the explicit generator ``rng``,
    which the checkpoint does not restore: its state before the forward is
    kept and replayed for the recompute, and put back after it, so the
    recompute draws the forward's masks and later draws are those of a run
    without remat."""
    if rng is None:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    before, calls = rng.get_state(), []

    def replayed(*a, **kw):
        if not calls:  # the forward
            calls.append(1)
            return fn(*a, **kw)
        now = rng.get_state()
        rng.set_state(before)
        try:
            return fn(*a, **kw)
        finally:
            rng.set_state(now)

    return checkpoint(replayed, *args, use_reentrant=False, **kwargs)


def add_layers(module: nn.Module, layers, prefix: str = "layers") -> list:
    """Register ``layers`` as ``layers_0``, ``layers_1``, ... (flax names;
    ``prefix`` replaces ``layers``)."""
    for i, layer in enumerate(layers):
        module.add_module(f"{prefix}_{i}", layer)
    return list(layers)


class MultiHeadAttention(nn.Module):
    """MHA with self/cross support and key-length masks; ``dropout`` on the
    attention output before ``out_proj`` in training (a ``dropout_rng``).

    ``sequence_parallel`` (self-attention): on a mesh whose sequence axis
    divides T, each sequence rank runs ring attention on its time chunk
    (``ops/ring_attention.py``) and the chunks' outputs are all-gathered
    along time; otherwise, as the JAX layer with the flag, the plain
    attention (never the flash kernel).

    On a tensor axis (``parallel/tensor.py``) ``q_proj`` / ``k_proj`` /
    ``v_proj`` are column-parallel and ``out_proj`` row-parallel: each rank
    attends with its H / tensor heads (with fewer heads than ranks, each
    head spans several: ``split_head_attention``)."""

    TENSOR_FORMS = {"q_proj": "column", "k_proj": "column", "v_proj": "column",
                    "out_proj": "row"}

    def __init__(self, d_model: int, num_heads: int, kv_dim: Optional[int] = None,
                 dropout: float = 0.0, sequence_parallel: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dropout, self.sequence_parallel = dropout, sequence_parallel
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.q_proj = nn.Linear(d_model, d_model, **kw)
        self.k_proj = nn.Linear(kv_dim or d_model, d_model, **kw)
        self.v_proj = nn.Linear(kv_dim or d_model, d_model, **kw)
        self.out_proj = nn.Linear(d_model, d_model, **kw)

    def forward(self, x, kv=None, *, kv_lens=None, dropout_rng=None):
        kv = x if kv is None else kv
        b, tq = x.shape[:2]
        tk = kv.shape[1]

        def split(t):  # this rank's heads
            return t.reshape(b, t.shape[1], -1, self.head_dim).transpose(1, 2)

        def key_mask():
            if kv_lens is None:
                return None
            return torch.arange(tk, device=x.device)[None, None, None, :] < kv_lens[:, None, None, None]

        q, k, v = self.q_proj(x), self.k_proj(kv), self.v_proj(kv)
        within = heads_within(self.num_heads, self.q_proj)
        if within is not None:
            out = split_head_attention(q, k, v, self.num_heads, within, key_mask())
            return self.out_proj(sharded_dropout(out, self.dropout, dropout_rng,
                                                 input_shard(self.out_proj)))
        q, k, v = split(q), split(k), split(v)
        ring = self.sequence_parallel and tq == tk
        mesh = active_mesh() if ring else None
        n_seq = mesh.size("sequence") if mesh is not None else 1
        if n_seq > 1 and tq % n_seq == 0:
            group = mesh.group("sequence")
            out = ring_attention(shard_of(q, group, 2), shard_of(k, group, 2),
                                 shard_of(v, group, 2), mesh, kv_len=kv_lens)
            out = all_gather(out, group, dim=2)
        elif not ring and use_flash(tq, tk, self.head_dim, q):
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), kv_lens=kv_lens)
        else:
            out = dot_product_attention(q, k, v, mask=key_mask())
        out = sharded_dropout(out.transpose(1, 2).reshape(b, tq, -1), self.dropout, dropout_rng,
                              input_shard(self.out_proj))
        return self.out_proj(out)


class FeedForward(nn.Module):
    TENSOR_FORMS = {"fc1": "column", "fc2": "row"}

    def __init__(self, d: int, hidden_dim: int, activation=gelu_exact, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.activation = activation
        self.fc1 = nn.Linear(d, hidden_dim, **kw)
        self.fc2 = nn.Linear(hidden_dim, d, **kw)

    def forward(self, x):
        return self.fc2(self.activation(self.fc1(x)))


class ConvPositionalEmbedding(nn.Module):
    """wav2vec2-style grouped conv positional embedding + SamePad + GELU."""

    def __init__(self, d: int, kernel_size: int = 128, groups: int = 16, device=None, dtype=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv = nn.Conv1d(d, d, kernel_size, padding=kernel_size // 2, groups=groups,
                              device=device, dtype=dtype)

    def forward(self, x):  # [B, T, D]
        pos = self.conv(x.transpose(1, 2)).transpose(1, 2)
        if self.kernel_size % 2 == 0:
            pos = pos[:, :-1]  # SamePad: drop the trailing element for even kernels
        return gelu_tanh(pos)


def sinusoidal_positions(n_pos: int, dim: int, base: float = 10000.0) -> np.ndarray:
    """Whisper-style [n_pos, dim] table: sin half, then cos half."""
    half = dim // 2
    freq = np.exp(-math.log(base) * np.arange(half) / (half - 1 if half > 1 else 1))
    pos = np.arange(n_pos)[:, None] * freq[None, :]
    return np.concatenate([np.sin(pos), np.cos(pos)], axis=1).astype(np.float32)


def batch_norm_train_(h: torch.Tensor, norm: nn.modules.batchnorm._BatchNorm,
                      momentum: float = 0.9, channel_dim: int = -1) -> torch.Tensor:
    """flax ``BatchNorm(use_running_average=False)`` over f32 ``h`` whose
    channels lie on ``channel_dim``: the batch mean and biased variance over
    every other dimension normalise ``h``, and move ``norm``'s running
    statistics (in place, no gradient, in the buffers' dtype) by
    ``momentum``.  On a mesh the statistics are the batch group's, as
    GSPMD's over the global batch: the sums and the count are all-reduced
    (their gradient summed back)."""
    dims = [d for d in range(h.ndim) if d != channel_dim % h.ndim]
    shape = [1] * h.ndim
    shape[channel_dim] = -1
    mesh = active_mesh()
    if mesh is not None and mesh.size(*BATCH_AXES) > 1:
        count = h.new_full((1,), h.numel() / h.shape[channel_dim])
        sums = all_reduce_sum(torch.cat([h.sum(dim=dims), (h * h).sum(dim=dims), count]),
                              mesh.group(*BATCH_AXES))
        c = h.shape[channel_dim]
        mean, mean_sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
    else:
        mean, mean_sq = h.mean(dim=dims), (h * h).mean(dim=dims)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    with torch.no_grad():
        for stat, batch in ((norm.running_mean, mean), (norm.running_var, var)):
            stat.copy_(momentum * stat.float() + (1.0 - momentum) * batch)
    scale = torch.rsqrt(var + norm.eps) * norm.weight.float()
    return (h - mean.view(shape)) * scale.view(shape) + norm.bias.float().view(shape)


class TransformerLayer(nn.Module):
    """fairseq wav2vec2 encoder layer, pre-LN (``layer_norm_first``: the
    AV-HuBERT large recipe and the speech-rate predictor) or post-LN (the
    base recipe).  ``dropout`` drops each residual branch in training (masks
    from ``dropout_rng``); the attention and FFN insides never drop, as in
    the JAX layer (their rates are 0 there)."""

    def __init__(self, d: int, num_heads: int, ffn_dim: int, dropout: float = 0.0,
                 layer_norm_first: bool = True, sequence_parallel: bool = False, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dropout, self.layer_norm_first = dropout, layer_norm_first
        self.self_attn = MultiHeadAttention(d, num_heads, sequence_parallel=sequence_parallel,
                                            **kw)
        self.ffn = FeedForward(d, ffn_dim, activation=gelu_tanh, **kw)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5, **kw)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5, **kw)

    def forward(self, x, *, kv_lens=None, dropout_rng=None):
        def drop(h):
            return dropout(h, self.dropout, dropout_rng)

        ln1, ln2 = self.self_attn_layer_norm, self.final_layer_norm
        if self.layer_norm_first:
            x = x + drop(self.self_attn(ln1(x), kv_lens=kv_lens))
            return x + drop(self.ffn(ln2(x)))
        x = ln1(x + drop(self.self_attn(x, kv_lens=kv_lens)))
        return ln2(x + drop(self.ffn(x)))


class TransformerEncoder(nn.Module):
    """Stack of TransformerLayers with a conv positional embedding.  The
    outer LayerNorm runs after the stack for pre-LN layers and before it for
    post-LN ones (fairseq wav2vec2); ``dropout`` drops the stack's input and
    each layer's residual branches in training (a ``dropout_rng``).
    ``remat`` rematerialises each layer's activations in the backward
    (``remat``) when a gradient is being taken."""

    def __init__(self, d: int, num_layers: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.0, layer_norm_first: bool = True,
                 conv_pos: int = 128, conv_pos_groups: int = 16, sequence_parallel: bool = False,
                 remat: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dropout, self.layer_norm_first, self.remat = dropout, layer_norm_first, remat
        self.pos_conv = ConvPositionalEmbedding(d, conv_pos, conv_pos_groups, **kw)
        self.layer_norm = nn.LayerNorm(d, eps=1e-5, **kw)
        self.layers = add_layers(self, [
            TransformerLayer(d, num_heads, ffn_dim, dropout, layer_norm_first,
                             sequence_parallel, **kw)
            for _ in range(num_layers)])

    def forward(self, x, *, lengths=None, dropout_rng=None, output_layer: Optional[int] = None):
        """``output_layer=N`` returns the state after layer N (from 1),
        without the final LayerNorm of a pre-LN stack (fairseq's
        ``extract_features(tgt_layer)``, the iteration-2 feature dump)."""
        if lengths is not None:
            keep = torch.arange(x.shape[1], device=x.device)[None, :, None] < lengths[:, None, None]
            x = x * keep.to(x.dtype)
        x = x + self.pos_conv(x)
        if not self.layer_norm_first:
            x = self.layer_norm(x)
        x = dropout(x, self.dropout, dropout_rng)
        for i, layer in enumerate(self.layers):
            if self.remat and torch.is_grad_enabled():
                x = remat(layer, x, rng=dropout_rng, kv_lens=lengths, dropout_rng=dropout_rng)
            else:
                x = layer(x, kv_lens=lengths, dropout_rng=dropout_rng)
            if output_layer is not None and i + 1 == output_layer:
                return x
        return self.layer_norm(x) if self.layer_norm_first else x
