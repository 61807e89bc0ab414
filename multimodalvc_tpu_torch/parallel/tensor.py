"""The tensor axis: Megatron's column- and row-parallel forms of the leaves
that the JAX sharding rules split.

The JAX package annotates the leaves (``parallel/sharding.py:
TRANSFORMER_TP_RULES``) and lets GSPMD insert the collectives; here
``split_tensor_parallel_`` swaps each rule-split ``nn.Linear`` /
``nn.Embedding`` for its parallel form, which holds only this rank's slice
of the weight and calls the tensor group's region operators
(``parallel/collectives.py``):

- ``ColumnParallelLinear``: the rows of the torch [out, in] weight (the
  flax kernel's out dim).  The input enters the region (copy), the output
  is this rank's slice of the features, or with ``gather_output`` the whole
  features.  The bias is the whole leaf (the JAX rules keep it whole), of
  which each rank adds its slice.  The input's gradient, a sum of the
  ranks' partial products, is taken and all-reduced in f32 and cast once.
- ``RowParallelLinear``: the columns (the flax in dim).  Its input is the
  split features of a column partner, or with ``scatter_input`` the whole
  features of which it takes its slice.  Each rank's partial product
  accumulates in f32 and is all-reduced in f32, the whole bias added once
  after the reduce, then one cast: the numbers of the one-rank product.
- ``VocabParallelEmbedding``: the rows of the [V, D] table; ids outside the
  rank's rows are masked, then one all-reduce.  The tied unembed
  (``nn/llama.py``) gives the logits over the rank's vocabulary.

A module declares how its children split in ``TENSOR_FORMS`` (child name
-> "column", "row", "column_gather", "row_scatter" or "vocab"); the
"column" / "row" children of one module split together or not at all
(an attention's projections, an FFN).  A leaf that the rules split and
that no form holds raises, naming it: it is never left whole.  The modules
that read the split width take their local heads from the weights.

A split parameter carries ``tensor_dim`` (the torch dim it is split along),
``whole_shape`` and ``tensor_group``; ``gather_whole`` gathers a whole leaf
(or a tensor of its slice's shape, such as its master) and ``slice_of``
takes a whole one's slice, with which the trainers' checkpoints hold whole
leaves: one written on any tensor size resumes on any other.  The tensor
collectives run inside ``parallel.mesh.local()`` too: validation runs on
the split modules, every rank of a tensor group on the same batches.
"""
from __future__ import annotations

import logging
import math
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .collectives import (
    copy_to_tensor_region,
    gather_from_tensor_region,
    reduce_from_tensor_region,
    scatter_to_tensor_region,
)
from .mesh import AXIS_ORDER, Mesh, get_current_mesh
from .sharding import param_specs

logger = logging.getLogger(__name__)

PAIRED = ("column", "row")


def _mark(p: nn.Parameter, dim: int, whole, group) -> nn.Parameter:
    p.tensor_dim, p.whole_shape, p.tensor_group = dim, torch.Size(whole), group
    return p


def slice_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal slice of ``t`` along ``dim`` (a copy)."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n).clone().contiguous()


def _split_param(p: torch.Tensor, dim: int, group) -> nn.Parameter:
    out = nn.Parameter(slice_dim(p.detach(), dim, group), requires_grad=p.requires_grad)
    return _mark(out, dim, p.shape, group)


def tensor_dim(p: torch.Tensor) -> Optional[int]:
    """The dim along which the tensor axis splits parameter ``p`` (None:
    whole)."""
    return getattr(p, "tensor_dim", None)


class _PartialLinear(torch.autograd.Function):
    """x @ w^T with f32 output (f32 accumulation) for any operand type; the
    gradients in the operands' type, from the gradient rounded to it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _f32_mm(x.reshape(-1, x.shape[-1]), w.T).reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w if ctx.needs_input_grad[0] else None
        dw = g.reshape(-1, g.shape[-1]).T @ x.reshape(-1, x.shape[-1]) \
            if ctx.needs_input_grad[1] else None
        return dx, dw


def _f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, K] @ b [K, M] with f32 accumulation and f32 output."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _ColumnLinear(torch.autograd.Function):
    """The column-parallel product entered from the whole input: x @ w^T (+
    b, this rank's slice of the bias), the identity into the region; the
    input's gradient is the sum over the tensor group of each rank's
    partial product, each taken and summed in f32 and cast once (the
    copy operator's all-reduce, at the one-rank product's rounding)."""

    @staticmethod
    def forward(ctx, x, w, b, group):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.has_bias = group, b is not None
        return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            part = _f32_mm(g2, w).reshape(*g.shape[:-1], -1)
            dist.all_reduce(part, group=ctx.group)
            dx = part.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = g2.T @ x.reshape(-1, x.shape[-1])
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g2.sum(0)
        return dx, dw, db, None


class ColumnParallelLinear(nn.Module):
    """This rank's rows of a Linear's weight; the output this rank's slice
    of the features (``gather_output``: the whole features)."""

    flax_leaf = "kernel"

    def __init__(self, linear: nn.Linear, group, gather_output: bool = False):
        super().__init__()
        self.group, self.gather_output = group, gather_output
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.weight = _split_param(linear.weight, 0, group)
        self.bias = linear.bias  # the whole leaf

    def forward(self, x):
        b = None if self.bias is None else scatter_to_tensor_region(self.bias, self.group)
        y = _ColumnLinear.apply(x, self.weight, b, self.group)
        return gather_from_tensor_region(y, self.group) if self.gather_output else y


class RowParallelLinear(nn.Module):
    """This rank's columns of a Linear's weight; the input this rank's
    slice of the features (``scatter_input``: the whole features, sliced
    here); the output whole."""

    flax_leaf = "kernel"

    def __init__(self, linear: nn.Linear, group, scatter_input: bool = False):
        super().__init__()
        self.group, self.scatter_input = group, scatter_input
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.weight = _split_param(linear.weight, 1, group)
        self.bias = linear.bias  # the whole leaf, added once after the reduce
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        self.input_shard = (rank, size)

    def forward(self, x):
        if self.scatter_input:
            x = scatter_to_tensor_region(x, self.group)
        y = reduce_from_tensor_region(_PartialLinear.apply(x, self.weight), self.group)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class VocabParallelEmbedding(nn.Module):
    """This rank's rows ``start`` .. ``start + weight.shape[0]`` of the
    [V, D] table.  The lookup takes ids of any shape (a 0-d one too)."""

    flax_leaf = "embedding"

    def __init__(self, emb: nn.Embedding, group):
        super().__init__()
        self.group = group
        self.num_embeddings, self.embedding_dim = emb.num_embeddings, emb.embedding_dim
        self.weight = _split_param(emb.weight, 0, group)
        self.start = dist.get_rank(group) * self.weight.shape[0]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids.long() - self.start
        outside = (local < 0) | (local >= self.weight.shape[0])
        rows = self.weight[torch.where(outside, torch.zeros_like(local), local)]
        rows = torch.where(outside[..., None], torch.zeros((), dtype=rows.dtype,
                                                           device=rows.device), rows)
        return reduce_from_tensor_region(rows, self.group)


def vocab_parallel(emb: nn.Module) -> Optional[VocabParallelEmbedding]:
    """``emb`` if it is a vocab-parallel table, else None."""
    return emb if isinstance(emb, VocabParallelEmbedding) else None


def gather_columns(h: torch.Tensor, column: nn.Module) -> torch.Tensor:
    """The whole features from the split output ``h`` of ``column`` (itself
    where ``column`` is not split)."""
    if isinstance(column, ColumnParallelLinear):
        return gather_from_tensor_region(h, column.group)
    return h


def heads_within(num_heads: int, proj: nn.Module):
    """The tensor group of a column-parallel ``proj`` whose size is a
    multiple of ``num_heads`` past it (each head spans several ranks, as
    GSPMD splits a narrow attention's kernels), else None."""
    if isinstance(proj, ColumnParallelLinear):
        size = dist.get_world_size(proj.group)
        if num_heads % size:
            return proj.group
    return None


def split_head_attention(q, k, v, num_heads: int, group, mask=None) -> torch.Tensor:
    """Attention where each of ``num_heads`` heads spans size / num_heads
    ranks of the tensor ``group``: q [B, Tq, n], k and v [B, Tk, n] are this
    rank's columns (a part of one head).  The partial scores of each rank's
    head are summed over the group (the scores of every head on every
    rank), softmaxed in f32 (``mask`` [B, 1, 1, Tk] or None: True attends),
    and applied to the rank's columns of v: [B, Tq, n], this rank's columns
    of the output (``ops/attention.py: dot_product_attention``'s numbers)."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    per = size // num_heads
    head = rank // per
    scale = 1.0 / math.sqrt(q.shape[-1] * per)
    part = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    onehot = torch.zeros(num_heads, dtype=part.dtype, device=part.device)
    onehot[head] = 1.0
    scores = reduce_from_tensor_region(part[:, None] * onehot[None, :, None, None], group)
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = copy_to_tensor_region(torch.softmax(scores, dim=-1), group)[:, head]
    return torch.einsum("bqk,bkd->bqd", probs.to(v.dtype), v)


def input_shard(proj: nn.Module):
    """(rank, size) of the split input of a row-parallel ``proj``, else None."""
    return getattr(proj, "input_shard", None) if isinstance(proj, RowParallelLinear) else None


_FORMS = {
    "column": lambda m, g: ColumnParallelLinear(m, g),
    "column_gather": lambda m, g: ColumnParallelLinear(m, g, gather_output=True),
    "row": lambda m, g: RowParallelLinear(m, g),
    "row_scatter": lambda m, g: RowParallelLinear(m, g, scatter_input=True),
    "vocab": lambda m, g: VocabParallelEmbedding(m, g),
}
# the torch dim of the weight that each form splits
_FORM_DIM = {"column": 0, "column_gather": 0, "row": 1, "row_scatter": 1, "vocab": 0}


def split_tensor_parallel_(module: nn.Module, mesh: Optional[Mesh] = None) -> Dict[str, int]:
    """Swap each rule-split Linear / Embedding of ``module`` for its
    tensor-parallel form holding this rank's slice, after the weights are
    final (init, ``init_from_pt``, a resume).  Each leaf to split first
    takes the value of the tensor group's first rank (the whole leaf of
    rank 0 before the split).  Returns {leaf name: split dim}; nothing
    without a tensor axis past 1.  Raises for a rule-split leaf that no
    form holds and for an attention whose head count and the tensor size
    divide neither the other."""
    mesh = mesh or get_current_mesh()
    if mesh is None or mesh.size("tensor") == 1:
        return {}
    if not mesh.distributed:
        raise ValueError(f"{mesh}: a tensor axis needs one process a device")
    size, group = mesh.size("tensor"), mesh.group("tensor")
    specs = param_specs(module, mesh.sizes)
    want = {n: s.tensor for n, s in specs.items() if s.tensor is not None}
    src = mesh.rank_of(tensor=0)
    held: Dict[str, int] = {}
    for parent_name, parent in list(module.named_modules()):
        forms = getattr(parent, "TENSOR_FORMS", None)
        if not forms:
            continue
        prefix = f"{parent_name}." if parent_name else ""
        split = {c: f for c, f in forms.items()
                 if f"{prefix}{c}.weight" in want and hasattr(parent, c)}
        paired = [c for c, f in forms.items() if f in PAIRED and hasattr(parent, c)]
        part = [c for c in paired if c in split]
        if part and len(part) != len(paired):
            raise ValueError(f"{prefix.rstrip('.')}: the tensor rules split {part} but not "
                             f"{sorted(set(paired) - set(part))}, which no form holds")
        heads = getattr(parent, "num_heads", None)
        if part and heads is not None and heads % size and size % heads:
            raise ValueError(f"{prefix.rstrip('.')}: {heads} heads on a tensor axis of {size}")
        for child, form in split.items():
            name = f"{prefix}{child}.weight"
            if want[name] != _FORM_DIM[form]:
                raise ValueError(f"{name}: the tensor rules split dim {want[name]}, "
                                 f"the {form} form dim {_FORM_DIM[form]}")
            old = getattr(parent, child)
            with torch.no_grad():
                dist.broadcast(old.weight.data, src=src, group=group)
            setattr(parent, child, _FORMS[form](old, group))
            held[name] = want[name]
    missing = sorted(set(want) - set(held))
    if missing:
        raise ValueError(f"the tensor rules split {missing}, which no tensor-parallel form "
                         "holds")
    logger.info("tensor %d: %d leaves split", size, len(held))
    return held


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's slices of ``t`` concatenated along ``dim`` in rank order."""
    t = t.detach().movedim(dim, 0).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts).movedim(0, dim).contiguous()


def gather_whole(p: torch.Tensor, value: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole leaf of the split parameter ``p`` from the tensor group's
    slices (of ``value``, default ``p`` itself; a tensor of ``p``'s slice
    shape such as its master); ``value`` as it is for a whole ``p``."""
    value = p if value is None else value
    d = tensor_dim(p)
    return value if d is None else gather_dim(value, d, p.tensor_group)


def slice_of(p: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """This rank's slice of ``whole`` (a value of the whole leaf of ``p``)."""
    d = tensor_dim(p)
    return whole if d is None else slice_dim(whole, d, p.tensor_group)


def tensor_groups(mesh: Mesh):
    """(the tensor group, the group of the ranks that hold this rank's
    slices: every axis but tensor)."""
    return mesh.group("tensor"), mesh.group(*(a for a in AXIS_ORDER if a != "tensor"))
