"""The optimizer's multi-tensor passes: K9 ``square_sums_many`` and ``adamw_many_``.

No TPU kernel: the JAX package runs optax's chain (``clip_by_global_norm``
-> ``adam`` -> ``add_decayed_weights`` -> the schedule's scale) under XLA,
which fuses it.  The port's trainer (``runtime/trainer.py``) takes each
step's global norm and finite check from ``square_sums_many`` and its
clipped AdamW update, with the module's cast copy, from ``adamw_many_``:
every leaf in one pass each.  For CUDA tensors both launch
``csrc/adamw.cu`` (one launch for all leaves, from a table of the leaves
copied to the card each call); for CPU tensors they run the plain versions,
the port's per-leaf chain, which keep the CPU parity tests on their numbers.
The kernel computes what the plain version computes on the card, bit for
bit: the same f32 operations in the same order, each host constant rounded
as PyTorch rounds a Python scalar for an f32 tensor (a division by one is a
multiplication by its f32 reciprocal there).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernel_lib

CHUNK = 16384  # csrc/adamw.cu: CHUNK, elements a work item
GROUPS = 4  # csrc/adamw.cu: GROUPS, the square sums' totals
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # csrc/adamw.cu: Dtype
_NO_COPY = 3
_WD, _SCALE, _CLIP = 1, 2, 4  # csrc/adamw.cu: the flags


def f32(x: float) -> float:
    """x rounded to the nearest f32."""
    return float(np.float32(x))


def square_sums_many_plain(grads: Sequence[torch.Tensor], groups: Optional[Sequence[int]] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``square_sums_many``: each leaf's sum of squares in
    f32, each group's total as the leaves' sums added in order from zero
    (optax's ``global_norm`` adds them so), and whether every element is
    finite."""
    sums = [(g.float() * g.float()).sum() for g in grads]
    totals = [torch.zeros((), device=grads[0].device)] * GROUPS
    for i, s in enumerate(sums):
        k = 0 if groups is None else groups[i]
        totals[k] = totals[k] + s
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    return torch.stack(sums), torch.stack(totals), finite


def square_sums_many(grads: Sequence[torch.Tensor], groups: Optional[Sequence[int]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sums [L] f32, totals [GROUPS] f32, finite: bool []) of the leaves
    ``grads`` (f32, bf16 or f16, each read once in its dtype): each leaf's sum
    of its squares, their totals by ``groups`` (an int in [0, GROUPS) a leaf;
    None: all in group 0), and whether every element is finite.  CUDA
    tensors run K9's square sums (two launches, deterministic: no float
    atomics; a gradient of another layout is made contiguous first); the
    kernel's sums agree with the plain version's within f32 reduction
    order."""
    grads = list(grads)
    if all(g.device.type == "cpu" for g in grads):
        return square_sums_many_plain(grads, groups)
    grads = [g.contiguous() for g in grads]  # autograd may give a leaf another layout
    dev = grads[0].device
    _check_all("grads", grads, _CODES, dev)
    table, items = _table(dev, grads, groups)
    partial = torch.empty(items, dtype=torch.float32, device=dev)
    bad = torch.empty(items, dtype=torch.uint8, device=dev)
    sums = torch.empty(len(grads), dtype=torch.float32, device=dev)
    totals = torch.empty(GROUPS, dtype=torch.float32, device=dev)
    finite = torch.empty((), dtype=torch.bool, device=dev)
    kernel_lib.load().call(
        "mmvc_square_sums_many", table.data_ptr(), len(grads), items, partial.data_ptr(),
        bad.data_ptr(), sums.data_ptr(), totals.data_ptr(), finite.data_ptr(),
        kernel_lib.stream_ptr(grads[0]))
    square_sums_many.launches += 1
    return sums, totals, finite


square_sums_many.launches = 0  # one a call: every leaf's sums (two kernels)


def adamw_many_plain(masters, grads, mu, nu, *, count: int, lr: float, betas, eps: float,
                     weight_decay: float, scale: float = 1.0,
                     norm: Optional[torch.Tensor] = None, clip: Optional[float] = None,
                     copies=None) -> None:
    """Plain version of ``adamw_many_``: the port's per-leaf chain."""
    b1, b2 = (float(b) for b in betas)
    bc1, bc2 = f32(1.0 - b1 ** count), f32(1.0 - b2 ** count)
    step_size = -f32(lr)
    for i, p in enumerate(masters):
        g, m, v = grads[i].float(), mu[i], nu[i]
        if norm is not None:
            g = torch.where(norm < clip, g, (g / norm) * clip)
        m.copy_((1.0 - b1) * g + b1 * m)
        v.copy_((1.0 - b2) * (g * g) + b2 * v)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p
        u = u * step_size
        if scale != 1.0:
            u = u * scale
        p.add_(u)
        if copies is not None:
            with torch.no_grad():
                copies[i].copy_(p)


def adamw_many_(masters, grads, mu, nu, *, count: int, lr: float, betas, eps: float,
                weight_decay: float, scale: float = 1.0, norm: Optional[torch.Tensor] = None,
                clip: Optional[float] = None, copies=None) -> None:
    """One optax ``adam`` (+ ``add_decayed_weights``) update of every leaf in
    place: f32 ``masters`` and their moments ``mu`` / ``nu``, from ``grads``
    (f32, bf16 or f16).  With ``norm`` (the global norm, a one-element f32
    tensor, read on the device) each gradient is first clipped to global
    norm ``clip`` (``clip_by_global_norm``); then the moments, bias
    corrections 1 - b^count as f32 scalars, eps outside the square root, the
    decay added to the direction, times -lr and the plateau ``scale``.
    ``count`` is the update's number, from 1.  With ``copies``, each leaf's
    new value is also written, cast, into ``copies[i]`` (the module's
    parameter).  CUDA tensors run K9's update (one launch): every operand
    but the gradients contiguous (those are made so), each leaf's tensors of
    one size."""
    masters, grads, mu, nu = list(masters), list(grads), list(mu), list(nu)
    copies = None if copies is None else list(copies)
    if all(t.device.type == "cpu" for t in masters + grads):
        return adamw_many_plain(masters, grads, mu, nu, count=count, lr=lr, betas=betas,
                                eps=eps, weight_decay=weight_decay, scale=scale, norm=norm,
                                clip=clip, copies=copies)
    dev = masters[0].device
    grads = [g.contiguous() for g in grads]
    sizes = [p.numel() for p in masters]
    _check_all("masters", masters, (torch.float32,), dev)
    for name, ts in (("mu", mu), ("nu", nu)):
        _check_all(name, ts, (torch.float32,), dev, sizes)
    _check_all("grads", grads, _CODES, dev, sizes)
    if copies is not None:
        _check_all("copies", copies, _CODES, dev, sizes)
    flags = (_WD if weight_decay else 0) | (0 if scale == 1.0 else _SCALE)
    if norm is not None:
        kernel_lib.check(norm.reshape(()), "norm", torch.float32)
        flags |= _CLIP
    b1, b2 = (float(b) for b in betas)
    one = np.float32(1.0)
    consts = (ctypes.c_float * 11)(
        f32(1.0 - b1), f32(b1), f32(1.0 - b2), f32(b2),
        float(one / np.float32(1.0 - b1 ** count)), float(one / np.float32(1.0 - b2 ** count)),
        f32(eps), f32(weight_decay), -f32(lr), f32(scale), f32(0.0 if clip is None else clip))
    table, items = _table(dev, grads, masters=masters, mu=mu, nu=nu, copies=copies)
    kernel_lib.load().call(
        "mmvc_adamw_many", table.data_ptr(), len(masters), items, consts, flags,
        None if norm is None else norm.data_ptr(), kernel_lib.stream_ptr(masters[0]))
    adamw_many_.launches += 1


adamw_many_.launches = 0  # one a call: every leaf's update


def _check_all(name: str, ts: Sequence[torch.Tensor], dtypes, device: torch.device,
               sizes: Optional[List[int]] = None) -> None:
    """Each of ``ts`` on ``device``, of one of ``dtypes``, contiguous (and of
    ``sizes[i]`` elements)."""
    if device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {device}")
    for i, t in enumerate(ts):
        if t.device != device or t.dtype not in dtypes or not t.is_contiguous() or (
                sizes is not None and t.numel() != sizes[i]):
            raise ValueError(f"{name}[{i}]: expected a contiguous tensor of {list(dtypes)} on "
                             f"{device}" + ("" if sizes is None else f" with {sizes[i]} elements")
                             + f", got {t.dtype} {tuple(t.shape)} on {t.device}")


def _table(device: torch.device, grads, groups=None, masters=None, mu=None, nu=None,
           copies=None) -> Tuple[torch.Tensor, int]:
    """``table_words`` on ``device``, copied from pinned memory without a
    synchronisation, and the number of work items."""
    words, items = table_words(grads, groups, masters, mu, nu, copies)
    return torch.from_numpy(words).pin_memory().to(device, non_blocking=True), items


def table_words(grads, groups=None, masters=None, mu=None, nu=None, copies=None
                ) -> Tuple[np.ndarray, int]:
    """The kernel's leaf table (csrc/adamw.cu: Leaf, eight int64 words a
    leaf: the pointers, the length, the dtypes and group; then each leaf's
    first work item of CHUNK elements and the total) and the number of work
    items."""
    rows = np.zeros((len(grads), 8), dtype=np.int64)
    rows[:, 0] = [g.data_ptr() for g in grads]
    if masters is not None:
        for col, ts in ((1, masters), (2, mu), (3, nu)):
            rows[:, col] = [t.data_ptr() for t in ts]
    n = np.array([g.numel() for g in grads], dtype=np.int64)
    rows[:, 5] = n
    code = np.array([_CODES[g.dtype] for g in grads], dtype=np.int64)
    if copies is None:
        code |= _NO_COPY << 8
    else:
        rows[:, 4] = [c.data_ptr() for c in copies]
        code |= np.array([_CODES[c.dtype] for c in copies], dtype=np.int64) << 8
    if groups is not None:
        code |= np.asarray(groups, dtype=np.int64) << 16
    rows[:, 6] = code
    first = np.zeros(len(grads) + 1, dtype=np.int64)
    np.cumsum((n + CHUNK - 1) // CHUNK, out=first[1:])
    items = int(first[-1])
    if items == 0:
        raise ValueError("K9: every leaf is empty")
    return np.concatenate([rows.reshape(-1), first]), items
