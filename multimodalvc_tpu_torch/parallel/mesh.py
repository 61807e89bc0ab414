"""The device mesh over the (pipeline, data, fsdp, sequence, expert, tensor)
axes, as groups of ranks.

Port of ``multimodalvc_tpu/parallel/mesh.py``.  The JAX package builds one
``jax.sharding.Mesh`` and lets XLA insert the collectives; here each rank is
one process with one device, the mesh lays the world out in ``AXIS_ORDER``
(row-major: pipeline and data outermost, so the tensor, expert and
sequence groups stay inside a node) and makes a process group for each axis
and each set of axes that a collective runs over, and the modules call the
collectives of ``parallel/collectives.py`` on its groups.

Ranks that share a (data, fsdp) coordinate, the **batch group** index,
hold the same batch: on the pipeline, expert and sequence axes the batch is
replicated, as the JAX ``BATCH_AXES`` shard only over data and fsdp.  A loss
divides by its global count (``batch_total``), and each rank's loss enters
the gradient with the weight 1 / ``replicas()`` (the ranks holding the
same batch), so that the sum over the world is the loss of the global
batch and every gradient is reduced by a plain sum.

``local()`` turns the collectives off for a block: validation, in which
every rank computes the whole set on its own.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import math
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# data-like axes outermost, then the axes that want near neighbours
AXIS_ORDER = ("pipeline", "data", "fsdp", "sequence", "expert", "tensor")

# axes over which a data batch is split (batch = data * fsdp)
BATCH_AXES = ("data", "fsdp")

_CURRENT: Optional["Mesh"] = None
_LOCAL = False


def resolve_axis_sizes(requested: Dict[str, int], n_devices: Optional[int] = None
                       ) -> Dict[str, int]:
    """Resolve a -1 ("fill") entry so that the product equals the device
    count (the world size: one device a process)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    sizes = {ax: int(requested.get(ax, 1)) for ax in AXIS_ORDER}
    fill = [ax for ax, s in sizes.items() if s == -1]
    if len(fill) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {fill}")
    fixed = math.prod(s for s in sizes.values() if s != -1)
    if fill:
        if n_devices % fixed != 0:
            raise ValueError(
                f"cannot fill axis {fill[0]}: {n_devices} devices not divisible by {fixed}")
        sizes[fill[0]] = n_devices // fixed
    if math.prod(sizes.values()) != n_devices:
        raise ValueError(
            f"mesh axes {sizes} product {math.prod(sizes.values())} != device count {n_devices}")
    return sizes


class Mesh:
    """The axis sizes, this rank's coordinates and the process groups of the
    axes.  Without a process group (one process, nothing initialised) it
    holds the sizes only and ``distributed`` is False."""

    def __init__(self, sizes: Dict[str, int], rank: int = 0,
                 groups: Optional[Dict[Tuple[str, ...], object]] = None):
        self.sizes = {ax: int(sizes[ax]) for ax in AXIS_ORDER}
        self.rank = rank
        self.groups = groups or {}
        self.coords = dict(zip(AXIS_ORDER, _unravel(rank, self.sizes)))

    @property
    def distributed(self) -> bool:
        return bool(self.groups)

    @property
    def world(self) -> int:
        return math.prod(self.sizes.values())

    def size(self, *axes: str) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def index(self, *axes: str) -> int:
        """This rank's row-major coordinate over ``axes``."""
        out = 0
        for a in axes:
            out = out * self.sizes[a] + self.coords[a]
        return out

    def rank_of(self, **coords: int) -> int:
        """The global rank at this rank's coordinates with ``coords`` changed."""
        c = {**self.coords, **coords}
        out = 0
        for a in AXIS_ORDER:
            out = out * self.sizes[a] + c[a]
        return out

    def group(self, *axes: str):
        """The process group over ``axes`` that holds this rank (None without
        a process group)."""
        return self.groups.get(_key(axes))

    def __repr__(self) -> str:
        used = {ax: s for ax, s in self.sizes.items() if s > 1} or "one device"
        return f"Mesh({used}, rank {self.rank})"


def _key(axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in AXIS_ORDER if a in axes)


def _unravel(rank: int, sizes: Dict[str, int]):
    coords = []
    for a in reversed(AXIS_ORDER):
        coords.append(rank % sizes[a])
        rank //= sizes[a]
    return list(reversed(coords))


# the groups every mesh makes: each axis alone, the batch group, the axes
# a sharded gradient is summed over after its fsdp reduce-scatter (of a
# whole leaf, and of a tensor-split one), the axes a tensor-split leaf's
# gradient is summed over, the world
GROUP_AXES = [(ax,) for ax in AXIS_ORDER] + [BATCH_AXES,
                                             tuple(a for a in AXIS_ORDER if a != "fsdp"),
                                             tuple(a for a in AXIS_ORDER
                                                   if a not in ("fsdp", "tensor")),
                                             tuple(a for a in AXIS_ORDER if a != "tensor"),
                                             AXIS_ORDER]


def _make_groups(sizes: Dict[str, int], rank: int) -> Dict[Tuple[str, ...], object]:
    """Every rank creates every group, in the same order (``new_group`` is
    collective); each keeps the ones that hold it."""
    mine = {}
    for axes in GROUP_AXES:
        key = _key(axes)
        if key == AXIS_ORDER:
            mine[key] = dist.group.WORLD
            continue
        rest = [a for a in AXIS_ORDER if a not in key]
        for fixed in itertools.product(*(range(sizes[a]) for a in rest)):
            ranks = []
            for varying in itertools.product(*(range(sizes[a]) for a in key)):
                c = dict(zip(rest, fixed))
                c.update(zip(key, varying))
                r = 0
                for a in AXIS_ORDER:
                    r = r * sizes[a] + c[a]
                ranks.append(r)
            g = dist.new_group(sorted(ranks))
            if rank in ranks:
                mine[key] = g
    return mine


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """The global mesh (``axis_sizes``: axis -> size, -1 fills), made the
    current one.  Without a process group it is a one-device mesh with no
    collectives; with one, the world in ``AXIS_ORDER`` and its groups, on
    the backend of the default group (gloo ranks that share a card carry
    CUDA tensors through host buffers)."""
    sizes = resolve_axis_sizes(axis_sizes or {})
    if not dist.is_initialized():
        mesh = Mesh(sizes)
    else:
        rank = dist.get_rank()
        mesh = Mesh(sizes, rank, _make_groups(sizes, rank))
    logger.info("mesh: %s", mesh)
    set_current_mesh(mesh)
    return mesh


def set_current_mesh(mesh: Optional[Mesh]) -> None:
    global _CURRENT
    _CURRENT = mesh


def get_current_mesh() -> Optional[Mesh]:
    """The mesh of the last ``make_mesh`` (for modules that call collectives
    without the mesh threaded through their configs)."""
    return _CURRENT


def active_mesh() -> Optional[Mesh]:
    """The current mesh when it has process groups and no ``local()`` block
    is open, else None: the modules' switch between their distributed and
    their one-process forms."""
    if _LOCAL or _CURRENT is None or not _CURRENT.distributed:
        return None
    return _CURRENT


@contextlib.contextmanager
def local() -> Iterator[None]:
    """Within the block the modules run as one process: no collective, the
    losses over the local batch (validation, where each rank computes the
    whole set)."""
    global _LOCAL
    prev, _LOCAL = _LOCAL, True
    try:
        yield
    finally:
        _LOCAL = prev


def batch_group_size(mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or active_mesh()
    return mesh.size(*BATCH_AXES) if mesh is not None else 1


def batch_group_rank(mesh: Optional[Mesh] = None) -> int:
    """This rank's index in the batch group: which share of the batches it
    loads, and its dropout stream."""
    mesh = mesh or active_mesh()
    return mesh.index(*BATCH_AXES) if mesh is not None else 0


def replicas(mesh: Optional[Mesh] = None) -> int:
    """How many ranks hold this rank's batch (pipeline x sequence x expert x
    tensor)."""
    mesh = mesh or active_mesh()
    return mesh.world // mesh.size(*BATCH_AXES) if mesh is not None else 1


def batch_total(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the batch group (no gradient): the global count a
    loss divides by, or a metric's global sum.  Itself outside a group of
    more than one rank."""
    mesh = active_mesh()
    if mesh is None or batch_group_size(mesh) == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=mesh.group(*BATCH_AXES))
    return y


# the stride between the dropout seeds of two batch-group ranks
SEED_STRIDE = 1_000_003


def dropout_seed(seed: int, mesh: Optional[Mesh] = None) -> int:
    """The dropout generator's seed on this rank: ``seed`` at batch-group
    rank 0 (a one-rank run draws as a run without a mesh), apart for the
    other data and fsdp ranks; the ranks that share a batch share it."""
    return seed + SEED_STRIDE * batch_group_rank(mesh)


def restore_generator_(generator: torch.Generator, state: torch.Tensor,
                       mesh: Optional[Mesh] = None) -> None:
    """Set ``generator`` from a restored state (rank 0's, as checkpoints hold
    it): the state itself at batch-group rank 0, else a seed drawn from it
    and the rank, so that the data ranks draw apart after a resume too.  The
    seed goes through the generator's own ``manual_seed``, whatever its
    device (a CUDA generator's state is not a CPU one's)."""
    index = batch_group_rank(mesh)
    if index == 0:
        generator.set_state(state)
    else:
        generator.manual_seed(int(state.to(torch.int64).sum()) + SEED_STRIDE * index)


def from_rank0(metrics: Dict[str, float]) -> Dict[str, float]:
    """Rank 0's ``metrics`` on every rank of the active mesh (themselves
    without one): the numbers that the checkpoint, patience and plateau
    decisions read, so that every rank makes the same ones and none leaves
    the loop alone."""
    if active_mesh() is None:
        return metrics
    box = [metrics]
    dist.broadcast_object_list(box, src=0)
    return box[0]
