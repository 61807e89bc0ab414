"""Training on several devices: one process a device, ``torch.distributed``.

Port of ``multimodalvc_tpu/parallel/``: the mesh over the (pipeline, data,
fsdp, sequence, expert, tensor) axes (``mesh.py``), the process-group
bootstrap (``distributed.py``), the collectives with derivatives
(``collectives.py``), the JAX sharding rules on the port's leaves
(``sharding.py``), the tensor-parallel forms (``tensor.py``), the
expert-parallel MoE layer (``expert.py``), the GPipe schedule
(``pipeline.py``) and BMUF (``bmuf.py``).  Ring attention is
``ops/ring_attention.py``.
"""
from .mesh import (  # noqa: F401
    AXIS_ORDER,
    BATCH_AXES,
    Mesh,
    active_mesh,
    batch_group_rank,
    batch_group_size,
    batch_total,
    get_current_mesh,
    local,
    make_mesh,
    replicas,
    resolve_axis_sizes,
    set_current_mesh,
)
