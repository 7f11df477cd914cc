"""Parallelism over ``torch.distributed`` (``fab_tpu/parallel/``): process-group set-up
(``distributed``), the (data, model) mesh with its collectives (``mesh``) and the
model axis's split layers (``tensor``)."""
from fab_tpu_torch.parallel.distributed import initialize, is_primary, n_hosts, shutdown
from fab_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    activate_mesh,
    active_mesh,
    constrain_batch,
    constrain_tree_batch,
    make_mesh,
    replicate,
    use_mesh,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "activate_mesh",
    "active_mesh",
    "constrain_batch",
    "constrain_tree_batch",
    "initialize",
    "is_primary",
    "make_mesh",
    "n_hosts",
    "replicate",
    "shutdown",
    "use_mesh",
]
