"""Multi-process set-up over ``torch.distributed`` (``fab_tpu/parallel/distributed.py``).

``fab_tpu`` runs one controller that sees every device. The port runs one process
per card, started by a launcher (``python3 -m torch.distributed.run
--nproc_per_node=N -m fab_tpu_torch.experiments.run_many_well ...``), and
``initialize`` joins them into one process group from the launcher's variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) or from
``fab_tpu``'s (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``). The backend follows the device: NCCL for CUDA, gloo for the
CPU, unless the caller names one: gloo on a CUDA device carries the cards' tensors
through the host, the one way to run several ranks on one card (NCCL refuses two
ranks on one device). A set-up that fails raises; there is no switch to another
backend.

Only the primary process (rank 0) writes logs, checkpoints and plots
(``is_primary``). Without a launcher every helper answers as for one process.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# A collective that waits longer than this for its peers fails instead of hanging.
TIMEOUT = datetime.timedelta(minutes=10)


def _int_env(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value is not None else None


def launcher_env() -> Optional[dict]:
    """(init_method, world_size, rank, local_rank) from a launcher's variables, or
    from ``fab_tpu``'s; None when neither is set."""
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
        return {
            "init_method": "env://",
            "world_size": int(os.environ["WORLD_SIZE"]),
            "rank": rank,
            "local_rank": _int_env("LOCAL_RANK") or 0,
        }
    address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    world = _int_env("JAX_NUM_PROCESSES")
    if address is None and world is None:
        return None
    if address is None or world is None:
        raise ValueError("JAX_COORDINATOR_ADDRESS and JAX_NUM_PROCESSES go together")
    rank = _int_env("JAX_PROCESS_ID") or 0
    return {
        "init_method": f"tcp://{address}",
        "world_size": world,
        "rank": rank,
        "local_rank": _int_env("LOCAL_RANK") or 0,
    }


def initialize(device="cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout: datetime.timedelta = TIMEOUT, backend: Optional[str] = None) -> bool:
    """Join the process group; True if this process is one of several launched
    together (or the group already exists), False (and nothing done) otherwise.

    ``init_method``, ``world_size`` and ``rank`` default to the launcher's variables
    (``launcher_env``). On a CUDA device the backend is NCCL on
    ``cuda:<local rank>``; on the CPU it is gloo; ``backend="gloo"`` on a CUDA
    device takes gloo there too. A collective that waits longer than ``timeout`` for
    its peers raises.
    """
    if dist.is_initialized():
        return True
    env = launcher_env() or {}
    if init_method is None and not env:
        return False
    device = torch.device(device)
    kwargs = dict(
        init_method=init_method or env["init_method"],
        world_size=world_size if world_size is not None else env["world_size"],
        rank=rank if rank is not None else env["rank"],
        timeout=timeout,
    )
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"no process-group backend {backend!r}: nccl or gloo")
    if device.type == "cuda":
        index = device.index if device.index is not None else env.get("local_rank", 0)
        torch.cuda.set_device(index)
        if backend == "gloo":
            dist.init_process_group("gloo", **kwargs)
        else:
            dist.init_process_group("nccl", device_id=torch.device("cuda", index), **kwargs)
    elif device.type == "cpu" and backend in (None, "gloo"):
        dist.init_process_group("gloo", **kwargs)
    else:
        raise ValueError(f"no process-group backend for device {device}")
    return True


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and plots (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def n_hosts() -> int:
    """The number of processes (``fab_tpu``'s ``jax.process_count()``): one per card."""
    return dist.get_world_size() if dist.is_initialized() else 1
