"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import os

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if a CUDA device is asked for and absent.
    Under a launcher (one process per card, ``LOCAL_RANK`` set), ``"cuda"`` is this
    process's card, ``cuda:<LOCAL_RANK>``.

    There is no silent fallback to the CPU: callers that want the CPU say so.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fab_tpu_torch: no CUDA device is available; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return device
