"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if a CUDA device is asked for and absent.

    There is no silent fallback to the CPU: callers that want the CPU say so.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fab_tpu_torch: no CUDA device is available; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return device
