"""Profiling helpers (``fab_tpu/utils/profiling.py``): a profiler trace around a
block and a samples/s meter per device.

    with trace("chiprun_out/trace"):
        state, info = trainer.train_step(state, generator, batch_size)

``trace`` records the host's PyTorch ops and, when a CUDA device is in use, the
card's kernels and copies, and writes a Chrome trace (``trace.json``, viewable in
Perfetto or chrome://tracing) into ``log_dir``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = "profile_trace"):
    """Profile the block and export ``<log_dir>/trace.json``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ThroughputMeter:
    """Samples/s, and per device, since the last ``reset``; call ``update(n)`` per
    step. ``n_devices`` defaults to the CUDA device count and raises without a card:
    a rate per device is a device metric."""

    def __init__(self, n_devices: Optional[int] = None):
        if n_devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ThroughputMeter: no CUDA device is available; pass n_devices to "
                    "count another device"
                )
            n_devices = torch.cuda.device_count()
        self.n_devices = n_devices
        self.reset()

    def reset(self) -> None:
        self.t0 = time.time()
        self.samples = 0

    def update(self, n_samples: int) -> None:
        self.samples += n_samples

    @property
    def samples_per_s(self) -> float:
        return self.samples / max(time.time() - self.t0, 1e-9)

    @property
    def samples_per_s_per_chip(self) -> float:
        return self.samples_per_s / self.n_devices
