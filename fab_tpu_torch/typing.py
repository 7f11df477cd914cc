"""Core types: the AIS ``Point`` carrier (``fab_tpu/typing.py``)."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

# Maps a batch of points [B, D] to log-probabilities [B].
LogProbFn = Callable[[torch.Tensor], torch.Tensor]


class Point(NamedTuple):
    """A batch of AIS points with cached log-probs (and scores for HMC)."""

    x: torch.Tensor  # [B, D]
    log_q: torch.Tensor  # [B]
    log_p: torch.Tensor  # [B]
    grad_log_q: Optional[torch.Tensor] = None  # [B, D]
    grad_log_p: Optional[torch.Tensor] = None  # [B, D]


def select_point(pred: torch.Tensor, a: Point, b: Point) -> Point:
    """Per-row select: rows of ``a`` where ``pred`` [B] else rows of ``b``."""
    pred_col = pred[:, None]
    return Point(
        x=torch.where(pred_col, a.x, b.x),
        log_q=torch.where(pred, a.log_q, b.log_q),
        log_p=torch.where(pred, a.log_p, b.log_p),
        grad_log_q=None
        if a.grad_log_q is None
        else torch.where(pred_col, a.grad_log_q, b.grad_log_q),
        grad_log_p=None
        if a.grad_log_p is None
        else torch.where(pred_col, a.grad_log_p, b.grad_log_p),
    )
