"""FAB losses on the main path (``fab_tpu/losses.py``): ``fab_alpha_div`` and
``buffer_replay_loss``. Invalid rows carry log_w = -inf and a zeroed log q, so no
NaN reaches the loss graph. The other loss variants are not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

LOSS_TYPES = ("fab_alpha_div",)


def fab_alpha_div(
    log_q_x: torch.Tensor,
    log_w_ais: torch.Tensor,
    alpha: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """-sign(alpha) * sum(softmax(log_w_ais) * log q) / N over valid rows."""
    if mask is not None:
        log_w_ais = torch.where(mask, log_w_ais, -math.inf)
        log_q_x = torch.where(mask, log_q_x, 0.0)
        n = mask.sum().clamp(min=1)
    else:
        n = log_q_x.shape[0]
    w_bar = torch.softmax(log_w_ais.detach(), dim=0)
    return -math.copysign(1.0, alpha) * (w_bar * log_q_x).sum() / n


def buffer_replay_loss(
    log_q_x: torch.Tensor,
    log_q_old: torch.Tensor,
    alpha: float,
    w_adjust_max_clip: Optional[float],
    mask: Optional[torch.Tensor] = None,
):
    """Prioritised-buffer replay loss with importance-weight adjustment.

    w_adjust = clip(exp((1-alpha)(log q_new - log q_old)), max) with log q_new
    detached; loss = -mean(w_adjust * log q_new). Returns (loss, log_w_adjust,
    w_adjust before the clip).
    """
    log_w_adjust = (1 - alpha) * (log_q_x.detach() - log_q_old)
    w_adjust_pre_clip = torch.exp(log_w_adjust)
    if w_adjust_max_clip is not None:
        w_adjust = w_adjust_pre_clip.clamp(max=w_adjust_max_clip)
    else:
        w_adjust = w_adjust_pre_clip
    if mask is not None:
        w_adjust = torch.where(mask, w_adjust, 0.0)
        log_q_safe = torch.where(mask, log_q_x, 0.0)
        n = mask.sum().clamp(min=1)
        loss = -(w_adjust * log_q_safe).sum() / n
    else:
        loss = -(w_adjust * log_q_x).mean()
    return loss, log_w_adjust, w_adjust_pre_clip
