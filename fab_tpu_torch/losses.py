"""FAB losses (``fab_tpu/losses.py``). Each returns a scalar to differentiate in the
flow's parameters. Invalid rows carry log_w = -inf and a zeroed log q (or are left
out of the means by ``mask``), so no NaN reaches the loss graph. ``flow_alpha_2_div``,
``flow_alpha_2_div_unbiased`` and ``fab_ub_alpha_2_div`` are experimental in the
original FAB code; they run here as they do in ``fab_tpu``.

Under a data mesh each loss is this rank's *share* of the loss over the global
batch (``parallel/mesh.py``): its softmax weights, counts and logsumexps are global,
its sums run over this rank's rows, so the shares and their gradients, summed over
the ranks, are the one-process loss and gradient. Without a mesh each is the
one-process loss.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from fab_tpu_torch.parallel import mesh

LOSS_TYPES = (
    "fab_alpha_div",
    "flow_reverse_kl",
    "forward_kl",
    "target_forward_kl",
    "flow_alpha_2_div_nis",
    "flow_alpha_2_div",
    "flow_alpha_2_div_unbiased",
    "fab_ub_alpha_2_div",
)


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
        n = mesh.sum_all(mask).clamp(min=1)
    else:
        n = mesh.global_rows(log_q_x.shape[0])
    w_bar = mesh.softmax(log_w_ais.detach())
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
        n = mesh.sum_all(mask).clamp(min=1)
        loss = -(w_adjust * log_q_safe).sum() / n
    else:
        loss = -mesh.share_mean(w_adjust * log_q_x)
    return loss, log_w_adjust, w_adjust_pre_clip


# Mean over the valid rows (this rank's share of it under a data mesh).
_masked_mean = mesh.share_mean


def flow_reverse_kl(log_q: torch.Tensor, log_p: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reverse KL on flow samples: mean log q - mean log p."""
    return _masked_mean(log_q, mask) - _masked_mean(log_p, mask)


def flow_alpha_2_div(log_q: torch.Tensor, log_p: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The alpha-2 divergence in logsumexp form, logsumexp(2 (log p - log q))."""
    lw = 2 * (log_p - log_q)
    if mask is not None:
        lw = torch.where(mask, lw, -math.inf)
    return mesh.share_logsumexp(lw)


def flow_alpha_2_div_unbiased(log_q: torch.Tensor, log_p: torch.Tensor,
                              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unbiased alpha-2 estimate from flow samples, mean(w^2 log q)."""
    return _masked_mean(torch.exp(2 * (log_p - log_q)) * log_q, mask)


def flow_alpha_2_div_nis(log_q: torch.Tensor, log_p: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Neural importance sampling loss, -mean(sg(w^2) log q)."""
    w_sq = torch.exp(2 * (log_p - log_q)).detach()
    return -_masked_mean(w_sq * log_q, mask)


def forward_kl(log_q_xp: torch.Tensor) -> torch.Tensor:
    """Forward KL up to a constant, -mean log q(x) with x ~ p."""
    return -mesh.share_mean(log_q_xp)


def fab_ub_alpha_2_div(log_q_x: torch.Tensor, log_p: torch.Tensor, log_w_ais: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Upper-bound alpha-2 FAB loss, logsumexp(log_w_ais + log p - log q) (the
    corrected form ``fab_tpu`` uses)."""
    log_w = log_p - log_q_x
    if mask is not None:
        log_w_ais = torch.where(mask, log_w_ais, -math.inf)
        log_w = torch.where(mask, log_w, 0.0)
    return mesh.share_logsumexp(log_w_ais + log_w)
