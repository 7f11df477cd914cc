"""ALDP model factory: a circular coupled neural-spline flow over internal coordinates
(``experiments/make_aldp_model.py`` of the repository).

``n_blocks`` spline couplings (hidden 256, 8 bins) alternate which half of the 60-D
internal vector they transform; circular dims (methyl rotors, phi/psi, ...) use
circular splines with a pi bound and enter the conditioners as (sin, cos); a
periodic shift with a seeded random offset follows each block; the base is uniform
on the circular dims and Gaussian elsewhere (``gauss-uni``), a trainable diagonal
Gaussian or the LARS resampled base; ``flow.snf`` adds Metropolis sampling layers
(the SNF variant).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.flows.base import DiagGaussianBase, Flow, UniformGaussianBase
from fab_tpu_torch.flows.resampled import ResampledGaussianBase
from fab_tpu_torch.flows.snf import MetropolisSamplingLayer, StochasticFlow
from fab_tpu_torch.flows.splines import PeriodicShift, SplineCoupling
from fab_tpu_torch.model import FABModel
from fab_tpu_torch.sampling import HamiltonianMonteCarlo, Metropolis
from fab_tpu_torch.targets.aldp import AldpBoltzmann
from fab_tpu_torch.utils.aldp_eval import chirality_scale_shift, make_chirality_filter


def make_aldp_flow(
    dim: int,
    circular_dims: Tuple[int, ...],
    n_blocks: int = 12,
    hidden_units: int = 256,
    n_bins: int = 8,
    tail_bound: float = 5.0,
    circ_shift: str = "random",
    seed: int = 0,
    base_type: str = "gauss-uni",
    snf_every: int = 0,
    snf_steps: int = 10,
    snf_proposal_scale: float = 0.1,
    target_log_prob=None,
    dtype=torch.float32,
    device="cuda",
) -> Flow:
    """base_type: 'gauss-uni' (circular dims uniform), 'gauss' (trainable diagonal
    Gaussian) or 'resampled' (the LARS base with its defaults: 2 x 256, T = 100,
    1024 points). ``snf_every`` > 0 puts a Metropolis sampling layer on
    ``target_log_prob`` (lam = (i+1)/n_blocks) after every ``snf_every`` spline
    blocks and returns a ``StochasticFlow``."""
    device = resolve_device(device)
    d = (dim + 1) // 2
    circ = set(circular_dims)
    rng = np.random.RandomState(seed)
    bijectors = []
    for i in range(n_blocks):
        swap = i % 2 == 1
        cond_dims, trans_dims = (range(d, dim), range(0, d)) if swap else (range(0, d), range(d, dim))
        bijectors.append(SplineCoupling(
            dim, hidden_units, n_bins=n_bins, tail_bound=tail_bound, swap=swap,
            circular_mask=tuple(j in circ for j in trans_dims),
            circular_cond_mask=tuple(j in circ for j in cond_dims),
            dtype=dtype, device=device,
        ))
        if circ_shift == "random" and circular_dims:
            bijectors.append(PeriodicShift(
                dim, circular_dims, shift=float(rng.uniform(-np.pi, np.pi)), device=device,
            ))
        if snf_every and (i + 1) % snf_every == 0:
            if target_log_prob is None:
                raise ValueError("SNF layers need target_log_prob")
            bijectors.append(MetropolisSamplingLayer(
                target_log_prob, lam=(i + 1) / n_blocks, n_steps=snf_steps,
                proposal_scale=snf_proposal_scale,
            ))
    if base_type == "resampled":
        base = ResampledGaussianBase(dim, dtype=dtype, device=device)
    elif base_type == "gauss":
        base = DiagGaussianBase(dim, dtype=dtype, device=device)
    else:
        base = UniformGaussianBase(dim, circular_dims, dtype=dtype, device=device)
    if snf_every:
        return StochasticFlow(dim, bijectors, base)
    return Flow(dim, bijectors, base)


def make_aldp_model(cfg, dtype=torch.float32, device="cuda") -> Tuple[FABModel, AldpBoltzmann]:
    """Target, flow, transition operator and FABModel from an ALDP config, with the
    train-time chirality filter when ``training.filter_chirality`` is 'train'."""
    sys_cfg = cfg.system
    target = AldpBoltzmann(
        data_path=cfg.data.get("transform"),
        temperature=sys_cfg.temperature,
        energy_cut=float(sys_cfg.energy_cut),
        energy_max=float(sys_cfg.energy_max),
        transform=sys_cfg.get("transform", "internal"),
        env=sys_cfg.get("env", "vacuum"),
        backend=sys_cfg.get("backend", "jax"),
        n_threads=sys_cfg.get("n_threads", 4),
        dtype=dtype,
        device=device,
    )
    snf_cfg = cfg.flow.get("snf")
    flow = make_aldp_flow(
        dim=target.dim,
        circular_dims=target.transform.circular_flow_dims,
        n_blocks=cfg.flow.blocks,
        hidden_units=cfg.flow.hidden_units,
        n_bins=cfg.flow.num_bins,
        circ_shift=cfg.flow.get("circ_shift", "random"),
        seed=cfg.training.seed,
        base_type=cfg.flow.get("base", {}).get("type", "gauss-uni"),
        snf_every=snf_cfg.every if snf_cfg else 0,
        snf_steps=snf_cfg.get("steps", 10) if snf_cfg else 10,
        snf_proposal_scale=snf_cfg.get("proposal_scale", 0.1) if snf_cfg else 0.1,
        target_log_prob=target.log_prob if snf_cfg else None,
        dtype=dtype,
        device=device,
    )
    fab_cfg = cfg.fab
    if fab_cfg.get("transition_type", "hmc") == "hmc":
        transition_operator = HamiltonianMonteCarlo(
            n_ais_intermediate_distributions=fab_cfg.n_int_dist,
            n_outer=1,
            n_leapfrog=fab_cfg.n_inner,
            epsilon=fab_cfg.epsilon,
        )
    else:
        transition_operator = Metropolis(
            n_ais_intermediate_distributions=fab_cfg.n_int_dist,
            n_updates=fab_cfg.n_inner,
            max_step_size=fab_cfg.epsilon,
            min_step_size=fab_cfg.epsilon,
        )
    model = FABModel.create(
        flow=flow,
        target=target,
        transition_operator=transition_operator,
        n_intermediate_distributions=fab_cfg.n_int_dist,
        alpha=fab_cfg.get("alpha", 2.0),
        loss_type=fab_cfg.get("loss_type", "fab_alpha_div"),
    )
    if cfg.training.get("filter_chirality") == "train":
        scale, shift = chirality_scale_shift(target.transform)
        model = dataclasses.replace(
            model, sample_filter=make_chirality_filter(scale, shift)
        )
    return model, target
