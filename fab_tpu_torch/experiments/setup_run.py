"""Experiment glue: config -> target-independent model, trainer and run
(``experiments/setup_run.py`` of the repository).

The flow-forward-pass budget, the logger, the flow and transition operator, the
trainer chosen by ``training.use_buffer`` and ``training.prioritised_buffer``, the
resume from ``training.checkpoint_load_dir``, ActNorm's data-dependent
initialisation, and the run. Everything is built on ``device`` in the config's
dtype (``training.use_64_bit``).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from fab_tpu_torch.buffer import PrioritisedReplayBuffer, ReplayBuffer
from fab_tpu_torch.checkpoint import latest_checkpoint
from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.flows import (
    data_dependent_init,
    make_realnvp,
    make_resampled_realnvp,
    make_snf_model,
)
from fab_tpu_torch.model import FABModel
from fab_tpu_torch.sampling import HamiltonianMonteCarlo, Metropolis
from fab_tpu_torch.train import BufferTrainer, PrioritisedBufferTrainer, Trainer, make_optimizer
from fab_tpu_torch.utils.logging import CSVLogger, ListLogger
from fab_tpu_torch.utils.training import (
    ConfigDict,
    get_latest_checkpoint_dir,
    maybe_enable_x64,
)


def get_n_iterations(
    n_training_iter: Optional[int],
    n_flow_forward_pass: Optional[int],
    batch_size: int,
    loss_type: str,
    n_transition_operator_inner_steps: int,
    n_intermediate_ais_dist: int,
    transition_operator_type: str,
    use_buffer: bool,
    min_buffer_length: Optional[int] = None,
) -> int:
    """Iterations from an iteration count or a flow-forward-pass budget (exactly one
    of the two). One AIS pass costs n_inner * n_dist + 1 flow evaluations per row; a
    buffer run adds one replay evaluation per row and the buffer's initial fill."""
    assert bool(n_training_iter) != bool(n_flow_forward_pass)
    if n_training_iter:
        return n_training_iter
    if loss_type.startswith("flow") or loss_type.startswith("target"):
        n_iter = n_flow_forward_pass // batch_size
    else:
        n_flow_eval_per_ais_forward = (
            n_transition_operator_inner_steps * n_intermediate_ais_dist + 1
        )
        if use_buffer:
            buffer_init_flow_eval = n_flow_eval_per_ais_forward * min_buffer_length
            n_flow_eval_per_iter = (n_flow_eval_per_ais_forward + 1) * batch_size
        else:
            buffer_init_flow_eval = 0
            n_flow_eval_per_iter = n_flow_eval_per_ais_forward * batch_size
        n_iter = int((n_flow_forward_pass - buffer_init_flow_eval) / n_flow_eval_per_iter)
    print(f"{n_iter} iter for {n_flow_forward_pass} flow forward passes")
    return n_iter


def setup_logger(cfg: ConfigDict, save_path: str):
    if hasattr(cfg.logger, "pandas_logger"):
        return CSVLogger(
            save_path=os.path.join(save_path, "logging_hist.csv"),
            save_period=cfg.logger.pandas_logger.save_period,
        )
    if hasattr(cfg.logger, "list_logger"):
        return ListLogger(save=True, save_path=os.path.join(save_path, "logging_hist.pkl"))
    raise ValueError("No logger specified (pandas_logger or list_logger).")


def setup_mesh(cfg: ConfigDict) -> None:
    """The ``mesh`` section: on one device (n_model 1, n_data null or 1) there is
    nothing to set up, as ``fab_tpu`` does on one chip. A mesh over several devices
    is not ported yet."""
    mesh_cfg = cfg.get("mesh")
    if not mesh_cfg or not mesh_cfg.get("enable", True):
        return
    if mesh_cfg.get("n_model", 1) == 1 and mesh_cfg.get("n_data") in (None, 1):
        return
    raise NotImplementedError(
        "a multi-device mesh is not ported yet (ROADMAP Queue 1, item 6: parallelism)"
    )


def setup_precision(cfg: ConfigDict) -> None:
    """f32 products in full f32 (``training.matmul_precision``, default
    "highest"): no TF32 in matrix products or convolutions."""
    precision = cfg.training.get("matmul_precision", "highest")
    if precision:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = precision != "highest"
        torch.backends.cudnn.allow_tf32 = precision != "highest"


def setup_model(cfg: ConfigDict, target, dtype=torch.float32, device="cuda") -> FABModel:
    """Flow + transition operator + FABModel, in ``dtype`` on ``device``: RealNVP,
    over the LARS base with ``flow.resampled_base``, or with MH sampling layers
    (``flow.snf``: ``it_snf_layer``, ``step_size``, ``num_steps``) with
    ``flow.use_snf``."""
    dim, flow_cfg = cfg.target.dim, cfg.flow
    init_mode = flow_cfg.get("init_mode", "he_normal")
    if flow_cfg.get("resampled_base"):
        flow = make_resampled_realnvp(
            dim, n_flow_layers=flow_cfg.n_layers,
            layer_nodes_per_dim=flow_cfg.layer_nodes_per_dim, act_norm=flow_cfg.act_norm,
            init_mode=init_mode, dtype=dtype, device=device,
        )
    elif flow_cfg.get("use_snf"):
        snf_cfg = flow_cfg.snf
        flow = make_snf_model(
            dim, target_log_prob=target.log_prob, n_flow_layers=flow_cfg.n_layers,
            layer_nodes_per_dim=flow_cfg.layer_nodes_per_dim, act_norm=flow_cfg.act_norm,
            it_snf_layer=snf_cfg.get("it_snf_layer", 2),
            mh_prop_scale=snf_cfg.get("step_size", 0.1),
            mh_steps=snf_cfg.get("num_steps", 10), init_mode=init_mode, dtype=dtype,
            device=device,
        )
    else:
        flow = make_realnvp(
            dim, n_flow_layers=flow_cfg.n_layers,
            layer_nodes_per_dim=flow_cfg.layer_nodes_per_dim, act_norm=flow_cfg.act_norm,
            scale_cap=flow_cfg.get("scale_cap", 0.0),
            fused_coupling=bool(flow_cfg.get("fused_coupling", False)),
            init_mode=init_mode, dtype=dtype, device=device,
        )
    to_cfg = cfg.fab.transition_operator
    if to_cfg.type == "hmc":
        transition_operator = HamiltonianMonteCarlo(
            n_ais_intermediate_distributions=cfg.fab.n_intermediate_distributions,
            n_outer=1,
            n_leapfrog=to_cfg.n_inner_steps,
            epsilon=to_cfg.init_step_size,
            target_p_accept=to_cfg.get("target_p_accept", 0.65),
        )
    elif to_cfg.type == "metropolis":
        # init_step_size is both the largest and the smallest scale (a constant
        # row); tune_step_size switches the tuning.
        transition_operator = Metropolis(
            n_ais_intermediate_distributions=cfg.fab.n_intermediate_distributions,
            n_updates=to_cfg.n_inner_steps,
            max_step_size=to_cfg.init_step_size,
            min_step_size=to_cfg.init_step_size,
            adjust_step_size=to_cfg.get("tune_step_size", True),
            target_p_accept=to_cfg.get("target_p_accept", 0.65),
        )
    else:
        raise NotImplementedError(to_cfg.type)
    return FABModel.create(
        flow=flow,
        target=target,
        transition_operator=transition_operator,
        n_intermediate_distributions=cfg.fab.n_intermediate_distributions,
        alpha=cfg.fab.alpha,
        loss_type=cfg.fab.loss_type,
    )


def setup_trainer_and_run_flow(cfg: ConfigDict, target, plotter=None, device="cuda"):
    """Build everything from ``cfg`` and run training; returns (trainer, state).
    Logs, checkpoints and evals go to ``<evaluation.save_path>/<timestamp>/``."""
    device = resolve_device(device)
    dtype = maybe_enable_x64(cfg)
    setup_precision(cfg)
    setup_mesh(cfg)
    t = cfg.training
    n_iterations = get_n_iterations(
        n_training_iter=t.n_iterations,
        n_flow_forward_pass=t.n_flow_forward_pass,
        batch_size=t.batch_size,
        loss_type=cfg.fab.loss_type,
        n_transition_operator_inner_steps=cfg.fab.transition_operator.n_inner_steps,
        n_intermediate_ais_dist=cfg.fab.n_intermediate_distributions,
        transition_operator_type=cfg.fab.transition_operator.type,
        use_buffer=t.use_buffer,
        min_buffer_length=t.get("min_buffer_length"),
    )

    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    save_path = os.path.join(cfg.evaluation.save_path, stamp)
    os.makedirs(save_path, exist_ok=True)
    logger = setup_logger(cfg, save_path)
    model = setup_model(cfg, target, dtype, device)
    optimizer = make_optimizer(t.lr, t.get("max_grad_norm"))
    generator = torch.Generator(device=device).manual_seed(t.seed)
    common = dict(logger=logger, plotter=plotter, save_path=save_path, dtype=dtype,
                  device=device)
    if t.use_buffer and t.prioritised_buffer:
        trainer = PrioritisedBufferTrainer(
            model, optimizer,
            PrioritisedReplayBuffer(dim=cfg.target.dim, max_length=t.maximum_buffer_length,
                                    min_sample_length=t.min_buffer_length),
            n_batches_buffer_sampling=t.n_batches_buffer_sampling,
            w_adjust_max_clip=t.get("w_adjust_max_clip"), **common,
        )
    elif t.use_buffer:
        trainer = BufferTrainer(
            model, optimizer,
            ReplayBuffer(dim=cfg.target.dim, max_length=t.maximum_buffer_length,
                         min_sample_length=t.min_buffer_length,
                         temperature=float(t.get("buffer_temp", 0.0))),
            n_batches_buffer_sampling=t.n_batches_buffer_sampling,
            clip_ais_weights_frac=t.get("log_w_clip_frac"), **common,
        )
    else:
        trainer = Trainer(model, optimizer, **common)

    state, start_iter = None, 0
    if t.get("checkpoint_load_dir"):
        run_dir = get_latest_checkpoint_dir(t.checkpoint_load_dir)
        ckpt = latest_checkpoint(os.path.join(run_dir, "model_checkpoints")) if run_dir else None
        if ckpt:
            state, start_iter = trainer.load_state(ckpt)
            print(f"Resuming from {ckpt} at iteration {start_iter}")
    if state is None:
        if t.use_buffer:
            state = trainer.init_state(generator, batch_size=t.batch_size)
        else:
            state = trainer.init_state(generator)
        if cfg.flow.act_norm:
            data_dependent_init(model.flow, generator)

    state = trainer.run(
        generator,
        n_iterations=n_iterations,
        batch_size=t.batch_size,
        eval_batch_size=cfg.evaluation.get("eval_batch_size"),
        n_eval=cfg.evaluation.get("n_eval"),
        n_plot=cfg.evaluation.get("n_plots"),
        n_checkpoints=cfg.evaluation.get("n_checkpoints"),
        tlimit=t.get("tlimit"),
        state=state,
        start_iter=start_iter,
        log_every=t.get("log_every", 1),
    )
    return trainer, state
