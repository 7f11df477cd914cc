"""Experiment glue: config -> target-independent model, trainer and run
(``experiments/setup_run.py`` of the repository).

The flow-forward-pass budget, the logger, the flow and transition operator, the
trainer chosen by ``training.use_buffer`` and ``training.prioritised_buffer``, the
resume from ``training.checkpoint_load_dir``, ActNorm's data-dependent
initialisation, and the run. Everything is built on ``device`` in the config's
dtype (``training.use_64_bit``).

The ``mesh`` section: under a launcher (one process per card, ``python3 -m
torch.distributed.run --nproc_per_node=<n_data * n_model> -m
fab_tpu_torch.experiments.run_gmm ... mesh.n_data=<n_data> mesh.n_model=<n_model>``)
the run spans an n_data x n_model grid of processes: the batch is split over
``n_data`` and the coupling MLPs over ``n_model`` (``n_data`` null meaning the world
size over ``n_model``). Without a launcher the run stays on its one device, as
``fab_tpu`` does on one chip, and says how to launch more; ``fab_tpu`` would span
every local device, which one process of the port cannot.
"""
from __future__ import annotations

import datetime
import os
import sys
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
from fab_tpu_torch.parallel import distributed
from fab_tpu_torch.parallel.mesh import (
    Mesh,
    activate_mesh,
    check_batch,
    make_mesh,
    replicate,
    use_mesh,
)
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


def launch_command(n: str = "N", n_model: int = 1) -> str:
    """The launcher command for a mesh of ``n`` data ranks (x ``n_model`` model
    ranks) running this program."""
    spec = getattr(sys.modules.get("__main__"), "__spec__", None)
    name = getattr(spec, "name", "") or ""
    runner = name if name.startswith("fab_tpu_torch.") else "fab_tpu_torch.experiments.run_<target>"
    if n_model == 1:
        return (f"python3 -m torch.distributed.run --nproc_per_node={n} -m {runner} "
                f"--config <config> mesh.n_data={n}")
    world = int(n) * n_model if n.isdigit() else f"<{n} x {n_model}>"
    return (f"python3 -m torch.distributed.run --nproc_per_node={world} -m {runner} "
            f"--config <config> mesh.n_data={n} mesh.n_model={n_model}")


def setup_mesh(cfg: ConfigDict, device="cuda") -> Optional[Mesh]:
    """The ``mesh`` section. Under a launcher: join the process group (NCCL on a
    card, gloo on the CPU), build the (data, model) grid over it (world size =
    n_data x n_model; ``n_data`` null = world // n_model) and activate it; returns
    it. Without one: None, after one line naming the launcher command (``n_data``
    or ``n_model`` above 1 raises, naming it: one process holds one device)."""
    mesh_cfg = cfg.get("mesh")
    if not mesh_cfg or not mesh_cfg.get("enable", True):
        return None
    n_data = mesh_cfg.get("n_data")
    n_model = int(mesh_cfg.get("n_model") or 1)
    if not distributed.initialize(device):
        if n_data not in (None, 1) or n_model != 1:
            what = "data shard" if n_model == 1 else "card of the (data, model) grid"
            raise ValueError(
                f"mesh.n_data={n_data} mesh.n_model={n_model} needs one process per "
                f"{what}: " + launch_command(str(n_data or 1), n_model))
        print(f"one process on {device}; for a data mesh over N cards: {launch_command()}")
        return None
    mesh = make_mesh(n_data, n_model)
    activate_mesh(mesh)
    if distributed.is_primary():
        if mesh.n_model == 1:
            print(f"data mesh over {mesh.n_data} processes on {device}")
        else:
            print(f"(data, model) mesh of {mesh.n_data} x {mesh.n_model} processes on "
                  f"{device}")
    return mesh


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


def setup_trainer(cfg: ConfigDict, target, plotter=None, logger=None, save_path: str = "",
                  device="cuda"):
    """The model, optimizer, buffer and trainer ``cfg`` asks for (the trainer chosen
    by ``training.use_buffer`` and ``training.prioritised_buffer``), on ``device`` in
    the config's dtype; nothing is initialised or run."""
    device = resolve_device(device)
    dtype = maybe_enable_x64(cfg)
    t = cfg.training
    model = setup_model(cfg, target, dtype, device)
    optimizer = make_optimizer(t.lr, t.get("max_grad_norm"))
    common = dict(logger=logger, plotter=plotter, save_path=save_path, dtype=dtype,
                  device=device)
    if t.use_buffer and t.prioritised_buffer:
        return PrioritisedBufferTrainer(
            model, optimizer,
            PrioritisedReplayBuffer(dim=cfg.target.dim, max_length=t.maximum_buffer_length,
                                    min_sample_length=t.min_buffer_length,
                                    batch_size=t.batch_size),
            n_batches_buffer_sampling=t.n_batches_buffer_sampling,
            w_adjust_max_clip=t.get("w_adjust_max_clip"), **common,
        )
    if t.use_buffer:
        return BufferTrainer(
            model, optimizer,
            ReplayBuffer(dim=cfg.target.dim, max_length=t.maximum_buffer_length,
                         min_sample_length=t.min_buffer_length,
                         temperature=float(t.get("buffer_temp", 0.0)),
                         batch_size=t.batch_size),
            n_batches_buffer_sampling=t.n_batches_buffer_sampling,
            clip_ais_weights_frac=t.get("log_w_clip_frac"), **common,
        )
    return Trainer(model, optimizer, **common)


def make_generator(seed: int, device) -> torch.Generator:
    """The run's generator: every draw of ``init_state`` and of training comes from
    it, on ``device``."""
    return torch.Generator(device=device).manual_seed(seed)


def setup_trainer_and_run_flow(cfg: ConfigDict, target, plotter=None, device="cuda"):
    """Build everything from ``cfg`` and run training; returns (trainer, state).
    Logs, checkpoints and evals go to ``<evaluation.save_path>/<timestamp>/``
    (rank 0's time stamp on every rank, and only rank 0 writes)."""
    device = resolve_device(device)
    setup_precision(cfg)
    if distributed.is_primary():
        print(f"f32 matmul precision {torch.get_float32_matmul_precision()}, TF32 "
              f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}", flush=True)
    mesh = setup_mesh(cfg, device)
    t = cfg.training
    if mesh is not None:
        check_batch(t.batch_size, "training.batch_size")
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

    stamp = replicate(datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
    save_path = os.path.join(cfg.evaluation.save_path, stamp)
    if distributed.is_primary():
        os.makedirs(save_path, exist_ok=True)
    trainer = setup_trainer(cfg, target, plotter, setup_logger(cfg, save_path), save_path,
                            device)
    model = trainer.model
    generator = make_generator(t.seed, device)

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
            with use_mesh(None):  # the same statistics on every rank
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
