"""Alanine-dipeptide (ALDP) experiment entry point (``experiments/run_aldp.py`` of
the repository).

    python3 -m fab_tpu_torch.experiments.run_aldp --config experiments/configs/aldp.yaml \
        [--device cpu] [training.max_iter=100 ...]

FAB with a prioritised buffer (or the plain ``Trainer`` without one, or
maximum-likelihood training for ``fab.loss_type: forward_kl``) on the 60-D
internal-coordinate Boltzmann target. The test set, and the ML training set, are made
by a long HMC run at the target and cached as ``.npy`` under ``training.save_root``;
the run resumes from the latest checkpoint there; a final evaluation compares flow
samples with the test set (Ramachandran and marginal KLDs) and, when matplotlib is
installed, draws the Ramachandran and dihedral-marginal plots into
``<save_root>/plots/`` (else it prints ``plots off: matplotlib is not installed``).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from fab_tpu_torch import checkpoint, graph, random
from fab_tpu_torch.buffer import PrioritisedReplayBuffer
from fab_tpu_torch.convert import to_jax_params
from fab_tpu_torch.experiments.make_aldp_model import make_aldp_model
from fab_tpu_torch.experiments.run_gmm import parse_args
from fab_tpu_torch.experiments.setup_run import setup_precision
from fab_tpu_torch.flows.base import log_q_noise
from fab_tpu_torch.sampling import HamiltonianMonteCarlo, create_point
from fab_tpu_torch.train import PrioritisedBufferTrainer, Trainer, guarded_update, make_optimizer
from fab_tpu_torch.utils.aldp_eval import (
    chirality_scale_shift,
    evaluate_aldp,
    filter_chirality,
)
from fab_tpu_torch.utils.logging import CSVLogger
from fab_tpu_torch.utils.plotting import when_plots_available
from fab_tpu_torch.utils.training import maybe_enable_x64

SWEEPS_PER_CHUNK = 20


def generate_test_set(target, generator: torch.Generator, n_samples: int = 10_000,
                      n_steps: int = 400, n_chains: Optional[int] = None) -> np.ndarray:
    """Flow-space samples of the target by HMC at beta = 1 (10 leapfrog steps of
    0.05, step size tuned) from the reference configuration plus 0.01 noise.

    The sweeps run in chunks of 20; the first half of the chunks is burn-in, the
    rest is kept. Only L-form rows are kept (refusing a set with at most 10 % of
    them), then the set is cut or tiled to ``n_samples`` rows."""
    if n_chains is None:
        n_chunks = n_steps // SWEEPS_PER_CHUNK
        n_collect_chunks = max(n_chunks - n_chunks // 2, 1)
        # 2x headroom for the D-form rows the chirality filter drops.
        n_chains = max(512, 2 * -(-n_samples // n_collect_chunks))
    op = HamiltonianMonteCarlo(
        n_ais_intermediate_distributions=1, n_outer=1, n_leapfrog=10, epsilon=0.05
    )
    dtype, device = target.dtype, target.device
    # The step sizes are float32 whatever the target's dtype, as in fab_tpu (its
    # HMC state's default dtype).
    state = op.init_state(target.dim, dtype=torch.float32, device=device)
    ref = torch.as_tensor(target.ref_cartesian, dtype=dtype, device=device)
    z0, _ = target.transform.cartesian_to_flow(ref)
    z = z0.expand(n_chains, target.dim) + 0.01 * random.normal(
        generator, (n_chains, target.dim), dtype, device
    )

    def log_q(x):  # beta = 1: the target alone
        return (x * 0.0).sum(-1)

    point = create_point(z, log_q, target.log_prob, with_grad=True)
    mask = torch.ones(n_chains, dtype=torch.bool, device=device)
    samples = []
    n_chunks = max(n_steps // SWEEPS_PER_CHUNK, 1)
    burn_in_chunks = n_chunks // 2
    for c in range(n_chunks):
        for _ in range(SWEEPS_PER_CHUNK):
            point, state, _ = op.transition(
                state, generator, point, 1.0, 0, log_q, target.log_prob, 1.0, mask, True
            )
        if c >= burn_in_chunks:
            samples.append(point.x.cpu().numpy())
    data = np.concatenate(samples)
    scale, shift = chirality_scale_shift(target.transform)
    keep = filter_chirality(data, scale, shift)
    if keep.mean() <= 0.1:
        raise RuntimeError(
            f"test-set generation: only {keep.mean():.1%} of HMC samples are "
            "L-form; refusing to build an (almost) empty L-only test set. "
            "Regenerate with a different seed or more chains."
        )
    if keep.mean() < 0.999:
        print(f"test set: dropping {int((~keep).sum())}/{len(keep)} D-form rows "
              f"(frac_L={keep.mean():.3f})")
        data = data[keep]
    data = data[:n_samples]
    if data.shape[0] < n_samples:
        reps = -(-n_samples // data.shape[0])
        data = np.tile(data, (reps, 1))[:n_samples]
    return data


def _optimizer(t):
    """The config's optimizer; the schedule counts optimizer updates against
    ``max_iter`` (a buffer trainer makes ``n_updates`` of them per iteration)."""
    return make_optimizer(
        t.learning_rate,
        t.get("max_grad_norm"),
        optimizer=t.get("optimizer", "adam"),
        schedule=t.get("lr_schedule"),
        total_steps=t.max_iter,
        warmup_steps=int(t.get("warmup_iter", 0)),
        decay_rate=float(t.get("lr_decay_rate", 0.1)),
        restart_period=t.get("lr_restart_period"),
    )


def sample_flow(flow, generator, n: int, chunk: int = 1000) -> np.ndarray:
    """n flow samples, drawn ``chunk`` at a time, on the host."""
    out = []
    with torch.no_grad():
        for _ in range(0, n, chunk):
            out.append(flow.sample(chunk, generator).cpu().numpy())
    return np.concatenate(out)[:n]


def _plot_dir(save_root: str) -> Optional[str]:
    """``<save_root>/plots`` for the final evaluation's plots, or None without
    matplotlib."""
    return when_plots_available(lambda: os.path.join(save_root, "plots"))


def run_ml_training(cfg, model, target, z_train: torch.Tensor, z_test: np.ndarray,
                    generator: torch.Generator):
    """Forward-KL (maximum-likelihood) training on target samples: minibatches drawn
    with replacement, a guarded update per iteration, a checkpoint and the final
    evaluation. Returns the metrics.

    The step is one compiled program (``graph.Program``: ``fab_tpu``'s jitted
    ``step``) where ``graph.supported`` admits the model, else eager; the choice and
    its reason are printed."""
    t = cfg.training
    save_root = t.save_root
    flow = model.flow
    model.init(generator)
    params = [p for p in flow.parameters() if p.requires_grad]
    optimizer = _optimizer(t)
    n_train = z_train.shape[0]

    def ml_step(opt_state, key):
        idx = random.randint(key, 0, n_train, (t.batch_size,), z_train.device)
        loss = model.forward_kl_loss(z_train[idx], log_q_noise(flow, key))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        opt_state, _, _ = guarded_update(optimizer, grads, opt_state, params, loss.detach())
        return opt_state, {"loss": loss.detach()}

    compiled, reason = graph.supported(model, z_train.device)
    print(f"ml step: {'compiled' if compiled else 'eager'} ({reason})", flush=True)
    step = graph.Program(ml_step, flow, z_train.device) if compiled else ml_step
    opt_state = optimizer.init(params)
    for i in range(t.max_iter):
        opt_state, info = step(opt_state, generator)
        if i % t.get("log_every", 100) == 0:
            print(f"ml iter {i}: loss {float(info['loss']):.4f}")
    checkpoint.save_checkpoint(
        os.path.join(save_root, "model_checkpoints", f"iter_{t.max_iter}", "state.pkl"),
        {"params": {"flow": to_jax_params(flow.state_dict(), len(flow.bijectors))}},
    )
    z_sample = sample_flow(flow, generator, int(t.get("final_eval_samples", 10_000)))
    metrics = evaluate_aldp(target, z_sample, z_test, iteration=t.max_iter,
                            metric_dir=os.path.join(save_root, "metrics"),
                            plot_dir=_plot_dir(save_root))
    print({k: round(float(v), 5) for k, v in metrics.items()})
    return metrics


def _cached_set(path: str, what: str, make) -> np.ndarray:
    """The array at ``path``, made by ``make()`` and saved there if absent."""
    if os.path.exists(path):
        return np.load(path)
    print(f"Generating MCMC {what} ...")
    data = make()
    np.save(path, data)
    return data


def main(argv=None):
    """Run the config; returns (trainer or None for ML, state or None, metrics)."""
    cfg, device = parse_args(argv, "experiments/configs/aldp.yaml")
    dtype = maybe_enable_x64(cfg)
    setup_precision(cfg)
    model, target = make_aldp_model(cfg, dtype, device)
    t = cfg.training
    save_root = t.save_root
    os.makedirs(save_root, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(t.seed)

    n_steps = int(t.get("test_mcmc_steps", 400))
    z_test = _cached_set(os.path.join(save_root, "test_set.npy"), "test set", lambda: (
        generate_test_set(target, generator, int(t.get("n_test_samples", 10_000)), n_steps)
    ))

    if cfg.fab.loss_type == "forward_kl":
        # Maximum likelihood on an MCMC training set made like the test set.
        z_train = _cached_set(os.path.join(save_root, "train_set.npy"), "training set", lambda: (
            generate_test_set(target, generator, int(t.get("n_train_samples", 100_000)), n_steps)
        ))
        z_train = torch.as_tensor(z_train, dtype=dtype, device=device)
        return None, None, run_ml_training(cfg, model, target, z_train, z_test, generator)

    logger = CSVLogger(save_path=os.path.join(save_root, "logging_hist.csv"),
                       save_period=t.get("log_iter", 100))
    common = dict(logger=logger, save_path=save_root, dtype=dtype, device=device)
    rb = t.replay_buffer
    use_buffer = rb is not None and rb.get("type") == "prioritised"
    if use_buffer:
        buffer = PrioritisedReplayBuffer(
            dim=target.dim,
            max_length=rb.max_length * t.batch_size,
            min_sample_length=rb.min_length * t.batch_size,
        )
        trainer = PrioritisedBufferTrainer(
            model, _optimizer(t), buffer, n_batches_buffer_sampling=rb.n_updates,
            w_adjust_max_clip=rb.get("max_adjust_w_clip"), **common,
        )
    else:
        trainer = Trainer(model, _optimizer(t), **common)

    # Resume from the latest checkpoint under save_root; the CSV log is cut back to
    # the checkpoint's iteration.
    state, start_iter = None, 0
    if t.get("resume", True):
        ckpt = checkpoint.latest_checkpoint(os.path.join(save_root, "model_checkpoints"))
        if ckpt:
            state, start_iter = trainer.load_state(ckpt)
            logger.resume_from(start_iter)
            print(f"Resuming from {ckpt} at iteration {start_iter}")
    if state is None:
        if use_buffer:
            state = trainer.init_state(generator, batch_size=t.batch_size)
        else:
            state = trainer.init_state(generator)

    state = trainer.run(
        generator,
        n_iterations=t.max_iter,
        batch_size=t.batch_size,
        eval_batch_size=t.get("eval_batch_size", t.batch_size),
        n_eval=t.get("n_eval", 5),
        n_checkpoints=t.get("n_checkpoints", 2),
        tlimit=t.get("tlimit"),
        start_iter=start_iter,
        state=state,
        log_every=t.get("log_every", 10),
    )

    print("Final ALDP evaluation ...")
    z_sample = sample_flow(model.flow, generator, int(t.get("final_eval_samples", 10_000)))
    # Label the metrics with the iteration reached (tlimit may stop early): the
    # trainer checkpoints at its stop, so the latest iter_N is it.
    ckpt = checkpoint.latest_checkpoint(os.path.join(save_root, "model_checkpoints"))
    try:
        reached = int(os.path.basename(os.path.dirname(ckpt)).split("_")[-1])
    except (TypeError, ValueError, AttributeError):
        reached = t.max_iter
    metrics = evaluate_aldp(target, z_sample, z_test, iteration=reached,
                            metric_dir=os.path.join(save_root, "metrics"),
                            plot_dir=_plot_dir(save_root))
    print({k: round(float(v), 5) for k, v in metrics.items()})
    return trainer, state, metrics


if __name__ == "__main__":
    main()
