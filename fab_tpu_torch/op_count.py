"""Count the aten ops that one train step dispatches, for a YAML config.

    python3 -m fab_tpu_torch.op_count --config experiments/configs/aldp_snf.yaml \
        --device cpu training.batch_size=16 data.transform=<frame.npy, Angstrom>
    python3 -m fab_tpu_torch.op_count --config experiments/configs/gmm.yaml \
        --device cpu flow.use_snf=true

Builds the config's model and trainer as its runner does (``run_aldp`` for a
config with a ``system`` section, else ``run_gmm``'s GMM through ``setup_model``),
fills the buffer (one batch, if the trainer has one), takes one step, then counts
with a ``TorchDispatchMode``: one flow log q (with its log-q key), one target log
p, one AIS pass and one train step. Every dispatched aten op counts once, so the
counts are a proxy for the kernels a card would launch; the device's own count
comes from its profiler. Prints one JSON object.
"""
from __future__ import annotations

import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fab_tpu_torch.buffer import PrioritisedReplayBuffer
from fab_tpu_torch.experiments import run_aldp
from fab_tpu_torch.experiments.make_aldp_model import make_aldp_model
from fab_tpu_torch.experiments.run_gmm import parse_args
from fab_tpu_torch.experiments.setup_run import setup_model
from fab_tpu_torch.flows.base import flow_log_prob, log_q_noise
from fab_tpu_torch.targets import GMM
from fab_tpu_torch.train import PrioritisedBufferTrainer, Trainer, make_optimizer
from fab_tpu_torch.utils.training import maybe_enable_x64


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def count(fn) -> int:
    with OpCount() as counter:
        fn()
    return counter.n


def _aldp_trainer(cfg, dtype, device):
    model, target = make_aldp_model(cfg, dtype, device)
    t, rb = cfg.training, cfg.training.replay_buffer
    if rb is not None and rb.get("type") == "prioritised":
        buffer = PrioritisedReplayBuffer(dim=target.dim, max_length=rb.max_length * t.batch_size,
                                         min_sample_length=t.batch_size)
        return PrioritisedBufferTrainer(
            model, run_aldp._optimizer(t), buffer, n_batches_buffer_sampling=rb.n_updates,
            w_adjust_max_clip=rb.get("max_adjust_w_clip"), dtype=dtype, device=device,
        ), t.batch_size
    return Trainer(model, run_aldp._optimizer(t), dtype=dtype, device=device), t.batch_size


def _gmm_trainer(cfg, dtype, device):
    target = GMM(dim=cfg.target.dim, n_mixes=cfg.target.n_mixes,
                 loc_scaling=cfg.target.loc_scaling, log_var_scaling=cfg.target.log_var_scaling,
                 true_expectation_estimation_n_samples=1000, dtype=dtype, device=device)
    model = setup_model(cfg, target, dtype, device)
    t = cfg.training
    return Trainer(model, make_optimizer(t.lr, t.get("max_grad_norm")), dtype=dtype,
                   device=device), t.batch_size


def main(argv=None) -> dict:
    cfg, device = parse_args(argv, "experiments/configs/aldp.yaml")
    dtype = maybe_enable_x64(cfg)
    make = _aldp_trainer if cfg.get("system") else _gmm_trainer
    trainer, batch = make(cfg, dtype, device)
    generator = torch.Generator(device=device).manual_seed(0)
    if isinstance(trainer, PrioritisedBufferTrainer):
        state = trainer.init_state(generator, batch_size=batch)
    else:
        state = trainer.init_state(generator)
    state, _ = trainer.train_step(state, generator, batch)
    model = trainer.model
    x = model.flow.sample(batch, generator).detach()
    key = log_q_noise(model.flow, generator)
    counts = {
        "batch": batch,
        "flow_log_q": count(lambda: flow_log_prob(model.flow, x, key)),
        "target_log_p": count(lambda: model.target.log_prob(x)),
        "ais_pass": count(lambda: model.ais.sample_and_log_weights(
            state.transition_state, generator, batch, p_target=False, tune=False)),
        "train_step": count(lambda: trainer.train_step(state, generator, batch)),
    }
    print(json.dumps(counts))
    return counts


if __name__ == "__main__":
    main()
