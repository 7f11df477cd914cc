"""Sample a trained ALDP model: flow samples with log q and log p, and AIS samples
with their log weights, to ``.npz`` (``experiments/sample_aldp.py`` of the
repository).

    python3 -m fab_tpu_torch.experiments.sample_aldp --config experiments/configs/aldp.yaml \
        --run <save_root> [--n-samples 100000] [--batch 1000] [--out samples.npz] \
        [--device cpu] [overrides ...]

The latest checkpoint under ``<run>/model_checkpoints`` is loaded; the target is
rebuilt from the config (pass the run's ``data.transform`` so that the transform is
the run's). ``n_samples // batch`` batches of each kind are drawn; the AIS chain
targets p, with the checkpoint's step sizes, untuned. Writes ``flow_samples``,
``flow_log_q``, ``flow_log_p``, ``ais_samples`` and ``ais_log_w`` (default
``<run>/samples.npz``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from fab_tpu_torch.checkpoint import latest_checkpoint
from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments.load_model_for_eval import load_flow
from fab_tpu_torch.experiments.make_aldp_model import make_aldp_model
from fab_tpu_torch.experiments.setup_run import setup_precision
from fab_tpu_torch.utils.training import apply_overrides, load_config, maybe_enable_x64


def load_aldp_run(argv, description_args):
    """Parse ``--config --run --device`` plus ``description_args`` (name, kwargs)
    and overrides; build the config's model and target and load the latest
    checkpoint under ``<run>/model_checkpoints`` into the flow. Returns (args, cfg,
    model, target, checkpoint path, its params)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="experiments/configs/aldp.yaml")
    parser.add_argument("--run", required=True)
    parser.add_argument("--device", default="cuda")
    for name, kw in description_args:
        parser.add_argument(name, **kw)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.overrides)
    device = resolve_device(args.device)
    dtype = maybe_enable_x64(cfg)
    setup_precision(cfg)
    model, target = make_aldp_model(cfg, dtype, device)
    ckpt = latest_checkpoint(os.path.join(args.run, "model_checkpoints"))
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {args.run}")
    params = load_flow(model.flow, ckpt, device)
    print(f"loaded {ckpt}")
    return args, cfg, model, target, ckpt, params


def main(argv=None):
    args, _, model, target, _, params = load_aldp_run(argv, [
        ("--n-samples", dict(type=int, default=100_000)),
        ("--batch", dict(type=int, default=1000)),
        ("--out", dict(default=None)),
    ])
    device = target.device
    transition = {k: torch.tensor(np.asarray(v), device=device)
                  for k, v in params["transition"].items()}
    generator = torch.Generator(device=device).manual_seed(0)
    out = {k: [] for k in ("flow_samples", "flow_log_q", "flow_log_p", "ais_samples",
                           "ais_log_w")}
    for _ in range(args.n_samples // args.batch):
        with torch.no_grad():
            x, log_q = model.flow.sample_and_log_prob(args.batch, generator)
            log_p = target.log_prob(x)
        result = model.ais.sample_and_log_weights(transition, generator, args.batch,
                                                  p_target=True, tune=False)
        for k, v in zip(out, (x, log_q, log_p, result.point.x, result.log_w)):
            out[k].append(v.detach().cpu().numpy())
    path = args.out or os.path.join(args.run, "samples.npz")
    np.savez_compressed(path, **{k: np.concatenate(v) for k, v in out.items()})
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
