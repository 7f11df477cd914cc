"""Checkpoint evaluation across methods and seeds: a metrics CSV and a mean (sem)
table per method (``experiments/evaluate.py`` of the repository).

    python3 -m fab_tpu_torch.experiments.evaluate --config experiments/configs/gmm.yaml \
        --run fab_buffer_seed0=results/gmm/seed0 --run snf_seed0=... \
        [--num-samples 10000] [--inner-batch 500] [--out eval_results.csv] \
        [--device cpu] [overrides ...]

The problem (GMM, LGCP or ManyWell) is read from the config. Each ``--run
name=path`` loads a checkpoint file or run directory (written by either package)
and computes the ESS and the target's metrics with the AIS target set to p; a name
whose method (the part before ``_seed``) starts with ``snf`` builds the SNF flow,
one starting with ``rsb`` the resampled (LARS) base. With
``flow.fused_coupling=true`` an LGCP checkpoint is evaluated through the fused
coupling kernel (K2) on the card.
"""
from __future__ import annotations

import argparse
import copy
import csv
from collections import defaultdict

import numpy as np
import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments.load_model_for_eval import load_model
from fab_tpu_torch.experiments.setup_run import setup_precision
from fab_tpu_torch.utils.training import apply_overrides, load_config, maybe_enable_x64

SUMMARY_KEYS = [
    "eval_ess_flow",
    "eval_ess_ais",
    "flow_test_set_mean_log_prob",
    "flow_kl_forward",
    "flow_test_set_exact_mean_log_prob",
    "flow_test_set_modes_mean_log_prob",
    "flow_forward_kl",
    "ais_relative_MSE_Z_estimate",
    "ais_abs_MSE_log_Z_estimate",
    "flow_bias_normed",
    "ais_bias_normed",
]


def build_target(cfg, dtype=torch.float32, device="cuda"):
    """The config's target: the seed-0 GMM, an LGCP or ManyWell."""
    device = resolve_device(device)
    if "n_mixes" in cfg.target:
        from fab_tpu_torch.targets import GMM

        return GMM(
            dim=cfg.target.dim,
            n_mixes=cfg.target.n_mixes,
            loc_scaling=cfg.target.loc_scaling,
            log_var_scaling=cfg.target.log_var_scaling,
            seed=0,  # the GMM problem is always the seed-0 mixture
            true_expectation_estimation_n_samples=int(
                cfg.target.get("true_expectation_n_samples", 1e7)
            ),
            expectation_generator=torch.Generator(device=device).manual_seed(0),
            dtype=dtype,
            device=device,
        )
    if "grid_size" in cfg.target:
        from fab_tpu_torch.targets import LogGaussianCoxProcess

        if cfg.target.get("in_graph_kernel"):
            raise NotImplementedError(
                "target.in_graph_kernel is not ported (ROADMAP Queue 1, item 10: the "
                "port keeps chol(K)^T on the device, built once)"
            )
        return LogGaussianCoxProcess(grid_size=cfg.target.grid_size, dtype=dtype,
                                     device=device)
    from fab_tpu_torch.targets import ManyWellEnergy

    return ManyWellEnergy(dim=cfg.target.dim, device=device)


def evaluate_checkpoint(cfg, target, path, num_samples, inner_batch, seed=0,
                        dtype=torch.float32, device="cuda"):
    """``get_eval_info`` of the checkpoint at ``path`` with the AIS target set to
    p, on a generator seeded with ``seed``."""
    model, transition_state = load_model(cfg, target, path, dtype, device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return model.get_eval_info(transition_state, generator, outer_batch_size=num_samples,
                               inner_batch_size=inner_batch, p_target=True)


def _write_rows(path, rows):
    cols = ["model_name"] + sorted({k for r in rows for k in r} - {"model_name"})
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=cols, restval="")
        writer.writeheader()
        writer.writerows(rows)


def method_of(name: str) -> str:
    return name.rsplit("_seed", 1)[0]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument(
        "--run", action="append", default=[],
        help="name=path (path = checkpoint file or run dir); repeatable",
    )
    parser.add_argument("--num-samples", type=int, default=10_000)
    parser.add_argument("--inner-batch", type=int, default=500)
    parser.add_argument("--out", default="eval_results.csv")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    cfg = apply_overrides(load_config(args.config), args.overrides)
    device = resolve_device(args.device)
    dtype = maybe_enable_x64(cfg)  # a use_64_bit run's checkpoint at full width
    setup_precision(cfg)
    target = build_target(cfg, dtype, device)

    rows = []
    for spec in args.run:
        name, path = spec.split("=", 1)
        # snf_* checkpoints need the SNF flow, rsb_* the resampled base.
        cfg_run = copy.deepcopy(cfg)
        cfg_run.flow.use_snf = method_of(name).startswith("snf")
        cfg_run.flow.resampled_base = method_of(name).startswith("rsb")
        info = evaluate_checkpoint(cfg_run, target, path, args.num_samples,
                                   args.inner_batch, dtype=dtype, device=device)
        info = {k: float(v) for k, v in info.items()}
        info["model_name"] = name
        rows.append(info)
        print(name, {k: round(v, 4) for k, v in info.items() if k != "model_name"})
        # Rewritten after every checkpoint: an interrupted evaluation keeps its rows.
        _write_rows(args.out, rows)

    if rows:
        grouped = defaultdict(list)
        for r in rows:
            grouped[method_of(r["model_name"])].append(r)
        print("\n*** mean (sem) per method ***")
        for name, rs in grouped.items():
            line = [name]
            for k in SUMMARY_KEYS:
                vals = [r[k] for r in rs if k in r]
                if vals:
                    mean = np.mean(vals)
                    sem = np.std(vals) / max(len(vals) - 1, 1) ** 0.5
                    line.append(f"{k}={mean:.4f}({sem:.4f})")
            print("  ".join(line))
    return rows


if __name__ == "__main__":
    main()
