"""Repeated quadratic-expectation bias estimates for GMM checkpoints
(``experiments/evaluate_expectation.py`` of the repository).

    python3 -m fab_tpu_torch.experiments.evaluate_expectation \
        --config experiments/configs/gmm.yaml --run fab_buffer_seed0=<run dir> \
        [--num-samples 1000] [--n-repeats 100] [--out gmm_results_expectation.csv] \
        [--device cpu] [overrides ...]

For each checkpoint, ``n_repeats`` times: draw ``num_samples`` flow samples, weight
them by w = p/q and estimate the normalised bias of the quadratic expectation, with
the weights and without (uniform weights over the finite rows). A ``target`` row
does the same on exact samples of the mixture. Reports each model's mean |bias|,
the bias's standard deviation and the unweighted mean |bias|, and the per-method
mean (sem) over seeds.
"""
from __future__ import annotations

import argparse
import csv
from collections import defaultdict

import numpy as np
import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments.evaluate import build_target, method_of
from fab_tpu_torch.experiments.load_model_for_eval import load_model
from fab_tpu_torch.experiments.setup_run import setup_precision
from fab_tpu_torch.utils.training import apply_overrides, load_config, maybe_enable_x64

COLUMNS = ["model_name", "bias", "std", "bias_unweighted"]


def bias_pair(target, samples, log_w):
    """(weighted, unweighted) normalised quadratic-expectation bias over the rows
    with a finite log_w; the unweighted estimate also leaves out rows whose
    normalised weight underflows to exactly 0."""
    mask = torch.isfinite(log_w)
    weighted = target.evaluate_expectation(samples, log_w, mask)
    w_bar = torch.softmax(torch.where(mask, log_w, -torch.inf), dim=0)
    unweighted = target.evaluate_expectation(samples, torch.zeros_like(log_w),
                                             mask & (w_bar > 0))
    return weighted, unweighted


def _repeat(n_repeats, draw):
    """``n_repeats`` bias pairs of ``draw()``, as two numpy arrays."""
    pairs = [torch.stack(draw()) for _ in range(n_repeats)]
    out = torch.stack(pairs).cpu().numpy()
    return out[:, 0], out[:, 1]


def evaluate_model(cfg, target, path, generator, num_samples, n_repeats,
                   dtype=torch.float32, device="cuda"):
    model, _ = load_model(cfg, target, path, dtype, device)

    def draw():
        x, log_q = model.flow.sample_and_log_prob(num_samples, generator)
        return bias_pair(target, x, target.log_prob(x) - log_q)

    with torch.no_grad():
        return _repeat(n_repeats, draw)


def evaluate_target(target, generator, num_samples, n_repeats):
    def draw():
        x = target.sample(generator, num_samples)
        return bias_pair(target, x, torch.zeros(num_samples, dtype=x.dtype, device=x.device))

    with torch.no_grad():
        return _repeat(n_repeats, draw)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="experiments/configs/gmm.yaml")
    parser.add_argument(
        "--run", action="append", default=[],
        help="name=path (checkpoint file or run dir); repeatable. The 'target' "
        "control row is always included.",
    )
    parser.add_argument("--num-samples", type=int, default=1000)
    parser.add_argument("--n-repeats", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="gmm_results_expectation.csv")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    cfg = apply_overrides(load_config(args.config), args.overrides)
    if "n_mixes" not in cfg.target:
        raise ValueError("evaluate_expectation is for the GMM problem")
    device = resolve_device(args.device)
    dtype = maybe_enable_x64(cfg)
    setup_precision(cfg)
    target = build_target(cfg, dtype, device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    rows = []

    def record(name, biases, biases_unweighted):
        rows.append({
            "model_name": name,
            "bias": float(np.mean(np.abs(biases))),
            "std": float(np.std(biases)),
            "bias_unweighted": float(np.mean(np.abs(biases_unweighted))),
        })
        print(rows[-1])

    record("target", *evaluate_target(target, generator, args.num_samples, args.n_repeats))
    for spec in args.run:
        name, path = spec.split("=", 1)
        record(name, *evaluate_model(cfg, target, path, generator, args.num_samples,
                                     args.n_repeats, dtype, device))

    with open(args.out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=COLUMNS)
        writer.writeheader()
        writer.writerows(rows)

    grouped = defaultdict(list)
    for r in rows:
        grouped[method_of(r["model_name"])].append(r)
    print("\n*** per-method mean (sem over seeds) ***")
    for name, rs in grouped.items():
        for k in ("bias", "bias_unweighted"):
            vals = [r[k] for r in rs]
            sem = np.std(vals) / max(len(vals) - 1, 1) ** 0.5
            print(f"{name}: {k} = {np.mean(vals):.5f} ({sem:.5f})")
    return rows


if __name__ == "__main__":
    main()
