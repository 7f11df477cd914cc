"""Alpha ablation: FAB trained across alpha values x seeds on the GMM, one row of
evaluation metrics per run (``experiments/alpha_study.py`` of the repository).

    python3 -m fab_tpu_torch.experiments.alpha_study \
        [--config experiments/configs/gmm_fast.yaml] [--alphas 0.5 1.0 2.0]
        [--seeds 0 1] [--num-samples 10000] [--out alpha_study.csv] [--device cpu]
        [overrides ...]

The FAB loss targets g = p^alpha q^(1-alpha); the paper ablates alpha in {0.25,
0.5, 1, 1.5, 2, 3}. Each (alpha, seed) trains the plain ``Trainer`` on the seed-0
mixture (its true expectation from ``target.true_expectation_n_samples`` exact
samples, 1e6 by default) for the config's budget, then ``get_eval_info`` with the
AIS target set to p on ``--num-samples`` samples (inner batch at most 1000). The CSV
has the columns of the repository's script and is rewritten after every run, so an
interrupted study keeps its finished rows.
"""
from __future__ import annotations

import argparse
import csv

import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments.setup_run import get_n_iterations, setup_model, setup_precision
from fab_tpu_torch.targets import GMM
from fab_tpu_torch.train import Trainer, make_optimizer
from fab_tpu_torch.utils.logging import ListLogger
from fab_tpu_torch.utils.training import apply_overrides, load_config, maybe_enable_x64


def run_one(cfg, alpha: float, seed: int, num_samples: int, device) -> dict:
    """One (alpha, seed): train, then the evaluation row."""
    cfg.fab.alpha = float(alpha)
    cfg.training.seed = int(seed)
    setup_precision(cfg)
    dtype = maybe_enable_x64(cfg)
    target = GMM(
        dim=cfg.target.dim,
        n_mixes=cfg.target.n_mixes,
        loc_scaling=cfg.target.loc_scaling,
        log_var_scaling=cfg.target.log_var_scaling,
        seed=0,
        true_expectation_estimation_n_samples=int(
            cfg.target.get("true_expectation_n_samples", 1e6)
        ),
        expectation_generator=torch.Generator(device=device).manual_seed(0),
        dtype=dtype,
        device=device,
    )
    model = setup_model(cfg, target, dtype, device)
    trainer = Trainer(model, make_optimizer(cfg.training.lr, cfg.training.get("max_grad_norm")),
                      logger=ListLogger(), dtype=dtype, device=device)
    t = cfg.training
    n_iterations = get_n_iterations(
        t.n_iterations,
        t.get("n_flow_forward_pass"),
        t.batch_size,
        cfg.fab.loss_type,
        cfg.fab.transition_operator.n_inner_steps,
        cfg.fab.n_intermediate_distributions,
        cfg.fab.transition_operator.type,
        use_buffer=False,  # the study trains with the plain Trainer
    )
    state = trainer.run(torch.Generator(device=device).manual_seed(seed),
                        n_iterations=n_iterations, batch_size=t.batch_size, save=False,
                        log_every=100)
    info = model.get_eval_info(
        state.transition_state, torch.Generator(device=device).manual_seed(seed + 100),
        outer_batch_size=num_samples, inner_batch_size=min(num_samples, 1000),
        p_target=True,
    )
    row = {"alpha": alpha, "seed": seed}
    row.update({k: float(v) for k, v in info.items()})
    return row


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="experiments/configs/gmm_fast.yaml")
    parser.add_argument("--alphas", type=float, nargs="+",
                        default=[0.25, 0.5, 1.0, 1.5, 2.0, 3.0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--num-samples", type=int, default=10_000)
    parser.add_argument("--out", default="alpha_study.csv")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    rows = []
    for alpha in args.alphas:
        for seed in args.seeds:
            cfg = apply_overrides(load_config(args.config), args.overrides)
            row = run_one(cfg, alpha, seed, args.num_samples, device)
            rows.append(row)
            print(f"alpha={alpha} seed={seed}: ess_flow={row['eval_ess_flow']:.4f} "
                  f"ess_ais={row['eval_ess_ais']:.4f}")
            _write_rows(args.out, rows)
    print(f"wrote {args.out}")
    return rows


def _write_rows(path, rows):
    cols = sorted({k for r in rows for k in r})
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=cols, restval="")
        writer.writeheader()
        writer.writerows(rows)


if __name__ == "__main__":
    main()
