"""Alanine-dipeptide demo: sample a trained flow and draw its Ramachandran map
(``demo/aldp_demo.py`` of the repository).

    python3 -m fab_tpu_torch.demo.aldp_demo --checkpoint <run dir or state.pkl>
        [--n-samples 5000] [--device cpu] [overrides ...]
    python3 -m fab_tpu_torch.demo.aldp_demo --train --iters 300   # self-contained

Loads the flow of a checkpoint written by ``run_aldp`` (either package's) into the
config's model, or with ``--train`` trains a small FAB model first (4 spline blocks
of width 64, 2 intermediate distributions of 2 HMC steps, batch 128, no buffer,
the plain ``Trainer``). Then draws flow samples, prints their mean log q and the
mean finite log p, and with matplotlib plots their phi/psi histogram and dihedral
marginals into ``--out`` (without it, ``plots off: matplotlib is not installed``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments.make_aldp_model import make_aldp_model
from fab_tpu_torch.utils.plotting import PLOTS_OFF, plots_available, pyplot
from fab_tpu_torch.utils.training import apply_overrides, load_config, maybe_enable_x64


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="experiments/configs/aldp.yaml")
    parser.add_argument("--checkpoint", help="run dir or checkpoint file")
    parser.add_argument("--train", action="store_true",
                        help="train a small model instead of loading a checkpoint")
    parser.add_argument("--iters", type=int, default=300)
    parser.add_argument("--n-samples", type=int, default=5000)
    parser.add_argument("--out", default="aldp_demo_ramachandran.png")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    if not args.train and not args.checkpoint:
        parser.error("--checkpoint required unless --train is given")
    device = resolve_device(args.device)

    overrides = list(args.overrides)
    if args.train:
        overrides = [
            "flow.blocks=4", "flow.hidden_units=64", "fab.n_int_dist=2",
            "fab.n_inner=2", f"training.max_iter={args.iters}",
            "training.batch_size=128", "training.replay_buffer=null",
        ] + overrides
    cfg = apply_overrides(load_config(args.config), overrides)
    dtype = maybe_enable_x64(cfg)
    model, target = make_aldp_model(cfg, dtype, device)
    generator = torch.Generator(device=device).manual_seed(0)

    if args.train:
        from fab_tpu_torch.train import Trainer, make_optimizer
        from fab_tpu_torch.utils.logging import ListLogger

        trainer = Trainer(model, make_optimizer(cfg.training.learning_rate, 1000.0),
                          logger=ListLogger(), dtype=dtype, device=device)
        print(f"Training FAB for {cfg.training.max_iter} iterations ...")
        trainer.run(generator, n_iterations=cfg.training.max_iter,
                    batch_size=cfg.training.batch_size, save=False, log_every=50)
    else:
        from fab_tpu_torch.experiments.load_model_for_eval import load_flow

        load_flow(model.flow, args.checkpoint, device)

    print(f"Sampling {args.n_samples} flow points ...")
    with torch.no_grad():
        z = torch.cat([model.flow.sample(min(1000, args.n_samples - i), generator)
                       for i in range(0, args.n_samples, 1000)])
        phi, psi = target.phi_psi(z)
        log_q = model.flow.log_prob(z)
        log_p = target.log_prob(z)
    finite = torch.isfinite(log_p)
    out = {"mean_log_q": float(log_q.mean()),
           "mean_log_p": float(log_p[finite].mean()) if finite.any() else float("nan"),
           "phi": phi.cpu().numpy(), "psi": psi.cpu().numpy()}
    print(f"mean log q = {out['mean_log_q']:.2f}, mean log p = {out['mean_log_p']:.2f}")

    if not plots_available():
        print(PLOTS_OFF)
        return out
    plt = pyplot()
    fig, axs = plt.subplots(1, 2, figsize=(11, 5))
    axs[0].hist2d(out["phi"], out["psi"], bins=64,
                  range=[[-np.pi, np.pi], [-np.pi, np.pi]], cmap="viridis")
    axs[0].set_xlabel(r"$\phi$")
    axs[0].set_ylabel(r"$\psi$")
    axs[0].set_title("flow samples (Ramachandran)")
    axs[1].hist(out["phi"], bins=100, range=(-np.pi, np.pi), density=True, alpha=0.6,
                label=r"$\phi$")
    axs[1].hist(out["psi"], bins=100, range=(-np.pi, np.pi), density=True, alpha=0.6,
                label=r"$\psi$")
    axs[1].legend()
    axs[1].set_title("dihedral marginals")
    plt.tight_layout()
    fig.savefig(args.out, dpi=150)
    plt.close(fig)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
