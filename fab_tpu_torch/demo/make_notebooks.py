"""Generate this folder's notebooks, ``fab_gmm.ipynb`` and ``fab_many_well.ipynb``
(``demo/make_notebooks.py`` of the repository, for the port).

    python3 -m fab_tpu_torch.demo.make_notebooks

FAB against reverse KL on the same architecture, with mode coverage, as the
reference's notebooks do, through ``fab_tpu_torch``. The notebooks are generated
artifacts kept in the repository so that their code stays reviewable: run this
again after editing the cells below. It writes only into ``fab_tpu_torch/demo/``.
Each notebook runs on the card (``DEVICE = "cuda"``); set ``DEVICE = "cpu"`` for the
plain PyTorch path on the CPU.
"""
from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def nb(cells):
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python", "version": "3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def md(src):
    return {"cell_type": "markdown", "metadata": {}, "source": src.splitlines(True)}


def code(src):
    return {
        "cell_type": "code",
        "execution_count": None,
        "metadata": {},
        "outputs": [],
        "source": src.strip("\n").splitlines(True),
    }


COMMON_SETUP = """
import os, sys
sys.path.insert(0, os.path.abspath(os.path.join("..", "..")))  # the repository root

import matplotlib.pyplot as plt
import numpy as np
import torch

from fab_tpu_torch.flows import make_realnvp
from fab_tpu_torch.model import FABModel
from fab_tpu_torch.train import PrioritisedBufferTrainer, Trainer, make_optimizer
from fab_tpu_torch.utils.logging import ListLogger
from fab_tpu_torch.utils.plotting import plot_contours, plot_marginal_pair

DEVICE = "cuda"  # "cpu": the plain PyTorch path on the CPU
"""

GMM_CELLS = [
    md(
        "# FAB on a 40-mode Gaussian mixture (PyTorch)\n"
        "\n"
        "The port's counterpart of `demo/fab_gmm.ipynb`: train the same RealNVP "
        "architecture with (a) the FAB α-divergence loss with AIS-bootstrapped "
        "gradients and (b) plain reverse KL, and compare mode coverage. FAB finds "
        "(nearly) all 40 modes; reverse KL mode-collapses.\n"
        "\n"
        "Runs on one CUDA card; with `DEVICE = \"cpu\"` on the CPU in a few minutes."
    ),
    code(COMMON_SETUP + """
from fab_tpu_torch.sampling import Metropolis
from fab_tpu_torch.targets import GMM
"""),
    md("## Target: GMM-40 (seed 0, the reference's mean layout)"),
    code("""
target = GMM(dim=2, n_mixes=40, loc_scaling=40.0, seed=0,
             true_expectation_estimation_n_samples=100_000,
             expectation_generator=torch.Generator(device=DEVICE).manual_seed(0),
             device=DEVICE)

fig, ax = plt.subplots(figsize=(5, 5))
plot_contours(target.log_prob, bounds=(-56, 56), n_contour_levels=50,
              grid_width_n_points=200, ax=ax, device=DEVICE)
ax.set_title("GMM-40 target")
plt.show()
"""),
    md(
        "## Model + training\n"
        "\n"
        "RealNVP (15 coupling layers, 40 hidden units per dimension, the paper's "
        "architecture), a Metropolis transition, one intermediate AIS distribution "
        "(`experiments/configs/gmm.yaml`). `N_ITERATIONS` is a demo budget; the "
        "paper's is 2×10⁷ flow forward passes (`python3 -m "
        "fab_tpu_torch.experiments.run_gmm --config experiments/configs/gmm.yaml`)."
    ),
    code("""
N_ITERATIONS = 2000  # demo scale


def train(loss_type, seed=0):
    generator = torch.Generator(device=DEVICE).manual_seed(seed)
    flow = make_realnvp(2, n_flow_layers=15, layer_nodes_per_dim=40, act_norm=False,
                        generator=generator, device=DEVICE)
    op = Metropolis(n_ais_intermediate_distributions=1, n_updates=1,
                    max_step_size=5.0, min_step_size=5.0)
    model = FABModel.create(flow, target, transition_operator=op,
                            n_intermediate_distributions=1, loss_type=loss_type)
    trainer = Trainer(model, make_optimizer(1e-4, 100.0), logger=ListLogger(),
                      device=DEVICE)
    state = trainer.run(generator, n_iterations=N_ITERATIONS, batch_size=128,
                        save=False, log_every=100)
    return model, state


fab_model, fab_state = train("fab_alpha_div")
kl_model, kl_state = train("flow_reverse_kl")
"""),
    md("## Mode coverage: FAB vs reverse KL"),
    code("""
def mode_coverage(x, radius=3.0):
    x = x.cpu().numpy()
    x = x[np.all(np.isfinite(x), axis=-1)]
    d = np.linalg.norm(x[:, None, :] - target.locs.cpu().numpy()[None], axis=-1)
    return int(np.sum(d.min(axis=0) < radius))


fig, axs = plt.subplots(1, 2, figsize=(11, 5))
for ax, (name, model) in zip(axs, [("FAB", fab_model), ("reverse KL", kl_model)]):
    with torch.no_grad():
        x = model.flow.sample(2000, torch.Generator(device=DEVICE).manual_seed(1))
    plot_contours(target.log_prob, bounds=(-56, 56), n_contour_levels=50,
                  grid_width_n_points=200, ax=ax, device=DEVICE)
    plot_marginal_pair(x, ax=ax, bounds=(-56, 56), alpha=0.3)
    ax.set_title(f"{name}: {mode_coverage(x)}/40 modes")
plt.tight_layout()
plt.show()
"""),
    md(
        "## Evaluation metrics\n"
        "\n"
        "The reference's metrics: flow and AIS effective sample size with the AIS "
        "target set to p, test-set mean log q, forward KL, and the importance-weighted "
        "quadratic-expectation bias."
    ),
    code("""
info = fab_model.get_eval_info(fab_state.transition_state,
                               torch.Generator(device=DEVICE).manual_seed(2),
                               outer_batch_size=2048, inner_batch_size=512)
{k: float(v) for k, v in info.items() if torch.as_tensor(v).ndim == 0}
"""),
]

MW_CELLS = [
    md(
        "# FAB on the Many Well problem (PyTorch)\n"
        "\n"
        "The port's counterpart of `demo/fab_many_well.ipynb`: the 32-dimensional "
        "Many Well target is a product of 16 independent 2-D double wells, 2¹⁶ = "
        "65,536 modes. FAB with the prioritised replay buffer (the paper's flagship "
        "configuration) covers the modes where reverse KL collapses.\n"
        "\n"
        "This demo uses the 6-D problem (8 modes); the 32-D flagship is `python3 -m "
        "fab_tpu_torch.experiments.run_many_well --config "
        "experiments/configs/many_well.yaml`, and its step is timed by `python3 -m "
        "fab_tpu_torch.bench`."
    ),
    code(COMMON_SETUP + """
from fab_tpu_torch.buffer import PrioritisedReplayBuffer
from fab_tpu_torch.sampling import HamiltonianMonteCarlo
from fab_tpu_torch.targets import ManyWellEnergy
"""),
    md("## Target: ManyWell-6 (3 independent double wells, 8 modes)"),
    code("""
DIM = 6
target = ManyWellEnergy(dim=DIM, device=DEVICE)

fig, ax = plt.subplots(figsize=(5, 5))
plot_contours(target.log_prob_2d, bounds=(-3, 3), n_contour_levels=40,
              grid_width_n_points=100, ax=ax, device=DEVICE)
ax.set_title("one double well's 2-D density")
plt.show()
"""),
    md(
        "## FAB + prioritised buffer vs reverse KL\n"
        "\n"
        "The fast config (`experiments/configs/many_well_fast.yaml`): batch 128, 4 "
        "intermediate distributions, HMC with 5 leapfrog steps, a prioritised buffer "
        "with 8 replay gradient steps per AIS pass."
    ),
    code("""
N_ITERATIONS = 500


def make_model(loss_type, seed=0):
    flow = make_realnvp(DIM, n_flow_layers=10, layer_nodes_per_dim=10, act_norm=False,
                        generator=torch.Generator(device=DEVICE).manual_seed(seed),
                        device=DEVICE)
    op = HamiltonianMonteCarlo(n_ais_intermediate_distributions=4, n_outer=1,
                               n_leapfrog=5, epsilon=1.0)
    return FABModel.create(flow, target, transition_operator=op,
                           n_intermediate_distributions=4, loss_type=loss_type)


fab_model = make_model("fab_alpha_div")
buffer = PrioritisedReplayBuffer(dim=DIM, max_length=6400, min_sample_length=640)
fab_trainer = PrioritisedBufferTrainer(
    fab_model, make_optimizer(1e-4, 100.0), buffer, n_batches_buffer_sampling=8,
    w_adjust_max_clip=10.0, logger=ListLogger(), device=DEVICE)
fab_state = fab_trainer.run(torch.Generator(device=DEVICE).manual_seed(0),
                            n_iterations=N_ITERATIONS, batch_size=128, save=False,
                            log_every=100)

kl_model = make_model("flow_reverse_kl")
kl_trainer = Trainer(kl_model, make_optimizer(1e-4, 100.0), logger=ListLogger(),
                     device=DEVICE)
kl_state = kl_trainer.run(torch.Generator(device=DEVICE).manual_seed(0),
                          n_iterations=N_ITERATIONS, batch_size=128, save=False,
                          log_every=100)
"""),
    md("## Marginal pairs: every 2-D well, FAB vs reverse KL"),
    code("""
fig, axs = plt.subplots(2, DIM // 2, figsize=(3 * (DIM // 2), 6))
for row, (name, model) in enumerate([("FAB + buffer", fab_model), ("reverse KL", kl_model)]):
    with torch.no_grad():
        x = model.flow.sample(1000, torch.Generator(device=DEVICE).manual_seed(row + 1))
    for i in range(DIM // 2):
        ax = axs[row, i]
        plot_contours(target.log_prob_2d, bounds=(-3, 3), n_contour_levels=40,
                      grid_width_n_points=100, ax=ax, device=DEVICE)
        plot_marginal_pair(x, ax=ax, bounds=(-3, 3), marginal_dims=(2 * i, 2 * i + 1),
                           alpha=0.3)
        if i == 0:
            ax.set_ylabel(name)
plt.tight_layout()
plt.show()
"""),
    md(
        "## Quantitative evaluation\n"
        "\n"
        "ESS, the log Z error against the analytic log Z, test-set log-likelihoods on "
        "exact samples and on the 2^(d/2) mode grid, forward KL: the reference's "
        "headline Many Well metrics."
    ),
    code("""
for name, model, state in [("FAB + buffer", fab_model, fab_state),
                           ("reverse KL", kl_model, kl_state)]:
    info = model.get_eval_info(state.transition_state,
                               torch.Generator(device=DEVICE).manual_seed(3),
                               outer_batch_size=2048, inner_batch_size=512)
    print(name, {k: round(float(v), 4) for k, v in info.items()
                 if torch.as_tensor(v).ndim == 0})
"""),
]

NOTEBOOKS = {"fab_gmm.ipynb": GMM_CELLS, "fab_many_well.ipynb": MW_CELLS}


def main(out_dir: str = HERE) -> list:
    paths = []
    for fname, cells in NOTEBOOKS.items():
        path = os.path.join(out_dir, fname)
        with open(path, "w") as f:
            json.dump(nb(cells), f, indent=1, ensure_ascii=False)
            f.write("\n")
        print("wrote", path)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
