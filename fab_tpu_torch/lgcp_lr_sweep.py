"""LGCP-1600 FAB + buffer training health against the learning rate, on one card.

    python3 -m fab_tpu_torch.lgcp_lr_sweep [--lrs 1e-4 3e-5 1e-5] [--seeds 1 2]
        [--steps 5] [--plain]

For each (lr, seed): the flow and trainer at experiments/configs/lgcp.yaml's
settings with flow.fused_coupling=true (f32; with --plain, the plain couplings
instead of K2), init_state, then a few train steps.
Each step prints the AIS batch's valid rows (n_valid) and the rows masked by the
|log_w| < 1e10 bound, the logged replay loss and gradient norm, and, for 512 fresh
flow samples after the step, max |x| and the range of log p.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

from fab_tpu_torch.buffer import PrioritisedReplayBuffer
from fab_tpu_torch.flows import make_realnvp
from fab_tpu_torch.model import FABModel
from fab_tpu_torch.sampling import HamiltonianMonteCarlo
from fab_tpu_torch.targets import LogGaussianCoxProcess
from fab_tpu_torch.train import PrioritisedBufferTrainer, make_optimizer


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--lrs", type=float, nargs="+", default=[1e-4, 3e-5, 1e-5])
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--plain", action="store_true", help="plain couplings, not K2")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    device = torch.device("cuda")
    target = LogGaussianCoxProcess(grid_size=40, device=device)
    for lr in args.lrs:
        for seed in args.seeds:
            gen = torch.Generator(device=device).manual_seed(seed)
            flow = make_realnvp(1600, 8, 2, scale_cap=5.0, fused_coupling=not args.plain,
                                generator=gen, device=device)
            model = FABModel.create(
                flow, target,
                transition_operator=HamiltonianMonteCarlo(
                    n_ais_intermediate_distributions=8, n_leapfrog=5, epsilon=0.2
                ),
                n_intermediate_distributions=8,
            )
            trainer = PrioritisedBufferTrainer(
                model, make_optimizer(lr, 100.0),
                PrioritisedReplayBuffer(dim=1600, max_length=65536, min_sample_length=4096),
                n_batches_buffer_sampling=4, w_adjust_max_clip=10.0, device=device,
            )
            state = trainer.init_state(gen, batch_size=512)
            route = "plain couplings" if args.plain else "K2"
            print(f"[{card}] lr {lr:g}, seed {seed}, {route}")
            for _ in range(args.steps):
                t0 = time.time()
                state, info = trainer.train_step(state, gen, 512)
                torch.cuda.synchronize()
                step_ms = (time.time() - t0) * 1e3
                with torch.no_grad():
                    x, _ = flow.sample_and_log_prob(512, gen)
                    log_p = target.log_prob(x)
                print(f"  step {state.step}: {step_ms:.0f} ms, n_valid {int(info['n_valid'])}, "
                      f"bound-masked {int(info['n_logw_bound_masked'])}, replay loss "
                      f"{float(info['loss']):.4g}, grad norm {float(info['grad_norm']):.4g}; "
                      f"fresh flow samples: max|x| {float(x.abs().max()):.3g}, log p in "
                      f"[{float(log_p.min()):.4g}, {float(log_p.max()):.4g}]")


if __name__ == "__main__":
    main()
