"""ManyWell-32 method study (``experiments/run_mw_method_study.sh``): FAB with and
without the buffer, the flow by reverse KL and by the alpha = 2 divergence with NIS,
each for seeds 0-2 (12 cells), at a shared budget of flow forward passes (the first
argument, 225,000,000 by default: 1/44 of the paper's 1e10), f32, each boxed by the
trainer's time limit (``training.tlimit=0.66`` hours).

    python3 -m fab_tpu_torch.experiments.run_mw_method_study [--device cpu]
        [--dry-run] [--only NAME] [BUDGET] [key=value ...]

Each cell runs ``python3 -m fab_tpu_torch.experiments.run_many_well`` (see
``study.py``) into ``results/torch/mw_study/<method>/seed<seed>/``, skipped when a
checkpoint is there. A run that outlives the 4800 s backstop (twice the time limit)
is killed, counted as rc 124, and a FAILURE line goes to
``results/torch/mw_study/FAILED``.
"""
from __future__ import annotations

import os

from fab_tpu_torch.experiments import study

BUDGET = 225_000_000
BACKSTOP_S = 4800
NO_BUFFER = ("training.use_buffer=false", "training.prioritised_buffer=false")
# run_mw_method_study.sh:46-53.
METHODS = {
    "fab_buffer": (),
    "fab_no_buffer": NO_BUFFER,
    "flow_reverse_kl": ("fab.loss_type=flow_reverse_kl", *NO_BUFFER, "training.log_every=100"),
    "flow_alpha_2_div_nis": ("fab.loss_type=flow_alpha_2_div_nis", *NO_BUFFER,
                             "training.log_every=100"),
}


def cells(args) -> list:
    budget = int(args.positional[0]) if args.positional else BUDGET
    return [study.Cell(
        name=f"{method}_s{seed}", runner="run_many_well", config="many_well.yaml",
        overrides=(f"training.seed={seed}", "training.use_64_bit=false",
                   "training.tlimit=0.66", "training.n_iterations=null",
                   f"training.n_flow_forward_pass={budget}", "evaluation.n_plots=0",
                   "evaluation.n_eval=1", "evaluation.n_checkpoints=1", *extra),
        save_path=f"mw_study/{method}/seed{seed}", log=f"mw_study_{method}_s{seed}")
        for seed in (0, 1, 2) for method, extra in METHODS.items()]


def main(argv=None):
    args = study.parse(study.parser(__doc__.splitlines()[0]), argv)
    if not args.dry_run:
        os.makedirs(os.path.join(args.root, "mw_study"), exist_ok=True)
    results = study.run_cells(cells(args), args, "mw-study", timeout_s=BACKSTOP_S,
                              failed_file=os.path.join("mw_study", "FAILED"))
    if not args.dry_run:
        print("mw method study complete")
    return results


if __name__ == "__main__":
    main()
