"""GMM-40 method study, the third round's methods
(``experiments/run_gmm_method_study_r3.sh``): target_kld (the target's forward KL),
rsb (the resampled base, reverse KL) and snf (the SNF flow, reverse KL), at
gmm.yaml's budget, f64, one cell per "method seed" argument.

    python3 -m fab_tpu_torch.experiments.run_gmm_method_study_r3 [--device cpu]
        [--dry-run] "target_kld 0" ["rsb 1" ...] [key=value ...]

Each cell runs ``python3 -m fab_tpu_torch.experiments.run_gmm`` (see ``study.py``)
into ``results/torch/gmm_study/<method>/seed<seed>/`` and is skipped when a
checkpoint is already there. An unknown method is reported and skipped, as in the
script.
"""
from __future__ import annotations

from fab_tpu_torch.experiments import study

# run_gmm_method_study_r3.sh:20-25.
EXTRA = {
    "target_kld": ("fab.loss_type=target_forward_kl",),
    "rsb": ("fab.loss_type=flow_reverse_kl", "flow.resampled_base=true"),
    "snf": ("fab.loss_type=flow_reverse_kl", "flow.use_snf=true"),
}


def cells(args) -> list:
    out = []
    for job in args.positional:
        method, seed = job.split()
        if method not in EXTRA:
            print(f"unknown method {method}")
            continue
        out.append(study.Cell(
            name=f"{method}_s{seed}", runner="run_gmm", config="gmm.yaml",
            overrides=(*EXTRA[method], f"training.seed={seed}", "evaluation.n_plots=0",
                       "evaluation.n_eval=2", "evaluation.n_checkpoints=1"),
            save_path=f"gmm_study/{method}/seed{seed}", log=f"gmm_r3_{method}_s{seed}"))
    return out


def main(argv=None):
    args = study.parse(study.parser(__doc__.splitlines()[0]), argv)
    results = study.run_cells(cells(args), args, "gmm-r3")
    if not args.dry_run:
        print(f"lane complete: {' '.join(args.positional)}")
    return results


if __name__ == "__main__":
    main()
