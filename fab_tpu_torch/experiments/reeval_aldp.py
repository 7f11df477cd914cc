"""Re-evaluate a trained ALDP run against the L-form rows of its test set
(``experiments/reeval_aldp.py`` of the repository).

    python3 -m fab_tpu_torch.experiments.reeval_aldp --config experiments/configs/aldp.yaml \
        --run <save_root> [--n-samples 10000] [--batch 1000] [--out-dir <dir>] \
        [--device cpu] [overrides ...]

A long HMC run can hop between the two mirror-image chirality basins, so a stored
test set may hold D-form rows, against which every single-chirality flow scores a
saturated phi and Ramachandran KLD. This recomputes the metric suite on
``n_samples`` flow samples with the D-form test rows dropped (refusing a set with
at most 10 % L-form rows), into ``<out-dir>/metrics/metrics.csv`` and, with
matplotlib, ``<out-dir>/plots/`` (default ``<run>/reeval_L_only``). Pass the run's
``data.transform`` so that the transform is the run's.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from fab_tpu_torch.experiments.run_aldp import sample_flow
from fab_tpu_torch.experiments.sample_aldp import load_aldp_run
from fab_tpu_torch.utils.aldp_eval import chirality_scale_shift, evaluate_aldp, filter_chirality
from fab_tpu_torch.utils.plotting import when_plots_available


def main(argv=None):
    args, _, model, target, ckpt, _ = load_aldp_run(argv, [
        ("--n-samples", dict(type=int, default=10_000)),
        ("--batch", dict(type=int, default=1000)),
        ("--out-dir", dict(default=None)),
    ])
    it = int(os.path.basename(os.path.dirname(ckpt)).split("_")[-1])
    z_test = np.load(os.path.join(args.run, "test_set.npy"))
    keep = filter_chirality(z_test, *chirality_scale_shift(target.transform))
    print(f"test set: {len(z_test)} rows, frac_L_form={keep.mean():.4f} -> keeping "
          f"{int(keep.sum())} L-form rows")
    if keep.mean() <= 0.1:
        raise RuntimeError(
            f"only {keep.mean():.1%} of the stored test set is L-form; an L-only "
            "re-evaluation on this set would be degenerate. Regenerate the test set "
            "(run_aldp)."
        )
    generator = torch.Generator(device=target.device).manual_seed(0)
    z_sample = sample_flow(model.flow, generator, args.n_samples, args.batch)
    out_dir = args.out_dir or os.path.join(args.run, "reeval_L_only")
    metrics = evaluate_aldp(
        target, z_sample, z_test[keep], iteration=it,
        metric_dir=os.path.join(out_dir, "metrics"),
        plot_dir=when_plots_available(lambda: os.path.join(out_dir, "plots")),
    )
    print({k: round(float(v), 5) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()
