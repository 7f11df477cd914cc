"""Matrix-product precision cells on ManyWell-32 (``experiments/run_matmul_cells.sh``):
seeds 1 and 2 x ``training.matmul_precision`` in {high, highest}, 3000 iterations,
f32 (4 cells).

    python3 -m fab_tpu_torch.experiments.run_matmul_cells [--device cpu] [--dry-run]
        [--only NAME] [key=value ...]

On this card the precisions mean what ``setup_run.setup_precision`` sets:
``highest`` computes f32 products in full f32, and ``high`` lets them run as TF32 on
the tensor cores (inputs rounded to a 10-bit mantissa, f32 sums). They are not the
TPU's bf16 passes the script compared, so these cells measure TF32 against f32.

Each cell runs ``python3 -m fab_tpu_torch.experiments.run_many_well`` (see
``study.py``) into ``results/torch/mw_matmul/<precision>_s<seed>/``, skipped when a
``*metrics*`` file or a ``logging_hist.csv`` is directly there (the script's guard);
the run's last three log lines are printed after it.
"""
from __future__ import annotations

from fab_tpu_torch.experiments import study

GUARD = ("*metrics*", "logging_hist.csv")


def cells(args) -> list:
    del args
    return [study.Cell(
        name=f"{prec}_s{seed}", runner="run_many_well", config="many_well.yaml",
        overrides=(f"training.seed={seed}", "training.use_64_bit=false",
                   f"training.matmul_precision={prec}", "training.n_flow_forward_pass=null",
                   "training.n_iterations=3000", "evaluation.n_plots=0",
                   "evaluation.n_eval=2", "evaluation.n_checkpoints=1"),
        save_path=f"mw_matmul/{prec}_s{seed}", log=f"mw_matmul_{prec}_s{seed}")
        for seed in (1, 2) for prec in ("high", "highest")]


def main(argv=None):
    args = study.parse(study.parser(__doc__.splitlines()[0]), argv)
    results = study.run_cells(cells(args), args, "matmul-cell", guard=GUARD, tail=3)
    if not args.dry_run:
        print("matmul cells complete")
    return results


if __name__ == "__main__":
    main()
