"""Conditioner-init A/B on GMM-40 (``experiments/run_init_parity_ab.sh``): the SNF
with he_normal and with torch's nn.Linear init, the resampled base with torch's
init, and FAB with the prioritised buffer at a quarter budget with torch's init;
gmm.yaml, f64, each cell boxed by the trainer's time limit (``training.tlimit``,
hours: 1.0, 1.0, 1.5, 2.5).

    python3 -m fab_tpu_torch.experiments.run_init_parity_ab [--device cpu]
        [--dry-run] [CELL ...] [key=value ...]

Cells: snf_he, snf_torch, rsb_torch, fabbuf_torch (all four by default). Each runs
``python3 -m fab_tpu_torch.experiments.run_gmm`` (see ``study.py``) into
``results/torch/init_ab/<cell>/``, skipped when a checkpoint is there; the run's
last two log lines are printed after it.
"""
from __future__ import annotations

from fab_tpu_torch.experiments import study

DEFAULT = ("snf_he", "snf_torch", "rsb_torch", "fabbuf_torch")
# run_init_parity_ab.sh:39-55: (tlimit in hours, overrides).
CELLS = {
    "snf_he": ("1.0", ("fab.loss_type=flow_reverse_kl", "flow.use_snf=true",
                       "training.log_every=100")),
    "snf_torch": ("1.0", ("fab.loss_type=flow_reverse_kl", "flow.use_snf=true",
                          "flow.init_mode=torch", "training.log_every=100")),
    "rsb_torch": ("1.5", ("fab.loss_type=flow_reverse_kl", "flow.resampled_base=true",
                          "flow.init_mode=torch", "training.log_every=100")),
    "fabbuf_torch": ("2.5", ("fab.loss_type=fab_alpha_div", "training.use_buffer=true",
                             "training.prioritised_buffer=true",
                             "training.n_flow_forward_pass=null",
                             "training.n_iterations=13019", "flow.init_mode=torch")),
}


def cells(args) -> list:
    out = []
    for name in args.positional or DEFAULT:
        if name not in CELLS:
            print(f"unknown cell {name}")
            continue
        tlimit, extra = CELLS[name]
        out.append(study.Cell(
            name=name, runner="run_gmm", config="gmm.yaml",
            overrides=("training.seed=0", f"training.tlimit={tlimit}",
                       "evaluation.eval_batch_size=512", "evaluation.n_plots=0",
                       "evaluation.n_eval=1", "evaluation.n_checkpoints=1", *extra),
            save_path=f"init_ab/{name}", log=f"init_ab_{name}"))
    return out


def main(argv=None):
    args = study.parse(study.parser(__doc__.splitlines()[0]), argv)
    results = study.run_cells(cells(args), args, "init-ab", tail=2)
    if not args.dry_run:
        print("init-parity A/B lane complete")
    return results


if __name__ == "__main__":
    main()
