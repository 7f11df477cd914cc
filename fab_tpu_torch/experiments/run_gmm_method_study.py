"""GMM-40 method study (``experiments/run_gmm_method_study.sh``): FAB without a
buffer, the flow trained by reverse KL and by the alpha = 2 divergence with NIS,
each for seeds 0-2 (9 cells), at gmm.yaml's budget of 2e7 flow forward passes, f64.

    python3 -m fab_tpu_torch.experiments.run_gmm_method_study [--device cpu]
        [--dry-run] [--only NAME] [key=value ...]

Each cell runs ``python3 -m fab_tpu_torch.experiments.run_gmm`` (see ``study.py``)
into ``results/torch/gmm_study/<method>/seed<seed>/``; the fab_buffer rows come from
another study, as in the script. The script ran its cells in two lanes on a 2-core
CPU host; here they run one after another, in the order the lanes started them. The
script has no skip guard, so neither has this module.
"""
from __future__ import annotations

from fab_tpu_torch.experiments import study

# The script's two lanes (run_gmm_method_study.sh:34-47), interleaved.
LANES = (
    [("fab_no_buffer", 0), ("flow_reverse_kl", 0), ("flow_alpha_2_div_nis", 0),
     ("fab_no_buffer", 2), ("flow_alpha_2_div_nis", 2)],
    [("fab_no_buffer", 1), ("flow_reverse_kl", 1), ("flow_alpha_2_div_nis", 1),
     ("flow_reverse_kl", 2)],
)
ORDER = [job for pair in zip(*LANES) for job in pair] + LANES[0][len(LANES[1]):]


def cell(method: str, seed: int) -> study.Cell:
    """run_gmm_method_study.sh:10-17 and :23-28: fab_no_buffer is fab_alpha_div
    without the buffer, under its own save path."""
    loss, extra = (("fab_alpha_div", ("training.use_buffer=false",))
                   if method == "fab_no_buffer" else (method, ()))
    return study.Cell(
        name=f"{method}_s{seed}", runner="run_gmm", config="gmm.yaml",
        overrides=(f"fab.loss_type={loss}", f"training.seed={seed}", "evaluation.n_plots=0",
                   "evaluation.n_eval=5", "evaluation.n_checkpoints=2", *extra),
        save_path=f"gmm_study/{method}/seed{seed}", log=f"gmm_study_{loss}_s{seed}")


def cells(args) -> list:
    del args
    return [cell(method, seed) for method, seed in ORDER]


def main(argv=None):
    args = study.parse(study.parser(__doc__.splitlines()[0]), argv)
    results = study.run_cells(cells(args), args, "gmm-study", guard=None)
    if not args.dry_run:
        print("method study complete")
    return results


if __name__ == "__main__":
    main()
