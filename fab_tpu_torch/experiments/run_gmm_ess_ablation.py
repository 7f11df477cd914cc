"""GMM-40 ESS ablation (``experiments/run_gmm_ess_ablation.sh``): FAB with the
prioritised buffer at a quarter of the paper's budget (13,019 iterations, f64), one
knob changed per variant, one eval of 512 samples at the end.

    python3 -m fab_tpu_torch.experiments.run_gmm_ess_ablation [--device cpu]
        [--dry-run] [VARIANT ...] [key=value ...]

Variants: control, w_clip10, lr5e-5, act_norm, scale_cap5 (the default five), and
buf_4x and step1 when named. Each runs ``python3 -m
fab_tpu_torch.experiments.run_gmm`` (see ``study.py``) into
``results/torch/gmm_ablation/<variant>/``, skipped when a checkpoint is there; the
run's last ``eval_ess_flow_p_target`` is printed after it. The script's default,
``"${@:-control w_clip10 lr5e-5 act_norm scale_cap5}"``, expands to one word, so
the script run without arguments reports one unknown variant and runs nothing; its
header and its five-word default mean the five variants, which this module runs.
"""
from __future__ import annotations

from fab_tpu_torch.experiments import study

ITERS = 13019  # a quarter of the 52,076-iteration paper budget
DEFAULT = ("control", "w_clip10", "lr5e-5", "act_norm", "scale_cap5")
# run_gmm_ess_ablation.sh:34-42.
VARIANTS = {
    "control": (),
    "w_clip10": ("training.w_adjust_max_clip=10",),
    "lr5e-5": ("training.lr=5e-5",),
    "act_norm": ("flow.act_norm=true",),
    "scale_cap5": ("flow.scale_cap=5.0",),
    "buf_4x": ("training.maximum_buffer_length=51200", "training.min_buffer_length=5120"),
    "step1": ("fab.transition_operator.init_step_size=1.0",),
}
COMMON = ("fab.loss_type=fab_alpha_div", "training.use_buffer=true",
          "training.prioritised_buffer=true", "training.seed=0",
          "training.n_flow_forward_pass=null", f"training.n_iterations={ITERS}",
          "evaluation.eval_batch_size=512", "evaluation.n_plots=0", "evaluation.n_eval=1",
          "evaluation.n_checkpoints=1")


def cells(args) -> list:
    out = []
    for variant in args.positional or DEFAULT:
        if variant not in VARIANTS:
            print(f"unknown variant {variant}")
            continue
        out.append(study.Cell(
            name=variant, runner="run_gmm", config="gmm.yaml",
            overrides=COMMON + VARIANTS[variant], save_path=f"gmm_ablation/{variant}",
            log=f"gmm_abl_{variant}"))
    return out


def main(argv=None):
    args = study.parse(study.parser(__doc__.splitlines()[0]), argv)
    results = study.run_cells(cells(args), args, "ess-abl",
                              grep=r"eval_ess_flow_p_target[^,]*")
    if not args.dry_run:
        print("ablation lane complete")
    return results


if __name__ == "__main__":
    main()
