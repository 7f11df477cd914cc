"""The port's experiment runners: a YAML config and dotted overrides in, a trained
and evaluated flow out (``experiments/`` of the repository, for ``fab_tpu``).

    python3 -m fab_tpu_torch.experiments.run_gmm --config experiments/configs/gmm.yaml \
        [--device cpu] [training.n_iterations=20 training.n_flow_forward_pass=null ...]

The ``experiments/*.sh`` studies are modules of the same stem here
(``run_gmm_method_study``, ``eval_lgcp_trajectory``, ...; their shared part is
``study.py``).
"""
