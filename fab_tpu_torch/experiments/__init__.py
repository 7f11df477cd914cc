"""The port's experiment runners: a YAML config and dotted overrides in, a trained
and evaluated flow out (``experiments/`` of the repository, for ``fab_tpu``).

    python3 -m fab_tpu_torch.experiments.run_gmm --config experiments/configs/gmm.yaml \
        [--device cpu] [training.n_iterations=20 training.n_flow_forward_pass=null ...]
"""
