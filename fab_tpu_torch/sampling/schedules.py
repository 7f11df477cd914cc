"""AIS inverse-temperature (beta) schedules (``fab_tpu/sampling/schedules.py``).

Static numpy arrays of shape [n_intermediate + 2], beta[0] = 0 (the flow) and
beta[-1] = 1 (the AIS target).
"""
from __future__ import annotations

import numpy as np


def beta_schedule(spacing_type: str, n_intermediate_distributions: int) -> np.ndarray:
    assert n_intermediate_distributions > 0
    n = n_intermediate_distributions
    if spacing_type == "geometric":
        # A quarter of the betas linear in [0, 0.01], the rest geometric in [0.01, 1].
        n_linear = int(n / 4)
        n_geom = n - n_linear - 1
        b = np.concatenate(
            [
                np.linspace(0.0, 0.01, n_linear + 2)[:-1],
                np.geomspace(0.01, 1.0, n_geom + 2),
            ]
        )
    elif spacing_type == "linear":
        b = np.linspace(0.0, 1.0, n + 2)
    else:
        raise ValueError(
            f"distribution spacing incorrectly specified: '{spacing_type}', "
            "options are 'geometric' or 'linear'"
        )
    assert b.shape == (n + 2,)
    return b
