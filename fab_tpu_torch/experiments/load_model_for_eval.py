"""Rebuild a model from its config and load a checkpoint's flow for evaluation
(``experiments/load_model_for_eval.py`` of the repository).

A checkpoint is a ``state.pkl`` file, or a run directory, where the latest
``iter_<n>`` under ``model_checkpoints/`` (or under the directory itself) is taken.
Both packages write the same layout (``checkpoint.py``), so a checkpoint of either
loads here.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from fab_tpu_torch.checkpoint import latest_checkpoint, load_checkpoint
from fab_tpu_torch.convert import from_jax_params
from fab_tpu_torch.experiments.setup_run import setup_model
from fab_tpu_torch.model import FABModel


def resolve_checkpoint(path: str) -> str:
    """``path`` itself if it is a file, else the latest checkpoint under it."""
    if not os.path.isdir(path):
        return path
    resolved = latest_checkpoint(os.path.join(path, "model_checkpoints")) or latest_checkpoint(path)
    if resolved is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    return resolved


def load_flow(flow, path: str, device) -> Dict:
    """Load the flow parameters of the checkpoint at ``path`` (a file or a run
    directory) into ``flow``; returns the checkpoint's params."""
    params = load_checkpoint(resolve_checkpoint(path))["params"]
    flow.load_state_dict(from_jax_params(params["flow"], device))
    return params


def load_model(cfg, target, checkpoint_path: str, dtype=torch.float32,
               device="cuda") -> Tuple[FABModel, Dict[str, torch.Tensor]]:
    """(model, transition state): the config's model in ``dtype`` on ``device``,
    with the checkpoint's flow parameters and transition state."""
    model = setup_model(cfg, target, dtype, device)
    params = load_flow(model.flow, checkpoint_path, device)
    transition = {k: torch.tensor(np.asarray(v), device=device)
                  for k, v in params["transition"].items()}
    return model, transition
