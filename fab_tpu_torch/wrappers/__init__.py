"""Wrappers: external distributions and modules adapted to the port's flow surface
(``fab_tpu/wrappers/``).

The surface is the one ``FABModel`` and the trainers use (``flows/base.py``):
``sample_and_log_prob(n, generator)`` (``n`` the global batch; under a data mesh this
rank's rows come back), ``log_prob(x)``, ``dim``, ``reset_parameters(generator)``.

``fab_tpu``'s four wrappers map onto two:

- ``WrappedTorchDist`` (``wrappers/torch_dist.py``) is ``fab_tpu``'s
  ``WrappedTorchDist`` without its host callback: a ``torch.distributions``
  object runs natively, on its own device. It also takes ``WrappedJaxDist``'s
  place: ``wrap(dist)`` for a distribution object, ``from_callables(sample_fn,
  log_prob_fn, dim)`` for a pair of callables. No trainable parameters.
- ``WrappedModuleFlow`` (``wrappers/module.py``) is the one seam for
  ``WrappedFlaxFlow`` and ``WrappedHaikuFlow``: an external ``nn.Module`` with
  ``sample_and_log_prob(generator, n)`` and ``log_prob(x)``, whose parameters train
  through the port's trainers.

The reference's flowtorch wrapper has no counterpart in ``fab_tpu`` either.
"""
from fab_tpu_torch.wrappers.module import WrappedModuleFlow
from fab_tpu_torch.wrappers.torch_dist import WrappedTorchDist

__all__ = ["WrappedModuleFlow", "WrappedTorchDist"]
