"""fab_tpu_torch: the PyTorch / CUDA port of fab_tpu for NVIDIA Hopper.

Module names mirror ``fab_tpu``. The package imports ``torch`` and never JAX or
``fab_tpu``. Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
