"""spectral-tpu on PyTorch: the Chebyshev spectral-collocation Poisson path
on an NVIDIA GPU, with hand-written CUDA kernels for its two hot transforms.

The package mirrors the layout of ``spectral_tpu`` (``grid.py``, ``ops/``,
``solvers/``, ``models/``, ``utils/``, ``cli/``), so the counterpart of
each JAX module is found by its path.  It imports ``torch`` and never
``jax``.

Precision policy (the analogue of ``Precision.HIGHEST`` everywhere in the
JAX package): float32 matrix products and convolutions run in full IEEE
float32, never TF32.  TF32 keeps about three decimal digits, which would
put a floor on the spectral accuracy the method exists for.  The policy is
set once, here, when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
