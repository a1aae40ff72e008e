"""open3d_slam_torch — the PyTorch/CUDA port of ``open3d_slam_tpu``.

A second package with the JAX package's layout (``utils/``, ``ops/``,
``models/``, ``io/``, ``cli/``).  Plain tensor code is PyTorch; the kernels
that the JAX package wrote in Pallas are hand-written CUDA C++ for Hopper
(``csrc/``), each with a plain PyTorch version beside it that runs on CPU
tensors.  The port imports nothing of the JAX package.

Entry points (``models.slam_wrapper.SlamWrapper``, ``cli.mapping``) run on
``cuda`` unless the caller asks for ``cpu``.
"""

__version__ = "0.1.0"

import torch as _torch

# Full-f32 matmuls everywhere, the counterpart of the JAX package's
# "highest" default precision: rotating points with reduced-precision
# (TF32) matrices moves coordinates by ~1e-2 m at |p|~30 m, which makes the
# Gauss-Newton registration loops dither around the optimum.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
