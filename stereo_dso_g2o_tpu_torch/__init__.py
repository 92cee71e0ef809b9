"""PyTorch + CUDA port of the stereo direct-SLAM engine.

Mirrors the JAX package `stereo_dso_g2o_tpu` module by module (same
sub-packages and module names), so every module's counterpart is found by
path. State is dataclasses of tensors, functions are plain functions on
tensors, entry points take an explicit `device`, and random draws use
explicit `torch.Generator`s. The one hand-written kernel (the epipolar
search, `ops/trace_cuda.py` + `csrc/epipolar_search.cu`) is built at first
use; on CPU tensors its plain PyTorch version runs instead.

This package never imports jax.
"""

__version__ = "0.1.0"

import torch as _torch

# The windowed-BA Hessian stitching and the small dense solves need full f32
# matmuls: reduced-precision matmuls took BA from 2.2 mm to 85 mm ATE in the
# JAX package (its __init__ pins "highest" for the same reason). TF32 is
# PyTorch's reduced-precision path on the GPU, so it stays off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from stereo_dso_g2o_tpu_torch.config import Settings, default_settings  # noqa: E402,F401
