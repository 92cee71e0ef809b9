"""PyTorch + CUDA port of the stereo direct-SLAM engine.

Mirrors the JAX package `stereo_dso_g2o_tpu` module by module (same
sub-packages and module names), so every module's counterpart is found by
path. State is dataclasses of tensors, functions are plain functions on
tensors, and random draws use explicit `torch.Generator`s. Entry points
take `device=None`, which means the GPU (`default_device()`); the CPU is
asked for by name, `device="cpu"`, as the tests do. The two hand-written
kernels (the epipolar search, `ops/trace_cuda.py` + `csrc/*.cu`) are built
at first use; on CPU tensors their plain PyTorch versions run instead.

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



def default_device(device=None) -> "_torch.device":
    """The device an entry point runs on: `device` when given, else the
    GPU. Without a GPU this raises: the CPU is never taken quietly."""
    if device is not None:
        return _torch.device(device)
    if _torch.cuda.is_available():
        return _torch.device("cuda")
    raise RuntimeError(
        "no CUDA device: this package's entry points run on the GPU by default; "
        'pass device="cpu" to run on the CPU'
    )


from stereo_dso_g2o_tpu_torch.config import Settings, default_settings  # noqa: E402,F401
