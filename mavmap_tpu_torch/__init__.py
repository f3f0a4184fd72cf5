"""mavmap_tpu_torch — the sequential mapper in PyTorch, with CUDA kernels.

A port of `mavmap_tpu` (JAX) that keeps its module paths and function
names, so each function's counterpart is found at the same place. Plain
tensor code is PyTorch; the three Pallas kernels of the mapper's main path
(descriptor matching and the two bundle-adjustment segment sums) are CUDA
C++ under `csrc/`, compiled for Hopper (sm_90a) at first use and bound
with ctypes (`ops/cuda/`). Every public entry takes its device explicitly;
nothing picks one automatically, and a CUDA tensor never falls back to a
CPU path.

This package imports neither `jax` nor `mavmap_tpu`.
"""

import torch as _torch

__version__ = "0.1.0"

# Full-precision float32 matrix products and convolutions, like
# mavmap_tpu/__init__.py's "highest" matmul precision: reduced-precision
# products (TF32) drop relative-pose accuracy by orders of magnitude.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
