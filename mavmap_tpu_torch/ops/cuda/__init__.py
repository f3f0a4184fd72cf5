"""Hand-written CUDA kernels (csrc/*.cu) and their PyTorch wrappers.

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version beside it for CPU tensors; a CUDA tensor never falls back.
"""
