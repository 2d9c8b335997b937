"""Hand-written CUDA kernels (``csrc/``), their builds and PyTorch wrappers.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors; the kernels build at first use
(``_build.py``).
"""
