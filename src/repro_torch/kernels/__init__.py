"""Kernels of the serving path: CUDA sources in ``csrc/``, ctypes wrappers
with launch counters, and their plain PyTorch versions (``ref``)."""
