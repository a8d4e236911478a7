"""Kernels: hand-written CUDA for Hopper (``csrc/``), their wrappers, and
their plain PyTorch versions (``ref``)."""
