"""Kernel dispatch, plain PyTorch versions and the hand-written CUDA kernels."""
