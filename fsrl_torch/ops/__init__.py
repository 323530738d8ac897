"""Numerical ops and the hand-written CUDA kernels."""
