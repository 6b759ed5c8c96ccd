"""Compute ops: plain PyTorch versions plus the hand-written CUDA kernels
in ``ops.cuda`` that replace the JAX package's Pallas kernels."""
