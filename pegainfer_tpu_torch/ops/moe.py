"""The DeepSeek-V4 experts' clamped SwiGLU, and the limits that the two fused
routed-expert chains (K8 ``cuda/int8_chain.py``, K9 ``cuda/fp4_chain.py``)
share."""

from __future__ import annotations

import torch

CHAIN_MAX_ROWS = 16  # kMaxRows of csrc/int8_chain.cu and csrc/fp4_chain.cu
# The chain kernels walk I and D one channel a warp, so any multiple of 128
# fits them: their wrappers hold a shape to the JAX gate at 128-wide tiles,
# while the model routes by the gate's 256-wide defaults, as the JAX package
# does (a shape the model sends to a chain always fits its kernel).
CHAIN_KERNEL_TILE = 128


def swiglu(gate, up, limit: float):
    """silu(gate) * up in f32, gate clamped from above and up on both sides
    by ``limit`` when it is > 0 (the JAX package's ``_moe`` swiglu)."""
    if limit > 0:
        gate = torch.clamp(gate, max=limit)
        up = torch.clamp(up, -limit, limit)
    return torch.sigmoid(gate) * gate * up
