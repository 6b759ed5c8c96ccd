"""Routed-expert pieces shared by the MoE families: DeepSeek-V4's clamped
SwiGLU, the limits that the two fused routed-expert chains (K8
``cuda/int8_chain.py``, K9 ``cuda/fp4_chain.py``) share, and the grouped
prefill form on plain bf16 expert stacks (DeepSeek-V4's bf16 mode,
DeepSeek-V2-Lite)."""

from __future__ import annotations

import torch

from pegainfer_tpu_torch.ops import quant

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


def bf16_grouped(x, w1, w2, w3, flat_e, flat_t, E: int, limit: float,
                 dtype=torch.bfloat16):
    """Prefill MoE on plain expert stacks (the JAX package's
    ``ragged_dot_general`` on bf16 weights): rows sorted by expert, each
    expert's run of rows times its weight in ``dtype`` with f32 sums, the
    activation rounded to ``dtype`` before w2. w1 / w3 [E, I, D], w2 [E, D,
    I]; ``limit`` 0 is the plain SwiGLU. DeepSeek-V4 rounds to bf16;
    DeepSeek-V2-Lite passes its activations' dtype, which the JAX form
    keeps. Rows of id E (a model-parallel rank's rows of another rank's
    experts, which sort last) are left unwritten. Returns the [M, D] f32 rows
    in (token, k) order. The run lengths are read on the host (prefill runs
    eagerly)."""
    order = torch.argsort(flat_e, stable=True)
    xs = x.to(dtype)[flat_t[order]]
    counts = torch.bincount(flat_e, minlength=E)[:E].tolist()

    def grouped(rows, w):
        y = torch.empty((rows.shape[0], w.shape[1]), dtype=torch.float32, device=rows.device)
        start = 0
        for e, n in enumerate(counts):
            if n:
                y[start:start + n] = quant.mm_f32(rows[start:start + n], w[e])
                start += n
        return y

    act = swiglu(grouped(xs, w1), grouped(xs, w3), limit)  # [M, I] f32
    per = torch.empty((xs.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    per[order] = grouped(act.to(dtype), w2)
    return per
