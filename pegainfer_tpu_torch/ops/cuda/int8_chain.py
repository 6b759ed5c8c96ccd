"""Fused int8 routed-expert chain for decode: kernel K8
(``csrc/int8_chain.cu``), with its gate ``int8_chain_supported``.

Replaces the TPU kernel ``pegainfer_tpu/ops/pallas/fp4_gemm.py::
moe_int8_chain``. One launch per layer computes, for every routed row m with
expert e = idx[m]: g = (x·w1[e]ᵀ)·s1[e], u = (x·w3[e]ᵀ)·s3[e], both clamped
by ``limit`` (skipped when it is <= 0), act = bf16(silu(g)·u) and
y = (act·w2[e]ᵀ)·s2[e], f32 [M, D].

The wrapper dispatches on the device of ``x``: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises, also for a shape
outside ``int8_chain_supported``. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
from pegainfer_tpu_torch.ops.moe import CHAIN_KERNEL_TILE, CHAIN_MAX_ROWS, swiglu

launches = 0


def int8_chain_supported(w1, w2, M: int, in_tile: int = 256, out_tile: int = 256) -> bool:
    """The JAX package's shape gate for the fused chain
    (``fp4_gemm.py::int8_chain_supported``): int8 stacks with aligned tiles
    and a decode-sized M <= 16."""
    if w1["q"].dtype != torch.int8 or w2["q"].dtype != torch.int8:
        return False
    I, D = w1["q"].shape[-2:]
    D2, I2 = w2["q"].shape[-2:]
    if (D, I) != (D2, I2):
        return False
    return (M <= CHAIN_MAX_ROWS and I % min(in_tile, I) == 0 and D % 128 == 0
            and D % min(out_tile, D) == 0 and I % 128 == 0)


def moe_int8_chain_plain(x, w1, w3, w2, s1, s3, s2, idx, limit: float):
    """The kernel's function in plain PyTorch: three K6 plain products with
    the gathered scales and the f32 SwiGLU between them."""
    e = idx.long()
    g = k6.moe_int8_gemv_plain(x, w1, idx) * s1[e].float()
    u = k6.moe_int8_gemv_plain(x, w3, idx) * s3[e].float()
    return k6.moe_int8_gemv_plain(swiglu(g, u, limit), w2, idx) * s2[e].float()


def moe_int8_chain(x, w1, w3, w2, s1, s3, s2, idx, limit: float):
    if x.device.type == "cpu":
        return moe_int8_chain_plain(x, w1, w3, w2, s1, s3, s2, idx, limit)
    if x.device.type != "cuda":
        raise ValueError(f"moe_int8_chain: no kernel for device {x.device}")
    return _launch(x, w1, w3, w2, s1, s3, s2, idx, limit)


def _launch(x, w1, w3, w2, s1, s3, s2, idx, limit):
    global launches
    if x.dim() != 2 or w1.dim() != 3 or w3.shape != w1.shape or w2.dim() != 3:
        raise ValueError("moe_int8_chain takes x [M, D], w1 / w3 [E, I, D], w2 [E, D, I]")
    M, D = x.shape
    E, I, D1 = w1.shape
    if D1 != D or w2.shape != (E, D, I) or idx.shape != (M,):
        raise ValueError(f"x {tuple(x.shape)} / w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} "
                         f"/ idx {tuple(idx.shape)} do not fit")
    if s1.shape != (E, I) or s3.shape != (E, I) or s2.shape != (E, D):
        raise ValueError(f"scales s1 {tuple(s1.shape)} / s3 {tuple(s3.shape)} / s2 "
                         f"{tuple(s2.shape)} do not fit [E, I] / [E, D]")
    if not int8_chain_supported({"q": w1}, {"q": w2}, M, CHAIN_KERNEL_TILE, CHAIN_KERNEL_TILE):
        raise ValueError(f"moe_int8_chain kernel: M={M}, I={I}, D={D} is outside "
                         "int8_chain_supported")
    if (any(t.dtype != torch.float32 for t in (s1, s3, s2)) or idx.dtype != torch.int32):
        raise ValueError("moe_int8_chain kernel takes f32 scales and int32 idx")
    xb = x.to(torch.bfloat16).contiguous()
    for t in (xb, w1, w3, w2, s1, s3, s2, idx):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("moe_int8_chain inputs must be contiguous, on one device")
    if any(t.data_ptr() % 16 for t in (xb, w1, w3, w2)):
        raise ValueError("moe_int8_chain needs 16-byte aligned x and weights")
    act = torch.empty((M, I), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((M, D), dtype=torch.float32, device=x.device)
    if M == 0:
        return y
    lib = build.load("int8_chain")
    err = lib.int8_chain(xb.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
                         s1.data_ptr(), s3.data_ptr(), s2.data_ptr(), idx.data_ptr(),
                         act.data_ptr(), y.data_ptr(), M, E, I, D, float(limit),
                         torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("int8_chain", err)
    launches += 1
    return y
