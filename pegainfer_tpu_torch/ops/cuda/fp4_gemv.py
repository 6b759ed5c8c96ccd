"""Packed-fp4 MoE expert GEMV for decode: kernel K3 (``csrc/fp4_gemv.cu``).

Replaces the TPU kernel ``pegainfer_tpu/ops/pallas/fp4_gemm.py::
moe_fp4_gemv``. y[m] = x[m] @ dequant(q[idx[m]], s[idx[m]]).T as f32
[M, OUT], for x [M, IN], q [E, OUT, IN/2] packed E2M1 and bf16 group scales
s [E, OUT, IN/g]. Numerics follow the TPU kernel: x rounded to bf16, each
weight bf16(f32(code) x scale), f32 accumulation.

The wrapper dispatches on the device of ``x``: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.ops.cuda import build

launches = 0


def moe_fp4_gemv_plain(x, q, s, idx):
    """The kernel's function in plain PyTorch: gather and decode only the
    routed experts, then a batched f32 product of exact bf16 values."""
    w = quant.gather_dequant({"q": q, "s": s}, idx.long(), torch.bfloat16).float()
    xb = x.to(torch.bfloat16).float()
    return torch.bmm(w, xb[:, :, None])[:, :, 0]


def moe_fp4_gemv(x, q, s, idx):
    if x.device.type == "cpu":
        return moe_fp4_gemv_plain(x, q, s, idx)
    if x.device.type != "cuda":
        raise ValueError(f"moe_fp4_gemv: no kernel for device {x.device}")
    return _launch(x, q, s, idx)


def _launch(x, q, s, idx):
    global launches
    if x.dim() != 2 or q.dim() != 3 or s.dim() != 3:
        raise ValueError("moe_fp4_gemv takes x [M, IN], q [E, OUT, IN/2], s [E, OUT, S]")
    M, IN = x.shape
    E, OUT, IN2 = q.shape
    S = s.shape[2]
    if IN != 2 * IN2 or s.shape[:2] != (E, OUT) or idx.shape != (M,):
        raise ValueError(f"x {tuple(x.shape)} / q {tuple(q.shape)} / s {tuple(s.shape)} "
                         f"/ idx {tuple(idx.shape)} do not fit")
    if IN % 32 or IN % S or (IN // S) % 32:
        raise ValueError(f"moe_fp4_gemv kernel takes IN and its scale group as "
                         f"multiples of 32; got IN={IN}, S={S}")
    if q.dtype != torch.uint8 or s.dtype != torch.bfloat16 or idx.dtype != torch.int32:
        raise ValueError(f"moe_fp4_gemv kernel takes uint8 q, bf16 s, int32 idx; got "
                         f"{q.dtype}, {s.dtype}, {idx.dtype}")
    xb = x.to(torch.bfloat16).contiguous()
    for t in (xb, q, s, idx):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("moe_fp4_gemv inputs must be contiguous, on one device")
    if xb.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("moe_fp4_gemv needs 16-byte aligned x and q")
    y = torch.empty((M, OUT), dtype=torch.float32, device=x.device)
    if M == 0:
        return y
    lib = build.load("fp4_gemv")
    err = lib.fp4_gemv(xb.data_ptr(), q.data_ptr(), s.data_ptr(), idx.data_ptr(),
                       y.data_ptr(), M, E, OUT, IN, S,
                       torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("fp4_gemv", err)
    launches += 1
    return y
