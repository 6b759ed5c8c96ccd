"""fp8 dense-linear GEMV for decode: kernel K4 (``csrc/fp8_gemv.cu``).

Replaces the TPU kernel ``pegainfer_tpu/ops/pallas/fp4_gemm.py::fp8_gemv``.
y = x @ dequant(q, s).T as f32 [M, OUT], for x [M <= 8, IN], q [OUT, IN]
E4M3 and bf16 block scales s [So, Si]. Numerics follow the TPU kernel: x
rounded to bf16, each weight bf16(f32(code) x scale), f32 accumulation.

The wrapper dispatches on the device of ``x``: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.ops.cuda import build

launches = 0

MAX_ROWS = 8
BLOCKS_PER_SM = 4  # grid cap: each block stages x once, then warps stride rows
WARPS = 8  # rows a block takes per pass (csrc/fp8_gemv.cu kWarps)


def fp8_gemv_plain(x, q, s):
    """The kernel's function in plain PyTorch."""
    w = quant.dequant_any({"q": q, "s": s}, torch.bfloat16).float()
    return x.to(torch.bfloat16).float() @ w.T


def fp8_gemv(x, q, s):
    if x.device.type == "cpu":
        return fp8_gemv_plain(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"fp8_gemv: no kernel for device {x.device}")
    return _launch(x, q, s)


def _launch(x, q, s):
    global launches
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 2:
        raise ValueError("fp8_gemv takes x [M, IN], q [OUT, IN], s [So, Si]")
    M, IN = x.shape
    OUT = q.shape[0]
    So, Si = s.shape
    if q.shape[1] != IN or OUT % So or IN % Si:
        raise ValueError(f"x {tuple(x.shape)} / q {tuple(q.shape)} / s "
                         f"{tuple(s.shape)} do not fit")
    ro, ri = OUT // So, IN // Si
    if not 1 <= M <= MAX_ROWS or IN % 16 or ri % 16:
        raise ValueError(f"fp8_gemv kernel takes 1 <= M <= {MAX_ROWS} and IN, "
                         f"IN/Si multiples of 16; got M={M} IN={IN} ri={ri}")
    if q.dtype != quant.F8 or s.dtype != torch.bfloat16:
        raise ValueError(f"fp8_gemv kernel takes e4m3 q and bf16 s, got {q.dtype}, {s.dtype}")
    xb = x.to(torch.bfloat16).contiguous()
    for t in (xb, q, s):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("fp8_gemv inputs must be contiguous, on one device")
    if xb.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("fp8_gemv needs 16-byte aligned x and q")
    y = torch.empty((M, OUT), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = min(-(-OUT // WARPS), BLOCKS_PER_SM * sms)
    lib = build.load("fp8_gemv")
    err = lib.fp8_gemv(xb.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                       M, OUT, IN, ro, ri, Si, blocks,
                       torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("fp8_gemv", err)
    launches += 1
    return y
