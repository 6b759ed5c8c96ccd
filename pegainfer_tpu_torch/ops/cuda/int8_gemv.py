"""int8 MoE expert GEMV for decode: kernel K6 (``csrc/int8_gemv.cu``).

Replaces the TPU kernel ``pegainfer_tpu/ops/pallas/fp4_gemm.py::
moe_int8_gemv``. y[m] = x[m] @ q[idx[m]].T as f32 [M, OUT], unscaled, for x
[M, IN] rounded to bf16 and int8 codes q [E, OUT, IN]; the caller multiplies
by the gathered per-output-channel scales (``models/dsv4.py::_int8_srows``).
Each code is an exact bf16 value and the sums are f32.

The wrapper dispatches on the device of ``x``: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from pegainfer_tpu_torch.ops.cuda import build

launches = 0


def moe_int8_gemv_plain(x, q, idx):
    """The kernel's function in plain PyTorch: gather only the routed
    experts, convert to bf16 (exact), then a batched f32 product (the JAX
    package's XLA int8 path, ``models/dsv4.py`` decode branch)."""
    w = q[idx.long()].to(torch.bfloat16).float()
    xb = x.to(torch.bfloat16).float()
    return torch.bmm(w, xb[:, :, None])[:, :, 0]


def moe_int8_gemv(x, q, idx):
    if x.device.type == "cpu":
        return moe_int8_gemv_plain(x, q, idx)
    if x.device.type != "cuda":
        raise ValueError(f"moe_int8_gemv: no kernel for device {x.device}")
    return _launch(x, q, idx)


def _launch(x, q, idx):
    global launches
    if x.dim() != 2 or q.dim() != 3:
        raise ValueError("moe_int8_gemv takes x [M, IN], q [E, OUT, IN]")
    M, IN = x.shape
    E, OUT, QIN = q.shape
    if IN != QIN or idx.shape != (M,):
        raise ValueError(f"x {tuple(x.shape)} / q {tuple(q.shape)} / idx {tuple(idx.shape)} "
                         "do not fit")
    if IN % 16:
        raise ValueError(f"moe_int8_gemv kernel takes IN as a multiple of 16; got IN={IN}")
    if q.dtype != torch.int8 or idx.dtype != torch.int32:
        raise ValueError(f"moe_int8_gemv kernel takes int8 q and int32 idx; got {q.dtype}, "
                         f"{idx.dtype}")
    xb = x.to(torch.bfloat16).contiguous()
    for t in (xb, q, idx):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("moe_int8_gemv inputs must be contiguous, on one device")
    if xb.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("moe_int8_gemv needs 16-byte aligned x and q")
    y = torch.empty((M, OUT), dtype=torch.float32, device=x.device)
    if M == 0:
        return y
    lib = build.load("int8_gemv")
    err = lib.int8_gemv(xb.data_ptr(), q.data_ptr(), idx.data_ptr(), y.data_ptr(),
                        M, E, OUT, IN, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("int8_gemv", err)
    launches += 1
    return y
