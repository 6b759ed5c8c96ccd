"""int8 grouped expert GEMM for prefill MoE: kernel K7
(``csrc/int8_grouped.cu``).

Replaces the TPU kernel ``pegainfer_tpu/ops/pallas/fp4_gemm.py::
moe_int8_grouped``: K5's tiling (``fp4_grouped.tile_segments``) over int8
codes, unscaled. Rows of ``x_sorted`` are sorted by expert and cut into
tiles of ``tm`` rows; y[r] = x_sorted[r] @ q[e(r)].T as f32 [Mp, OUT], rows
in no segment give 0. The caller applies the per-output-channel scales.
Numerics: x rounded to bf16, each code an exact bf16 value, f32
accumulation.

The wrapper dispatches on the device of ``x_sorted``: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda.fp4_grouped import K_STEP, MAX_TM, OUT_TILE, _row_experts

launches = 0


def moe_int8_grouped_plain(x_sorted, q, seg_expert, seg_lo, seg_hi, n_seg, tm=128):
    """The kernel's function in plain PyTorch: each expert's rows times its
    codes in f32 (exact bf16 values), one expert at a time, as
    ``moe_fp4_grouped_plain``."""
    Mp = x_sorted.shape[0]
    row_e, covered = _row_experts(seg_expert, seg_lo, seg_hi, n_seg, tm)
    xb = x_sorted.to(torch.bfloat16).float()
    out = torch.zeros((Mp, q.shape[1]), dtype=torch.float32, device=x_sorted.device)
    for e in torch.unique(row_e[covered]).tolist():
        rows = torch.nonzero(covered & (row_e == e))[:, 0]
        out[rows] = xb[rows] @ q[e].float().T
    return out


def moe_int8_grouped(x_sorted, q, seg_expert, seg_lo, seg_hi, n_seg, tm=128):
    if x_sorted.device.type == "cpu":
        return moe_int8_grouped_plain(x_sorted, q, seg_expert, seg_lo, seg_hi, n_seg, tm)
    if x_sorted.device.type != "cuda":
        raise ValueError(f"moe_int8_grouped: no kernel for device {x_sorted.device}")
    return _launch(x_sorted, q, seg_expert, seg_lo, seg_hi, n_seg, tm)


def _launch(x_sorted, q, seg_expert, seg_lo, seg_hi, n_seg, tm):
    global launches
    if x_sorted.dim() != 2 or q.dim() != 3:
        raise ValueError("moe_int8_grouped takes x [Mp, IN], q [E, OUT, IN]")
    Mp, IN = x_sorted.shape
    E, OUT, QIN = q.shape
    T = Mp // tm if tm else 0
    if IN != QIN or not tm or Mp % tm:
        raise ValueError(f"x {tuple(x_sorted.shape)} / q {tuple(q.shape)} / tm {tm} "
                         "do not fit")
    for t in (seg_expert, seg_lo, seg_hi):
        if t.shape != (T, tm) or t.dtype != torch.int32:
            raise ValueError("segment arrays must be int32 [Mp/tm, tm]")
    if n_seg.shape != (T,) or n_seg.dtype != torch.int32:
        raise ValueError("n_seg must be int32 [Mp/tm]")
    if tm % 8 or tm > MAX_TM or OUT % OUT_TILE or IN % K_STEP:
        raise ValueError(f"moe_int8_grouped kernel takes tm % 8 == 0 and <= {MAX_TM}, "
                         f"OUT % {OUT_TILE} and IN % {K_STEP} == 0; got tm={tm} OUT={OUT} "
                         f"IN={IN}")
    if q.dtype != torch.int8:
        raise ValueError(f"moe_int8_grouped kernel takes int8 q, got {q.dtype}")
    xb = x_sorted.to(torch.bfloat16).contiguous()
    for t in (xb, q, seg_expert, seg_lo, seg_hi, n_seg):
        if t.device != x_sorted.device or not t.is_contiguous():
            raise ValueError("moe_int8_grouped inputs must be contiguous, on one device")
    if xb.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("moe_int8_grouped needs 16-byte aligned x and q")
    y = torch.empty((Mp, OUT), dtype=torch.float32, device=x_sorted.device)
    if Mp == 0:
        return y
    lib = build.load("int8_grouped")
    err = lib.int8_grouped(xb.data_ptr(), q.data_ptr(), seg_expert.data_ptr(),
                           seg_lo.data_ptr(), seg_hi.data_ptr(), n_seg.data_ptr(),
                           y.data_ptr(), Mp, E, OUT, IN, tm,
                           torch.cuda.current_stream(x_sorted.device).cuda_stream)
    build.check_launch("int8_grouped", err)
    launches += 1
    return y
