"""int8 grouped expert GEMM for prefill MoE: kernel K7
(``csrc/int8_grouped.cu``), with its launch plan.

Replaces the TPU kernel ``pegainfer_tpu/ops/pallas/fp4_gemm.py::
moe_int8_grouped`` and keeps its signature: rows of ``x_sorted`` are sorted
by expert and cut into tiles of ``tm`` rows, each tile listing its expert
segments (``fp4_grouped.tile_segments``); y[r] = x_sorted[r] @ q[e(r)].T as
f32 [Mp, OUT], rows in no segment give 0. The caller applies the
per-output-channel scales. Numerics: x rounded to bf16, each code an exact
bf16 value, f32 accumulation.

The kernel does not walk the tiles: it takes the launch plan that K5
shares (``fp4_grouped.plan``, re-exported here as ``plan``), work items of
one expert, a chunk of at most ``ROW_CHUNK`` of its rows and (in the kernel)
one tile of output channels, so that each expert's codes stream once per row
chunk; ``models/dsv4.py`` builds it once per MoE layer for its three
calls.

The wrapper dispatches on the device of ``x_sorted``: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda.fp4_grouped import (  # noqa: F401 (Plan, plan: re-exported)
    K_STEP, MAX_TM, OUT_STEP, ROW_CHUNK, Plan, _row_experts, check_plan, check_segments, plan)

launches = 0

OUT_TILE = 128  # csrc/int8_grouped.cu kBM: output channels of one work item


def moe_int8_grouped_plain(x_sorted, q, seg_expert, seg_lo, seg_hi, n_seg, tm=128):
    """The kernel's function in plain PyTorch: each expert's rows times its
    codes in f32 (exact bf16 values), one expert at a time, as
    ``moe_fp4_grouped_plain``."""
    Mp = x_sorted.shape[0]
    row_e, covered = _row_experts(seg_expert, seg_lo, seg_hi, n_seg, tm)
    covered &= (row_e >= 0) & (row_e < q.shape[0])  # as the plan: no expert outside [0, E)
    xb = x_sorted.to(torch.bfloat16).float()
    out = torch.zeros((Mp, q.shape[1]), dtype=torch.float32, device=x_sorted.device)
    for e in torch.unique(row_e[covered]).tolist():
        rows = torch.nonzero(covered & (row_e == e))[:, 0]
        out[rows] = xb[rows] @ q[e].float().T
    return out


def moe_int8_grouped(x_sorted, q, seg_expert, seg_lo, seg_hi, n_seg, tm=128, plan=None):
    """``plan``: this call's ``plan(...)``, to share one among the calls of
    a layer; built here when None. A CPU tensor ignores it."""
    if x_sorted.device.type == "cpu":
        return moe_int8_grouped_plain(x_sorted, q, seg_expert, seg_lo, seg_hi, n_seg, tm)
    if x_sorted.device.type != "cuda":
        raise ValueError(f"moe_int8_grouped: no kernel for device {x_sorted.device}")
    return _launch(x_sorted, q, seg_expert, seg_lo, seg_hi, n_seg, tm, plan)


def _launch(x_sorted, q, seg_expert, seg_lo, seg_hi, n_seg, tm, work):
    global launches
    if x_sorted.dim() != 2 or q.dim() != 3:
        raise ValueError("moe_int8_grouped takes x [Mp, IN], q [E, OUT, IN]")
    Mp, IN = x_sorted.shape
    E, OUT, QIN = q.shape
    if IN != QIN or not tm or Mp % tm:
        raise ValueError(f"x {tuple(x_sorted.shape)} / q {tuple(q.shape)} / tm {tm} "
                         "do not fit")
    check_segments(seg_expert, seg_lo, seg_hi, n_seg, Mp, tm)
    if tm % 8 or tm > MAX_TM or OUT % OUT_STEP or IN % K_STEP:
        raise ValueError(f"moe_int8_grouped kernel takes tm % 8 == 0 and <= {MAX_TM}, "
                         f"OUT % {OUT_STEP} and IN % {K_STEP} == 0; got tm={tm} OUT={OUT} "
                         f"IN={IN}")
    if q.dtype != torch.int8:
        raise ValueError(f"moe_int8_grouped kernel takes int8 q, got {q.dtype}")
    if Mp == 0:
        return torch.empty((0, OUT), dtype=torch.float32, device=x_sorted.device)
    if work is None:
        work = plan(seg_expert, seg_lo, seg_hi, n_seg, tm, E)
    n_slots = check_plan(work, Mp, E, "moe_int8_grouped")
    xb = x_sorted.to(torch.bfloat16).contiguous()
    for t in (xb, q, seg_expert, seg_lo, seg_hi, n_seg, *work):
        if t.device != x_sorted.device or not t.is_contiguous():
            raise ValueError("moe_int8_grouped inputs must be contiguous, on one device")
    if xb.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("moe_int8_grouped needs 16-byte aligned x and q")
    y = torch.empty((Mp, OUT), dtype=torch.float32, device=x_sorted.device)
    lib = build.load("int8_grouped")
    err = lib.int8_grouped(xb.data_ptr(), q.data_ptr(), work.row_e.data_ptr(),
                           work.owner.data_ptr(), work.items.data_ptr(),
                           work.n_items.data_ptr(), y.data_ptr(), Mp, E, OUT, IN, n_slots,
                           torch.cuda.current_stream(x_sorted.device).cuda_stream)
    build.check_launch("int8_grouped", err)
    launches += 1
    return y
