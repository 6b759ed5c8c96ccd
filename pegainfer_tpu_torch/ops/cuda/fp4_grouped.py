"""Packed-fp4 grouped expert GEMM for prefill MoE: kernel K5
(``csrc/fp4_grouped.cu``), with ``tile_segments``.

Replaces the TPU kernel ``pegainfer_tpu/ops/pallas/fp4_gemm.py::
moe_fp4_grouped`` and keeps its signature: rows of ``x_sorted`` are sorted by
expert and cut into tiles of ``tm`` rows; ``tile_segments`` lists each
tile's expert segments. y[r] = x_sorted[r] @ dequant(q[e(r)], s[e(r)]).T as
f32 [Mp, OUT]; rows in no segment give 0. Numerics follow the TPU kernel:
x rounded to bf16, each weight bf16(f32(code) x scale), f32 accumulation.

The wrapper dispatches on the device of ``x_sorted``: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.ops.cuda import build

launches = 0

MAX_TM = 128
OUT_TILE = 64  # csrc/fp4_grouped.cu kTileOut
K_STEP = 64  # csrc/fp4_grouped.cu kStepK


def tile_segments(flat_e_sorted: torch.Tensor, tm: int, n_experts: int):
    """Per-tile expert segments for ``moe_fp4_grouped`` (plain torch on the
    tensor's device). flat_e_sorted: [M] ascending expert ids, M % tm == 0
    (pad rows carry a valid id). Returns (seg_expert [T, tm], seg_lo
    [T, tm], seg_hi [T, tm], n_seg [T]), int32, T = M / tm; entries past
    n_seg hold expert 0, lo tm, hi 1, as in the JAX package."""
    M = flat_e_sorted.shape[0]
    T = M // tm
    dev = flat_e_sorted.device
    e = flat_e_sorted.reshape(T, tm).to(torch.int32)
    pos = torch.arange(tm, dtype=torch.int32, device=dev).expand(T, tm)
    is_start = torch.cat([torch.ones((T, 1), dtype=torch.bool, device=dev),
                          e[:, 1:] != e[:, :-1]], dim=1)
    seg_id = torch.cumsum(is_start, dim=1).long() - 1
    n_seg = (seg_id[:, -1] + 1).to(torch.int32)
    seg_expert = torch.zeros((T, tm), dtype=torch.int32, device=dev).scatter_(1, seg_id, e)
    seg_lo = torch.full((T, tm), tm, dtype=torch.int32, device=dev).scatter_reduce_(
        1, seg_id, pos, "amin")
    seg_hi = torch.zeros((T, tm), dtype=torch.int32, device=dev).scatter_reduce_(
        1, seg_id, pos, "amax") + 1
    return seg_expert, seg_lo, seg_hi, n_seg


def _row_experts(seg_expert, seg_lo, seg_hi, n_seg, tm):
    """Each row's expert and whether a segment covers it, from the tiles'
    segments: ([Mp] int64, [Mp] bool)."""
    T = n_seg.shape[0]
    i = torch.arange(tm, device=n_seg.device)
    live = i[None, :] < n_seg[:, None]  # [T, segment]
    in_seg = (live[:, :, None] & (i[None, None, :] >= seg_lo[:, :, None])
              & (i[None, None, :] < seg_hi[:, :, None]))  # [T, segment, row]
    covered = in_seg.any(dim=1).reshape(T * tm)
    row_e = (in_seg.long() * seg_expert[:, :, None].long()).sum(dim=1).reshape(T * tm)
    return row_e, covered


def moe_fp4_grouped_plain(x_sorted, q, s, seg_expert, seg_lo, seg_hi, n_seg, tm=128):
    """The kernel's function in plain PyTorch: each expert's rows times its
    decoded weight (f32 products of exact bf16 values), one expert at a
    time so the whole stack is never decoded at once."""
    Mp = x_sorted.shape[0]
    row_e, covered = _row_experts(seg_expert, seg_lo, seg_hi, n_seg, tm)
    xb = x_sorted.to(torch.bfloat16).float()
    out = torch.zeros((Mp, q.shape[1]), dtype=torch.float32, device=x_sorted.device)
    for e in torch.unique(row_e[covered]).tolist():
        rows = torch.nonzero(covered & (row_e == e))[:, 0]
        w = quant.dequant_any({"q": q[e], "s": s[e]}, torch.bfloat16).float()
        out[rows] = xb[rows] @ w.T
    return out


def moe_fp4_grouped(x_sorted, q, s, seg_expert, seg_lo, seg_hi, n_seg, tm=128):
    if x_sorted.device.type == "cpu":
        return moe_fp4_grouped_plain(x_sorted, q, s, seg_expert, seg_lo, seg_hi, n_seg, tm)
    if x_sorted.device.type != "cuda":
        raise ValueError(f"moe_fp4_grouped: no kernel for device {x_sorted.device}")
    return _launch(x_sorted, q, s, seg_expert, seg_lo, seg_hi, n_seg, tm)


def _launch(x_sorted, q, s, seg_expert, seg_lo, seg_hi, n_seg, tm):
    global launches
    if x_sorted.dim() != 2 or q.dim() != 3 or s.dim() != 3:
        raise ValueError("moe_fp4_grouped takes x [Mp, IN], q [E, OUT, IN/2], s [E, OUT, S]")
    Mp, IN = x_sorted.shape
    E, OUT, IN2 = q.shape
    S = s.shape[2]
    T = Mp // tm if tm else 0
    if IN != 2 * IN2 or s.shape[:2] != (E, OUT) or not tm or Mp % tm:
        raise ValueError(f"x {tuple(x_sorted.shape)} / q {tuple(q.shape)} / s "
                         f"{tuple(s.shape)} / tm {tm} do not fit")
    for t in (seg_expert, seg_lo, seg_hi):
        if t.shape != (T, tm) or t.dtype != torch.int32:
            raise ValueError("segment arrays must be int32 [Mp/tm, tm]")
    if n_seg.shape != (T,) or n_seg.dtype != torch.int32:
        raise ValueError("n_seg must be int32 [Mp/tm]")
    if (tm % 8 or tm > MAX_TM or OUT % OUT_TILE or IN % K_STEP or IN % S
            or (IN // S) % 16):
        raise ValueError(f"moe_fp4_grouped kernel takes tm % 8 == 0 and <= {MAX_TM}, "
                         f"OUT % {OUT_TILE}, IN % {K_STEP} == 0 and scale groups of a "
                         f"multiple of 16; got tm={tm} OUT={OUT} IN={IN} S={S}")
    if q.dtype != torch.uint8 or s.dtype != torch.bfloat16:
        raise ValueError(f"moe_fp4_grouped kernel takes uint8 q and bf16 s, got "
                         f"{q.dtype}, {s.dtype}")
    xb = x_sorted.to(torch.bfloat16).contiguous()
    for t in (xb, q, s, seg_expert, seg_lo, seg_hi, n_seg):
        if t.device != x_sorted.device or not t.is_contiguous():
            raise ValueError("moe_fp4_grouped inputs must be contiguous, on one device")
    if xb.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("moe_fp4_grouped needs 16-byte aligned x and q")
    y = torch.empty((Mp, OUT), dtype=torch.float32, device=x_sorted.device)
    if Mp == 0:
        return y
    lib = build.load("fp4_grouped")
    err = lib.fp4_grouped(xb.data_ptr(), q.data_ptr(), s.data_ptr(),
                          seg_expert.data_ptr(), seg_lo.data_ptr(), seg_hi.data_ptr(),
                          n_seg.data_ptr(), y.data_ptr(), Mp, E, OUT, IN, S, tm,
                          torch.cuda.current_stream(x_sorted.device).cuda_stream)
    build.check_launch("fp4_grouped", err)
    launches += 1
    return y
