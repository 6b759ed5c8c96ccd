"""Packed-fp4 grouped expert GEMM for prefill MoE: kernel K5
(``csrc/fp4_grouped.cu``), with ``tile_segments`` and the launch plan that
K5 and K7 (``int8_grouped.py``) share.

Replaces the TPU kernel ``pegainfer_tpu/ops/pallas/fp4_gemm.py::
moe_fp4_grouped`` and keeps its signature: rows of ``x_sorted`` are sorted by
expert and cut into tiles of ``tm`` rows; ``tile_segments`` lists each
tile's expert segments. y[r] = x_sorted[r] @ dequant(q[e(r)], s[e(r)]).T as
f32 [Mp, OUT]; rows in no segment give 0. Numerics follow the TPU kernel:
x rounded to bf16, each weight bf16(f32(code) x scale), f32 accumulation.

The kernels do not walk the tiles: ``plan`` turns the segments into work
items of one expert, a chunk of at most ``ROW_CHUNK`` of its rows and (in
the kernel) one tile of output channels, so that each expert's codes stream
once per row chunk. The plan is plain torch on the segments' device, from
shapes alone (no value is read back to the host); ``models/dsv4.py`` builds
it once per MoE layer for its three calls.

The wrapper dispatches on the device of ``x_sorted``: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.ops.cuda import build

launches = 0

MAX_TM = 128
ROW_CHUNK = 64  # csrc/fp4_grouped.cu and csrc/int8_grouped.cu kBN: rows of one work item
OUT_TILE = 128  # csrc/fp4_grouped.cu kBM: output channels of one work item
OUT_STEP = 64  # OUT must be a multiple of this (a last tile may be half)
K_STEP = 64  # IN must be a multiple of this (a last k-stage may be half)
GROUP_STEP = 16  # a scale group must be a multiple of this (one scale a 16-code run)


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


class Plan(NamedTuple):
    """The work of K5 and K7, int32 tensors on the segments' device.

    row_e: [Mp] each row's expert, -1 where no segment covers it (or its
        expert is outside [0, E)); the kernel loads x[r] only for row_e[r].
    owner: [Mp] the expert whose work item writes row r: its own, else the
        nearest covered row's before it (expert 0 for leading rows), so each
        expert's owned rows are one range [lo, hi) for sorted rows; with
        ``own_tail`` False, -1 for the rows past the last covered one (no
        item writes them).
    items: [E * ceil(Mp / ROW_CHUNK), 3] (expert, lo, hi) of each work item,
        experts in order, chunks of ROW_CHUNK rows of the expert's owned
        range; entries past the live count are (0, 0, 0).
    n_items: [1] the live count.
    """

    row_e: torch.Tensor
    owner: torch.Tensor
    items: torch.Tensor
    n_items: torch.Tensor


def plan(seg_expert, seg_lo, seg_hi, n_seg, tm: int, E: int, own_tail: bool = True) -> Plan:
    """The work items of K5 and K7 from the tiles' segments (see ``Plan``):
    about 60 small device operations, no value read back to the host.
    ``own_tail`` False leaves the rows past the last covered row to no work
    item, so they cost nothing and y keeps whatever its buffer held there:
    a model-parallel rank's rows of other ranks' experts, which sort last
    (``models/dsv4.py``)."""
    T = n_seg.shape[0]
    Mp, dev = T * tm, n_seg.device
    live = ((torch.arange(tm, device=dev) < n_seg[:, None]) & (seg_lo < seg_hi)
            & (seg_expert.clamp(0, E - 1) == seg_expert))
    # a difference array of one int64 a segment, (1 << 32) + expert, added at
    # its first row and taken off past its last: its prefix sum holds, for
    # each row, the segments covering it (high half) and their experts' sum
    tag = torch.where(live, seg_expert.long() + (1 << 32), 0)
    base = torch.arange(0, Mp, tm, device=dev)[:, None]
    at = torch.cat([base + seg_lo.clamp(0, tm), base + seg_hi.clamp(0, tm)]).view(-1)
    acc = torch.zeros(Mp + 1, dtype=torch.long, device=dev).index_add_(
        0, at, torch.cat([tag, -tag]).view(-1)).cumsum(0)[:Mp]
    row_e = acc & 0xFFFFFFFF
    row_e = torch.where((acc >> 32 > 0) & (row_e < E), row_e, -1)
    # rows of no segment go to the last covered row's expert (expert 0 before
    # the first), which for sorted rows keeps each expert's rows one range
    owner = torch.where(row_e >= 0, row_e, row_e.cummax(0).values.clamp(min=0))
    r = torch.arange(Mp, device=dev)
    slot, n = owner, E
    if not own_tail:  # rows past the last covered one go to a slot E, dropped
        last = torch.where(row_e >= 0, r, -1).max()
        owner = torch.where(r > last, -1, owner)
        slot, n = torch.where(owner >= 0, owner, E), E + 1
    lo_e = torch.full((n,), Mp, device=dev).scatter_reduce_(0, slot, r, "amin")[:E]
    hi_e = torch.zeros(n, dtype=torch.long, device=dev).scatter_reduce_(
        0, slot, r + 1, "amax")[:E]
    chunks = (hi_e - lo_e).clamp(min=0).add(ROW_CHUNK - 1).div(ROW_CHUNK, rounding_mode="floor")
    ends = chunks.cumsum(0)
    j = torch.arange(E * -(-Mp // ROW_CHUNK), device=dev)
    e_of = torch.searchsorted(ends, j, right=True).clamp(max=E - 1)
    # item j of expert e starts at lo_e[e] + (j - first item of e) * ROW_CHUNK
    it_lo = (lo_e - (ends - chunks) * ROW_CHUNK)[e_of] + j * ROW_CHUNK
    it_hi = torch.minimum(it_lo + ROW_CHUNK, hi_e[e_of])
    items = torch.stack([e_of, it_lo, it_hi], 1) * (j < ends[-1])[:, None]
    return Plan(row_e.int(), owner.int(), items.int(), ends[-1:].int())


def check_plan(work: Plan, Mp: int, E: int, name: str) -> int:
    """Raise unless ``work`` has the shapes and dtypes of ``plan`` for Mp
    rows and E experts; returns its slot count."""
    n_slots = E * -(-Mp // ROW_CHUNK)
    if (work.row_e.shape != (Mp,) or work.owner.shape != (Mp,)
            or work.items.shape != (n_slots, 3) or work.n_items.shape != (1,)
            or any(t.dtype != torch.int32 for t in work)):
        raise ValueError(f"{name}: plan does not fit these inputs: build it with "
                         "plan(seg_expert, seg_lo, seg_hi, n_seg, tm, E)")
    return n_slots


def check_segments(seg_expert, seg_lo, seg_hi, n_seg, Mp: int, tm: int) -> None:
    T = Mp // tm
    for t in (seg_expert, seg_lo, seg_hi):
        if t.shape != (T, tm) or t.dtype != torch.int32:
            raise ValueError("segment arrays must be int32 [Mp/tm, tm]")
    if n_seg.shape != (T,) or n_seg.dtype != torch.int32:
        raise ValueError("n_seg must be int32 [Mp/tm]")


def moe_fp4_grouped_plain(x_sorted, q, s, seg_expert, seg_lo, seg_hi, n_seg, tm=128):
    """The kernel's function in plain PyTorch: each expert's rows times its
    decoded weight (f32 products of exact bf16 values), one expert at a
    time so the whole stack is never decoded at once."""
    Mp = x_sorted.shape[0]
    row_e, covered = _row_experts(seg_expert, seg_lo, seg_hi, n_seg, tm)
    covered &= (row_e >= 0) & (row_e < q.shape[0])  # as the plan: no expert outside [0, E)
    xb = x_sorted.to(torch.bfloat16).float()
    out = torch.zeros((Mp, q.shape[1]), dtype=torch.float32, device=x_sorted.device)
    for e in torch.unique(row_e[covered]).tolist():
        rows = torch.nonzero(covered & (row_e == e))[:, 0]
        w = quant.dequant_any({"q": q[e], "s": s[e]}, torch.bfloat16).float()
        out[rows] = xb[rows] @ w.T
    return out


def moe_fp4_grouped(x_sorted, q, s, seg_expert, seg_lo, seg_hi, n_seg, tm=128, plan=None):
    """``plan``: this call's ``plan(...)``, to share one among the calls of
    a layer; built here when None. A CPU tensor ignores it."""
    if x_sorted.device.type == "cpu":
        return moe_fp4_grouped_plain(x_sorted, q, s, seg_expert, seg_lo, seg_hi, n_seg, tm)
    if x_sorted.device.type != "cuda":
        raise ValueError(f"moe_fp4_grouped: no kernel for device {x_sorted.device}")
    return _launch(x_sorted, q, s, seg_expert, seg_lo, seg_hi, n_seg, tm, plan)


def _launch(x_sorted, q, s, seg_expert, seg_lo, seg_hi, n_seg, tm, work):
    global launches
    if x_sorted.dim() != 2 or q.dim() != 3 or s.dim() != 3:
        raise ValueError("moe_fp4_grouped takes x [Mp, IN], q [E, OUT, IN/2], s [E, OUT, S]")
    Mp, IN = x_sorted.shape
    E, OUT, IN2 = q.shape
    S = s.shape[2]
    if IN != 2 * IN2 or s.shape[:2] != (E, OUT) or not tm or Mp % tm:
        raise ValueError(f"x {tuple(x_sorted.shape)} / q {tuple(q.shape)} / s "
                         f"{tuple(s.shape)} / tm {tm} do not fit")
    check_segments(seg_expert, seg_lo, seg_hi, n_seg, Mp, tm)
    if (tm % 8 or tm > MAX_TM or OUT % OUT_STEP or IN % K_STEP or not S or IN % S
            or (IN // S) % GROUP_STEP):
        raise ValueError(f"moe_fp4_grouped kernel takes tm % 8 == 0 and <= {MAX_TM}, "
                         f"OUT % {OUT_STEP}, IN % {K_STEP} == 0 and scale groups of a "
                         f"multiple of {GROUP_STEP}; got tm={tm} OUT={OUT} IN={IN} S={S}")
    if q.dtype != torch.uint8 or s.dtype != torch.bfloat16:
        raise ValueError(f"moe_fp4_grouped kernel takes uint8 q and bf16 s, got "
                         f"{q.dtype}, {s.dtype}")
    if Mp == 0:
        return torch.empty((0, OUT), dtype=torch.float32, device=x_sorted.device)
    if work is None:
        work = plan(seg_expert, seg_lo, seg_hi, n_seg, tm, E)
    n_slots = check_plan(work, Mp, E, "moe_fp4_grouped")
    xb = x_sorted.to(torch.bfloat16).contiguous()
    for t in (xb, q, s, seg_expert, seg_lo, seg_hi, n_seg, *work):
        if t.device != x_sorted.device or not t.is_contiguous():
            raise ValueError("moe_fp4_grouped inputs must be contiguous, on one device")
    if xb.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("moe_fp4_grouped needs 16-byte aligned x and q")
    y = torch.empty((Mp, OUT), dtype=torch.float32, device=x_sorted.device)
    lib = build.load("fp4_grouped")
    err = lib.fp4_grouped(xb.data_ptr(), q.data_ptr(), s.data_ptr(), work.row_e.data_ptr(),
                          work.owner.data_ptr(), work.items.data_ptr(),
                          work.n_items.data_ptr(), y.data_ptr(), Mp, E, OUT, IN, S, n_slots,
                          torch.cuda.current_stream(x_sorted.device).cuda_stream)
    build.check_launch("fp4_grouped", err)
    launches += 1
    return y
