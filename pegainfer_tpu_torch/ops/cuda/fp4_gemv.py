"""Packed-fp4 MoE expert GEMV for decode: kernel K3 (``csrc/fp4_gemv.cu``).

Replaces the TPU kernel ``pegainfer_tpu/ops/pallas/fp4_gemm.py::
moe_fp4_gemv``. y[m] = x[m] @ dequant(q[idx[m]], s[idx[m]]).T as f32
[M, OUT], for x [M, IN], q [E, OUT, IN/2] packed E2M1 and bf16 group scales
s [E, OUT, IN/g]. Numerics follow the TPU kernel: x rounded to bf16, each
weight bf16(f32(code) x scale), f32 accumulation. A row whose expert id
lies outside [0, E) gives 0.

The wrapper dispatches on the device of ``x``: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. ``launches`` counts
kernel launches. The launch plan (``plan``) comes from the shapes alone;
the kernel groups the rows by expert on the card (no host read of idx).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.ops.cuda import build

launches = 0

CHUNK_ROWS = 16  # rows of idx grouped together (csrc/fp4_gemv.cu kChunkRows)
WARP_CH = 16  # output channels of a warp tile: one m16 tile (kWarpCh)
STEP_K = 128  # columns of a warp step: 4 lanes x one run of 32 codes (kStepK)
MAX_WARPS = 8  # warps of a block (kMaxWarps), three blocks an SM
FIRST_WARPS = 8  # a block's warp tiles before the plan trades them for K parts
BLOCKS_PER_SM = 1.5  # the plan splits until the grid holds this many blocks an SM


class Plan(NamedTuple):
    """A block takes ``rt`` warp tiles of WARP_CH output channels and ``ks``
    K parts of them, one warp a (tile, part), for one expert slot; K parts
    are whole units of ``unit`` columns."""
    rt: int
    ks: int
    unit: int

    def blocks(self, OUT: int) -> int:
        """Blocks of one expert slot (the grid is this x M)."""
        tiles = -(-OUT // WARP_CH)
        return -(-tiles // self.rt)

    def span(self, kp: int, IN: int) -> tuple:
        """Columns [k0, k1) of K part ``kp`` (the kernel's formula)."""
        nu = IN // self.unit
        return kp * nu // self.ks * self.unit, (kp + 1) * nu // self.ks * self.unit


def plan(OUT: int, IN: int, group: int, M: int, sm_count: int) -> Plan:
    """The launch plan, from shapes alone. K is cut into units of whole
    steps and whole scale groups (lcm(STEP_K, group) columns, or all of IN
    where that does not divide it), then split by ``split``."""
    unit = math.lcm(STEP_K, group)
    if IN % unit:
        unit = IN
    return split(OUT, IN, unit, M, sm_count)


def split(OUT: int, IN: int, unit: int, M: int, sm_count: int) -> Plan:
    """A block's warps for M expert slots of OUT channels and K parts of
    whole ``unit`` columns (K3's plan and K6's, ``ops/cuda/int8_gemv.py``).
    Starting from blocks of FIRST_WARPS tiles (fewer where OUT has fewer)
    and one K part, it trades a block's tiles for K parts until the grid, M
    expert slots of blocks, holds BLOCKS_PER_SM blocks an SM; where the
    tiles are too few for that, it adds K parts (more warps a block, up to
    MAX_WARPS), while each part keeps a unit."""
    tiles = -(-OUT // WARP_CH)
    nu = IN // unit
    rt, ks = FIRST_WARPS, 1
    while rt > 1 and rt >= 2 * tiles:
        rt //= 2
    want = BLOCKS_PER_SM * sm_count

    def grid(rt):
        return -(-tiles // rt) * M

    while grid(rt) < want and rt > 1 and 2 * ks <= nu:
        rt, ks = rt // 2, ks * 2
    while grid(rt) < want and rt * ks < MAX_WARPS and 2 * ks <= nu:
        ks *= 2
    return Plan(rt, ks, unit)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def moe_fp4_gemv_plain(x, q, s, idx):
    """The kernel's function in plain PyTorch: gather and decode only the
    routed experts, then a batched f32 product of exact bf16 values; a row
    of an id outside [0, E) is 0."""
    valid = (idx >= 0) & (idx < q.shape[0])
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    w = quant.gather_dequant({"q": q, "s": s}, safe, torch.bfloat16).float()
    xb = x.to(torch.bfloat16).float()
    y = torch.bmm(w, xb[:, :, None])[:, :, 0]
    return torch.where(valid[:, None], y, torch.zeros_like(y))


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
    if IN % 32 or S < 1 or IN % S or (IN // S) % 32:
        raise ValueError(f"moe_fp4_gemv kernel takes IN and its scale group as "
                         f"multiples of 32; got IN={IN}, S={S}")
    if M > 65535:
        raise ValueError(f"moe_fp4_gemv kernel takes at most 65535 rows; got M={M}")
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
    p = plan(OUT, IN, IN // S, M, _sm_count(x.device))
    lib = build.load("fp4_gemv")
    err = lib.fp4_gemv(xb.data_ptr(), q.data_ptr(), s.data_ptr(), idx.data_ptr(),
                       y.data_ptr(), M, E, OUT, IN, S, *p,
                       torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("fp4_gemv", err)
    launches += 1
    return y
