"""fp8 dense-linear GEMV for decode: kernel K4 (``csrc/fp8_gemv.cu``).

Replaces the TPU kernel ``pegainfer_tpu/ops/pallas/fp4_gemm.py::fp8_gemv``.
y = x @ dequant(q, s).T as f32 [M, OUT], for x [M <= 8, IN], q [OUT, IN]
E4M3 and bf16 block scales s [So, Si]. Numerics follow the TPU kernel: x
rounded to bf16, each weight bf16(f32(code) x scale), f32 accumulation.

The wrapper dispatches on the device of ``x``: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. ``launches`` counts
kernel launches. The launch plan (``plan``) comes from the shapes alone.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.ops.cuda import build

launches = 0

MAX_ROWS = 8
MAX_WARPS = 16  # warps of a block (csrc/fp8_gemv.cu kMaxWarps)
FIRST_WARPS = 8  # a block's warps before the plan adds K parts to fill the card
BLOCKS_PER_SM = 1.5  # the plan splits until the grid holds this many blocks an SM


class Plan(NamedTuple):
    """A block takes ``rt`` tiles of ``tile_rows`` rows (8 or 16) and ``ks``
    K parts of them, one warp a (tile, part). K parts are whole units of
    ``unit`` columns."""
    tile_rows: int
    rt: int
    ks: int
    unit: int

    def blocks(self, OUT: int) -> int:
        tiles = -(-OUT // self.tile_rows)
        return -(-tiles // self.rt)

    def span(self, kp: int, IN: int) -> tuple:
        """Columns [k0, k1) of K part ``kp`` (the kernel's formula)."""
        nu = IN // self.unit
        return kp * nu // self.ks * self.unit, (kp + 1) * nu // self.ks * self.unit


def plan(OUT: int, IN: int, ri: int, sm_count: int) -> Plan:
    """The launch plan, from shapes alone. Tiles of 16 rows where they
    alone give each SM one (a thread then keeps twice the bytes in flight),
    else of 8. K is cut on scale blocks (units of ri columns, when ri is a
    multiple of 64; else not at all). Starting from blocks of 8 tiles and
    one K part, it trades a block's tiles for K parts until the grid holds
    BLOCKS_PER_SM blocks an SM; where the tiles are too few for that, it
    adds K parts (more warps a block, up to MAX_WARPS), while each part
    keeps a unit."""
    tile_rows = 16 if -(-OUT // 16) >= sm_count else 8
    tiles = -(-OUT // tile_rows)
    unit = ri if ri % 64 == 0 else IN
    nu = IN // unit
    rt, ks = FIRST_WARPS, 1
    want = BLOCKS_PER_SM * sm_count
    while -(-tiles // rt) < want and rt > 1 and 2 * ks <= nu:
        rt, ks = rt // 2, ks * 2
    while -(-tiles // rt) < want and rt * ks < MAX_WARPS and 2 * ks <= nu:
        ks *= 2
    return Plan(tile_rows, rt, ks, unit)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    p = plan(OUT, IN, ri, _sm_count(x.device))
    y = torch.empty((M, OUT), dtype=torch.float32, device=x.device)
    lib = build.load("fp8_gemv")
    err = lib.fp8_gemv(xb.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                       M, OUT, IN, ro, ri, Si, *p,
                       torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("fp8_gemv", err)
    launches += 1
    return y
