"""int8 weight-only linears for decode rows: kernel ``csrc/int8_linear.cu``.

The JAX package's ``ops/quant.py::int8_linear`` (an XLA op there, no
Pallas kernel): y = (x @ q.T with f32 sums of the exact codes) * s, cast to
x's dtype, for x [M, IN] rounded to bf16 first and up to ``MAX_WEIGHTS``
int8 weights q [OUT, IN] with f32 scales s [OUT] that read the same x, in
one launch. It takes the decode rows of the int8 linears of Qwen3 and
Qwen3.5 (``ops/quant.py::int8_linear`` / ``int8_linears``, at most
``quant.INT8_GEMV_ROWS`` rows) in place of K6 at one expert
(``ops/cuda/int8_gemv.py::int8_gemv_dense``) and its multiply and cast.

With ``f32_out`` the epilogue keeps the f32 sums times the scale and
writes them unrounded, for bf16 rows too: the partial sums of a
row-parallel projection under tensor parallelism (wo and w_down), reduced
across the ranks in f32 before the one rounding (``models/qwen3.py``).

The wrapper dispatches on the device of ``x``: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches. The plan (``plan``) comes from the shapes alone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from pegainfer_tpu_torch.ops.cuda import build

launches = 0

MAX_WEIGHTS = 4  # weights of one launch (csrc/int8_linear.cu kMaxW)
MAX_ROWS = 64  # rows of x (8 n8 groups)
STEP_K = 128  # columns of a step: 4 lanes x 2 runs of 16 codes (kStepK)
MAX_WARPS = 8  # warps of a block (kMaxWarps)
# the plan's K parts: at least 2, more until the launch has WARPS_TARGET
# warps, and 4 for a launch of BIG_TILES tiles or more (the heads), each
# part keeping a step (studies/int8_linear_study.py --sweep on an H100)
WARPS_TARGET = 1024
BIG_TILES = 4096
WG_FROM_GROUPS = 4  # row groups from which the plan may take the warpgroup form (kWgFromGroups)
# the warpgroup form for launches of at least this many 64-channel tiles, by
# row groups (4, 8), the warps' form below (it keeps 16-channel tiles, so a
# small weight still fills the card); and K split in two below
# WG_SPLIT_BLOCKS tiles (studies/int8_linear_study.py on an H100)
WG_MIN_TILES = {4: 256, 8: 96}
WG_SPLIT_BLOCKS = 264


class Plan(NamedTuple):
    """``groups`` n8 groups of rows (1, 2, 4, 8), ``rt`` warp tiles of 16
    output channels and ``ks`` K parts of them a block (one warp a (tile,
    part); part kp takes the steps kp, kp + ks, ... of STEP_K columns)."""
    groups: int
    rt: int
    ks: int

    def blocks(self, OUT: int) -> int:
        """Blocks of one weight of OUT channels."""
        return -(-(-(-OUT // 16)) // self.rt)


def row_groups(M: int) -> int:
    """n8 groups of rows: the fewest of 1, 2, 4, 8 that hold M rows."""
    return next(G for G in (1, 2, 4, 8) if 8 * G >= M)


def plan(outs: Sequence[int], IN: int, M: int) -> Plan:
    """The launch plan for weights of ``outs`` channels that share IN, from
    shapes alone. A block is one 16-channel tile's K parts, a warp each
    (``WARPS_TARGET``, ``BIG_TILES``); a warp's x is its own, so the
    grouping of tiles into blocks moves no bytes. Past 16 rows a launch of
    at least ``WG_MIN_TILES`` 64-channel tiles takes the warpgroup form
    instead: a block is a 64-channel tile of 4 warps (rt = 4, x staged once
    a step for the 4), with 2 K parts, a warpgroup each, while the launch
    has fewer than WG_SPLIT_BLOCKS tiles."""
    G = row_groups(M)
    nsteps = -(-IN // STEP_K)
    wg_tiles = sum(-(-o // 64) for o in outs)
    if G >= WG_FROM_GROUPS and wg_tiles >= WG_MIN_TILES[G]:
        return Plan(G, 4, 2 if wg_tiles < WG_SPLIT_BLOCKS and nsteps >= 2 else 1)
    tiles = sum(-(-o // 16) for o in outs)
    ks = min(2, nsteps)
    while ks < MAX_WARPS and 2 * ks <= nsteps and (
            tiles * ks < WARPS_TARGET or (tiles >= BIG_TILES and ks < 4)):
        ks *= 2
    return Plan(G, 1, ks)


def out_dtype(x: torch.Tensor, f32_out: bool = False) -> torch.dtype:
    """The output dtype: x's (bf16 or f32), or f32 with ``f32_out``."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_linear takes bf16 or f32 rows; got {x.dtype}")
    return torch.float32 if f32_out else x.dtype


def int8_linear_plain(x, qs, ss, joined: bool = False, f32_out: bool = False):
    """The kernel's function in plain PyTorch, weight by weight: x rounded
    to bf16, the exact codes, one f32 product, times s in f32, cast to x's
    dtype (kept f32 with ``f32_out``). A list of [M, OUT_w], or with
    ``joined`` one [M, sum OUT_w]."""
    dt = out_dtype(x, f32_out)
    xb = x.to(torch.bfloat16).float()
    ys = [((xb @ q.float().T) * s).to(dt) for q, s in zip(qs, ss)]
    return torch.cat(ys, dim=-1) if joined else ys


def int8_linear(x, qs, ss, joined: bool = False, f32_out: bool = False):
    """y_w = (x @ q_w.T with f32 sums) * s_w in x's dtype (bf16 or f32),
    or in f32 with ``f32_out``, x rounded to bf16, for each weight (q_w
    int8 [OUT_w, IN], s_w f32 [OUT_w]) of ``qs`` / ``ss``: a list of [M,
    OUT_w] (contiguous views of one buffer), or with ``joined`` one [M, sum
    OUT_w], the outputs side by side. One launch for up to MAX_WEIGHTS
    weights and MAX_ROWS rows."""
    if x.device.type == "cpu":
        return int8_linear_plain(x, qs, ss, joined, f32_out)
    if x.device.type != "cuda":
        raise ValueError(f"int8_linear: no kernel for device {x.device}")
    return _launch(x, list(qs), list(ss), joined, f32_out=f32_out)


def _launch(x, qs, ss, joined, p=None, lib=None, f32_out: bool = False):
    """One launch; ``p`` (a ``Plan``) and ``lib`` (a library of the same C
    interface) default to ``plan``'s and the built kernel's."""
    global launches
    n = len(qs)
    if not 1 <= n <= MAX_WEIGHTS or len(ss) != n:
        raise ValueError(f"int8_linear takes 1 to {MAX_WEIGHTS} weights and a scale each; got "
                         f"{n} and {len(ss)}")
    if x.dim() != 2:
        raise ValueError("int8_linear takes x [M, IN]")
    M, IN = x.shape
    dt = out_dtype(x, f32_out)
    if M > MAX_ROWS:
        raise ValueError(f"int8_linear kernel takes at most {MAX_ROWS} rows; got M={M}")
    if IN % 16:
        raise ValueError(f"int8_linear kernel takes IN as a multiple of 16; got IN={IN}")
    for q, s in zip(qs, ss):
        if q.dim() != 2 or q.shape[1] != IN or s.shape != (q.shape[0],):
            raise ValueError(f"x {tuple(x.shape)} / q {tuple(q.shape)} / s {tuple(s.shape)} "
                             "do not fit")
        if q.dtype != torch.int8 or s.dtype != torch.float32:
            raise ValueError(f"int8_linear kernel takes int8 q and f32 s; got {q.dtype}, "
                             f"{s.dtype}")
    xb = x.to(torch.bfloat16).contiguous()
    for t in (xb, *qs, *ss):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("int8_linear inputs must be contiguous, on one device")
    if xb.data_ptr() % 16 or any(q.data_ptr() % 16 for q in qs):
        raise ValueError("int8_linear needs 16-byte aligned x and q")
    outs = [q.shape[0] for q in qs]
    total = sum(outs)
    buf = torch.empty((M, total) if joined else (M * total,), dtype=dt, device=x.device)
    if joined:
        ys = [buf[:, o0:o0 + o] for o0, o in zip(_offsets(outs), outs)]
        ldy = [total] * n
    else:
        ys = [buf[M * o0:M * (o0 + o)].view(M, o) for o0, o in zip(_offsets(outs), outs)]
        ldy = outs
    if M == 0:
        return buf if joined else ys
    p = p or plan(outs, IN, M)
    arr = ctypes.c_void_p * n
    ints = ctypes.c_int * n
    lib = lib or build.load("int8_linear")
    err = lib.int8_linear(xb.data_ptr(), n, arr(*[q.data_ptr() for q in qs]),
                          arr(*[s.data_ptr() for s in ss]), arr(*[y.data_ptr() for y in ys]),
                          ints(*outs), ints(*ldy), M, IN, int(dt == torch.float32), p.groups,
                          p.rt, p.ks, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("int8_linear", err)
    launches += 1
    return buf if joined else ys


def _offsets(outs):
    """Each weight's first column in the outputs side by side."""
    at, offs = 0, []
    for o in outs:
        offs.append(at)
        at += o
    return offs
