"""int8 MoE expert GEMV for decode: kernel K6 (``csrc/int8_gemv.cu``).

Replaces the TPU kernel ``pegainfer_tpu/ops/pallas/fp4_gemm.py::
moe_int8_gemv``. y[m] = x[m] @ q[idx[m]].T as f32 [M, OUT], unscaled, for x
[M, IN] rounded to bf16 and int8 codes q [E, OUT, IN]; the caller multiplies
by the gathered per-output-channel scales (``models/dsv4.py::_int8_srows``).
Each code is an exact bf16 value and the sums are f32. A row whose expert
id lies outside [0, E) gives 0.

``int8_gemv_dense`` is the same kernel on one int8 weight [OUT, IN] with
every row on it. It carried the decode-shaped rows of the int8 weight-only
linears of Qwen3 and Qwen3.5 until the int8 linear kernel
(``ops/cuda/int8_linear.py``) took them; it stays off the main path as the
yardstick the studies and the smoke time beside that kernel. Its launch
asks for one expert slot a chunk of 16 rows, the only slot with work.

The wrappers dispatch on the device of ``x``: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. ``launches`` counts
kernel launches, routed and dense. The launch plan (``plan``) comes from
the shapes alone; the kernel groups the rows by expert on the card (no host
read of idx).
"""

from __future__ import annotations

import functools

import torch

from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
from pegainfer_tpu_torch.ops.cuda.fp4_gemv import Plan

launches = 0

CHUNK_ROWS = 16  # rows of idx grouped together (csrc/int8_gemv.cu kChunkRows)
WARP_CH = 16  # output channels of a warp tile: one m16 tile (kWarpCh)
RUNS = 2  # 16-code runs a thread a step (kRuns)
STEP_K = 4 * 16 * RUNS  # columns of a warp step: 4 lanes x RUNS runs (kStepK)
MAX_WARPS = 8  # warps of a block (kMaxWarps), three blocks an SM


def plan(OUT: int, IN: int, slots: int, sm_count: int) -> Plan:
    """The launch plan, from shapes alone, for ``slots`` expert slots with
    work (M for routed rows, ``dense_slots(M)`` for a dense weight), split
    as K3's (``fp4_gemv.split``) with a unit of one step: the kernel passes
    the K parts of a tile steps in turn (part kp takes steps kp, kp + ks,
    ...), so each keeps a step."""
    return k3.split(OUT, IN, STEP_K, slots, sm_count)


def dense_slots(M: int) -> int:
    """Expert slots of a dense launch: one a chunk of CHUNK_ROWS rows."""
    return -(-M // CHUNK_ROWS)


def moe_int8_gemv_plain(x, q, idx):
    """The kernel's function in plain PyTorch: gather only the routed
    experts, convert to bf16 (exact), then a batched f32 product (the JAX
    package's XLA int8 path, ``models/dsv4.py`` decode branch); a row of an
    id outside [0, E) is 0."""
    valid = (idx >= 0) & (idx < q.shape[0])
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    w = q[safe].to(torch.bfloat16).float()
    xb = x.to(torch.bfloat16).float()
    y = torch.bmm(w, xb[:, :, None])[:, :, 0]
    return torch.where(valid[:, None], y, torch.zeros_like(y))


def moe_int8_gemv(x, q, idx):
    if x.device.type == "cpu":
        return moe_int8_gemv_plain(x, q, idx)
    if x.device.type != "cuda":
        raise ValueError(f"moe_int8_gemv: no kernel for device {x.device}")
    return _launch(x, q, idx)


@functools.lru_cache(maxsize=None)
def zero_idx(M: int, device: torch.device) -> torch.Tensor:
    """The expert ids of a dense launch of M rows, made once per (rows,
    device): never written, so shared by every call. Made first inside a
    CUDA graph's capture, its zeroing would run only when that graph
    replays, so the decode graphs (``engine/decode_graphs.py``) make it for
    every batch bucket before their first capture."""
    return torch.zeros(M, dtype=torch.int32, device=device)


def int8_gemv_dense_plain(x, q):
    """``int8_gemv_dense``'s function in plain PyTorch: x rounded to bf16,
    the exact codes, one f32 product (the routed plain version's function
    with one expert, without its copy of the weight a row)."""
    return x.to(torch.bfloat16).float() @ q.float().T


def int8_gemv_dense(x, q):
    """y = x @ q.T as f32 [M, OUT], unscaled, for x [M, IN] rounded to bf16
    and one int8 weight q [OUT, IN]: K6 with every row on expert 0."""
    if x.device.type == "cpu":
        return int8_gemv_dense_plain(x, q)
    if x.device.type != "cuda":
        raise ValueError(f"int8_gemv_dense: no kernel for device {x.device}")
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError("int8_gemv_dense takes x [M, IN], q [OUT, IN]")
    M = x.shape[0]
    return _launch(x, q[None], zero_idx(M, x.device), dense_slots(M))


def _launch(x, q, idx, slots=None):
    """One launch over ``slots`` expert slots (None: routed rows, one a
    row)."""
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
    if M > 65535:
        raise ValueError(f"moe_int8_gemv kernel takes at most 65535 rows; got M={M}")
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
    slots = M if slots is None else slots
    p = plan(OUT, IN, slots, k3._sm_count(x.device))
    lib = build.load("int8_gemv")
    err = lib.int8_gemv(xb.data_ptr(), q.data_ptr(), idx.data_ptr(), y.data_ptr(),
                        M, E, OUT, IN, p.rt, p.ks, slots,
                        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("int8_gemv", err)
    launches += 1
    return y
