"""int8 expert GEMV study kernels: ``expert_gemv`` in its convert and native
forms and ``expert_gemv_in_flight`` (``csrc/expert_stream.cu``).

Replace the TPU study kernels ``scripts/expert_stream_study.py::run_auto``
(both forms) and ``run_all_in_flight``. y[m, o] = sum_d q[idx[m], o, d] *
x[m, d] as f32 [M, OUT], for int8 codes q [E, OUT, D]; each routed row
streams its own expert (no dedupe, unlike K6, ``ops/cuda/int8_gemv.py``):

- the convert form (``native=False``, the TPU's "production form"): x
  rounded to bf16, each code an exact bf16 value, f32 sums;
- the native form (``native=True``, the "w8a8 form"): int8 x, the exact
  integer sum rounded to f32 once;
- ``expert_gemv_in_flight``: the convert form, a block owning T output rows
  and issuing every copy of its M x T rows before its first wait; with
  ``copies_only`` a probe that waits for every copy and computes nothing
  (y is 0).

A row whose expert id lies outside [0, E) gives 0. Each wrapper dispatches
on the device of ``x``: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises. ``launches`` counts kernel launches by
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda.gemv_stream import MAX_SMEM

launches = {"expert_gemv_convert": 0, "expert_gemv_native": 0, "expert_gemv_in_flight": 0,
            "expert_gemv_in_flight_copies_only": 0}  # the last: the probe's launches
ROWS = (16, 32, 64)  # output rows a block of expert_gemv (the TPU's TO)
IN_FLIGHT_BYTES = 200 * 1024  # the in-flight form's codes a block: M x T x D at most
IN_FLIGHT_TILES = (8, 4, 2, 1)  # its T, largest first (a divisor of its 8 warps)
NATIVE_MAX_D = 133144  # D x 127^2 stays below 2^31
WARPS = 8


def in_flight_smem(M: int, T: int, D: int) -> int:
    """The in-flight form's shared memory (csrc/expert_stream.cu
    in_flight_smem): codes, M mbarriers, the warps' partial sums."""
    return M * T * D + 8 * M + 4 * M * WARPS


def expert_gemv_plain(x, q, idx, native: bool = False):
    """The kernels' function in plain PyTorch: gather q[idx]; the convert
    form converts the codes to bf16 (exact) and takes a batched f32 product
    with x rounded to bf16; the native form takes the integer product
    exactly (every product and partial sum is an integer below 2^53, so the
    f64 product equals the int64 one) and casts it to f32, rounding once to
    nearest even."""
    E = q.shape[0]
    w = q[idx.long().clamp(0, E - 1)]
    if native:
        y = torch.bmm(w.double(), x.double()[:, :, None])[:, :, 0].float()
    else:
        y = torch.bmm(w.to(torch.bfloat16).float(),
                      x.to(torch.bfloat16).float()[:, :, None])[:, :, 0]
    valid = (idx >= 0) & (idx < E)
    return torch.where(valid[:, None], y, torch.zeros((), dtype=y.dtype, device=y.device))


def expert_gemv_in_flight_plain(x, q, idx, copies_only: bool = False):
    """``expert_gemv_in_flight``'s function: the convert form's (zeros for
    the copies-only probe)."""
    if copies_only:
        return torch.zeros((x.shape[0], q.shape[1]), dtype=torch.float32, device=x.device)
    return expert_gemv_plain(x, q, idx, native=False)


def expert_gemv(x, q, idx, native: bool = False, rows: int = 32):
    """y [M, OUT] f32; x [M, D] int8 when ``native``, else any float type
    (rounded to bf16); ``rows`` output rows a block, one of ROWS."""
    if x.device.type == "cpu":
        return expert_gemv_plain(x, q, idx, native)
    _check_device(x, "expert_gemv")
    if rows not in ROWS:
        raise ValueError(f"expert_gemv: rows {rows} is not one of {ROWS}")
    if native and x.dtype != torch.int8:
        raise ValueError(f"expert_gemv's native form takes int8 x; got {x.dtype}")
    xk = x.contiguous() if native else x.to(torch.bfloat16).contiguous()
    M, E, OUT, D = _shapes(xk, q, idx, "expert_gemv")
    if native and D > NATIVE_MAX_D:
        raise ValueError(f"expert_gemv's native form takes D up to {NATIVE_MAX_D}; got {D}")
    y = torch.empty((M, OUT), dtype=torch.float32, device=x.device)
    if M == 0:
        return y
    err = build.load("expert_stream").expert_gemv(
        xk.data_ptr(), q.data_ptr(), idx.data_ptr(), y.data_ptr(), M, E, OUT, D, int(native),
        rows, torch.cuda.current_stream(x.device).cuda_stream)
    name = "expert_gemv_native" if native else "expert_gemv_convert"
    build.check_launch(name, err)
    launches[name] += 1
    return y


def tile_fits(M: int, D: int, T: int) -> bool:
    """Whether the in-flight form takes T: one of IN_FLIGHT_TILES, M x T x D
    codes within IN_FLIGHT_BYTES (and the block's shared memory within
    MAX_SMEM), and 8/T warps a row splitting D in whole 16-byte units."""
    return (T in IN_FLIGHT_TILES and M * T * D <= IN_FLIGHT_BYTES
            and in_flight_smem(M, T, D) <= MAX_SMEM and D % (16 * (WARPS // T)) == 0)


def in_flight_tile(M: int, D: int) -> int:
    """The in-flight form's default T: the largest that fits; raises where
    none does."""
    for T in IN_FLIGHT_TILES:
        if tile_fits(M, D, T):
            return T
    raise ValueError(f"expert_gemv_in_flight: M {M} x D {D} codes do not fit a block's "
                     f"{IN_FLIGHT_BYTES} bytes, or D is not a multiple of 128")


def expert_gemv_in_flight(x, q, idx, tile: int | None = None, copies_only: bool = False):
    """y [M, OUT] f32, the convert form; x any float type (rounded to bf16);
    ``tile`` output rows a block (T; None: ``in_flight_tile``)."""
    if x.device.type == "cpu":
        return expert_gemv_in_flight_plain(x, q, idx, copies_only)
    _check_device(x, "expert_gemv_in_flight")
    xb = x.to(torch.bfloat16).contiguous()
    M, E, OUT, D = _shapes(xb, q, idx, "expert_gemv_in_flight")
    y = torch.empty((M, OUT), dtype=torch.float32, device=x.device)
    if M == 0:
        return y
    T = in_flight_tile(M, D) if tile is None else tile
    if not tile_fits(M, D, T):
        raise ValueError(f"expert_gemv_in_flight: T {tile} does not fit M {M}, D {D}")
    err = build.load("expert_stream").expert_gemv_in_flight(
        xb.data_ptr(), q.data_ptr(), idx.data_ptr(), y.data_ptr(), M, E, OUT, D, T,
        int(copies_only), torch.cuda.current_stream(x.device).cuda_stream)
    name = "expert_gemv_in_flight_copies_only" if copies_only else "expert_gemv_in_flight"
    build.check_launch(name, err)
    launches[name] += 1
    return y


def blocks_per_sm(form: str, rows: int, M: int, D: int) -> int:
    """Blocks of a form ("convert", "native", or "in_flight" with rows = T)
    that fit an SM at once, from the CUDA occupancy calculator."""
    out = ctypes.c_int(0)
    err = build.load("expert_stream").expert_stream_blocks_per_sm(
        ("convert", "native", "in_flight").index(form), rows, M, D, ctypes.byref(out))
    build.check_launch("expert_stream_blocks_per_sm", err)
    return out.value


def _check_device(t, who):
    if t.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {t.device}")


def _shapes(x, q, idx, who):
    if x.dim() != 2 or q.dim() != 3:
        raise ValueError(f"{who} takes x [M, D], q [E, OUT, D]")
    M, D = x.shape
    E, OUT, QD = q.shape
    if QD != D or idx.shape != (M,):
        raise ValueError(f"{who}: x {tuple(x.shape)} / q {tuple(q.shape)} / idx "
                         f"{tuple(idx.shape)} do not fit")
    if D % 16:
        raise ValueError(f"{who} kernel takes D as a multiple of 16; got D={D}")
    if q.dtype != torch.int8 or idx.dtype != torch.int32:
        raise ValueError(f"{who} kernel takes int8 q and int32 idx; got {q.dtype}, {idx.dtype}")
    for t in (q, idx):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{who} inputs must be contiguous, on one device")
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"{who} needs 16-byte aligned x and q")
    return M, E, OUT, D
