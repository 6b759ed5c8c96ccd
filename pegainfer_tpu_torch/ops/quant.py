"""Block-scaled weights: fp8 (E4M3), packed fp4 (E2M1) and int8 containers.

The port's counterpart of ``pegainfer_tpu/ops/quant.py`` for the resident
DeepSeek-V4 formats. A quantized weight travels the params tree as
``{"q": values, "s": scales}``; the kind follows from ``q.dtype``:

- ``torch.float8_e4m3fn`` ``[.., out, in]`` with bf16 block scales
  ``[.., out/bo, in/bi]`` (128 x 128 blocks in the checkpoint);
- ``torch.uint8`` ``[.., out, in/2]``: two E2M1 codes per byte, the low
  nibble holding the even element, with bf16 scales ``[.., out, in/g]``
  (g = 32 in the checkpoint);
- ``torch.int8`` ``[.., out, in]`` with one f32 scale per output channel
  ``[.., out]``: the int8-experts mode, a requantization of the fp4 expert
  stacks at load (``quantize_int8_stack``, ``requantize_int8_stack``).

Block and group sizes follow from the shape ratios, as in the JAX package.
Scales are bf16 powers of two, so a decoded weight ``code x scale`` is exact
in bf16. Host-side quantizers (tests, random init) use numpy; the E2M1
encoder is written out here because the port does not use ``ml_dtypes``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

FP8_MAX = 448.0  # E4M3 max normal
FP4_MAX = 6.0  # E2M1 max
F8 = torch.float8_e4m3fn
SCALE_DTYPE = torch.bfloat16

E2M1_VALUES = np.array(
    [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
     -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0], np.float32)
# midpoints between neighbouring E2M1 magnitudes; at a midpoint the even
# code (lowest bit 0) wins, so the boundaries after an odd code round up
_E2M1_MIDPOINTS = np.array([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0], np.float32)


def round_scale_pow2(amax: torch.Tensor, fmt_max: float) -> torch.Tensor:
    """Power-of-two scale >= amax / fmt_max, f32 (on any device)."""
    ratio = torch.clamp(amax.float() / fmt_max, min=1e-38)
    return torch.exp2(torch.ceil(torch.log2(ratio)))


def _round_scale_pow2_np(amax: np.ndarray, fmt_max: float) -> np.ndarray:
    ratio = np.maximum(np.asarray(amax, np.float32) / fmt_max, 1e-38)
    return np.exp2(np.ceil(np.log2(ratio))).astype(np.float32)


def _e2m1_codes(arr) -> np.ndarray:
    """Finite floats -> E2M1 codes (uint8 0..15), round to nearest with ties
    to the even code, saturating at +-6; the sign bit follows the sign of
    the input (so -0.0 and small negatives give code 8)."""
    a = np.asarray(arr, np.float32)
    mag = np.abs(a)
    code = np.zeros(a.shape, np.uint8)
    for i, b in enumerate(_E2M1_MIDPOINTS):
        code += (mag >= b) if i % 2 else (mag > b)
    return code | (np.signbit(a).astype(np.uint8) << 3)


def pack_fp4(arr) -> np.ndarray:
    """Host side: floats [..., in] -> packed uint8 [..., in/2], low nibble
    first (the checkpoint's byte order)."""
    codes = _e2m1_codes(arr)
    if codes.shape[-1] % 2:
        raise ValueError(f"pack_fp4 needs an even last dim, got {codes.shape}")
    return (codes[..., 0::2] | (codes[..., 1::2] << 4)).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _e2m1_table(device: torch.device, dtype) -> torch.Tensor:
    # made once per device: a host-to-device copy per call would wait for
    # the device to drain its queue
    return torch.from_numpy(E2M1_VALUES).to(device=device, dtype=dtype)


def unpack_fp4(q: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Packed uint8 [..., in/2] -> values [..., in] (a 16-entry table)."""
    lut = _e2m1_table(q.device, dtype)
    qi = q.long()
    vals = torch.stack([lut[qi & 0xF], lut[qi >> 4]], dim=-1)
    return vals.reshape(*q.shape[:-1], 2 * q.shape[-1])


def is_quantized(w) -> bool:
    return isinstance(w, dict) and set(w.keys()) >= {"q", "s"}


def dequant_any(w, dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize a {"q","s"} container (any leading batch dims)."""
    q, s = w["q"], w["s"]
    sf = s.float()
    if q.dtype == torch.int8:  # per-output-channel scale
        if q.shape[:-1] != s.shape:
            raise ValueError(f"int8 q {tuple(q.shape)} / s {tuple(s.shape)} disagree")
        return (q.float() * sf[..., None]).to(dtype)
    if q.dtype == torch.uint8:  # packed fp4, per-row groups
        if q.shape[:-1] != s.shape[:-1]:
            raise ValueError(f"fp4 q {tuple(q.shape)} / s {tuple(s.shape)} disagree")
        vals = unpack_fp4(q, torch.float32)
        bi, ri = divmod(vals.shape[-1], s.shape[-1])
        if ri:
            raise ValueError(f"fp4 q {tuple(q.shape)} / s {tuple(s.shape)} disagree")
        return (vals * sf.repeat_interleave(bi, dim=-1)).to(dtype)
    if q.dtype != F8:
        raise ValueError(f"no dequantization for {q.dtype}")
    (bo, ro), (bi, ri) = divmod(q.shape[-2], s.shape[-2]), divmod(q.shape[-1], s.shape[-1])
    if ro or ri:
        raise ValueError(f"fp8 q {tuple(q.shape)} / s {tuple(s.shape)} disagree")
    sfull = sf.repeat_interleave(bo, dim=-2).repeat_interleave(bi, dim=-1)
    return (q.float() * sfull).to(dtype)


def gather_dequant(w, idx: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Rows ``idx`` of an expert stack ([E, out, in] plain or container) ->
    [len(idx), out, in]; only the gathered experts are decoded."""
    if is_quantized(w):
        return dequant_any({"q": w["q"][idx], "s": w["s"][idx]}, dtype)
    return w[idx].to(dtype)


def qlinear(x: torch.Tensor, w, plain_kernels: bool = False) -> torch.Tensor:
    """y = x @ W.T for a plain [out, in] weight or a {"q","s"} container.

    An fp8 container with at most 8 rows of ``x`` on a CUDA tensor goes to
    kernel K4 (``ops.cuda.fp8_gemv``; its plain version when
    ``plain_kernels``), as the JAX package routes decode-shaped fp8 linears
    to its fused GEMV. Everything else dequantizes and multiplies, as the
    JAX package leaves it to XLA."""
    if not is_quantized(w):
        return x @ w.T
    if w["q"].dtype == F8 and x.dim() == 2 and x.shape[0] <= 8 and x.is_cuda:
        from pegainfer_tpu_torch.ops.cuda import fp8_gemv as k4

        fn = k4.fp8_gemv_plain if plain_kernels else k4.fp8_gemv
        return fn(x, w["q"], w["s"]).to(x.dtype)
    return x @ dequant_any(w, x.dtype).T


def quantize_fp8_tensor(w, block: int = 128) -> dict:
    """[out, in] array -> resident fp8 container (host numpy, for tests and
    init). A block falls back to the full dim when ``block`` does not
    divide it."""
    wf = np.asarray(w, np.float32)
    out_dim, in_dim = wf.shape
    bo = block if out_dim % block == 0 else out_dim
    bi = block if in_dim % block == 0 else in_dim
    blocks = wf.reshape(out_dim // bo, bo, in_dim // bi, bi)
    scales = _round_scale_pow2_np(np.abs(blocks).max(axis=(1, 3)), FP8_MAX)
    q = (blocks / scales[:, None, :, None]).reshape(out_dim, in_dim)
    return {"q": torch.from_numpy(np.ascontiguousarray(q)).to(F8),
            "s": torch.from_numpy(scales).to(SCALE_DTYPE)}


def quantize_fp4_stack(w, group: int = 32) -> dict:
    """[E, out, in] expert stack -> packed-fp4 container ({"q": uint8
    [E, out, in/2], "s": bf16 [E, out, in/group]}), host numpy."""
    arr = np.asarray(w, np.float32)
    g = group if arr.shape[-1] % group == 0 else arr.shape[-1]
    grouped = arr.reshape(*arr.shape[:-1], arr.shape[-1] // g, g)
    scales = _round_scale_pow2_np(np.abs(grouped).max(axis=-1), FP4_MAX)
    vals = (grouped / scales[..., None]).reshape(arr.shape)
    return {"q": torch.from_numpy(pack_fp4(vals)),
            "s": torch.from_numpy(scales).to(SCALE_DTYPE)}


def quantize_int8_stack(w) -> dict:
    """[E, out, in] expert stack -> int8 container ({"q": int8 [E, out, in],
    "s": f32 [E, out]}), host numpy, bit for bit the JAX package's
    ``quantize_int8_stack``: a symmetric scale amax / 127 per output channel
    (1 where the channel is all zero), values rounded half to even and
    clipped to +-127."""
    wf = np.asarray(w, np.float32)
    amax = np.abs(wf).max(axis=-1)
    scale = np.where(amax > 0, amax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint(wf / scale[..., None]), -127, 127).astype(np.int8)
    return {"q": torch.from_numpy(q), "s": torch.from_numpy(scale)}


def requantize_int8_stack(w, chunk: int = 8) -> dict:
    """A packed-fp4 expert stack -> the int8 container of its f32
    dequantization, on the stack's own device, ``chunk`` experts at a time
    (a whole full-width stack in f32 would take 8.6 GB). The same
    arithmetic as ``quantize_int8_stack``: the f32 dequantization is exact,
    the divisions are true f32 divisions (a divisor held as a tensor: torch
    multiplies by the reciprocal of a Python scalar on the card) and
    ``torch.round`` rounds half to even like ``np.rint``, so the codes and
    scales equal the host path's bit for bit."""
    q4, s4 = w["q"], w["s"]
    if q4.dtype != torch.uint8:
        raise ValueError(f"requantize_int8_stack takes a packed-fp4 stack, got {q4.dtype}")
    E, OUT = q4.shape[0], q4.shape[1]
    q8 = torch.empty((E, OUT, 2 * q4.shape[2]), dtype=torch.int8, device=q4.device)
    s8 = torch.empty((E, OUT), dtype=torch.float32, device=q4.device)
    div = torch.tensor(127.0, dtype=torch.float32, device=q4.device)
    for e0 in range(0, E, chunk):
        wf = dequant_any({"q": q4[e0:e0 + chunk], "s": s4[e0:e0 + chunk]}, torch.float32)
        amax = wf.abs().amax(dim=-1)
        scale = torch.where(amax > 0, amax / div, torch.ones_like(amax))
        q8[e0:e0 + chunk] = torch.clamp(torch.round(wf / scale[..., None]), -127, 127).to(
            torch.int8)
        s8[e0:e0 + chunk] = scale
        del wf
    return {"q": q8, "s": s8}
