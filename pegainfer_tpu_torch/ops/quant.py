"""Block-scaled weights: fp8 (E4M3) and packed fp4 (E2M1) containers.

The port's counterpart of ``pegainfer_tpu/ops/quant.py`` for the resident
DeepSeek-V4 formats. A quantized weight travels the params tree as
``{"q": values, "s": scales}``; the kind follows from ``q.dtype``:

- ``torch.float8_e4m3fn`` ``[.., out, in]`` with bf16 block scales
  ``[.., out/bo, in/bi]`` (128 x 128 blocks in the checkpoint);
- ``torch.uint8`` ``[.., out, in/2]``: two E2M1 codes per byte, the low
  nibble holding the even element, with bf16 scales ``[.., out, in/g]``
  (g = 32 in the checkpoint).

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
