"""Packed-fp4 expert GEMV decode variants: ``fp4_variant_gemv``
(``csrc/fp4_study.cu``).

Replaces the TPU study kernel ``scripts/fp4_kernel_study.py::build`` (body
``make_kernel``). y[m, o] = sum_j w_lo[o, j] x[m, 2j] + w_hi[o, j] x[m, 2j+1]
as f32 [M, OUT] over the packed codes q[idx[m]] [OUT, IN/2] (byte j: element
2j in the low nibble, 2j + 1 in the high), with bf16 group scales s [E, OUT,
IN/g] and x rounded to bf16, in four variants of the weight:

- ``floor``: the code byte 0-255 itself, for both halves (the load + dot
  floor, a cost probe);
- ``bits_noscale``: the E2M1 value, no scale (a cost probe);
- ``bits``: the E2M1 value in bf16 times the bf16 scale, a bf16 multiply;
- ``arith``: the E2M1 value in f32 times the f32 scale, rounded to bf16.

``bits`` and ``arith`` give the same bf16 weight (each product is exact
before its one rounding), K3's. A row whose expert id lies outside [0, E)
gives 0. The wrapper dispatches on the device of ``x``: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches by variant.
"""

from __future__ import annotations

import torch

from pegainfer_tpu_torch.ops.cuda import build

VARIANTS = ("floor", "bits_noscale", "bits", "arith")
ROWS = (16, 32, 64)  # output rows a block (the TPU's TO)
launches = {f"fp4_variant_{v}": 0 for v in VARIANTS}
# E2M1 code -> value; bit 3 is the sign
E2M1 = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)


_tables: dict = {}


def _e2m1_table(device):
    """E2M1 as an f32 tensor on ``device``, made once (no host copy, and so
    no wait on the device, in a timed plain call)."""
    if device not in _tables:
        _tables[device] = torch.tensor(E2M1, device=device)
    return _tables[device]


def variant_weights(q, s, idx, variant: str):
    """The weights of the routed experts, [M, OUT, IN] f32 (element 2j from
    byte j's low nibble): each variant's, in plain PyTorch."""
    if variant not in VARIANTS:
        raise ValueError(f"fp4_variant_gemv: variant {variant!r} is not one of {VARIANTS}")
    E = q.shape[0]
    qg = q[idx.long().clamp(0, E - 1)]
    if variant == "floor":
        return qg.float().repeat_interleave(2, dim=-1)
    codes = torch.stack((qg & 0xF, qg >> 4), dim=-1).flatten(-2).long()
    dec = _e2m1_table(q.device)[codes]
    if variant == "bits_noscale":
        return dec
    sc = s[idx.long().clamp(0, E - 1)].repeat_interleave(dec.shape[-1] // s.shape[-1], dim=-1)
    if variant == "bits":
        return (dec.to(torch.bfloat16) * sc).float()
    return (dec * sc.float()).to(torch.bfloat16).float()


def fp4_variant_gemv_plain(x, q, s, idx, variant: str):
    """The kernel's function in plain PyTorch: the variant's weights, then a
    batched f32 product with x rounded to bf16."""
    w = variant_weights(q, s, idx, variant)
    y = torch.bmm(w, x.to(torch.bfloat16).float()[:, :, None])[:, :, 0]
    valid = (idx >= 0) & (idx < q.shape[0])
    return torch.where(valid[:, None], y, torch.zeros((), dtype=y.dtype, device=y.device))


def fp4_variant_gemv(x, q, s, idx, variant: str, rows: int = 32):
    """y [M, OUT] f32 for x [M, IN] (any float type), q [E, OUT, IN/2]
    uint8, s [E, OUT, S] bf16, idx [M] int32; ``rows`` output rows a block."""
    if x.device.type == "cpu":
        return fp4_variant_gemv_plain(x, q, s, idx, variant)
    if x.device.type != "cuda":
        raise ValueError(f"fp4_variant_gemv: no kernel for device {x.device}")
    if variant not in VARIANTS:
        raise ValueError(f"fp4_variant_gemv: variant {variant!r} is not one of {VARIANTS}")
    if rows not in ROWS:
        raise ValueError(f"fp4_variant_gemv: rows {rows} is not one of {ROWS}")
    if x.dim() != 2 or q.dim() != 3 or s.dim() != 3:
        raise ValueError("fp4_variant_gemv takes x [M, IN], q [E, OUT, IN/2], s [E, OUT, S]")
    M, IN = x.shape
    E, OUT, IN2 = q.shape
    S = s.shape[2]
    if IN != 2 * IN2 or s.shape[:2] != (E, OUT) or idx.shape != (M,):
        raise ValueError(f"x {tuple(x.shape)} / q {tuple(q.shape)} / s {tuple(s.shape)} / idx "
                         f"{tuple(idx.shape)} do not fit")
    if IN % 32 or IN % S or (IN // S) % 32:
        raise ValueError(f"fp4_variant_gemv kernel takes IN and its scale group as multiples "
                         f"of 32; got IN={IN}, S={S}")
    if q.dtype != torch.uint8 or s.dtype != torch.bfloat16 or idx.dtype != torch.int32:
        raise ValueError(f"fp4_variant_gemv kernel takes uint8 q, bf16 s, int32 idx; got "
                         f"{q.dtype}, {s.dtype}, {idx.dtype}")
    xb = x.to(torch.bfloat16).contiguous()
    for t in (q, s, idx):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("fp4_variant_gemv inputs must be contiguous, on one device")
    if xb.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("fp4_variant_gemv needs 16-byte aligned x and q")
    y = torch.empty((M, OUT), dtype=torch.float32, device=x.device)
    if M == 0:
        return y
    err = build.load("fp4_study").fp4_variant_gemv(
        xb.data_ptr(), q.data_ptr(), s.data_ptr(), idx.data_ptr(), y.data_ptr(), M, E, OUT, IN,
        S, VARIANTS.index(variant), rows, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(f"fp4_variant_{variant}", err)
    launches[f"fp4_variant_{variant}"] += 1
    return y
