"""Fused packed-fp4 routed-expert chain for decode: kernel K9
(``csrc/fp4_chain.cu``), with its gate ``fp4_chain_supported`` and the
perm13 row permutation.

Replaces the TPU kernel ``pegainfer_tpu/ops/pallas/fp4_gemm.py::
moe_fp4_chain``: the packed-fp4 analog of K8 (``int8_chain.py``). One launch
per layer computes, for every routed row m with expert e = idx[m],
act = bf16(silu(g)·u) of g = x·dequant(w1[e])ᵀ and u = x·dequant(w3[e])ᵀ
(clamped by ``limit`` when it is > 0), then y = act·dequant(w2[e])ᵀ as f32
[M, D], with K3's numerics (``fp4_gemv.py``). The weights are {"q","s"}
packed-fp4 containers.

``perm13=True`` takes w1 / w3 whose rows (and scale rows) ``permute_w13``
reordered evens then odds, so act comes out split by w2's nibble halves.
Three checks guard it, on every device: the flag must agree with the
``"perm13"`` mark that ``permute_w13`` leaves on both containers, I/2 must be
a multiple of 128 with it, and w3's scale groups must be as many as w1's.

The wrapper dispatches on the device of ``x``: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises, also for a shape
outside ``fp4_chain_supported``. ``launches`` counts kernel launches. A
row whose expert id lies outside [0, E) gives 0 on either.
"""

from __future__ import annotations

import torch

from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
from pegainfer_tpu_torch.ops.moe import CHAIN_KERNEL_TILE, CHAIN_MAX_ROWS, swiglu

launches = 0


def fp4_chain_supported(w1, w2, M: int, in_tile: int = 256, out_tile: int = 256) -> bool:
    """The JAX package's shape gate for the fused chain
    (``fp4_gemm.py::fp4_chain_supported``): packed stacks with aligned
    tiles, equal scale groups in w1 and w2, and a decode-sized M <= 16."""
    if w1["q"].dtype != torch.uint8 or w2["q"].dtype != torch.uint8:
        return False
    I, D2 = w1["q"].shape[-2:]
    D, I2 = w2["q"].shape[-2:]
    if D != 2 * D2 or I != 2 * I2:
        return False
    S1, S2 = w1["s"].shape[-1], w2["s"].shape[-1]
    if S1 == 0 or S2 == 0:
        return False
    return (M <= CHAIN_MAX_ROWS and I % min(in_tile, I) == 0 and D2 % 128 == 0
            and D % min(out_tile, D) == 0 and I2 % 128 == 0
            and D2 % S1 == 0 and I2 % S2 == 0 and D2 // S1 == I2 // S2)


def perm13_rows(I: int) -> torch.Tensor:
    """Evens-then-odds order of the I intermediate channels (the JAX
    package's ``perm13_rows``)."""
    return torch.cat([torch.arange(0, I, 2), torch.arange(1, I, 2)])


def permute_w13(w) -> dict:
    """A w1 or w3 container with its output rows (and their scale rows) in
    ``perm13_rows`` order, marked ``"perm13": True`` for the chain's check."""
    perm = perm13_rows(w["q"].shape[-2]).to(w["q"].device)
    return {"q": w["q"][..., perm, :].contiguous(), "s": w["s"][..., perm, :].contiguous(),
            "perm13": True}


def _check(w1, w3, perm13: bool) -> None:
    marked = (bool(w1.get("perm13")), bool(w3.get("perm13")))
    if perm13 and not all(marked):
        raise ValueError("moe_fp4_chain: perm13=True needs w1 and w3 permuted by "
                         "permute_w13 (both containers marked 'perm13')")
    if not perm13 and any(marked):
        raise ValueError("moe_fp4_chain: w1 / w3 are perm13-permuted but perm13=False")
    I = w1["q"].shape[-2]
    if perm13 and (I // 2) % 128:
        raise ValueError(f"moe_fp4_chain: perm13 needs I/2 % 128 == 0, got I={I}")
    if w3["s"].shape[-1] != w1["s"].shape[-1]:
        raise ValueError(f"moe_fp4_chain: w3 has {w3['s'].shape[-1]} scale groups a row, "
                         f"w1 {w1['s'].shape[-1]}")


def moe_fp4_chain_plain(x, w1, w3, w2, idx, limit: float, perm13: bool = False):
    """The kernel's function in plain PyTorch: three K3 plain products with
    the f32 SwiGLU between them; with perm13, act is put back in natural
    order before w2. A row whose expert id lies outside [0, E) gives 0."""
    valid = (idx >= 0) & (idx < w1["q"].shape[0])
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    g = k3.moe_fp4_gemv_plain(x, w1["q"], w1["s"], idx)
    u = k3.moe_fp4_gemv_plain(x, w3["q"], w3["s"], idx)
    act = swiglu(g, u, limit)
    if perm13:
        natural = torch.empty_like(act)
        natural[:, perm13_rows(act.shape[1]).to(act.device)] = act
        act = natural
    y = k3.moe_fp4_gemv_plain(act, w2["q"], w2["s"], idx)
    return torch.where(valid[:, None], y, torch.zeros_like(y))


def moe_fp4_chain(x, w1, w3, w2, idx, limit: float, perm13: bool = False):
    _check(w1, w3, perm13)
    if x.device.type == "cpu":
        return moe_fp4_chain_plain(x, w1, w3, w2, idx, limit, perm13)
    if x.device.type != "cuda":
        raise ValueError(f"moe_fp4_chain: no kernel for device {x.device}")
    return _launch(x, w1, w3, w2, idx, limit, perm13)


def _launch(x, w1, w3, w2, idx, limit, perm13):
    global launches
    q1, s1, q3, s3, q2, s2 = w1["q"], w1["s"], w3["q"], w3["s"], w2["q"], w2["s"]
    if x.dim() != 2 or q1.dim() != 3 or q3.shape != q1.shape or q2.dim() != 3:
        raise ValueError("moe_fp4_chain takes x [M, D], w1 / w3 [E, I, D/2], w2 [E, D, I/2]")
    M, D = x.shape
    E, I, D2 = q1.shape
    if 2 * D2 != D or q2.shape != (E, D, I // 2) or idx.shape != (M,):
        raise ValueError(f"x {tuple(x.shape)} / w1 {tuple(q1.shape)} / w2 {tuple(q2.shape)} "
                         f"/ idx {tuple(idx.shape)} do not fit")
    S1, S2 = s1.shape[-1], s2.shape[-1]
    if s1.shape != (E, I, S1) or s3.shape != s1.shape or s2.shape != (E, D, S2):
        raise ValueError(f"scales s1 {tuple(s1.shape)} / s3 {tuple(s3.shape)} / s2 "
                         f"{tuple(s2.shape)} do not fit")
    if not fp4_chain_supported(w1, w2, M, CHAIN_KERNEL_TILE, CHAIN_KERNEL_TILE):
        raise ValueError(f"moe_fp4_chain kernel: M={M}, I={I}, D={D}, scale groups "
                         f"{S1} / {S2} are outside fp4_chain_supported")
    if (D // S1) % 32:
        raise ValueError(f"moe_fp4_chain kernel takes scale groups of a multiple of 32 "
                         f"values; got {D // S1}")
    if (any(t.dtype != torch.bfloat16 for t in (s1, s3, s2)) or idx.dtype != torch.int32):
        raise ValueError("moe_fp4_chain kernel takes bf16 scales and int32 idx")
    xb = x.to(torch.bfloat16).contiguous()
    for t in (xb, q1, s1, q3, s3, q2, s2, idx):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("moe_fp4_chain inputs must be contiguous, on one device")
    if any(t.data_ptr() % 16 for t in (xb, q1, q3, q2)):
        raise ValueError("moe_fp4_chain needs 16-byte aligned x and weights")
    act = torch.empty((M, I), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((M, D), dtype=torch.float32, device=x.device)
    if M == 0:
        return y
    lib = build.load("fp4_chain")
    err = lib.fp4_chain(xb.data_ptr(), q1.data_ptr(), s1.data_ptr(), q3.data_ptr(),
                        s3.data_ptr(), q2.data_ptr(), s2.data_ptr(), idx.data_ptr(),
                        act.data_ptr(), y.data_ptr(), M, E, I, D, S1, S2, float(limit),
                        int(perm13), torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("fp4_chain", err)
    launches += 1
    return y
