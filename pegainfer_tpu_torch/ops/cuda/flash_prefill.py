"""Causal GQA flash attention for prefill: kernel K2 (``csrc/flash_prefill.cu``).

Replaces the TPU kernel ``pegainfer_tpu/ops/pallas/flash_prefill.py::
flash_attention`` (and its ``flash_prefill`` wrapper). The wrapper dispatches
on the device of ``q``: a CPU tensor takes the plain version
(``ops.attention.causal_attention``), a CUDA tensor launches the kernel or
raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from pegainfer_tpu_torch.ops import attention as att
from pegainfer_tpu_torch.ops.cuda import build

launches = 0

HEAD_DIMS = (64, 128, 256)
ROWS_PER_BLOCK = 64  # query (head, position) rows of one block; G must divide it


def flash_attention(q, k, v, kv_valid: int, q_offset: int, scale: float):
    """Causal GQA attention: q [T, Hq, hd] at absolute positions
    q_offset + i over k/v [S, Hkv, hd] with ``kv_valid`` valid rows.
    Returns [T, Hq, hd]; rows whose absolute position >= kv_valid hold
    garbage."""
    if q.device.type == "cpu":
        return att.causal_attention(q, k, v, kv_valid, q_offset, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k, v, int(kv_valid), int(q_offset), scale)


def flash_prefill(q, k, v, seq_len: int, scale: float):
    """Whole-prompt causal flash attention (q_offset = 0)."""
    return flash_attention(q, k, v, seq_len, 0, scale)


def _launch(q, k, v, kv_valid, q_offset, scale):
    global launches
    T, Hq, hd = q.shape
    S, Hkv, _ = k.shape
    if v.shape != k.shape or k.shape[2] != hd or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit")
    G = Hq // Hkv
    if hd not in HEAD_DIMS or ROWS_PER_BLOCK % G:
        raise ValueError(f"flash prefill kernel takes hd in {HEAD_DIMS} and G "
                         f"dividing {ROWS_PER_BLOCK}, got hd={hd} G={G}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError("flash prefill kernel takes contiguous bf16 tensors "
                             "on one device")
    out = torch.empty_like(q)
    if T == 0:
        return out
    lib = build.load("flash_prefill")
    err = lib.flash_prefill_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        T, S, Hkv, G, hd, kv_valid, q_offset, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch("flash_prefill", err)
    launches += 1
    return out
