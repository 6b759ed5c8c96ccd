"""Rotary position embeddings, GPT-NeoX rotate-half form as in HF Qwen3
(counterpart of ``pegainfer_tpu/ops/rope.py``).

cos/sin are computed in f32 then cast to the activation dtype before the
multiply, matching HF.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_inv_freq(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor, dtype) -> tuple:
    """positions: [...]; inv_freq: [hd/2] f32. Returns cos, sin: [..., hd]."""
    freqs = positions[..., None].float() * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., H, hd]; cos/sin: [..., hd] (broadcast over the head axis)."""
    c = cos[..., None, :]
    s = sin[..., None, :]
    return x * c + rotate_half(x) * s
