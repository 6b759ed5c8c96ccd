"""RMSNorm variants (counterpart of ``pegainfer_tpu/ops/norm.py``).

``rms_norm`` matches HF Qwen3RMSNorm: accumulate in f32, rsqrt, cast back to
the input dtype, then multiply by the (input-dtype) weight.
``rms_norm_zero_centered`` is the Qwen3Next / Qwen3.5 form.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """x: [..., D]; weight: [D]."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * weight


def rms_norm_zero_centered(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma-style RMSNorm of Qwen3Next / Qwen3.5 (HF Qwen3NextRMSNorm): the
    scale is ``1 + weight``, multiplied in f32 BEFORE the cast back."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + weight.float())).to(x.dtype)
