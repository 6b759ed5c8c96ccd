"""RMSNorm (counterpart of ``pegainfer_tpu/ops/norm.py::rms_norm``).

Numerics match HF Qwen3RMSNorm: accumulate in f32, rsqrt, cast back to the
input dtype, then multiply by the (input-dtype) weight.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """x: [..., D]; weight: [D]."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * weight
