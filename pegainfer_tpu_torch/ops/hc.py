"""Hyper-connections: the DeepSeek-V4 widened residual stream.

The port's counterpart of ``pegainfer_tpu/ops/hc.py`` (same math and
names): the stream is ``n = hc_mult`` copies of the hidden state,
x [T, n, D]. Per branch, an RMS-normalized linear read of the stream gives
(2 + n) * n mixes, split into pre weights (sigmoid), post weights
(2 * sigmoid) and an n x n combination made doubly stochastic by Sinkhorn
iterations. All hc math runs in f32.
"""

from __future__ import annotations

import torch


def hc_expand(x: torch.Tensor, n: int) -> torch.Tensor:
    """[T, D] -> [T, n, D] (replicate into n streams)."""
    return x[:, None, :].expand(x.shape[0], n, x.shape[1])


def hc_mixes(x: torch.Tensor, hc_fn: torch.Tensor, eps: float) -> torch.Tensor:
    """x: [T, n, D]; hc_fn: [mix_hc, n*D] f32 -> mixes [T, mix_hc] f32."""
    flat = x.reshape(x.shape[0], -1).float()
    rms = torch.rsqrt((flat * flat).mean(dim=-1, keepdim=True) + eps)
    return (flat @ hc_fn.float().T) * rms


def hc_split_sinkhorn(mixes, scale, base, n: int, iters: int, eps: float):
    """mixes [T, mix_hc]; scale [3]; base [mix_hc].
    Returns (pre [T, n], post [T, n], comb [T, n, n])."""
    m, scale, base = mixes.float(), scale.float(), base.float()
    pre = torch.sigmoid(m[:, :n] * scale[0] + base[:n]) + eps
    post = 2.0 * torch.sigmoid(m[:, n:2 * n] * scale[1] + base[n:2 * n])
    comb = (m[:, 2 * n:] * scale[2] + base[2 * n:]).reshape(-1, n, n)
    # first pass: row softmax + eps, then column normalize with +eps
    comb = torch.softmax(comb, dim=-1) + eps
    comb = comb / (comb.sum(dim=-2, keepdim=True) + eps)
    for _ in range(iters - 1):
        comb = comb / (comb.sum(dim=-1, keepdim=True) + eps)
        comb = comb / (comb.sum(dim=-2, keepdim=True) + eps)
    return pre, post, comb


def hc_pre(x, pre):
    """x: [T, n, D]; pre: [T, n] -> [T, D] (combined layer input)."""
    return torch.einsum("tn,tnd->td", pre, x.float()).to(x.dtype)


def hc_post(layer_out, residual, post, comb):
    """layer_out: [T, D]; residual: [T, n, D]; post: [T, n]; comb: [T, n, n]
    -> new stream [T, n, D]: out[k] = post[k] * layer_out + sum_j comb[j, k]
    * residual[j]."""
    res = torch.einsum("tjk,tjd->tkd", comb, residual.float())
    out = res + post[:, :, None] * layer_out.float()[:, None, :]
    return out.to(residual.dtype)


def hc_head_pre(mixes, scale, base, n: int, eps: float):
    """Final head combine weights from the first n mixes:
    pre[j] = sigmoid(mix[j] * scale0 + base[j]) + eps."""
    return torch.sigmoid(mixes[:, :n].float() * scale.float()[0] + base.float()[:n]) + eps
