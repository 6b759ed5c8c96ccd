"""DeepSeek sparse attention (DSA) building blocks.

The port's counterpart of ``pegainfer_tpu/ops/dsa.py`` (same math and
names): interleaved-pair RoPE with the YaRN correction, fp8 storage
rounding of the non-rope dims, the KV compressors (non-overlap and the
overlapping ratio-4 form), window index lists, the lightning indexer with
its strict-">" top-k, and the sparse attention core with a per-head sink
logit. The attention stays plain torch: the JAX package computes it outside
any Pallas kernel.

Top-k tie contract: a higher score wins, and among equal scores the lower
candidate index. ``torch.topk`` does not promise that order, so every
selection here goes through a stable descending ``torch.sort``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pegainfer_tpu_torch.ops.quant import FP8_MAX, round_scale_pow2

NEG_INF = float(torch.finfo(torch.float32).min)
_DEAD = -3.0e38  # logits at or below it are masked candidates


# ── RoPE (interleaved pairs, YaRN) ───────────────────────────────────────


def yarn_inv_freq(rotary_dim: int, base: float, factor: float, beta_fast: float,
                  beta_slow: float, original_seq_len: int) -> np.ndarray:
    """Inverse frequencies with the YaRN correction; original_seq_len == 0
    disables it."""
    half = rotary_dim // 2
    inv = 1.0 / base ** (np.arange(half) * 2.0 / rotary_dim)
    if original_seq_len > 0:
        def corr_dim(n_rot):
            return (rotary_dim * math.log(original_seq_len / (n_rot * 2 * math.pi))
                    / (2 * math.log(base)))

        low = max(math.floor(corr_dim(beta_fast)), 0)
        high = min(math.ceil(corr_dim(beta_slow)), rotary_dim - 1)
        if abs(high - low) < np.finfo(np.float32).eps:
            high = high + 0.001
        ramp = np.clip((np.arange(half) - low) / (high - low), 0.0, 1.0)
        smooth = 1.0 - ramp
        inv = inv / factor * (1 - smooth) + inv * smooth
    return inv.astype(np.float32)


def rope_interleaved(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
                     rotary_dim: int) -> torch.Tensor:
    """Rotate the last ``rotary_dim`` dims of x as interleaved pairs.
    x: [..., D]; positions broadcastable to x.shape[:-1]."""
    nope = x.shape[-1] - rotary_dim
    x_pass, x_rot = x[..., :nope], x[..., nope:]
    pairs = x_rot.reshape(*x_rot.shape[:-1], rotary_dim // 2, 2)
    ang = positions[..., None].float() * inv_freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x0, x1 = pairs[..., 0].float(), pairs[..., 1].float()
    rot = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return torch.cat([x_pass, rot.reshape(x_rot.shape).to(x.dtype)], dim=-1)


def fp8_round_nope(x: torch.Tensor, rotary_dim: int, group: int = 64) -> torch.Tensor:
    """Round the non-rope dims through E4M3 with a power-of-two scale per
    group of ``group`` dims (the cache's storage rounding)."""
    nope = x.shape[-1] - rotary_dim
    if nope == 0:
        return x
    group = min(group, nope)
    x_nope, x_rot = x[..., :nope], x[..., nope:]
    g = x_nope.float().reshape(*x_nope.shape[:-1], nope // group, group)
    scale = round_scale_pow2(g.abs().amax(dim=-1, keepdim=True), FP8_MAX)
    q = (g / scale).to(torch.float8_e4m3fn).float() * scale
    return torch.cat([q.reshape(x_nope.shape).to(x.dtype), x_rot], dim=-1)


# ── KV compressor ────────────────────────────────────────────────────────


def compress_scores_values(x, wkv, wgate):
    """x: [T, D] -> (scores, values): [T, out_dim] f32."""
    return (x @ wgate.T).float(), (x @ wkv.T).float()


def _rms_norm_f32(w, norm_w, eps):
    inv = torch.rsqrt((w * w).mean(dim=-1, keepdim=True) + eps)
    return w * inv * norm_w.float()


def compress_nonoverlap(scores, values, ape, norm_w, ratio: int, eps: float):
    """Per-dim softmax over each group of ``ratio`` tokens.
    scores/values: [T, hd] f32; ape: [ratio, hd]. Returns [T // ratio, hd]."""
    C, hd = scores.shape[0] // ratio, scores.shape[1]
    s = scores[: C * ratio].reshape(C, ratio, hd) + ape.float()[None]
    v = values[: C * ratio].reshape(C, ratio, hd)
    w = (torch.softmax(s, dim=1) * v).sum(dim=1)
    return _rms_norm_f32(w, norm_w, eps)


def compress_overlap(scores, values, ape, norm_w, eps: float):
    """Overlap (ratio 4) compressor: 8 routes per block, 4 from the previous
    group reading dims [0:hd] and 4 from the current group reading dims
    [hd:2hd]; block 0 has no previous group.
    scores/values: [T, 2*hd] f32; ape: [4, 2*hd]. Returns [T // 4, hd]."""
    ratio = 4
    two_hd = scores.shape[1]
    hd = two_hd // 2
    C = scores.shape[0] // ratio
    s = scores[: C * ratio].reshape(C, ratio, two_hd) + ape.float()[None]
    v = values[: C * ratio].reshape(C, ratio, two_hd)
    dev = scores.device
    s_prev = torch.cat([torch.full((1, ratio, hd), NEG_INF, device=dev), s[:-1, :, :hd]])[:C]
    v_prev = torch.cat([torch.zeros((1, ratio, hd), device=dev), v[:-1, :, :hd]])[:C]
    s_all = torch.cat([s_prev, s[:, :, hd:]], dim=1)  # [C, 8, hd]
    v_all = torch.cat([v_prev, v[:, :, hd:]], dim=1)
    w = (torch.softmax(s_all, dim=1) * v_all).sum(dim=1)
    return _rms_norm_f32(w, norm_w, eps)


def compress_block_nonoverlap(sg, vg, ape, norm_w, eps: float):
    """Single-block decode emission. sg/vg: [..., ratio, hd] f32; ape:
    [ratio, hd]. Returns [..., hd]: the math of compress_nonoverlap."""
    w = (torch.softmax(sg + ape.float(), dim=-2) * vg).sum(dim=-2)
    return _rms_norm_f32(w, norm_w, eps)


def compress_block_overlap(s_prev, v_prev, s_cur, v_cur, ape, norm_w, eps: float,
                           has_prev):
    """Single-block overlap (ratio 4) emission. s_prev/v_prev: [..., 4, 2*hd]
    of the previous group's tokens; s_cur/v_cur: the current group's; ape:
    [4, 2*hd]; has_prev: [...] bool. Returns [..., hd]: the math of
    compress_overlap."""
    hd = s_cur.shape[-1] // 2
    apef = ape.float()
    mask = has_prev[..., None, None]
    sp = torch.where(mask, s_prev[..., :hd] + apef[:, :hd], NEG_INF)
    vp = torch.where(mask, v_prev[..., :hd], 0.0)
    s_all = torch.cat([sp, s_cur[..., hd:] + apef[:, hd:]], dim=-2)  # [..., 8, hd]
    v_all = torch.cat([vp, v_cur[..., hd:]], dim=-2)
    w = (torch.softmax(s_all, dim=-2) * v_all).sum(dim=-2)
    return _rms_norm_f32(w, norm_w, eps)


# ── Index generation ─────────────────────────────────────────────────────


def window_indices(seq_len: int, window: int, device="cpu") -> torch.Tensor:
    """Prefill window index lists [T, window]: for query i, keys
    [max(i - window + 1, 0) .. i], -1 padded."""
    t = torch.arange(seq_len, device=device)[:, None]
    r = torch.arange(window, device=device)[None, :]
    key = torch.clamp(t - (window - 1), min=0) + r
    return torch.where(key <= t, key, -1).to(torch.int32)


# ── Lightning indexer ────────────────────────────────────────────────────


def indexer_scores(q_idx, ck, w, scale: float):
    """q_idx: [T, H, dk]; ck: [C, dk]; w: [T, H] -> scores [T, C] f32 =
    scale * sum_h w[t, h] * relu(q[t, h] . ck[c])."""
    dots = torch.einsum("thd,cd->thc", q_idx.float(), ck.float())
    return torch.einsum("th,thc->tc", w.float(), torch.relu(dots)) * scale


def _masked(scores, valid_counts):
    cand = torch.arange(scores.shape[1], device=scores.device)[None, :]
    counts = torch.as_tensor(valid_counts, device=scores.device)
    return torch.where(cand < counts[:, None], scores, NEG_INF)


def topk_select(scores, k: int, valid_counts):
    """Strict-">" top-k in candidate space: (ids [T, k] int32, valid [T, k]
    bool), the lower index first among equal scores."""
    k = min(k, scores.shape[1])
    vals, ids = torch.sort(_masked(scores, valid_counts), dim=-1, descending=True,
                           stable=True)
    return ids[:, :k].to(torch.int32), vals[:, :k] > _DEAD


def topk_mask(scores, k: int, valid_counts):
    """Top-k membership mask [T, C] bool under topk_strict's contract: the
    k-th value from a descending sort, then everything strictly above it
    plus the lowest-index ties that fill the remaining slots."""
    k = min(k, scores.shape[1])
    masked = _masked(scores, valid_counts)
    kth = torch.sort(masked, dim=-1, descending=True).values[:, k - 1:k]
    above = masked > kth
    eq = masked == kth
    n_above = above.sum(dim=-1, keepdim=True)
    tie_rank = torch.cumsum(eq.int(), dim=-1)
    sel = above | (eq & (tie_rank <= k - n_above))
    return sel & (masked > _DEAD)


def topk_strict(scores, k: int, valid_counts, offset):
    """Strict-">" top-k with lowest-index tie-break: [T, k] int32 indices
    plus ``offset``, -1 padded."""
    T, C = scores.shape
    masked = _masked(scores, valid_counts)
    picked, order = torch.sort(masked, dim=-1, descending=True, stable=True)
    picked, order = picked[:, :k], order[:, :k]
    off = torch.as_tensor(offset, device=scores.device).expand(T)[:, None]
    out = torch.where(picked > _DEAD, order + off, -1).to(torch.int32)
    if k > C:  # fewer candidates than k: -1 padding
        out = torch.nn.functional.pad(out, (0, k - C), value=-1)
    return out


# ── Sparse attention core ────────────────────────────────────────────────


def sparse_attention_parts(q, parts, sink, scale: float):
    """Joint softmax attention over several candidate row sets without
    concatenating them.

    q: [T, h, d]; parts: sequence of (rows, valid [T, K] bool), rows either
    [T, K, d] (per-query candidates) or [K, d] (a set every query scores,
    selection by the mask); sink: [h] f32. Returns [T, h, d] in q.dtype.
    bf16 inputs keep the reference's numerics: bf16 products accumulated in
    f32 (computed here as f32 products of the exact bf16 values), p rounded
    to bf16 before it multiplies the rows; f32 inputs stay f32.
    """
    sinkf = sink.float()[None, :]  # [1, h]
    bf16 = q.dtype == torch.bfloat16
    qf = q.float()
    logits = []
    for rows, valid in parts:
        rf = rows.to(torch.bfloat16).float() if bf16 else rows.float()
        eq = "thd,kd->thk" if rows.dim() == 2 else "thd,tkd->thk"
        s = torch.einsum(eq, qf, rf) * scale
        logits.append((torch.where(valid[:, None, :], s, NEG_INF), rf, valid))
    m = sinkf
    for s, _, _ in logits:
        if s.shape[-1]:  # a part may have no candidates (a short prompt)
            m = torch.maximum(m, s.amax(dim=-1))  # [T, h]
    num = 0.0
    denom = torch.exp(sinkf - m)
    for s, rf, valid in logits:
        p = torch.where(valid[:, None, :], torch.exp(s - m[..., None]), 0.0)
        eq = "thk,kd->thd" if rf.dim() == 2 else "thk,tkd->thd"
        pr = p.to(torch.bfloat16).float() if bf16 else p
        num = num + torch.einsum(eq, pr, rf)
        denom = denom + p.sum(dim=-1)
    return (num / denom[..., None]).to(q.dtype)


def sparse_attention(q, kv, idx, sink, scale: float):
    """q: [T, h, d]; kv: [N, d] joint key = value rows; idx: [T, K] int32
    (-1 masked); sink: [h] f32 -> [T, h, d] in q.dtype."""
    gathered = kv[torch.clamp(idx, min=0).long()]  # [T, K, d]
    return sparse_attention_parts(q, [(gathered, idx >= 0)], sink, scale)
