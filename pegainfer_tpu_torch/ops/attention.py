"""Paged-KV attention: plain PyTorch versions (counterpart of
``pegainfer_tpu/ops/attention.py``).

These are the oracles of the two hand-written kernels in ``ops/cuda`` and
the path every CPU tensor takes. Layouts are the JAX package's:

- per layer, ``k_pages, v_pages: [Hkv, num_pages, page_size, hd]``;
- the engine's full pool is ``[L, Hkv, pages, 2, page_size, hd]`` (k and v
  of a page adjacent); ``pool[l, :, :, 0]`` and ``pool[l, :, :, 1]`` are the
  per-layer k and v views;
- token ``t`` of a request lives at page ``table[t // page_size]``, slot
  ``t % page_size``; page id 0 is the null page.

All softmax math in f32; outputs cast back to the query dtype.
"""

from __future__ import annotations

import torch

NEG_INF = torch.finfo(torch.float32).min


def paged_attention_decode(q, k_pages, v_pages, page_tables, seq_lens, scale,
                           cur_k=None, cur_v=None):
    """GQA decode attention over paged KV.

    q: [B, Hq, hd]; k_pages/v_pages: [Hkv, num_pages, ps, hd];
    page_tables: [B, P] int32; seq_lens: [B] int32 — valid tokens INCLUDING
    the current one. With ``cur_k/cur_v`` ([B, Hkv, hd]) the current token's
    k/v come from these tensors and the pages hold only the first
    seq_len-1 tokens. Rows with seq_len 0 are dead and return 0, as the
    kernel does. Returns [B, Hq, hd] in q.dtype.
    """
    B, Hq, hd = q.shape
    P = page_tables.shape[1]
    Hkv, _, ps, _ = k_pages.shape
    G = Hq // Hkv
    S = P * ps
    tables = page_tables.long()
    seq_lens = seq_lens.long()

    # [Hkv, B, P, ps, hd] -> [B, Hkv, S, hd]
    k = k_pages[:, tables].reshape(Hkv, B, S, hd).transpose(0, 1).float()
    v = v_pages[:, tables].reshape(Hkv, B, S, hd).transpose(0, 1).float()
    past = seq_lens if cur_k is None else torch.clamp(seq_lens - 1, min=0)
    qg = q.reshape(B, Hkv, G, hd).float()
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k) * scale  # [B, Hkv, G, S]
    pos = torch.arange(S, device=q.device)
    mask = pos[None, None, None, :] < past[:, None, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    if cur_k is not None:
        s_cur = torch.einsum("bhgd,bhd->bhg", qg, cur_k.float())[..., None] * scale
        scores = torch.cat([scores, s_cur], dim=-1)
        v = torch.cat([v, cur_v.float()[:, :, None, :]], dim=2)  # [B, Hkv, S+1, hd]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", probs, v).reshape(B, Hq, hd)
    out = torch.where((seq_lens > 0)[:, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def causal_attention(q, k, v, kv_valid, q_offset, scale):
    """Causal GQA attention with queries at absolute positions
    ``q_offset + i`` over keys ``[S, Hkv, hd]`` of which the first
    ``kv_valid`` are valid: the function the flash-prefill kernel computes.

    q: [T, Hq, hd]. Returns [T, Hq, hd] in q.dtype; rows whose absolute
    position is >= kv_valid hold garbage.
    """
    T, Hq, hd = q.shape
    S, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(T, Hkv, G, hd).float()
    scores = torch.einsum("thgd,shd->thgs", qg, k.float()) * scale  # [T, Hkv, G, S]
    key_pos = torch.arange(S, device=q.device)[None, None, None, :]
    q_pos = q_offset + torch.arange(T, device=q.device)[:, None, None, None]
    mask = (key_pos <= q_pos) & (key_pos < kv_valid)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("thgs,shd->thgd", probs, v.float())
    return out.reshape(T, Hq, hd).to(q.dtype)


def prefill_attention(q, k, v, seq_len, scale):
    """Causal self-attention over one prompt. q: [T, Hq, hd]; k, v:
    [T, Hkv, hd]; rows past seq_len produce garbage."""
    return causal_attention(q, k, v, seq_len, 0, scale)


def chunk_attention_seq(q, k_seq, v_seq, start_pos, scale):
    """Prefill-continuation attention over explicit key/value sequences:
    q [Tc, Hq, hd] at absolute positions start_pos + i; k_seq/v_seq
    [S, Hkv, hd] laid out by absolute position (entries past the chunk are
    causally masked)."""
    return causal_attention(q, k_seq, v_seq, k_seq.shape[0], start_pos, scale)
