"""On-device sampling: greedy argmax and temperature/top-k/top-p
(counterpart of ``pegainfer_tpu/ops/sampling.py``).

temperature == 0 -> greedy top-1; otherwise softmax(logits/temperature) ->
top-k filter -> top-p (nucleus) filter -> draw with one uniform
``random_val`` per request by inverse CDF, so the draw is a pure function of
logits and random_val and matches the JAX package for the same random_val.
The descending sort is stable, so ties break toward the lower token id as
``lax.top_k`` does (``torch.topk`` gives no such guarantee).
"""

from __future__ import annotations

import torch


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits: [B, V] -> [B] int32 (first index of the maximum)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits, temperature, top_k, top_p, random_val):
    """General sampling. logits: [B, V]; the rest: [B] tensors.

    top_k <= 0 disables the top-k filter; top_p >= 1.0 disables nucleus.
    Greedy rows (temperature == 0) take argmax exactly.
    """
    B, V = logits.shape
    lf = logits.float()
    greedy = temperature <= 0.0
    greedy_tok = torch.argmax(lf, dim=-1).to(torch.int32)

    safe_t = torch.where(greedy, torch.ones_like(temperature), temperature)[:, None]
    probs = torch.softmax(lf / safe_t, dim=-1)

    sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    cum = torch.cumsum(sorted_probs, dim=-1)
    rank = torch.arange(V, device=logits.device)[None, :]

    k_mask = (top_k[:, None] <= 0) | (rank < top_k[:, None])
    # nucleus: keep entries whose exclusive prefix sum is still < top_p
    # (the first entry is always kept)
    p_mask = (cum - sorted_probs) < top_p[:, None]
    filt = torch.where(k_mask & p_mask, sorted_probs, torch.zeros_like(sorted_probs))

    cum_filt = torch.cumsum(filt, dim=-1)
    total = cum_filt[:, -1:]
    r = random_val[:, None] * total
    # inverse CDF: first entry with cum_filt > r
    pick = torch.clamp((cum_filt <= r).sum(dim=-1), max=V - 1)
    # the picked entry must be an unfiltered one: clamp to the last kept index
    last_kept = torch.clamp((filt > 0.0).sum(dim=-1) - 1, min=0)
    pick = torch.minimum(pick, last_kept)
    sampled_tok = torch.gather(sorted_idx, 1, pick[:, None])[:, 0]
    return torch.where(greedy, greedy_tok, sampled_tok.to(torch.int32))


def token_logprob(logits, tokens):
    """log_softmax(logits)[token] per row. logits: [B, V], tokens: [B] -> [B] f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, 1, tokens[:, None].long())[:, 0]


def top_logprobs(logits, n: int):
    """Top-n (logprob, token) per row. Returns (values [B, n] f32, ids [B, n] i32)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    vals, ids = torch.sort(logp, dim=-1, descending=True, stable=True)
    return vals[:, :n], ids[:, :n].to(torch.int32)
