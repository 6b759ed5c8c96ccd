"""PyTorch ModelExecutor for Qwen3 over a device-resident paged KV pool.

Counterpart of ``pegainfer_tpu/engine/jax_executor.py`` for the plain
protocol: whole-prompt prefill with greedy / temperature / top-k / top-p
sampling, one decode token per step for the active batch, and the unified
step as prefills followed by one decode step. PyTorch runs eagerly, so there
are no compiled buckets; the decode batch is still padded to the JAX
executor's batch buckets (padding rows: null page, seq_len 0).

Not here yet, and refused with ``NotImplementedError``: chunked prefill, the
prefix cache, multi-token decode blocks, int8 weights and echo.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from pegainfer_tpu_torch.engine.contract import EngineLoadOptions, TokenLogprob
from pegainfer_tpu_torch.engine.executor import (
    DecodePlan,
    DecodeRequestResult,
    DecodeResult,
    PrefillPlan,
    PrefillRequestResult,
    PrefillResult,
    UnifiedPlan,
    UnifiedResult,
)
from pegainfer_tpu_torch.engine.kv import KvAccounting, PagePool
from pegainfer_tpu_torch.models import qwen3 as q3
from pegainfer_tpu_torch.ops import sampling as smp

log = logging.getLogger("pegainfer_torch.executor")

BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def bucket_batch(n: int) -> int:
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"batch {n} exceeds max bucket {BATCH_BUCKETS[-1]}")


def check_supported(opts: EngineLoadOptions) -> None:
    """Refuse the JAX engine's options the port does not implement yet."""
    unsupported = {
        "quantize": opts.quantize is not None,
        "enable_prefix_cache": opts.enable_prefix_cache,
        "prefill_chunk": opts.prefill_chunk is not None,
        "decode_block": opts.decode_block != 1,
    }
    named = [k for k, v in unsupported.items() if v]
    if named:
        raise NotImplementedError(
            "the PyTorch port does not support yet: " + ", ".join(named))
    if opts.max_batch_size > BATCH_BUCKETS[-1]:
        raise ValueError(f"max_batch_size above {BATCH_BUCKETS[-1]}")


def sample_tokens(logits, items) -> Tuple[List[int], torch.Tensor]:
    """Sample one token per row of ``logits`` [n, V] (on the device) by each
    item's params and ``random_val``. Returns (host tokens, device tokens)."""
    if all(it.params.is_greedy for it in items):
        toks = smp.sample_greedy(logits)
    else:
        def col(f, dtype):
            return torch.tensor([f(it) for it in items], dtype=dtype, device=logits.device)

        toks = smp.sample(
            logits,
            col(lambda it: it.params.temperature, torch.float32),
            col(lambda it: it.params.top_k, torch.int32),
            col(lambda it: it.params.top_p, torch.float32),
            col(lambda it: it.random_val, torch.float32),
        )
    return toks.tolist(), toks


def token_logprobs(logits, toks, items) -> List[Optional[TokenLogprob]]:
    """The logprob of each sampled token and the top ``item.logprobs``
    alternatives, for the items that ask for them (None elsewhere)."""
    out: List[Optional[TokenLogprob]] = [None] * len(items)
    n_top = max(it.logprobs for it in items)
    if n_top <= 0:
        return out
    chosen = smp.token_logprob(logits, toks).tolist()
    vals, ids = smp.top_logprobs(logits, n_top)
    vals, ids = vals.tolist(), ids.tolist()
    for i, it in enumerate(items):
        if it.logprobs > 0:
            out[i] = TokenLogprob(
                logprob=chosen[i],
                top_logprobs=[(ids[i][j], vals[i][j]) for j in range(it.logprobs)],
            )
    return out


class TorchExecutor:
    """Continuous-batching executor for one Qwen3 model on one device."""

    def __init__(self, cfg: q3.Qwen3Config, params, kv_pages: torch.Tensor,
                 options: Optional[EngineLoadOptions] = None):
        opts = options or EngineLoadOptions()
        check_supported(opts)
        self.cfg = cfg
        self.params = params
        self.kv_pages = kv_pages
        self.device = kv_pages.device
        self._page_size = kv_pages.shape[4]
        self.acct = KvAccounting(PagePool(kv_pages.shape[2]), self._page_size)
        self.max_batch = opts.max_batch_size
        max_model_len = opts.max_model_len or cfg.max_position_embeddings
        self._max_pages = min(self.acct.pool.available,
                              -(-max_model_len // self._page_size))
        self._stop_ids = frozenset(cfg.stop_token_ids)
        # what ran, for callers that check the path (chip_smoke.py)
        self.prefills = 0
        self.decode_steps = 0

    # ── scheduler-facing accounting ──────────────────────────────────

    def page_size(self) -> int:
        return self._page_size

    def available_pages(self) -> int:
        return self.acct.pool.available

    def max_request_pages(self) -> int:
        return self._max_pages

    def is_stop_token(self, token_id: int) -> bool:
        return token_id in self._stop_ids

    def release_request(self, request_id: int) -> None:
        self.acct.release(request_id)

    # ── prefill ──────────────────────────────────────────────────────

    def _prefill_one(self, item) -> PrefillRequestResult:
        if item.echo:
            raise NotImplementedError("echo is not supported by the PyTorch port yet")
        T = len(item.prompt_tokens)
        st = self.acct.state(item.request_id)
        st.ensure_capacity(self.acct.pool, T)
        tokens = torch.tensor(item.prompt_tokens, dtype=torch.int32, device=self.device)
        table = torch.tensor(st.pages, dtype=torch.int32, device=self.device)
        last_logits, _ = q3.prefill(self.cfg, self.params, self.kv_pages, tokens, table)
        st.advance(T)
        self.prefills += 1
        logits = last_logits[None, :]
        host, dev = sample_tokens(logits, [item])
        return PrefillRequestResult(
            request_id=item.request_id,
            first_token=host[0],
            first_token_logprob=token_logprobs(logits, dev, [item])[0],
        )

    def execute_prefill(self, plan: PrefillPlan) -> PrefillResult:
        return PrefillResult(requests=[self._prefill_one(it) for it in plan.requests])

    # ── decode ───────────────────────────────────────────────────────

    def _decode_inputs(self, items):
        """Host-side batch assembly: one more token per request, the batch
        padded to its bucket with dead rows."""
        B = bucket_batch(len(items))
        tokens = np.zeros(B, np.int32)
        positions = np.zeros(B, np.int32)
        seq_lens = np.zeros(B, np.int32)
        states = []
        for i, it in enumerate(items):
            st = self.acct.state(it.request_id)
            pos = st.length
            st.ensure_capacity(self.acct.pool, pos + 1)
            states.append(st)
            tokens[i] = it.token_id
            positions[i] = pos
            seq_lens[i] = pos + 1
        P = max(len(st.pages) for st in states)
        tables = np.full((B, P), PagePool.NULL_PAGE, np.int32)
        for i, st in enumerate(states):
            tables[i, : len(st.pages)] = st.pages
        dev = [torch.from_numpy(a).to(self.device)
               for a in (tokens, positions, tables, seq_lens)]
        return dev, states

    def execute_decode(self, plan: DecodePlan) -> DecodeResult:
        items = plan.requests
        if not items:
            return DecodeResult()
        if len(items) > self.max_batch:
            head = self.execute_decode(DecodePlan(requests=items[: self.max_batch]))
            tail = self.execute_decode(DecodePlan(requests=items[self.max_batch:]))
            return DecodeResult(requests=head.requests + tail.requests)
        (tokens, positions, tables, seq_lens), states = self._decode_inputs(items)
        logits = q3.decode(self.cfg, self.params, self.kv_pages, tokens, positions,
                           tables, seq_lens)
        for st in states:
            st.advance(1)
        self.decode_steps += 1
        logits = logits[: len(items)]
        host, dev = sample_tokens(logits, items)
        lps = token_logprobs(logits, dev, items)
        return DecodeResult(requests=[
            DecodeRequestResult(request_id=it.request_id, token=host[i], logprob=lps[i])
            for i, it in enumerate(items)
        ])

    # ── unified ──────────────────────────────────────────────────────

    def execute_unified(self, plan: UnifiedPlan) -> UnifiedResult:
        """Prefill the new prompts, then one decode step for the active set."""
        prefill = self.execute_prefill(PrefillPlan(requests=plan.prefill_requests))
        decode = self.execute_decode(DecodePlan(requests=plan.decode_requests))
        return UnifiedResult(prefill_requests=prefill.requests,
                             decode_requests=decode.requests)
