"""Slot executor: the ModelExecutor for a page-less model (DeepSeek-V4).

The port's counterpart of what ``pegainfer_tpu/engine/jax_executor.py`` does
for the DSv4 runtime (``models/dsv4_engine.py::make_runtime``). DSv4 keeps
no paged KV: each request owns a decode slot (window ring, compressed rows,
pending projection rings), so the page accounting degenerates to page size
1 with a budget of ``max_model_len * max_slots + 2`` pages, and admission
is bound by the slots, which the scheduler gates on ``free_slots()``.

Whole-prompt prefill writes the request's slot in place; a decode step runs
the active requests with the batch padded to its bucket by dead-slot rows
at position 0. Sampling and logprobs are ``TorchExecutor``'s.

``quantize="int8-experts"`` serves experts requantized to int8 at load
(``models/dsv4_engine.py``); ``moe_chain`` is handed to every prefill and
decode step (``models/dsv4.py``). Not here yet, and refused with
``NotImplementedError``: bf16 weights (dequantized at load), the slot
prefix cache, chunked prefill, multi-token decode blocks and echo.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pegainfer_tpu_torch.engine.contract import EngineLoadOptions
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
from pegainfer_tpu_torch.engine.slots import StateSlots
from pegainfer_tpu_torch.engine.torch_executor import (
    bucket_batch,
    sample_tokens,
    token_logprobs,
)
from pegainfer_tpu_torch.models import dsv4


def check_supported(opts: EngineLoadOptions) -> None:
    """Refuse the JAX DSv4 engine's options the port does not implement."""
    unsupported = {
        f"quantize={opts.quantize!r}": opts.quantize not in (None, "int8-experts"),
        "enable_prefix_cache (slot prefix cache)": opts.enable_prefix_cache,
        "prefill_chunk": opts.prefill_chunk is not None,
        "decode_block": opts.decode_block != 1,
    }
    named = [k for k, v in unsupported.items() if v]
    if named:
        raise NotImplementedError(
            "the PyTorch port's DeepSeek-V4 engine does not support yet: " + ", ".join(named))


class SlotExecutor(StateSlots):
    """Continuous-batching executor for one DSv4 model with per-slot state
    on one device."""

    def __init__(self, cfg: dsv4.DSv4Config, params, state, max_slots: int,
                 max_model_len: int, options: Optional[EngineLoadOptions] = None,
                 moe_chain: Optional[bool] = None):
        opts = options or EngineLoadOptions()
        check_supported(opts)
        self.cfg = cfg
        self.params = params
        self.moe_chain = moe_chain
        self.state = state
        self.device = params["embed"].device
        self._init_slots(max_slots)
        self.acct = KvAccounting(PagePool(max_model_len * max_slots + 2), 1)
        self.max_batch = min(opts.max_batch_size, max_slots)
        self._max_pages = min(self.acct.pool.available, max_model_len)
        self._stop_ids = frozenset({cfg.eos_token_id})
        # what ran, for callers that check the path (chip_smoke.py)
        self.prefills = 0
        self.decode_steps = 0

    # ── scheduler-facing accounting ──────────────────────────────────

    def page_size(self) -> int:
        return 1

    def available_pages(self) -> int:
        return self.acct.pool.available

    def max_request_pages(self) -> int:
        return self._max_pages

    def is_stop_token(self, token_id: int) -> bool:
        return token_id in self._stop_ids

    # ── prefill ──────────────────────────────────────────────────────

    def _prefill_one(self, item) -> PrefillRequestResult:
        if item.echo:
            raise NotImplementedError("echo is not supported by the PyTorch port yet")
        T = len(item.prompt_tokens)
        st = self.acct.state(item.request_id)
        st.ensure_capacity(self.acct.pool, T)
        slot = self._slot(item.request_id)
        tokens = torch.tensor(item.prompt_tokens, dtype=torch.int32, device=self.device)
        logits, _ = dsv4.prefill(self.cfg, self.params, tokens, state=self.state,
                                 slot=slot, last_only=True, moe_chain=self.moe_chain)
        st.advance(T)
        self.prefills += 1
        host, dev = sample_tokens(logits, [item])
        return PrefillRequestResult(
            request_id=item.request_id, first_token=host[0],
            first_token_logprob=token_logprobs(logits, dev, [item])[0])

    def execute_prefill(self, plan: PrefillPlan) -> PrefillResult:
        return PrefillResult(requests=[self._prefill_one(it) for it in plan.requests])

    # ── decode ───────────────────────────────────────────────────────

    def _decode_inputs(self, items):
        """One more token per request; padding rows take the dead slot at
        position 0."""
        B = bucket_batch(len(items))
        tokens = np.zeros(B, np.int32)
        positions = np.zeros(B, np.int32)
        slots = np.full(B, self.max_slots, np.int32)
        states = []
        for i, it in enumerate(items):
            st = self.acct.state(it.request_id)
            st.ensure_capacity(self.acct.pool, st.length + 1)
            states.append(st)
            tokens[i], positions[i] = it.token_id, st.length
            slots[i] = self._slot(it.request_id)
        dev = [torch.from_numpy(a).to(self.device) for a in (tokens, positions, slots)]
        return dev, states

    def execute_decode(self, plan: DecodePlan) -> DecodeResult:
        items = plan.requests
        if not items:
            return DecodeResult()
        if len(items) > self.max_batch:
            raise RuntimeError(f"decode batch {len(items)} exceeds the {self.max_batch} slots")
        (tokens, positions, slots), states = self._decode_inputs(items)
        logits = dsv4.decode(self.cfg, self.params, self.state, tokens, positions, slots,
                             moe_chain=self.moe_chain)
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
