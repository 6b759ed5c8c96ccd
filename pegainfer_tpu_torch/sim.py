"""Simulated engine: a host-only fake executor behind the port's scheduler,
counterpart of ``pegainfer_tpu/sim.py``. It implements the
``ModelExecutor`` protocol (so the real scheduler, admission control and
channel plumbing all run) and emits a deterministic token stream with a
configurable TTFT / TPOT; no device is touched.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

from pegainfer_tpu_torch.engine.contract import EngineHandle, EngineLoadOptions
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
from pegainfer_tpu_torch.engine.scheduler import start_scheduler


@dataclass
class SimulatedEngineConfig:
    ttft_s: float = 0.0
    tpot_s: float = 0.0
    page_size: int = 16
    num_pages: int = 4096
    vocab_size: int = 1000
    eos_token_id: int = 1
    # emit EOS after this many tokens when the request would otherwise run
    # forever (0 = never)
    eos_after: int = 0


class SimExecutor:
    """Deterministic fake: token(t) = (prompt_sum + step) % vocab."""

    def __init__(self, cfg: SimulatedEngineConfig):
        self.cfg = cfg
        self.acct = KvAccounting(PagePool(cfg.num_pages), cfg.page_size)
        self._step_count: Dict[int, int] = {}
        self._seeds: Dict[int, int] = {}

    def page_size(self) -> int:
        return self.cfg.page_size

    def available_pages(self) -> int:
        return self.acct.pool.available

    def max_request_pages(self) -> int:
        return self.cfg.num_pages - 1

    def is_stop_token(self, token_id: int) -> bool:
        return token_id == self.cfg.eos_token_id

    def release_request(self, request_id: int) -> None:
        self._step_count.pop(request_id, None)
        self._seeds.pop(request_id, None)
        self.acct.release(request_id)

    def _next_token(self, request_id: int, seed: int) -> int:
        step = self._step_count.get(request_id, 0)
        self._step_count[request_id] = step + 1
        if self.cfg.eos_after and step + 1 >= self.cfg.eos_after:
            return self.cfg.eos_token_id
        tok = (seed + step) % self.cfg.vocab_size
        return tok if tok != self.cfg.eos_token_id else tok + 1

    def execute_prefill(self, plan: PrefillPlan) -> PrefillResult:
        if self.cfg.ttft_s:
            time.sleep(self.cfg.ttft_s)
        out = []
        for it in plan.requests:
            st = self.acct.state(it.request_id)
            st.ensure_capacity(self.acct.pool, len(it.prompt_tokens))
            st.advance(len(it.prompt_tokens))
            seed = sum(it.prompt_tokens) % self.cfg.vocab_size
            self._seeds[it.request_id] = seed
            out.append(PrefillRequestResult(request_id=it.request_id,
                                            first_token=self._next_token(it.request_id, seed)))
        return PrefillResult(requests=out)

    def execute_decode(self, plan: DecodePlan) -> DecodeResult:
        if self.cfg.tpot_s:
            time.sleep(self.cfg.tpot_s)
        out = []
        for it in plan.requests:
            st = self.acct.state(it.request_id)
            st.ensure_capacity(self.acct.pool, st.length + 1)
            st.advance(1)
            seed = self._seeds.get(it.request_id, 0)
            out.append(DecodeRequestResult(request_id=it.request_id,
                                           token=self._next_token(it.request_id, seed)))
        return DecodeResult(requests=out)

    def execute_unified(self, plan: UnifiedPlan) -> UnifiedResult:
        decode = self.execute_decode(DecodePlan(requests=plan.decode_requests))
        prefill = self.execute_prefill(PrefillPlan(requests=plan.prefill_requests))
        return UnifiedResult(prefill_requests=prefill.requests,
                             decode_requests=decode.requests)


def start_engine(cfg: Optional[SimulatedEngineConfig] = None,
                 options: Optional[EngineLoadOptions] = None) -> EngineHandle:
    """The sim executor behind the port's scheduler (seeded by
    ``options.seed``). ``handle._scheduler.executor`` is the
    ``SimExecutor``."""
    cfg = cfg or SimulatedEngineConfig()
    seed = options.seed if options else 42
    return start_scheduler(SimExecutor(cfg), seed=seed)
