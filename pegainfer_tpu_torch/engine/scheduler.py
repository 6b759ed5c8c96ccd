"""Continuous-batching scheduler: FCFS with full-lifetime KV admission.

The PyTorch port's own copy of ``pegainfer_tpu/engine/scheduler.py``: a
single host thread drains submissions, admits under the KV page budget,
builds a Prefill | Decode | Unified plan, executes it on the ModelExecutor,
resolves outcomes (EOS / length / continue) and emits TokenEvents. On
executor failure every touched request gets an ``Error`` event and its KV
dropped; serving continues.

Only the plain prefill -> decode loop of the protocol is here. The JAX
scheduler's pipelined decode blocks and chunked / fused mixed steps follow
optional executor features that the port's executor does not have yet; they
come back with those features.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from pegainfer_tpu_torch.engine import kv as kvmod
from pegainfer_tpu_torch.engine.contract import (
    EngineHandle,
    Error,
    Finished,
    FinishReason,
    GenerateRequest,
    Rejected,
    SamplingParams,
    Scheduled,
    Token,
    TokenChannel,
)
from pegainfer_tpu_torch.engine.executor import (
    DecodePlan,
    DecodeStepItem,
    ModelExecutor,
    PrefillPlan,
    PrefillStepItem,
    UnifiedPlan,
)

log = logging.getLogger("pegainfer_torch.scheduler")


@dataclass
class PendingRequest:
    request_id: int
    prompt_tokens: List[int]
    params: SamplingParams
    max_tokens: int
    channel: TokenChannel
    logprobs: int = 0
    echo: bool = False
    queued_at_unix_s: float = 0.0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)


@dataclass
class ActiveRequestState:
    request_id: int
    channel: TokenChannel
    last_token: int
    generated_count: int
    max_tokens: int
    prompt_len: int
    params: SamplingParams
    logprobs: int = 0


@dataclass
class _FailureTarget:
    request_id: int
    channel: TokenChannel
    prompt_tokens: int
    completion_tokens: int


def build_next_plan(have_active: bool, pending: List[PendingRequest]) -> Optional[str]:
    if pending and have_active:
        return "unified"
    if pending:
        return "prefill"
    if have_active:
        return "decode"
    return None


class Scheduler:
    """Owns the step loop. Create via ``start_scheduler``."""

    def __init__(self, executor: ModelExecutor, handle: EngineHandle, seed: int = 42):
        self.executor = executor
        self.handle = handle
        self.rng = random.Random(seed)
        self.active: List[ActiveRequestState] = []
        self.deferred: List[PendingRequest] = []
        self._next_request_id = 0
        self._stop = threading.Event()

    # ── request intake ───────────────────────────────────────────────

    def _ingest(self, req: GenerateRequest) -> None:
        self.deferred.append(
            PendingRequest(
                request_id=self._next_request_id,
                prompt_tokens=list(req.prompt_tokens),
                params=req.params,
                max_tokens=req.max_tokens,
                channel=req.channel,
                logprobs=req.logprobs,
                echo=req.echo,
                queued_at_unix_s=req.queued_at_unix_s or time.time(),
            )
        )
        self._next_request_id += 1

    # ── main loop ────────────────────────────────────────────────────

    def run(self) -> None:
        log.info("scheduler ready")
        while not self._stop.is_set():
            reqs, still_open = self.handle._drain()
            for r in reqs:
                self._ingest(r)
            if not still_open:
                break

            if not self.active and not self.deferred:
                req, still_open = self.handle._recv_blocking(timeout=0.1)
                if not still_open:
                    break
                if req is None:
                    continue
                self._ingest(req)
                more, still_open = self.handle._drain()
                for r in more:
                    self._ingest(r)
                if not still_open:
                    break

            self._drop_closed_channels()
            self.step()
        log.info("scheduler exiting")
        self.executor_release_all()

    def executor_release_all(self) -> None:
        for st in self.active:
            self.executor.release_request(st.request_id)
        self.active.clear()

    def _drop_closed_channels(self) -> None:
        """A consumer that closed its channel retires its request."""
        keep = []
        for st in self.active:
            if st.channel.is_closed:
                self.executor.release_request(st.request_id)
            else:
                keep.append(st)
        self.active = keep
        self.deferred = [r for r in self.deferred if not r.channel.is_closed]

    def step(self) -> bool:
        """One plan→execute→resolve→apply cycle. Returns False when idle."""
        outcome = kvmod.admit_deferred_requests(
            self.deferred,
            self.active,
            self.executor.page_size(),
            self.executor.available_pages(),
            self.executor.max_request_pages(),
        )
        for req in outcome.rejected:
            self._send_rejection(req)
        self.deferred = outcome.deferred
        pending = outcome.pending

        # a page-less model's state slots are a second admission resource:
        # overflow waits (its page budget is evaluated again next step)
        free_slots_fn = getattr(self.executor, "free_slots", None)
        if free_slots_fn is not None:
            n = free_slots_fn()
            if len(pending) > n:
                self.deferred = pending[n:] + self.deferred
                pending = pending[:n]

        plan_kind = build_next_plan(bool(self.active), pending)
        if plan_kind is None:
            return False

        now = time.time()
        for req in pending:
            req.channel.send(
                Scheduled(
                    queued_at_unix_s=req.queued_at_unix_s,
                    scheduled_at_unix_s=now,
                    prompt_tokens=req.prompt_len,
                )
            )

        failure_targets = self._failure_targets(pending, plan_kind)
        try:
            self._execute_and_apply(plan_kind, pending)
        except Exception as e:  # noqa: BLE001 — keep serving on any step failure
            log.warning("execution step failed: %s", e, exc_info=True)
            self._fail_touched(failure_targets, f"{type(e).__name__}: {e}")
        return True

    # ── execution ────────────────────────────────────────────────────

    def _prefill_items(self, pending: List[PendingRequest]) -> List[PrefillStepItem]:
        return [
            PrefillStepItem(
                request_id=r.request_id,
                prompt_tokens=r.prompt_tokens,
                params=r.params,
                logprobs=r.logprobs,
                echo=r.echo,
                random_val=self.rng.random(),
            )
            for r in pending
        ]

    def _decode_items(self) -> List[DecodeStepItem]:
        return [
            DecodeStepItem(
                request_id=r.request_id,
                token_id=r.last_token,
                params=r.params,
                logprobs=r.logprobs,
                random_val=self.rng.random(),
            )
            for r in self.active
        ]

    def _execute_and_apply(self, plan_kind: str, pending: List[PendingRequest]) -> None:
        if plan_kind == "prefill":
            result = self.executor.execute_prefill(
                PrefillPlan(
                    requests=self._prefill_items(pending),
                    echo=any(r.echo for r in pending),
                )
            )
            self._apply_prefill(pending, result.requests)
        elif plan_kind == "decode":
            result = self.executor.execute_decode(
                DecodePlan(requests=self._decode_items()))
            self._apply_decode(result.requests)
        else:  # unified: new prompts plus one decode step of the active set
            result = self.executor.execute_unified(
                UnifiedPlan(prefill_requests=self._prefill_items(pending),
                            decode_requests=self._decode_items())
            )
            self._apply_decode(result.decode_requests)
            self._apply_prefill(pending, result.prefill_requests)

    # ── resolve + effects ────────────────────────────────────────────

    def _apply_prefill(self, pending, results) -> None:
        for req, res in zip(pending, results):
            if req.request_id != res.request_id:
                raise RuntimeError(
                    f"prefill result for request {res.request_id}, "
                    f"expected {req.request_id}")
            if not req.params.ignore_eos and self.executor.is_stop_token(res.first_token):
                req.channel.send(
                    Finished(FinishReason.STOP, req.prompt_len, 0)
                )
                self.executor.release_request(req.request_id)
                continue
            if req.max_tokens <= 1:
                req.channel.send(Token(res.first_token, res.first_token_logprob))
                req.channel.send(Finished(FinishReason.LENGTH, req.prompt_len, 1))
                self.executor.release_request(req.request_id)
                continue
            req.channel.send(Token(res.first_token, res.first_token_logprob))
            self.active.append(
                ActiveRequestState(
                    request_id=req.request_id,
                    channel=req.channel,
                    last_token=res.first_token,
                    generated_count=1,
                    max_tokens=req.max_tokens,
                    prompt_len=req.prompt_len,
                    params=req.params,
                    logprobs=req.logprobs,
                )
            )

    def _apply_decode(self, results) -> set:
        by_id = {st.request_id: st for st in self.active}
        finished_ids = set()
        for res in results:
            st = by_id[res.request_id]
            completion = st.generated_count + 1
            is_eos = not st.params.ignore_eos and self.executor.is_stop_token(res.token)
            at_limit = completion >= st.max_tokens
            if is_eos:
                st.channel.send(Finished(FinishReason.STOP, st.prompt_len, completion))
                finished_ids.add(st.request_id)
            elif at_limit:
                st.channel.send(Token(res.token, res.logprob))
                st.channel.send(Finished(FinishReason.LENGTH, st.prompt_len, completion))
                finished_ids.add(st.request_id)
            else:
                st.channel.send(Token(res.token, res.logprob))
                st.last_token = res.token
                st.generated_count = completion
        if finished_ids:
            for rid in finished_ids:
                self.executor.release_request(rid)
            self.active = [s for s in self.active if s.request_id not in finished_ids]
        return finished_ids

    # ── failure handling ─────────────────────────────────────────────

    def _failure_targets(self, pending, plan_kind) -> List[_FailureTarget]:
        targets = [
            _FailureTarget(r.request_id, r.channel, r.prompt_len, 0) for r in pending
        ]
        if plan_kind in ("decode", "unified"):
            targets.extend(
                _FailureTarget(s.request_id, s.channel, s.prompt_len, s.generated_count)
                for s in self.active
            )
        return targets

    def _fail_touched(self, targets: List[_FailureTarget], message: str) -> None:
        for t in targets:
            t.channel.send(Error(message, t.prompt_tokens, t.completion_tokens))
            self.executor.release_request(t.request_id)
        failed = {t.request_id for t in targets}
        self.active = [s for s in self.active if s.request_id not in failed]

    def _send_rejection(self, req: PendingRequest) -> None:
        max_tok = kvmod.max_request_tokens(req.prompt_len, req.max_tokens)
        req.channel.send(
            Rejected(
                message=(
                    "request requires more KV pages than this model instance can "
                    f"provide: prompt_tokens={req.prompt_len}, max_context_tokens={max_tok}"
                ),
                prompt_tokens=req.prompt_len,
                completion_tokens=0,
            )
        )


def start_scheduler(executor: ModelExecutor, seed: int = 42) -> EngineHandle:
    """Spawn the scheduler thread and return the submit handle."""
    handle = EngineHandle()
    sched = Scheduler(executor, handle, seed=seed)
    t = threading.Thread(target=sched.run, name="pegainfer-torch-scheduler", daemon=True)
    t.start()
    handle._scheduler = sched  # type: ignore[attr-defined]  # test/introspection hook
    handle._thread = t  # type: ignore[attr-defined]
    return handle
