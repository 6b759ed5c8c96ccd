"""Continuous-batching scheduler: FCFS with full-lifetime KV admission.

The PyTorch port's own copy of ``pegainfer_tpu/engine/scheduler.py``: a
single host thread drains submissions, admits under the KV page budget,
builds a Prefill | Decode | Unified plan, executes it on the ModelExecutor,
resolves outcomes (EOS / length / continue) and emits TokenEvents. On
executor failure every touched request gets an ``Error`` event and its KV
dropped; serving continues.

A unified step (new prompts while streams decode) is the JAX scheduler's
``_unified_interleaved``: an executor with a prefill stepper runs long
prompts piece by piece, each piece carrying one decode row per active
stream (the fused mixed step) or followed by a decode step, so a stream
stalls for one piece, not a whole prompt. An executor without one (DSv4's
slot executor) takes the plain unified step.

Decode runs in blocks, as the JAX scheduler's does, on an executor with
``execute_decode_async``: a block computes N tokens a row on the card (N =
``decode_block`` between prefill pieces and near a stream's length limit,
``decode_block_max`` in steady decode, 1 past a LENGTH boundary's reach),
and in steady decode (``_decode_pipelined``) up to
``decode_pipeline_depth`` blocks are in flight: the next is dispatched on
the last one's tokens on the card before that one is read. The pipeline
drains (reads every block in flight) on an arrival, a finish, a closed
channel or a deferred request, and never speculates past a LENGTH
boundary; rows of requests that finished in an earlier block are dropped.
Random draws come in the JAX scheduler's order: one per row for the
block's items, then the block's [N, rows] matrix.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

from pegainfer_tpu_torch.engine import kv as kvmod
from pegainfer_tpu_torch.engine.contract import (
    EngineHandle,
    Error,
    Finished,
    FinishReason,
    GenerateRequest,
    PromptTokens,
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
        shutdown = getattr(self.executor, "shutdown", None)
        if shutdown is not None:  # an executor of several processes stops them
            shutdown()

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
            items = self._decode_items()
            if self._async_decode(items):
                self._decode_pipelined(items)
            else:
                result = self.executor.execute_decode(DecodePlan(requests=items))
                self._apply_decode(result.requests)
        else:  # unified
            self._unified_interleaved(pending)

    def _async_decode(self, items) -> bool:
        ex = self.executor
        return hasattr(ex, "execute_decode_async") and ex.supports_async_decode(items)

    def _decode_block_once(self) -> None:
        """One decode block for the active set (between prefill pieces; no
        speculation, the batch may change right after)."""
        if not self.active:
            return
        items = self._decode_items()
        if not self._async_decode(items):
            result = self.executor.execute_decode(DecodePlan(requests=items))
            self._apply_decode(result.requests)
            return
        n = self._decode_block_size()
        pend = self.executor.execute_decode_async(
            items, n_tokens=n, rand_matrix=self._rand_matrix(items, n))
        self._apply_decode_tokens(self.executor.resolve_pending_multi(pend))

    def _decode_block_size(self, after: int = 0, steady: bool = False) -> int:
        """Tokens a block: ``decode_block`` (``decode_block_max`` in steady
        decode) while every stream has that many tokens left after the
        ``after`` already in flight, else ``decode_block`` if that fits,
        else 1 (page use stays within the admitted budget)."""
        small = getattr(self.executor, "decode_block", 1)
        block = max(small, getattr(self.executor, "decode_block_max", 0)) if steady else small
        rem = self._min_remaining() - after
        if rem >= block:
            return block
        return small if rem >= small else 1

    def _decode_pipelined(self, items) -> None:
        """Steady decode: blocks of ``_decode_block_size(steady=True)``
        tokens, up to ``decode_pipeline_depth`` in flight, each after the
        first dispatched on the previous block's tokens on the card before
        the oldest is read. Returns after a drain (an arrival, a finish, a
        closed channel, a deferred request) or when nothing is in flight."""
        ex = self.executor
        depth = max(1, getattr(ex, "decode_pipeline_depth", 2))
        N = self._decode_block_size(steady=True)
        q: deque = deque()  # [(PendingDecode, n_tokens)]
        q.append((ex.execute_decode_async(items, n_tokens=N,
                                          rand_matrix=self._rand_matrix(items, N)), N))
        queued = N

        def drain_rest() -> None:
            # rows of requests that finished are dropped (their pages and
            # slots were released with the request)
            while q:
                blk, _ = q.popleft()
                self._apply_decode_tokens(ex.resolve_pending_multi(blk))

        while True:
            reqs, still_open = self.handle._drain()
            for r in reqs:
                self._ingest(r)
            if not still_open:  # the handle's shutdown, taken here: the loop ends after
                self._stop.set()
            closed = any(st.channel.is_closed for st in self.active)
            steady = still_open and not self.deferred and not closed
            if steady:
                # fill the window; never past a LENGTH boundary (an EOS
                # finish drops its rows)
                while len(q) < depth and self._min_remaining() > queued:
                    n2 = self._decode_block_size(after=queued, steady=True)
                    next_items = self._decode_items()  # token ids unused
                    q.append((ex.execute_decode_async(
                        next_items, tokens_dev=q[-1][0].tokens_dev, n_tokens=n2,
                        rand_matrix=self._rand_matrix(next_items, n2)), n2))
                    queued += n2
            blk, n = q.popleft()
            queued -= n
            finished = self._apply_decode_tokens(ex.resolve_pending_multi(blk))
            if not q:
                return
            if finished or not self.active or not steady:
                drain_rest()
                return

    def _unified_interleaved(self, pending: List[PendingRequest]) -> None:
        """Mixed step: prompts that the executor chunks run piece by piece
        with the active streams' decode rows fused into each piece (or a
        decode step between pieces), so a stream stalls for one piece."""
        ex = self.executor
        chunkable = hasattr(ex, "prefill_stepper") and hasattr(ex, "supports_chunked_prefill")
        done_results, done_reqs, plain, plain_reqs = [], [], [], []
        for req in pending:
            item = self._prefill_items([req])[0]
            if chunkable and ex.supports_chunked_prefill(item) and self.active:
                done_results.append(self._drive_stepper(ex.prefill_stepper(item)))
                done_reqs.append(req)
            elif chunkable and self.active:
                # a prompt the executor does not chunk runs alone, and the
                # active set decodes right after it: the stall is one
                # prompt's prefill, not the whole pending queue's
                result = ex.execute_prefill(PrefillPlan(requests=[item], echo=item.echo))
                done_results.append(result.requests[0])
                done_reqs.append(req)
                self._decode_block_once()
            else:
                plain.append(item)
                plain_reqs.append(req)
        if plain:
            result = ex.execute_unified(
                UnifiedPlan(prefill_requests=plain, decode_requests=self._decode_items()))
            self._apply_prefill(plain_reqs, result.prefill_requests)
            self._apply_decode(result.decode_requests)
        if done_reqs:
            self._apply_prefill(done_reqs, done_results)
        if not plain:
            self._decode_block_once()

    def _drive_stepper(self, gen):
        """Run one prompt's prefill stepper to its end with the active set
        decoding along. Piece k's decode tokens are applied after piece k+1
        is dispatched (the JAX scheduler's pipeline; the executor feeds
        piece k's tokens to piece k+1 itself). Returns the prefill result."""
        ex = self.executor
        prev = None  # the fused piece whose tokens are not applied yet

        def flush_prev():
            nonlocal prev
            mp, prev = prev, None
            if mp is not None:
                self._apply_decode_tokens(ex.resolve_pending_multi(mp))

        try:
            while True:
                # adaptive pieces: smaller while streams are decoding
                ex.decode_active = bool(self.active)
                ex.mixed_items = None  # never leave stale items
                ditems = self._decode_items() if self.active else []
                if ditems and ex.supports_mixed_step(ditems):
                    if prev is not None and (
                            tuple(i.request_id for i in ditems)
                            != tuple(i.request_id for i in prev.items)
                            or self._min_remaining() <= 2):
                        # the batch changed, or a stream is near its length
                        # limit: apply first (no token past the admitted
                        # budget)
                        flush_prev()
                        ditems = self._decode_items() if self.active else []
                    if ditems and ex.supports_mixed_step(ditems):
                        ex.mixed_items = ditems
                        ex.mixed_rand = self._rand_matrix(ditems, 1)
                try:
                    next(gen)
                except StopIteration as done:
                    return done.value
                mp, ex.mixed_pending = ex.mixed_pending, None
                flush_prev()  # piece k-1's tokens, now that piece k ran
                if mp is not None:
                    prev = mp
                else:
                    self._decode_block_once()
        finally:
            ex.decode_active = False
            ex.mixed_items = None
            # in order: the held piece, then a last piece that ran fused
            # right before the stepper returned
            mp, ex.mixed_pending = ex.mixed_pending, None
            flush_prev()
            if mp is not None:
                self._apply_decode_tokens(ex.resolve_pending_multi(mp))

    def _min_remaining(self) -> int:
        return min(st.max_tokens - st.generated_count for st in self.active)

    def _rand_matrix(self, items, n_tokens: int):
        if all(it.params.is_greedy for it in items):
            return None
        return [[self.rng.random() for _ in items] for _ in range(n_tokens)]

    # ── resolve + effects ────────────────────────────────────────────

    def _apply_prefill(self, pending, results) -> None:
        for req, res in zip(pending, results):
            if req.request_id != res.request_id:
                raise RuntimeError(
                    f"prefill result for request {res.request_id}, "
                    f"expected {req.request_id}")
            if req.echo:  # the prompt comes back first
                lp = res.prompt_logprobs or [None] * req.prompt_len
                req.channel.send(PromptTokens(ids=list(req.prompt_tokens), logprobs=lp))
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
        return self._apply_decode_tokens(
            [(r.request_id, [r.token], None if r.logprob is None else [r.logprob])
             for r in results])

    def _apply_decode_tokens(self, results) -> set:
        """Apply [(request_id, tokens, logprobs | None)] with one-token
        semantics each (EOS discards a request's remaining tokens). Rows of
        requests that finished while the rows were pending are dropped:
        their KV is already released."""
        by_id = {st.request_id: st for st in self.active}
        finished_ids = set()
        for rid, toks, lps in results:
            st = by_id.get(rid)
            if st is None:
                continue
            for ti, tok in enumerate(toks):
                completion = st.generated_count + 1
                if not st.params.ignore_eos and self.executor.is_stop_token(tok):
                    st.channel.send(Finished(FinishReason.STOP, st.prompt_len, completion))
                    finished_ids.add(rid)
                    break
                st.channel.send(Token(tok, lps[ti] if lps else None))
                st.last_token = tok
                st.generated_count = completion
                if completion >= st.max_tokens:
                    st.channel.send(Finished(FinishReason.LENGTH, st.prompt_len, completion))
                    finished_ids.add(rid)
                    break
        for rid in finished_ids:
            self.executor.release_request(rid)
        if finished_ids:
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
