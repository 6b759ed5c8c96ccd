"""Engine contract: the stable seam between frontend, scheduler, and models.

The PyTorch port's own copy of ``pegainfer_tpu/engine/contract.py``: an
``EngineHandle`` accepts ``GenerateRequest``s and streams ``TokenEvent``s
back over a per-request channel. The scheduler runs on a dedicated host
thread; consumers may be sync or asyncio.
"""

from __future__ import annotations

import asyncio
import enum
import logging
import queue
import threading
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

log = logging.getLogger("pegainfer_torch.contract")

class FinishReason(str, enum.Enum):
    LENGTH = "length"
    STOP = "stop"
    ERROR = "error"


@dataclass(frozen=True)
class SamplingParams:
    """temperature == 0.0 means greedy; top_k <= 0 means no top-k filter;
    top_p >= 1.0 means no nucleus filter. Matches reference defaults
    (pegainfer-engine/src/sampler.rs:10-17)."""

    temperature: float = 0.0
    top_k: int = -1
    top_p: float = 1.0
    ignore_eos: bool = False

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


@dataclass
class EngineLoadOptions:
    """Engine startup options (counterpart of the JAX package's
    ``EngineLoadOptions``), with its defaults: prompts longer than 2,048
    tokens prefill in pieces and the prefix cache is on (Qwen3's page
    cache, the Qwen3.5 hybrid's pages with state snapshots, DeepSeek-V4's
    slot snapshots; DSv4 prefills every prompt whole, as the JAX engine
    does).

    ``precompile`` and ``enable_cuda_graph`` (both True, as in the JAX
    engine, where the second is an alias for the first): with both set,
    the Qwen3 and Qwen3.5 hybrid executors run each decode step as one CUDA
    graph per (batch bucket, page-table width), the batch buckets captured
    at engine start and other widths at first use, and DeepSeek-V4's one
    graph per batch bucket, each captured at first use, as the JAX DSv4
    engine compiles (``engine/decode_graphs.py``); either False keeps the
    eager step.

    ``decode_block``, ``decode_block_max`` and ``decode_pipeline_depth``
    (4, 16 and 2, as in the JAX engine) shape the decode: a dispatch
    computes a block of tokens on the card, sampled tokens fed back there
    (a CUDA graph of N steps under the graph options), ``decode_block`` of
    them while prompts wait or stream lengths near their end and up to
    ``decode_block_max`` in steady decode, with up to
    ``decode_pipeline_depth`` blocks in flight before the oldest is read
    (``block_options`` applies the JAX executor's clamps).

    ``quantize`` names weight modes the executors do not all have; an
    executor raises ``NotImplementedError`` for a value it does not serve,
    so no option is silently ignored: None everywhere; ``"int8"`` (int8
    weight-only projections and head) for Qwen3 and the Qwen3.5 hybrid;
    ``"int8-experts"`` (experts requantized to int8) for DeepSeek-V4.

    ``device_ordinals`` (``[0]``, as in the JAX engine): the cards of a
    tensor-parallel engine's ranks. Listing one ordinal a rank puts rank r
    on ``cuda:{device_ordinals[r]}`` (a repeat puts two ranks on one card);
    otherwise the ranks take the first cards, one each.
    """

    precompile: bool = True
    enable_cuda_graph: bool = True  # with precompile: the graphed decode step
    device_ordinals: List[int] = field(default_factory=lambda: [0])
    seed: int = 42
    # Fraction of free device memory given to the paged KV pool.
    kv_memory_fraction: float = 0.85
    max_num_pages: Optional[int] = None  # override pool size (tests)
    max_batch_size: int = 64
    max_model_len: Optional[int] = None
    # weight quantization, per family as above
    quantize: Optional[str] = None
    # Tokens computed per decode dispatch; token events come in bursts of
    # this size.
    decode_block: int = 4
    # Block size in steady decode (no prompt waiting); decode_block keeps
    # the finer grain under mixed load and near a stream's length limit.
    decode_block_max: int = 16
    # Blocks in flight in steady decode before the oldest is read: 1 reads
    # each block before the next dispatch, 2 dispatches the next block on
    # the card's tokens before reading the last.
    decode_pipeline_depth: int = 2
    # Shared-prompt-prefix page cache: a repeated prompt skips prefilling
    # its cached page-aligned prefix (Qwen3 and the hybrid need
    # ``prefill_chunk``); DeepSeek-V4 caches whole-slot snapshots.
    enable_prefix_cache: bool = True
    # Prompts longer than this prefill in pieces of this many tokens
    # (aligned down to the page); None prefills every prompt whole.
    prefill_chunk: Optional[int] = 2048
    # Piece size while other requests decode: each piece then carries one
    # decode row per active stream (the fused mixed step), so it bounds the
    # streams' token gap. PEGAINFER_MIXED_FUSED=0 time-slices instead.
    prefill_chunk_mixed: int = 256


def block_options(opts: EngineLoadOptions) -> Tuple[int, int, int]:
    """(decode_block, decode_block_max, decode_pipeline_depth) as the JAX
    executor clamps them: a block of at least 1, a steady block of at least
    ``decode_block`` (a lower value is raised, with a warning), a depth of
    at least 1."""
    block = max(1, opts.decode_block)
    if 0 < opts.decode_block_max < block:
        log.warning("decode_block_max=%d below decode_block=%d — clamped up",
                    opts.decode_block_max, block)
    return block, max(block, opts.decode_block_max), max(1, opts.decode_pipeline_depth)


@dataclass
class TokenLogprob:
    logprob: float
    top_logprobs: List[Tuple[int, float]] = field(default_factory=list)


class TokenEvent:
    """Union of events streamed back per request (reference engine.rs:59-86)."""

    __slots__ = ()


@dataclass
class Scheduled(TokenEvent):
    queued_at_unix_s: float
    scheduled_at_unix_s: float
    prompt_tokens: int


@dataclass
class Token(TokenEvent):
    id: int
    logprob: Optional[TokenLogprob] = None


@dataclass
class PromptTokens(TokenEvent):
    """An echo request's prompt, sent before its first token: the ids and
    each one's logprob given the tokens before it (None for the first, and
    for all when the request asked for no logprobs)."""

    ids: List[int]
    logprobs: List[Optional[TokenLogprob]] = field(default_factory=list)


@dataclass
class Finished(TokenEvent):
    finish_reason: FinishReason
    prompt_tokens: int
    completion_tokens: int


@dataclass
class Error(TokenEvent):
    message: str
    prompt_tokens: int
    completion_tokens: int


@dataclass
class Rejected(TokenEvent):
    message: str
    prompt_tokens: int
    completion_tokens: int


_TERMINAL = (Finished, Error, Rejected)


def is_terminal(event: TokenEvent) -> bool:
    return isinstance(event, _TERMINAL)


class TokenChannel:
    """Unbounded SPSC channel from the scheduler thread to a consumer.

    The consumer may ``close()`` (receiver drop); the scheduler observes
    ``is_closed`` and retires the request, mirroring the reference's
    receiver-drop cleanup (qwen3-4b/tests/e2e.rs:193-214).
    """

    def __init__(self) -> None:
        self._q: "queue.SimpleQueue[Optional[TokenEvent]]" = queue.SimpleQueue()
        self._closed = threading.Event()
        self._done = threading.Event()

    # -- sender side (scheduler thread) --
    def send(self, event: TokenEvent) -> bool:
        if self._closed.is_set():
            return False
        self._q.put(event)
        if is_terminal(event):
            self._done.set()
            self._q.put(None)
        return True

    @property
    def is_closed(self) -> bool:
        return self._closed.is_set()

    # -- receiver side --
    def close(self) -> None:
        self._closed.set()
        self._q.put(None)

    def __iter__(self) -> Iterator[TokenEvent]:
        while True:
            ev = self._q.get()
            if ev is None:
                return
            yield ev

    def get(self, timeout: Optional[float] = None) -> Optional[TokenEvent]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    async def __aiter__(self):
        loop = asyncio.get_running_loop()
        while True:
            ev = await loop.run_in_executor(None, self._q.get)
            if ev is None:
                return
            yield ev


@dataclass
class GenerateRequest:
    """One generation request (reference engine.rs:46-57)."""

    prompt_tokens: List[int]
    max_tokens: int
    params: SamplingParams = field(default_factory=SamplingParams)
    channel: TokenChannel = field(default_factory=TokenChannel)
    request_id: Optional[str] = None
    queued_at_unix_s: Optional[float] = None
    logprobs: int = 0
    echo: bool = False


class EngineHandle:
    """Cloneable submit handle; the scheduler drains the shared queue."""

    def __init__(self) -> None:
        self._submit_q: "queue.SimpleQueue[Optional[GenerateRequest]]" = queue.SimpleQueue()
        self._shutdown = threading.Event()

    def submit(self, req: GenerateRequest) -> None:
        if self._shutdown.is_set():
            raise RuntimeError("engine is shut down")
        self._submit_q.put(req)

    def shutdown(self) -> None:
        self._shutdown.set()
        self._submit_q.put(None)

    # -- scheduler side --
    def _drain(self) -> Tuple[List[GenerateRequest], bool]:
        """Non-blocking drain. Returns (requests, still_open)."""
        out: List[GenerateRequest] = []
        while True:
            try:
                item = self._submit_q.get_nowait()
            except queue.Empty:
                return out, True
            if item is None:
                return out, False
            out.append(item)

    def _recv_blocking(self, timeout: Optional[float] = None) -> Tuple[Optional[GenerateRequest], bool]:
        """Blocking receive of one request. Returns (request|None, still_open)."""
        try:
            item = self._submit_q.get(timeout=timeout)
        except queue.Empty:
            return None, True
        if item is None:
            return None, False
        return item, True
