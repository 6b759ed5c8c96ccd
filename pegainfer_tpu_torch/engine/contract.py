"""Engine contract: the stable seam between frontend, scheduler, and models.

The PyTorch port's own copy of ``pegainfer_tpu/engine/contract.py``: an
``EngineHandle`` accepts ``GenerateRequest``s and streams ``TokenEvent``s
back over a per-request channel. The scheduler runs on a dedicated host
thread; consumers may be sync or asyncio.
"""

from __future__ import annotations

import asyncio
import enum
import queue
import threading
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple


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
    ``EngineLoadOptions``).

    The last four fields name features of the JAX engine that the port does
    not have yet; the executor raises ``NotImplementedError`` when one is
    set away from its default, so no option is silently ignored.
    """

    seed: int = 42
    # Fraction of free device memory given to the paged KV pool.
    kv_memory_fraction: float = 0.85
    max_num_pages: Optional[int] = None  # override pool size (tests)
    max_batch_size: int = 64
    max_model_len: Optional[int] = None
    # not supported yet: weight quantization, prefix cache, chunked
    # prefill, multi-token decode blocks
    quantize: Optional[str] = None
    enable_prefix_cache: bool = False
    prefill_chunk: Optional[int] = None
    decode_block: int = 1


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
