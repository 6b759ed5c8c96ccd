"""ModelExecutor seam: the hardware-free boundary the scheduler drives.

The PyTorch port's own copy of ``pegainfer_tpu/engine/executor.py``: the
seam that makes the scheduler testable without a device. Implemented by
``engine.torch_executor.TorchExecutor``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Protocol, runtime_checkable

from pegainfer_tpu_torch.engine.contract import SamplingParams, TokenLogprob


@dataclass
class PrefillStepItem:
    request_id: int
    prompt_tokens: List[int]
    params: SamplingParams
    logprobs: int = 0
    echo: bool = False
    random_val: float = 0.0


@dataclass
class DecodeStepItem:
    request_id: int
    token_id: int
    params: SamplingParams
    logprobs: int = 0
    random_val: float = 0.0


@dataclass
class PrefillPlan:
    requests: List[PrefillStepItem]
    echo: bool = False


@dataclass
class DecodePlan:
    requests: List[DecodeStepItem]


@dataclass
class UnifiedPlan:
    prefill_requests: List[PrefillStepItem]
    decode_requests: List[DecodeStepItem]


@dataclass
class PrefillRequestResult:
    request_id: int
    first_token: int
    first_token_logprob: Optional[TokenLogprob] = None
    prompt_logprobs: Optional[List[Optional[TokenLogprob]]] = None


@dataclass
class DecodeRequestResult:
    request_id: int
    token: int
    logprob: Optional[TokenLogprob] = None


@dataclass
class PrefillResult:
    requests: List[PrefillRequestResult] = field(default_factory=list)


@dataclass
class DecodeResult:
    requests: List[DecodeRequestResult] = field(default_factory=list)


@dataclass
class UnifiedResult:
    prefill_requests: List[PrefillRequestResult] = field(default_factory=list)
    decode_requests: List[DecodeRequestResult] = field(default_factory=list)


@runtime_checkable
class ModelExecutor(Protocol):
    """What a model engine must expose to the scheduler."""

    def page_size(self) -> int: ...

    def available_pages(self) -> int: ...

    def max_request_pages(self) -> int: ...

    def is_stop_token(self, token_id: int) -> bool: ...

    def execute_prefill(self, plan: PrefillPlan) -> PrefillResult: ...

    def execute_decode(self, plan: DecodePlan) -> DecodeResult: ...

    def execute_unified(self, plan: UnifiedPlan) -> UnifiedResult: ...

    def release_request(self, request_id: int) -> None: ...
