"""Host-side paged-KV accounting: page pool, per-request KV state, admission.

The PyTorch port's own copy of the Python half of
``pegainfer_tpu/engine/kv.py``: ``PagePool``, ``KvState``, ``KvAccounting``
and the admission rule. The prefix caches (and the page refcounts they need)
and the native C++ accounting core are not carried over.

Key invariant: a request is only admitted when its *full-lifetime* page count
fits in the budget after subtracting every active request's future growth,
so decode can never deadlock on page exhaustion.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence


def pages_needed(token_count: int, page_size: int) -> int:
    return -(-token_count // page_size)  # ceil div


class PagePool:
    """Free-list allocator over a fixed set of KV page ids.

    Page id 0 is reserved as the *null page*: padding entries of page tables
    point there, so it must never be handed to a request.
    """

    NULL_PAGE = 0

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (one is the null page)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(f"page pool exhausted: want {n}, have {len(self._free)}")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p == self.NULL_PAGE:
                raise ValueError("freeing the null page")
            self._free.append(p)


@dataclass
class KvState:
    """Per-request KV occupancy: ordered page list + token length."""

    page_size: int
    pages: List[int] = field(default_factory=list)
    length: int = 0  # tokens currently stored

    @property
    def capacity(self) -> int:
        return len(self.pages) * self.page_size

    def ensure_capacity(self, pool: PagePool, total_tokens: int) -> None:
        """Grow the page list so ``total_tokens`` fit."""
        need = pages_needed(total_tokens, self.page_size) - len(self.pages)
        if need > 0:
            self.pages.extend(pool.alloc(need))

    def advance(self, n: int = 1) -> None:
        self.length += n
        if self.length > self.capacity:
            raise RuntimeError(
                f"KV advance past capacity: len={self.length} cap={self.capacity}"
            )

    def release(self, pool: PagePool) -> None:
        if self.pages:
            pool.free(self.pages)
        self.pages = []
        self.length = 0


class KvAccounting:
    """Tracks KvState per request id over a shared PagePool."""

    def __init__(self, pool: PagePool, page_size: int) -> None:
        self.pool = pool
        self.page_size = page_size
        self._states: Dict[int, KvState] = {}

    def state(self, request_id: int) -> KvState:
        st = self._states.get(request_id)
        if st is None:
            st = KvState(page_size=self.page_size)
            self._states[request_id] = st
        return st

    def release(self, request_id: int) -> None:
        st = self._states.pop(request_id, None)
        if st is not None:
            st.release(self.pool)


# ── Admission control ────────────────────────────────────────────────────
# Prefill samples the first output token but does not append it to KV; a
# generated token occupies KV only when fed back as a decode input — so N
# completion tokens occupy at most N-1 KV slots.


def max_request_tokens(prompt_len: int, max_tokens: int) -> int:
    return prompt_len + max(max_tokens - 1, 0)


@dataclass
class AdmissionOutcome:
    pending: list
    deferred: list
    rejected: list


def admit_deferred_requests(
    deferred: list,
    active: list,
    page_size: int,
    available_pages: int,
    max_request_pages: int,
) -> AdmissionOutcome:
    """FCFS admission under the full-lifetime page budget.

    ``deferred`` items need ``.prompt_len`` and ``.max_tokens``; ``active``
    items need ``.prompt_len``, ``.max_tokens`` and ``.generated_count``.
    """
    future = 0
    for req in active:
        max_tok = max_request_tokens(req.prompt_len, req.max_tokens)
        cur_tok = req.prompt_len + max(req.generated_count - 1, 0)
        future += pages_needed(max_tok, page_size) - pages_needed(cur_tok, page_size)

    budget = max(available_pages - future, 0)
    pending, still_deferred, rejected = [], [], []
    for req in deferred:
        max_needed = pages_needed(
            max_request_tokens(req.prompt_len, req.max_tokens), page_size
        )
        if max_needed > max_request_pages:
            rejected.append(req)
        elif max_needed <= budget:
            budget -= max_needed
            pending.append(req)
        else:
            still_deferred.append(req)
    return AdmissionOutcome(pending, still_deferred, rejected)
