"""Host-side paged-KV accounting: page pool, per-request KV state, admission.

The PyTorch port's own copy of the Python half of
``pegainfer_tpu/engine/kv.py``: the refcounted ``PagePool``, ``KvState``,
``KvAccounting``, the admission rule, the page ``PrefixCache`` with the
hybrid models' state snapshots (``match_hybrid``, ``insert_snapshot``) and
the page-less models' ``SlotPrefixCache``. The native C++ accounting core is
not carried over.

Key invariant: a request is only admitted when its *full-lifetime* page count
fits in the budget after subtracting every active request's future growth,
so decode can never deadlock on page exhaustion.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence


def pages_needed(token_count: int, page_size: int) -> int:
    return -(-token_count // page_size)  # ceil div


class PagePool:
    """Refcounted free-list allocator over a fixed set of KV page ids.

    Page id 0 is reserved as the *null page*: padding entries of page tables
    point there, so it must never be handed to a request.

    Pages are refcounted so the prefix cache can share immutable prompt
    pages across requests (``incref``; ``free`` drops one reference and a
    page returns to the free list at 0). ``alloc`` hands out pages at
    refcount 1 and, on shortage, first calls the eviction hook (the prefix
    cache releases its least recently used entries).
    """

    NULL_PAGE = 0

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (one is the null page)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self._allocated = 0
        self._evict_hook = None  # callable(n_pages_needed) -> None

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def allocated(self) -> int:
        return self._allocated

    def set_eviction_hook(self, hook) -> None:
        self._evict_hook = hook

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free) and self._evict_hook is not None:
            self._evict_hook(n - len(self._free))
        if n > len(self._free):
            raise RuntimeError(f"page pool exhausted: want {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self._allocated += n
        return pages

    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; reclaim pages that reach zero."""
        for p in pages:
            if p == self.NULL_PAGE:
                raise ValueError("freeing the null page")
            left = self._refs[p] - 1
            if left == 0:
                del self._refs[p]
                self._free.append(p)
                self._allocated -= 1
            else:
                self._refs[p] = left


@dataclass
class KvState:
    """Per-request KV occupancy: ordered page list + token length.

    ``prefix_len`` > 0 means the first pages were seeded from the prefix
    cache (already written, shared read-only) and prefill starts there.
    """

    page_size: int
    pages: List[int] = field(default_factory=list)
    length: int = 0  # tokens currently stored
    prefix_len: int = 0  # cached-prefix tokens (page-aligned)
    prefix_checked: bool = False  # cache lookup already performed
    prefix_snap: Optional[Any] = None  # hybrid state snapshot to restore

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

    def get(self, request_id: int) -> Optional[KvState]:
        return self._states.get(request_id)

    def release(self, request_id: int) -> None:
        st = self._states.pop(request_id, None)
        if st is not None:
            st.release(self.pool)


# ── Prefix cache ─────────────────────────────────────────────────────────

# The hybrid state snapshot cap (LRU). An engine that sizes its KV pool
# around the snapshots (models/qwen35_engine.py::compute_num_pages) uses the
# same number. A prompt family keeps up to two entries (the deepest interior
# boundary and the page-aligned end), so the cap should be at least twice the
# families kept warm at once.
DEFAULT_MAX_SNAPSHOTS = 8


class PrefixCache:
    """Shared-prompt-prefix page cache over the refcounted ``PagePool``.

    A cached prefix is a chain of immutable page ids addressed through
    per-request page tables, so reuse is a host-side table edit with no
    device copy. Keys are a rolling hash per page boundary (each chains the
    previous key with the page's token ids), so key i names
    ``tokens[0:(i + 1) * page_size]``. LRU eviction runs from the pool's
    shortage hook.

    A model with per-request state (the Qwen3.5 hybrid's GDN rows) can only
    continue a prefix where that state was snapshotted: ``insert_snapshot``
    keeps (position, snapshot) by chain key, LRU-capped by count, and such
    a model matches only through ``match_hybrid`` (plain ``match`` would
    hand it pages with no state behind them).
    """

    def __init__(self, pool: PagePool, page_size: int,
                 max_snapshots: int = DEFAULT_MAX_SNAPSHOTS) -> None:
        self.pool = pool
        self.page_size = page_size
        self._pages: Dict[int, int] = {}  # chain key -> page id
        self._lru: Dict[int, int] = {}  # chain key -> tick
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self._snaps: Dict[int, tuple] = {}  # chain key -> (pos, snapshot), LRU order
        self.max_snapshots = max_snapshots
        pool.set_eviction_hook(self._evict)

    def _keys(self, tokens: Sequence[int]):
        ps = self.page_size
        h = 0
        for i in range(len(tokens) // ps):
            h = hash((h, tuple(tokens[i * ps:(i + 1) * ps])))
            yield h

    def match(self, tokens: Sequence[int]) -> tuple:
        """Longest cached prefix of ``tokens``, capped at ``(T - 1) // ps``
        full pages so the last prompt token always re-runs and prefill
        emits its logits. Returns (n_tokens, page_ids), one pool reference
        taken per page on the caller's behalf."""
        ps = self.page_size
        usable = (len(tokens) - 1) // ps
        pages: List[int] = []
        self._tick += 1
        for i, key in enumerate(self._keys(tokens)):
            if i >= usable:
                break
            pid = self._pages.get(key)
            if pid is None:
                break
            pages.append(pid)
            self._lru[key] = self._tick
        if pages:
            self.pool.incref(pages)
            self.hits += 1
        else:
            self.misses += 1
        return len(pages) * ps, pages

    def match_hybrid(self, tokens: Sequence[int]) -> tuple:
        """Longest cached prefix a stateful model can continue: the deepest
        snapshotted position whose page chain is cached, capped as in
        ``match``. Returns (n_tokens, page_ids, snapshot), pages referenced
        as in ``match``; (0, [], None) when no snapshotted boundary
        matches."""
        ps = self.page_size
        usable = (len(tokens) - 1) // ps
        self._tick += 1
        chain: List[tuple] = []  # (key, page id) per matched page
        best = None  # (n_pages, key)
        for i, key in enumerate(self._keys(tokens)):
            if i >= usable:
                break
            pid = self._pages.get(key)
            if pid is None:
                break
            chain.append((key, pid))
            if key in self._snaps:
                best = (i + 1, key)
        if best is None:
            self.misses += 1
            return 0, [], None
        n_pages, skey = best
        pages = [pid for _, pid in chain[:n_pages]]
        for key, _ in chain[:n_pages]:
            self._lru[key] = self._tick
        pos, snap = self._snaps.pop(skey)
        self._snaps[skey] = (pos, snap)  # most recently used
        if pos != n_pages * ps:
            raise RuntimeError(f"snapshot at {pos} keyed at page {n_pages}")
        self.pool.incref(pages)
        self.hits += 1
        return pos, pages, snap

    def insert_snapshot(self, tokens: Sequence[int], pos: int, snap) -> None:
        """Register a state snapshot taken after exactly ``pos`` tokens
        (page-aligned; other positions are ignored). Its pages are inserted
        with ``insert``; a snapshot whose pages were evicted never matches
        and ages out."""
        ps = self.page_size
        if pos <= 0 or pos % ps or pos > len(tokens):
            return
        key = list(self._keys(tokens[:pos]))[pos // ps - 1]
        self._snaps.pop(key, None)
        self._snaps[key] = (pos, snap)
        while len(self._snaps) > self.max_snapshots:
            self._snaps.pop(next(iter(self._snaps)))

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> None:
        """Register a prefilled prompt's full pages (immutable: generated
        tokens land on later pages). Takes one reference per newly cached
        page; chains already cached are left as they are."""
        self._tick += 1
        for i, key in enumerate(self._keys(tokens)):
            if i >= len(pages):
                break
            if key in self._pages:
                self._lru[key] = self._tick
                continue
            self._pages[key] = pages[i]
            self._lru[key] = self._tick
            self.pool.incref([pages[i]])

    def evictable(self) -> int:
        """Pages only the cache holds (refcount 1), reclaimable on demand.
        Admission counts them as available: the eviction hook fires only on
        ``alloc``, which a deferred request never reaches otherwise."""
        refs = self.pool._refs
        return sum(1 for pid in self._pages.values() if refs.get(pid) == 1)

    def _evict(self, n_pages: int) -> None:
        """Drop LRU entries until ``n_pages`` pages actually return to the
        free list (a dropped reference frees only a page no live request
        shares) or the cache is empty. Entries orphaned by an evicted
        ancestor age out the same way (``match`` walks from page 0)."""
        want = self.pool.available + max(n_pages, 0)
        for key, _ in sorted(self._lru.items(), key=lambda kv: kv[1]):
            if self.pool.available >= want:
                break
            pid = self._pages.pop(key)
            del self._lru[key]
            self.pool.free([pid])

    def clear(self) -> None:
        self._snaps.clear()
        self._evict(len(self._pages))


class SlotPrefixCache:
    """Prefix cache for a page-less model (DeepSeek-V4: per-slot window
    ring and compressed rows, no paged KV); the JAX package's
    ``SlotPrefixCache``.

    An entry is a whole prompt's token tuple with the slot-state snapshot
    taken after prefilling exactly those tokens (``dsv4.slot_export``, the
    payload a PD handoff ships) and, optionally, the prompt-end logits. A
    prompt extending a cached one imports the snapshot and runs only the
    suffix through the decode recurrence (``dsv4.prefill_resume``); an
    identical prompt with stored logits skips the forward. Snapshots are
    whole-slot rows (MBs each at full width), so the cache is LRU-capped by
    entry count, not bytes.
    """

    def __init__(self, max_entries: int = 4) -> None:
        # prompt token tuple -> (snapshot, logits [V] | None); dict order is
        # the LRU order (refreshed on a hit)
        self._entries: Dict[tuple, tuple] = {}
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0

    def match(self, tokens: Sequence[int]) -> Optional[tuple]:
        """The longest cached prompt that is a prefix of ``tokens``, as
        (pos, snapshot, logits); ``pos == len(tokens)`` only when the entry
        stored logits (no forward is left to make them). None on a miss."""
        t = tuple(tokens)
        best = None
        for key, (snap, logits) in self._entries.items():
            n = len(key)
            if n > len(t) or (n == len(t) and logits is None):
                continue
            if best is not None and n <= best[0]:
                continue
            if t[:n] == key:
                best = (n, key, snap, logits)
        if best is None:
            self.misses += 1
            return None
        n, key, snap, logits = best
        self._entries[key] = self._entries.pop(key)  # refresh its LRU place
        self.hits += 1
        return n, snap, logits

    def insert(self, tokens: Sequence[int], snap, logits=None) -> None:
        key = tuple(tokens)
        if not key:
            return
        old = self._entries.pop(key, None)
        if old is not None and logits is None:
            logits = old[1]  # a re-insert without logits keeps the old ones
        self._entries[key] = (snap, logits)
        while len(self._entries) > self.max_entries:
            self._entries.pop(next(iter(self._entries)))

    def clear(self) -> None:
        self._entries.clear()


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
