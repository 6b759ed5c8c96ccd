"""Per-request state slots, shared by the executors whose model keeps state
rows a request (DeepSeek-V4's ``SlotExecutor``, the Qwen3.5 hybrid's
``HybridExecutor``): the counterpart of ``JaxExecutor``'s slot handling.

A request takes a slot at its first prefill and gives it back when it is
released; ``free_slots()`` is the scheduler's second admission gate. Slot
``max_slots`` is the dead slot that padded decode rows use, never handed out.
"""

from __future__ import annotations


class StateSlots:
    """Mixin for an executor with ``acct`` (``KvAccounting``); call
    ``_init_slots`` from its ``__init__``."""

    def _init_slots(self, max_slots: int) -> None:
        self.max_slots = max_slots
        self._slots = {}  # request -> state slot
        self._free_slots = list(range(max_slots - 1, -1, -1))

    def free_slots(self) -> int:
        return len(self._free_slots)

    def release_request(self, request_id: int) -> None:
        self.acct.release(request_id)
        slot = self._slots.pop(request_id, None)
        if slot is not None:
            self._free_slots.append(slot)

    def _slot(self, request_id: int) -> int:
        slot = self._slots.get(request_id)
        if slot is None:
            if not self._free_slots:
                raise RuntimeError("state slot pool exhausted")
            slot = self._free_slots.pop()
            self._slots[request_id] = slot
        return slot
