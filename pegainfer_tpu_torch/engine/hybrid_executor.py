"""Hybrid executor: the ModelExecutor for the Qwen3.5 hybrid, paged KV for
its full-attention layers beside per-request recurrent and conv state
slots for its GDN layers.

The port's counterpart of what ``pegainfer_tpu/engine/jax_executor.py``
does for the Qwen3.5 runtime (``models/qwen35.py::make_runtime``): page
accounting, sampling, logprobs, the prefill stepper and the fused mixed
piece are ``TorchExecutor``'s; a request takes a state slot at its prefill
or its first piece and frees it on release (``StateSlots``, whose
``free_slots`` the scheduler gates admission on); a decode step, or a
fused piece's decode rows, pads its batch to the bucket with rows at
seq_len 0 on the null page and the dead slot ``max_slots``.

``prefill_chunk``, ``prefill_chunk_mixed`` and ``enable_prefix_cache`` have
the JAX engine's meanings. With the cache on, a prompt matches only at a
state snapshot (``PrefixCache.match_hybrid``), whose rows are copied into
the request's slot before its first piece; the stepper ends a long prompt
with a fine tail and snapshots (copies of the slot's rows) the deepest
piece end within a chunk of the prompt's end and the page-aligned end.
A PD handoff (``engine/pd.py``) carries the request's pages and its slot's
rows (``export_pages`` / ``import_pages``, ``slot_export`` /
``slot_import``). ``quantize="int8"`` serves int8 weight-only projections
(``models/qwen35.py::quantize_params_int8``, applied at engine start).
Echo is ``TorchExecutor``'s over the hybrid's ``prefill`` /
``prefill_chunk``: with logprobs, no cache lookup, pieces with all their
logits and never fused, while the fine tail and the state snapshots follow
the stepper as for any prompt.

With ``precompile`` and ``enable_cuda_graph`` (the defaults) its decode
step replays CUDA graphs as Qwen3's does (``engine/decode_graphs.py``, the
``hybrid`` family): the rows' state slots are the fifth static input,
written with the others from one pinned stage, padding rows on the dead
slot (a warm-up or a padding row must never write a live slot's rows); the
engine captures the batch ladder at width 8 at start
(``models/qwen35_engine.py``), other widths at first use. The fused mixed
step's decode rows stay eager. Either option False keeps the eager step.
Decode blocks are ``TorchExecutor``'s (``BlockDecode``): a block graph of
the ``hybrid`` family holds N steps on the same slots, its padding rows on
the dead slot.

Tensor parallelism: with ``tp`` (a rank's ``parallel/group.py::RankGroups``)
the executor holds one rank's shard and state (made at the rank's
``local_config_qwen35``) and passes ``tp`` to every model call; the decode
step is then eager (``TorchExecutor``'s ``check_tp_supported``). The slot
map, the page accounting and the snapshots of each rank's executor follow
the same calls in the same order (``parallel/tp_executor.py``).
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial
from typing import Optional

import numpy as np

from pegainfer_tpu_torch.engine.contract import EngineLoadOptions
from pegainfer_tpu_torch.engine.decode_graphs import Family, hybrid
from pegainfer_tpu_torch.engine.slots import StateSlots
from pegainfer_tpu_torch.engine import torch_executor as tx
from pegainfer_tpu_torch.engine.torch_executor import TorchExecutor
from pegainfer_tpu_torch.models import qwen35 as q35

# TorchExecutor's rules (the prefix cache needs prefill_chunk), naming Qwen3.5
check_supported = partial(tx.check_supported, family="Qwen3.5")


class HybridExecutor(StateSlots, TorchExecutor):
    """Continuous-batching executor for one Qwen3.5 hybrid on one device;
    ``state`` is ``models/qwen35.py::make_state``'s, whose slots (all but
    its dead one) are the requests' state slots."""

    def __init__(self, cfg: q35.Qwen35Config, params, state,
                 options: Optional[EngineLoadOptions] = None, tp=None):
        opts = options or EngineLoadOptions()
        check_supported(opts)  # on the options as given, before the slots cap the batch
        self.state = state
        self._init_slots(state["rec"].shape[2] - 1)
        # a decode batch fits the slots, and so do the graphs' buckets
        super().__init__(cfg, params, state["kv"],
                         replace(opts, max_batch_size=min(opts.max_batch_size, self.max_slots)),
                         tp=tp)
        self._hybrid_cache = self.prefix_cache is not None

    def _slots_of(self, items, B: int) -> np.ndarray:
        """The decode rows' state slots, padding rows on the dead slot."""
        slots = np.full(B, self.max_slots, np.int32)
        slots[: len(items)] = [self._slot(it.request_id) for it in items]
        return slots

    def _decode_host(self, items, extra_tokens: int = 0):
        """``TorchExecutor``'s arrays (pages for ``1 + extra_tokens``
        writes) and the rows' state slots."""
        host, states = super()._decode_host(items, extra_tokens)
        return (*host, self._slots_of(items, host[0].shape[0])), states

    def _prefill_model(self, item, tokens, table, all_logits: bool = False):
        last_logits, every = q35.prefill(self.cfg, self.params, self.state, tokens, table,
                                         self._slot(item.request_id),
                                         return_all_logits=all_logits, tp=self.tp)
        return every if all_logits else last_logits

    def _chunk_model(self, item, chunk_tokens, start: int, valid: int, table,
                     all_logits: bool = False):
        return q35.prefill_chunk(self.cfg, self.params, self.state, chunk_tokens, start,
                                 valid, table, self._slot(item.request_id),
                                 return_all_logits=all_logits, tp=self.tp)

    def _mixed_model(self, item, items, chunk_tokens, start: int, valid: int, table, dec):
        return q35.mixed_chunk(self.cfg, self.params, self.state, chunk_tokens, start, valid,
                               table, self._slot(item.request_id), *dec, tp=self.tp)

    def _decode_model(self, items, tokens, positions, tables, seq_lens, slots):
        return q35.decode(self.cfg, self.params, self.state, tokens, positions, tables,
                          seq_lens, slots, tp=self.tp)

    def _graph_step(self):
        return partial(q35.decode, self.cfg, self.params, self.state)

    def _graph_family(self) -> Family:
        return hybrid(self.max_slots)

    # ── slot rows: cache snapshots, PD hooks (engine/pd.py); the pages'
    # hooks are TorchExecutor's, on state["kv"] ─────────────────────────

    def slot_export(self, slot: int):
        """A copy of ``slot``'s recurrent and conv rows."""
        return q35.slot_export(self.state, slot)

    def slot_import(self, snap, slot: int) -> None:
        q35.slot_import(self.state, snap, slot)
