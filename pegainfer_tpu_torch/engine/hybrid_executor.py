"""Hybrid executor: the ModelExecutor for the Qwen3.5 hybrid, paged KV for
its full-attention layers beside per-request recurrent and conv state
slots for its GDN layers.

The port's counterpart of what ``pegainfer_tpu/engine/jax_executor.py``
does for the Qwen3.5 runtime (``models/qwen35.py::make_runtime``): page
accounting, sampling and logprobs are ``TorchExecutor``'s; a request takes a
state slot at its prefill and frees it on release (``StateSlots``, whose
``free_slots`` the scheduler gates admission on); a decode step pads its
batch to the bucket with rows at seq_len 0 on the null page and the dead
slot ``max_slots``.

Not here yet, and refused with ``NotImplementedError``: chunked prefill
(and so the fused mixed step), the hybrid prefix cache, int8 weights,
multi-token decode blocks and echo.
"""

from __future__ import annotations

from typing import Optional

import torch

from pegainfer_tpu_torch.engine.contract import EngineLoadOptions
from pegainfer_tpu_torch.engine.slots import StateSlots
from pegainfer_tpu_torch.engine.torch_executor import TorchExecutor
from pegainfer_tpu_torch.models import qwen35 as q35


def check_supported(opts: EngineLoadOptions) -> None:
    """Refuse the JAX Qwen3.5 engine's options the port does not implement."""
    unsupported = {
        "prefill_chunk (chunked prefill, mixed step)": opts.prefill_chunk is not None,
        "enable_prefix_cache (hybrid state snapshots)": opts.enable_prefix_cache,
        f"quantize={opts.quantize!r}": opts.quantize is not None,
        "decode_block": opts.decode_block != 1,
    }
    named = [k for k, v in unsupported.items() if v]
    if named:
        raise NotImplementedError(
            "the PyTorch port's Qwen3.5 engine does not support yet: " + ", ".join(named))


class HybridExecutor(StateSlots, TorchExecutor):
    """Continuous-batching executor for one Qwen3.5 hybrid on one device;
    ``state`` is ``models/qwen35.py::make_state``'s, whose slots (all but
    its dead one) are the requests' state slots."""

    def __init__(self, cfg: q35.Qwen35Config, params, state,
                 options: Optional[EngineLoadOptions] = None):
        opts = options or EngineLoadOptions()
        check_supported(opts)
        super().__init__(cfg, params, state["kv"], opts)
        self.state = state
        self._init_slots(state["rec"].shape[2] - 1)
        self.max_batch = min(opts.max_batch_size, self.max_slots)

    def _prefill_model(self, item, tokens, table):
        last_logits, _ = q35.prefill(self.cfg, self.params, self.state, tokens, table,
                                     self._slot(item.request_id))
        return last_logits

    def _decode_model(self, items, tokens, positions, tables, seq_lens):
        slots = torch.full(tokens.shape, self.max_slots, dtype=torch.int32)
        slots[: len(items)] = torch.tensor([self._slot(it.request_id) for it in items])
        return q35.decode(self.cfg, self.params, self.state, tokens, positions, tables,
                          seq_lens, slots.to(self.device))
