"""Slot executor: the ModelExecutor for a page-less model (DeepSeek-V4,
DeepSeek-V2-Lite).

The port's counterpart of what ``pegainfer_tpu/engine/jax_executor.py`` does
for the slot runtimes (``models/dsv4_engine.py::make_runtime``,
``models/dsv2lite.py::make_runtime``). These families keep no paged KV:
each request owns a decode slot (DSv4: window ring, compressed rows,
pending projection rings; DSv2-Lite: its latent cache rows), so the page
accounting degenerates to page size 1 with a budget of ``max_model_len *
max_slots + 2`` pages, and admission is bound by the slots, which the
scheduler gates on ``free_slots()``.

The executor takes the family's functions as a ``SlotModel`` (``dsv4_model``
by default, ``models/dsv2lite.py::slot_model``). Whole-prompt prefill
writes the request's slot in place; a decode step runs the active requests
with the batch padded to its bucket by dead-slot rows at position 0.
Sampling and logprobs are ``torch_executor.py``'s.

``enable_prefix_cache`` turns on the slot prefix cache
(``engine/kv.py::SlotPrefixCache``) for a family with a resume function
(DSv4), as in the JAX executor: every fresh prefill stores a snapshot of
its slot (with the prompt-end logits when the request asked for logprobs);
a prompt that extends a cached one by a short suffix (at most ``max(32, T
// 16)`` tokens) imports the snapshot and runs the suffix through the
decode recurrence (``dsv4.prefill_resume``), and an identical prompt whose
entry kept its logits skips the forward. The cache holds at most 4 entries
and at most a fifth of the card's free memory. A family without a resume
function (DSv2-Lite) has no slot prefix cache, as in the JAX executor.
``prefill_chunk`` and ``prefill_chunk_mixed`` are taken with the JAX
engine's meaning for these families, which have no chunked prefill: every
prompt prefills whole (there is no ``prefill_stepper``, so the scheduler
never chunks one).

``slot_export`` / ``slot_import`` are the PD handoff's hooks
(``engine/pd.py``): the slot's rows are the whole payload.

For DSv4, ``quantize="int8-experts"`` serves experts requantized to int8
at load and ``quantize="bf16"`` weights dequantized to bf16 at load
(``models/dsv4_engine.py``); ``moe_chain`` is handed to every prefill,
resume and decode step (``models/dsv4.py``). An echo request with logprobs
skips the slot-cache resume and prefills whole with every row's logits,
reduced on the device to its prompt logprobs; its snapshot goes into the
cache with the last logits, as in the JAX executor.

With ``precompile`` and ``enable_cuda_graph`` (the defaults) the decode
step replays one CUDA graph per batch bucket (``engine/decode_graphs.py``,
the family's ``Family``: tokens, positions and slots, padding rows on the
dead slot; DSv4's ``moe_chain`` bound in), captured at the bucket's first
use: the JAX slot engines compile their decode program at first use and
never call ``precompile``, so neither does this one. A slot-cache resume
replays the B = 1 graph on the request's slot, one suffix token a replay,
and keeps a copy of the last logits (the next replay of that graph
overwrites them). Either option False keeps the eager step (the family's
``decode``, ``dsv4.prefill_resume``).

Decode blocks are ``torch_executor.py``'s ``BlockDecode`` over this
executor's ``_decode_host`` (the slots' pages for ``1 + extra_tokens``
writes): a block graph of the family per (B, 0, N, greedy, lp_k), captured
at first use; the resume keeps the one-token B = 1 graph.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace
from functools import partial
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from pegainfer_tpu_torch.engine import torch_executor as tx
from pegainfer_tpu_torch.engine.contract import EngineLoadOptions
from pegainfer_tpu_torch.engine.decode_graphs import DecodeGraphs, Family
from pegainfer_tpu_torch.engine.decode_graphs import dsv4 as dsv4_family
from pegainfer_tpu_torch.engine.executor import (
    DecodePlan,
    PrefillPlan,
    PrefillRequestResult,
    PrefillResult,
    UnifiedPlan,
    UnifiedResult,
)
from pegainfer_tpu_torch.engine.kv import KvAccounting, PagePool, SlotPrefixCache
from pegainfer_tpu_torch.engine.slots import StateSlots
from pegainfer_tpu_torch.engine.torch_executor import (
    BATCH_BUCKETS,
    BlockDecode,
    bucket_batch,
    first_token,
    prompt_logprobs,
    wants_prompt_logprobs,
)
from pegainfer_tpu_torch.models import dsv4
from pegainfer_tpu_torch.ops import sampling as smp

log = logging.getLogger("pegainfer_torch.slot_executor")

# the slot prefix cache's entries: at most this many, and at most this share
# of the card's free memory (the JAX executor's ``_slot_cache_cap``)
SLOT_CACHE_ENTRIES = 4
SLOT_CACHE_FRACTION = 0.2


DSV4_QUANTIZE = (None, "int8-experts", "bf16")
# DSv4 prefills whole: TorchExecutor's chunk rules do not apply
check_supported = partial(tx.check_supported, family="DeepSeek-V4", quantize=DSV4_QUANTIZE,
                          chunked=False)


@dataclass(frozen=True)
class SlotModel:
    """A page-less family's functions, bound to its config and params:
    ``prefill(tokens, state, slot, all_logits)`` -> (last logits [V], every
    row's [T, V] with ``all_logits``, else None), the slot written in
    place; ``decode(state, tokens, positions, slots)`` -> logits [B, V];
    ``slot_export(state, slot)`` (a copy), ``slot_import(state, snap,
    slot)``, ``snapshot_bytes(state)``; ``graph_family(dead_slot)``, the
    decode graphs' ``Family``; ``resume(state, tokens, start, slot)`` -> the
    last logits [V] of a prompt continued from a cached prefix, or None (no
    slot prefix cache). ``family`` and ``quantize`` name the family and the
    ``quantize`` values it serves."""

    family: str
    quantize: tuple
    prefill: Callable
    decode: Callable
    slot_export: Callable
    slot_import: Callable
    snapshot_bytes: Callable
    graph_family: Callable
    resume: Optional[Callable] = None


def dsv4_model(cfg: dsv4.DSv4Config, params, moe_chain: Optional[bool] = None,
               tp=None, tape: Callable = lambda: None) -> SlotModel:
    """DeepSeek-V4's functions (``models/dsv4.py``, looked up at each call),
    ``moe_chain`` and ``tp`` (a rank's groups: its shard ``params`` at its
    local ``cfg``) bound in; each call takes the route tape that ``tape()``
    returns at that moment (None: none)."""
    def prefill(tokens, state, slot, all_logits):
        logits, _ = dsv4.prefill(cfg, params, tokens, state=state, slot=slot,
                                 last_only=not all_logits, moe_chain=moe_chain, tp=tp,
                                 tape=tape())
        # a copy of an echo prompt's last row: the cache must not hold [T, V]
        return (logits[-1].clone(), logits) if all_logits else (logits[0], None)

    def decode(state, tokens, positions, slots):
        return dsv4.decode(cfg, params, state, tokens, positions, slots, moe_chain=moe_chain,
                           tp=tp, tape=tape())

    def resume(state, tokens, start, slot):
        return dsv4.prefill_resume(cfg, params, state, tokens, start, slot,
                                   moe_chain=moe_chain, tp=tp, tape=tape())

    return SlotModel(family="DeepSeek-V4", quantize=DSV4_QUANTIZE, prefill=prefill,
                     decode=decode, slot_export=dsv4.slot_export, slot_import=dsv4.slot_import,
                     snapshot_bytes=dsv4.snapshot_bytes, graph_family=dsv4_family, resume=resume)


def slot_cache_cap(snapshot_bytes: int, device: torch.device) -> int:
    """Entries of the slot prefix cache: ``SLOT_CACHE_ENTRIES``, or fewer
    when that many snapshots would take more than ``SLOT_CACHE_FRACTION``
    of the card's free memory (snapshots lie outside the slot state). On
    the CPU the cap is the default."""
    if device.type != "cuda" or not snapshot_bytes:
        return SLOT_CACHE_ENTRIES
    free, _ = torch.cuda.mem_get_info(device)
    cap = min(SLOT_CACHE_ENTRIES, int(free * SLOT_CACHE_FRACTION) // snapshot_bytes)
    if cap < SLOT_CACHE_ENTRIES:
        log.warning("slot prefix cache capped at %d entries (%.1f MB a snapshot, %.1f MB free)",
                    cap, snapshot_bytes / 2**20, free / 2**20)
    return cap


class SlotExecutor(StateSlots, BlockDecode):
    """Continuous-batching executor for one page-less model with per-slot
    state on one device: ``model``'s functions (DSv4's by default, with
    ``moe_chain``). With ``tp`` (a rank's groups) it is one rank of a
    model-parallel DSv4 engine (``parallel/tp_executor.py``): its shard and
    local config, the whole slot state, the eager decode step, and a slot
    prefix cache of as many entries as every rank can hold."""

    def __init__(self, cfg, params, state, max_slots: int,
                 max_model_len: int, options: Optional[EngineLoadOptions] = None,
                 moe_chain: Optional[bool] = None, model: Optional[SlotModel] = None,
                 tp=None):
        opts = options or EngineLoadOptions()
        if tp is not None:
            tx.check_tp_supported(opts)
        self.tp = tp
        self.tape = None  # DeepSeek-V4's route tape (models/dsv4.py::RouteTape), when set
        self.model = (model if model is not None
                      else dsv4_model(cfg, params, moe_chain, tp, lambda: self.tape))
        tx.check_supported(opts, family=self.model.family, quantize=self.model.quantize,
                           chunked=False)
        self.cfg = cfg
        self.params = params
        self.state = state
        self.device = params["embed"].device
        self._init_slots(max_slots)
        self.acct = KvAccounting(PagePool(max_model_len * max_slots + 2), 1)
        self.max_batch = min(opts.max_batch_size, max_slots)
        self._max_pages = min(self.acct.pool.available, max_model_len)
        self._stop_ids = frozenset({cfg.eos_token_id})
        self.snapshot_bytes = self.model.snapshot_bytes(state)
        cap = (slot_cache_cap(self.snapshot_bytes, self.device)
               if opts.enable_prefix_cache and self.model.resume is not None else 0)
        if tp is not None:  # ranks that share a card see different free memory
            cap = tp.agree_min(cap)
        self.slot_prefix_cache = SlotPrefixCache(max_entries=cap) if cap > 0 else None
        # the decode step under CUDA graphs, each bucket captured at first use
        self._graphs = None
        if opts.precompile and opts.enable_cuda_graph:
            top = bucket_batch(self.max_batch)
            self._graphs = DecodeGraphs(
                partial(self.model.decode, state), self.device,
                [b for b in BATCH_BUCKETS if b <= top], 0, self._graph_family())
        # what ran, for callers that check the path (chip_smoke.py): fresh
        # prefills, the decode steps of cache resumes; decode steps and
        # blocks (_init_blocks)
        self.prefills = 0
        self.resume_steps = 0
        self._init_blocks(opts)

    # ── scheduler-facing accounting ──────────────────────────────────

    def page_size(self) -> int:
        return 1

    def available_pages(self) -> int:
        return self.acct.pool.available

    def max_request_pages(self) -> int:
        return self._max_pages

    def is_stop_token(self, token_id: int) -> bool:
        return token_id in self._stop_ids

    # ── prefill ──────────────────────────────────────────────────────

    def _prefill_one(self, item) -> PrefillRequestResult:
        T = len(item.prompt_tokens)
        st = self.acct.state(item.request_id)
        want_all = wants_prompt_logprobs(item)  # echo: every row's logits
        if self.slot_prefix_cache is not None and st.length == 0 and not want_all:
            res = self._maybe_prefill_resume(item, st)
            if res is not None:
                return res
        st.ensure_capacity(self.acct.pool, T)
        slot = self._slot(item.request_id)
        tokens = torch.tensor(item.prompt_tokens, dtype=torch.int32, device=self.device)
        last, logits = self.model.prefill(tokens, self.state, slot, want_all)
        st.advance(T)
        self.prefills += 1
        if self.slot_prefix_cache is not None:
            # the prompt-end logits are kept where the JAX executor keeps
            # them, for a request that asked for logprobs (its fused greedy
            # prefill returns none): a later identical prompt then skips
            # its forward exactly where the JAX executor's does
            self._slot_cache_insert(item, slot, last if item.logprobs > 0 else None)
        res = first_token(item, last)
        if want_all:  # row t predicts prompt token t + 1
            lps = prompt_logprobs([smp.token_logprob(logits[: T - 1], tokens[1:])])
            res = replace(res, prompt_logprobs=lps)
        return res

    def _slot_cache_insert(self, item, slot: int, logits=None) -> None:
        self.slot_prefix_cache.insert(item.prompt_tokens, self.slot_export(slot), logits)

    def _maybe_prefill_resume(self, item, st) -> Optional[PrefillRequestResult]:
        """Serve a prompt from the slot prefix cache: import the longest
        cached snapshot into the request's slot and run the rest of the
        prompt through the decode recurrence; an identical prompt with
        stored logits runs nothing. None when there is no usable hit (the
        caller prefills from scratch)."""
        T = len(item.prompt_tokens)
        hit = self.slot_prefix_cache.match(item.prompt_tokens)
        if hit is None:
            return None
        pos, snap, logits = hit
        suffix = T - pos
        # a resume runs at decode rate, one token a step, so it pays only
        # for a short suffix on a long cached prefix; past this a fresh
        # prefill is faster (the JAX executor's threshold)
        if suffix > max(32, T // 16):
            return None
        st.ensure_capacity(self.acct.pool, T)
        slot = self._slot(item.request_id)
        self.slot_import(snap, slot)
        if suffix:
            logits = self._resume(item.prompt_tokens[pos:], pos, slot)
            self.resume_steps += suffix
        st.advance(T)
        if suffix:  # the extended prompt is itself a likely future prefix
            self._slot_cache_insert(item, slot, logits)
        return first_token(item, logits)

    def _resume(self, tokens: Sequence[int], start: int, slot: int) -> torch.Tensor:
        """Run ``tokens`` through the decode recurrence on ``slot`` from
        position ``start``; the last step's logits [V]. Graphed: one
        replay of the B = 1 graph a token; eager: the model's ``resume``."""
        if self._graphs is None:
            return self.model.resume(
                self.state, torch.tensor(tokens, dtype=torch.int32, device=self.device),
                start, slot)
        one = np.array([slot], np.int32)
        for i, tok in enumerate(tokens):
            logits = self._graphs.run(np.array([tok], np.int32),
                                      np.array([start + i], np.int32), one)
        return logits[0].clone()

    def execute_prefill(self, plan: PrefillPlan) -> PrefillResult:
        return PrefillResult(requests=[self._prefill_one(it) for it in plan.requests])

    # ── decode ───────────────────────────────────────────────────────

    def _decode_host(self, items, extra_tokens: int = 0):
        """One more token per request (pages for ``1 + extra_tokens``
        writes), as numpy (tokens, positions, slots); padding rows take the
        dead slot at position 0."""
        B = bucket_batch(len(items))
        tokens = np.zeros(B, np.int32)
        positions = np.zeros(B, np.int32)
        slots = np.full(B, self.max_slots, np.int32)
        states = []
        for i, it in enumerate(items):
            st = self.acct.state(it.request_id)
            st.ensure_capacity(self.acct.pool, st.length + 1 + extra_tokens)
            states.append(st)
            tokens[i], positions[i] = it.token_id, st.length
            slots[i] = self._slot(it.request_id)
        return (tokens, positions, slots), states

    def _decode_model(self, items, tokens, positions, slots):
        """The model call of one decode step over the padded batch: logits
        [B, V]."""
        return self.model.decode(self.state, tokens, positions, slots)

    def _graph_family(self) -> Family:
        return self.model.graph_family(self.max_slots)

    # ── the slot's rows: cache snapshots, PD hooks (engine/pd.py) ────

    def slot_export(self, slot: int):
        """A copy of ``slot``'s rows in every layer (a PD handoff's whole
        payload)."""
        return self.model.slot_export(self.state, slot)

    def slot_import(self, snap, slot: int) -> None:
        self.model.slot_import(self.state, snap, slot)

    # ── unified ──────────────────────────────────────────────────────

    def execute_unified(self, plan: UnifiedPlan) -> UnifiedResult:
        """Prefill the new prompts, then one decode step for the active set."""
        prefill = self.execute_prefill(PrefillPlan(requests=plan.prefill_requests))
        decode = self.execute_decode(DecodePlan(requests=plan.decode_requests))
        return UnifiedResult(prefill_requests=prefill.requests,
                             decode_requests=decode.requests)
