"""PyTorch ModelExecutor for Qwen3 over a device-resident paged KV pool.

Counterpart of ``pegainfer_tpu/engine/jax_executor.py``: whole-prompt and
chunked prefill with greedy / temperature / top-k / top-p sampling, the page
prefix cache, one decode token per step for the active batch, and the fused
mixed step (a prefill piece's rows and one decode row per active stream in
one forward). A prefill piece runs eagerly at its own length. A decode
step pads its batch to the JAX executor's batch buckets (padding rows:
token 0, position 0, seq_len 0, null pages) and its page table to the JAX
executor's power-of-two widths (``bucket_pow2(P, 8, table_cap)``, the
fused mixed step's decode rows too). With ``precompile`` and
``enable_cuda_graph`` (the defaults) the decode step replays one CUDA
graph per (batch bucket, width) over static input buffers
(``engine/decode_graphs.py``): the JAX executor's bucket ladder, captured
by ``precompile()`` at engine start, other widths at first use; on the
CPU the same buffers feed the eager forward. Sampling and logprobs run
after the graph, on its logits. The model calls are hooks
(``_prefill_model``, ``_chunk_model``, ``_mixed_model``, ``_decode_model``,
and ``_graph_step`` / ``_graph_family`` for the graphs) that
``HybridExecutor`` overrides; with
its cache on (``_hybrid_cache``), the stepper also keeps state snapshots
at piece ends and restores a cache hit's before the first piece, through
its ``slot_export`` / ``slot_import``. ``export_pages`` / ``import_pages``
are the PD handoff's hooks (``engine/pd.py``).

``quantize="int8"`` serves int8 weight-only projections
(``models/qwen3.py::quantize_params_int8``, applied at engine start); the
executor runs them as it runs bf16 weights.

Echo: a request with ``echo`` gets its prompt back first
(``PromptTokens``, sent by the scheduler). With ``logprobs`` as well, the
executor computes each prompt token's logprob given the tokens before it,
as the JAX executor does: it skips the prefix cache's lookup for the
request, prefills whole with all logits or, past ``prefill_chunk``, runs
each stepper piece with all its logits (never fused with decode rows),
reduces them on the device to the piece's [Tc] target logprobs and reads
them from the host once, after the last piece.

Decode blocks (``BlockDecode``, shared with ``SlotExecutor``): the JAX
executor's async decode. ``execute_decode_async`` dispatches N steps with
sampling on the card (a block graph of N steps under the graph options,
``DecodeGraphs.run_block``; N = 1 replays the one-token graph and samples
after it; eager: ``decode_block`` over the step), pages pre-extended for
the N writes, the first tokens taken from the previous block's last row
on the card when the batch width matches; its outputs start on their way
to pinned host memory at once and are read by ``resolve_pending(_multi)``.
``execute_decode`` is one such block of one token, read at once, unless a
row asks for logprobs: then the one-token step keeps its logits and
samples after it (the JAX executor's ``_execute_decode_with_logits``).
``decode_steps`` counts the steps computed (tokens a row, a block's N
included), ``decode_blocks`` the dispatches.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, replace
from functools import partial
from typing import List, Optional, Tuple

import numpy as np
import torch

from pegainfer_tpu_torch.engine.contract import EngineLoadOptions, TokenLogprob, block_options
from pegainfer_tpu_torch.engine.decode_graphs import (QWEN3, DecodeGraphs, Family, decode_block,
                                                      unpack_block)
from pegainfer_tpu_torch.engine.executor import (
    DecodePlan,
    DecodeRequestResult,
    DecodeResult,
    PrefillPlan,
    PrefillRequestResult,
    PrefillResult,
    UnifiedPlan,
    UnifiedResult,
)
from pegainfer_tpu_torch.engine.kv import KvAccounting, PagePool, PrefixCache
from pegainfer_tpu_torch.models import qwen3 as q3
from pegainfer_tpu_torch.ops import sampling as smp

log = logging.getLogger("pegainfer_torch.executor")

BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def bucket_batch(n: int) -> int:
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"batch {n} exceeds max bucket {BATCH_BUCKETS[-1]}")


def bucket_pow2(n: int, lo: int, hi: int) -> int:
    """The JAX executor's power-of-two bucket: the least ``lo * 2^k >= n``,
    kept within [lo, hi]."""
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(max(b, lo), hi)


def table_cap(max_pages: int, chunk: int, page_size: int) -> int:
    """The widest decode table: the least power of two from 8 that holds a
    request's most pages plus one chunk of slack, as the JAX executor
    computes it (``chunk`` 0 when prompts prefill whole)."""
    cap = 8
    while cap < max_pages + chunk // page_size:
        cap *= 2
    return cap


def check_supported(opts: EngineLoadOptions, family: str = "Qwen3",
                    quantize: tuple = (None, "int8"), chunked: bool = True) -> None:
    """Refuse a ``quantize`` value outside the ``family``'s ``quantize``
    (the error names the family and the value), then, for a family that
    prefills in pieces (``chunked``), option values that cannot work."""
    if opts.quantize not in quantize:
        raise NotImplementedError(f"the PyTorch port's {family} engine does not support yet: "
                                  f"quantize={opts.quantize!r}")
    if not chunked:
        return
    if opts.max_batch_size > BATCH_BUCKETS[-1]:
        raise ValueError(f"max_batch_size above {BATCH_BUCKETS[-1]}")
    if opts.prefill_chunk is not None and opts.prefill_chunk <= 0:
        raise ValueError(f"prefill_chunk must be positive, got {opts.prefill_chunk}")
    if opts.prefill_chunk_mixed <= 0:
        raise ValueError(
            f"prefill_chunk_mixed must be positive, got {opts.prefill_chunk_mixed}")
    if opts.enable_prefix_cache and opts.prefill_chunk is None:
        # a cache hit prefills the rest of the prompt from an offset: the
        # chunk path
        raise ValueError("enable_prefix_cache needs prefill_chunk (the cached prefix is "
                         "continued by the chunked prefill)")


# the tail piece of a chunked prefill (a short remainder, such as a
# near-whole prefix-cache hit, does not pay for a whole chunk)
SMALL_PIECE = 256


def small_piece(chunk: int, page_size: int) -> int:
    return SMALL_PIECE if SMALL_PIECE % page_size == 0 and SMALL_PIECE < chunk else chunk


def plan_piece(T: int, start: int, chunk: int, mixed: int, small: int,
               decode_active: bool, fine_tail: bool = False, page_size: int = 1) -> int:
    """End of the prefill piece starting at ``start`` of a ``T``-token
    prompt: the JAX stepper's ``plan_piece``. ``mixed`` pieces while other
    requests decode, else ``chunk``; a remainder of at most ``small`` tokens
    goes in one piece. With ``start`` and the three sizes page multiples,
    every interior end is page-aligned.

    ``fine_tail`` (a hybrid model's prefix cache on, ``small < chunk``):
    the schedule ends in a piece of at most ``small`` tokens from the
    page boundary at or above ``T - small``, so the deepest state snapshot
    lies within ``small`` tokens of the prompt's end."""
    size = mixed if decode_active else chunk
    if fine_tail and T - start > small:
        b = -(-(T - small) // page_size) * page_size  # the last piece's start
        return start + size if b - start > size else b
    return min(start + (small if T - start <= small else size), T)


def sample_tokens(logits, items) -> Tuple[List[int], torch.Tensor]:
    """Sample one token per row of ``logits`` [n, V] (on the device) by each
    item's params and ``random_val``. Returns (host tokens, device tokens)."""
    if all(it.params.is_greedy for it in items):
        toks = smp.sample_greedy(logits)
    else:
        def col(f, dtype):
            return torch.tensor([f(it) for it in items], dtype=dtype, device=logits.device)

        toks = smp.sample(
            logits,
            col(lambda it: it.params.temperature, torch.float32),
            col(lambda it: it.params.top_k, torch.int32),
            col(lambda it: it.params.top_p, torch.float32),
            col(lambda it: it.random_val, torch.float32),
        )
    return toks.tolist(), toks


def token_logprobs(logits, toks, items) -> List[Optional[TokenLogprob]]:
    """The logprob of each sampled token and the top ``item.logprobs``
    alternatives, for the items that ask for them (None elsewhere)."""
    out: List[Optional[TokenLogprob]] = [None] * len(items)
    n_top = max(it.logprobs for it in items)
    if n_top <= 0:
        return out
    chosen = smp.token_logprob(logits, toks).tolist()
    vals, ids = smp.top_logprobs(logits, n_top)
    vals, ids = vals.tolist(), ids.tolist()
    for i, it in enumerate(items):
        if it.logprobs > 0:
            out[i] = TokenLogprob(
                logprob=chosen[i],
                top_logprobs=[(ids[i][j], vals[i][j]) for j in range(it.logprobs)],
            )
    return out


def wants_prompt_logprobs(item) -> bool:
    """An echo request that asked for logprobs: its prompt's logprobs are
    computed (every prompt row's logits), as in the JAX executor."""
    return item.echo and item.logprobs > 0


def prompt_logprobs(parts) -> List[Optional[TokenLogprob]]:
    """An echo prompt's logprobs: None for its first token, then each
    later token's given the tokens before it, from device tensors ``parts``
    (in order) read from the host at once."""
    vals = torch.cat(parts).tolist() if parts else []
    return [None] + [TokenLogprob(logprob=v) for v in vals]


def first_token(item, last_logits) -> PrefillRequestResult:
    """Sample a prompt's first output token from its last logits [V]."""
    logits = last_logits[None, :]
    host, dev = sample_tokens(logits, [item])
    return PrefillRequestResult(
        request_id=item.request_id,
        first_token=host[0],
        first_token_logprob=token_logprobs(logits, dev, [item])[0],
    )


@dataclass
class PendingDecode:
    """Decode rows dispatched but not yet applied: a block's outputs on
    their way to the host (``execute_decode_async``: its tokens [N, B] on
    the card, which the next block may take as its first tokens, and the
    flat outputs in pinned memory once ``copied`` has passed), or a fused
    mixed piece's decode rows, sampled and read (``tokens``,
    ``logprobs``), which the scheduler applies one piece late
    (``resolve_pending_multi``)."""

    items: list
    tokens: Optional[List[int]] = None
    logprobs: Optional[List[Optional[TokenLogprob]]] = None
    tokens_dev: Optional[torch.Tensor] = None
    out: Optional[torch.Tensor] = None
    copied: Optional["torch.cuda.Event"] = None
    n_steps: int = 1
    lp_k: int = 0


# the most logprobs a row of a decode block computes on the card (top-k
# over [B, V]); a row that asks for more takes the one-token step
MAX_FUSED_LOGPROBS = 32


class BlockDecode:
    """The JAX executor's async decode over an executor's ``_decode_host``
    (numpy arrays in the family's order, pages or slots for ``1 +
    extra_tokens`` writes), ``_decode_model`` (the eager step),
    ``_graph_family`` and ``_graphs`` (None: eager). ``_init_blocks`` sets
    the block options and the counters."""

    def _init_blocks(self, opts: EngineLoadOptions) -> None:
        self.decode_block, self.decode_block_max, self.decode_pipeline_depth = (
            block_options(opts))
        self.decode_steps = 0  # steps computed: tokens a row
        self.decode_blocks = 0  # dispatches
        self._mixed_toks = None

    @property
    def graph_captures(self) -> int:
        """CUDA graphs captured so far (0 with the eager step or on the CPU)."""
        return 0 if self._graphs is None else len(self._graphs.capture_log)

    def supports_async_decode(self, items) -> bool:
        return (len(items) <= self.max_batch
                and all(it.logprobs <= MAX_FUSED_LOGPROBS for it in items))

    def _decode_inputs(self, items, extra_tokens: int = 0):
        """``_decode_host``'s arrays on the device."""
        host, states = self._decode_host(items, extra_tokens)
        return [torch.from_numpy(a).to(self.device) for a in host], states

    def execute_decode_async(self, items, tokens_dev: Optional[torch.Tensor] = None,
                             n_tokens: int = 1, rand_matrix=None) -> PendingDecode:
        """Dispatch one block of ``n_tokens`` decode steps with sampling on
        the card, without reading it. ``tokens_dev``: the previous block's
        tokens [N, B] on the card, whose last row is this block's first
        tokens when the batch width matches (the host's token ids are then
        stale). ``rand_matrix``: [n_tokens, len(items)] uniform draws for
        the sampled rows, else each item's ``random_val`` for the first
        step."""
        n, N = len(items), n_tokens
        self._mixed_toks = None  # tokens advance outside the fused chain
        if self._graphs is not None:
            host, states = self._decode_host(items, N - 1)
            B = host[0].shape[0]
        else:
            inputs, states = self._decode_inputs(items, N - 1)
            B = inputs[0].shape[0]
        feed = tokens_dev[-1] if tokens_dev is not None and tokens_dev.shape[-1] == B else None
        lp_max = max((it.logprobs for it in items), default=0)
        lp_k = bucket_pow2(lp_max, 1, MAX_FUSED_LOGPROBS) if lp_max else 0
        sampling = None
        if not all(it.params.is_greedy for it in items):
            temp = np.zeros(B, np.float32)
            top_k = np.full(B, -1, np.int32)
            top_p = np.ones(B, np.float32)
            rand = np.zeros((N, B), np.float32)
            for i, it in enumerate(items):
                temp[i], top_k[i], top_p[i] = (it.params.temperature, it.params.top_k,
                                               it.params.top_p)
                rand[0, i] = it.random_val
            if rand_matrix is not None:
                rand[:, :n] = rand_matrix
            sampling = (temp, top_k, top_p, rand)
        if self._graphs is not None and N > 1:
            out = self._graphs.run_block(host, N, sampling, lp_k, feed)
        else:
            dev = None if sampling is None else [torch.from_numpy(a).to(self.device)
                                                 for a in sampling]
            with torch.no_grad():
                if self._graphs is not None:
                    # one token: the one-token graph (the precompiled
                    # ladder), sampled after it
                    out = decode_block(lambda: self._graphs.run(*host, tokens=feed), {}, (),
                                       1, dev, lp_k)
                else:
                    order = self._graph_family().args
                    args = dict(zip(order, inputs))
                    if feed is not None:
                        args["tokens"] = feed
                    out = decode_block(lambda *a: self._decode_model(items, *a), args, order,
                                       N, dev, lp_k)
        for st in states:
            st.advance(N)
        self.decode_steps += N
        self.decode_blocks += 1
        copied = None
        if out.is_cuda:  # to the host now, read at the resolve
            dst = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            dst.copy_(out, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            out, tokens_dev = dst, out[:N * B].view(N, B)
        else:
            tokens_dev = out[:N * B].view(N, B)
        return PendingDecode(items=list(items), tokens_dev=tokens_dev, out=out, copied=copied,
                             n_steps=N, lp_k=lp_k)

    def _pending_rows(self, pending: PendingDecode):
        """[(tokens, [TokenLogprob] | None)] of each item: all the block's
        steps, the logprobs of the rows that asked for them."""
        if pending.tokens is not None:
            return [([t], None if lp is None else [lp])
                    for t, lp in zip(pending.tokens, pending.logprobs)]
        if pending.copied is not None:
            pending.copied.synchronize()
        N = pending.n_steps
        toks, lp = unpack_block(pending.out.numpy(), N, pending.tokens_dev.shape[1],
                                pending.lp_k)
        rows = []
        for i, it in enumerate(pending.items):
            lps = None
            if lp is not None and it.logprobs > 0:
                chosen, vals, ids = lp
                lps = [TokenLogprob(logprob=float(chosen[s, i]), top_logprobs=[
                    (int(ids[s, i, j]), float(vals[s, i, j])) for j in range(it.logprobs)])
                    for s in range(N)]
            rows.append((toks[:, i].tolist(), lps))
        return rows

    def resolve_pending(self, pending: PendingDecode) -> DecodeResult:
        """The first token of each row (a one-token block)."""
        return DecodeResult(requests=[
            DecodeRequestResult(request_id=it.request_id, token=toks[0],
                                logprob=lps[0] if lps else None)
            for it, (toks, lps) in zip(pending.items, self._pending_rows(pending))])

    def resolve_pending_multi(self, pending: PendingDecode):
        """[(request_id, [token, ...], [TokenLogprob, ...] | None), ...]:
        every step of each row."""
        return [(it.request_id, toks, lps)
                for it, (toks, lps) in zip(pending.items, self._pending_rows(pending))]

    def execute_decode(self, plan: DecodePlan) -> DecodeResult:
        items = plan.requests
        self._mixed_toks = None  # tokens advance outside the fused chain
        if not items:
            return DecodeResult()
        if len(items) > self.max_batch:
            head = self.execute_decode(DecodePlan(requests=items[: self.max_batch]))
            tail = self.execute_decode(DecodePlan(requests=items[self.max_batch:]))
            return DecodeResult(requests=head.requests + tail.requests)
        if any(it.logprobs > 0 for it in items):
            return self._execute_decode_with_logits(items)
        return self.resolve_pending(self.execute_decode_async(items))

    def _execute_decode_with_logits(self, items) -> DecodeResult:
        """One step that keeps its logits: sampled and reduced to logprobs
        after the step (the one-token graph, or the eager step)."""
        if self._graphs is not None:
            host, states = self._decode_host(items)
            logits = self._graphs.run(*host)
        else:
            inputs, states = self._decode_inputs(items)
            logits = self._decode_model(items, *inputs)
        for st in states:
            st.advance(1)
        self.decode_steps += 1
        self.decode_blocks += 1
        logits = logits[: len(items)]
        host, dev = sample_tokens(logits, items)
        lps = token_logprobs(logits, dev, items)
        return DecodeResult(requests=[
            DecodeRequestResult(request_id=it.request_id, token=host[i], logprob=lps[i])
            for i, it in enumerate(items)
        ])


class TorchExecutor(BlockDecode):
    """Continuous-batching executor for one Qwen3 model on one device."""

    def __init__(self, cfg: q3.Qwen3Config, params, kv_pages: torch.Tensor,
                 options: Optional[EngineLoadOptions] = None):
        opts = options or EngineLoadOptions()
        check_supported(opts)
        self.cfg = cfg
        self.params = params
        self.kv_pages = kv_pages
        self.device = kv_pages.device
        ps = self._page_size = kv_pages.shape[4]
        self.acct = KvAccounting(PagePool(kv_pages.shape[2]), ps)
        self.prefix_cache = (PrefixCache(self.acct.pool, ps) if opts.enable_prefix_cache
                             else None)
        # a model with per-request state (HybridExecutor) sets this with the
        # cache on: cache hits only at state snapshots, the fine tail
        self._hybrid_cache = False
        self.max_batch = opts.max_batch_size
        max_model_len = opts.max_model_len or cfg.max_position_embeddings
        self._max_pages = min(self.acct.pool.available, -(-max_model_len // ps))
        self._stop_ids = frozenset(cfg.stop_token_ids)
        # chunk sizes are page multiples, so interior piece ends are
        # page-aligned (the prefix cache shares whole pages)
        self.prefill_chunk = None
        if opts.prefill_chunk is not None:
            pc = max(ps, opts.prefill_chunk)
            self.prefill_chunk = pc - pc % ps
            mixed = min(opts.prefill_chunk_mixed, self.prefill_chunk)
            self.prefill_chunk_mixed = max(ps, mixed - mixed % ps)
            self._small_piece = small_piece(self.prefill_chunk, ps)
        self._table_cap = table_cap(self._max_pages, self.prefill_chunk or 0, ps)
        # the decode step under CUDA graphs (static buffers on the CPU)
        self._graphs = None
        if opts.precompile and opts.enable_cuda_graph:
            top = bucket_batch(self.max_batch)
            self._graphs = DecodeGraphs(self._graph_step(), self.device,
                                        [b for b in BATCH_BUCKETS if b <= top],
                                        cfg.num_key_value_heads, self._graph_family())
        # set by the scheduler around stepper pieces: decode_active picks the
        # mixed piece size; mixed_items (+ mixed_rand, one row of uniform
        # draws for non-greedy rows) asks for the next piece to carry those
        # decode rows, whose sampled tokens are left in mixed_pending
        self.decode_active = False
        self.mixed_items = None
        self.mixed_rand = None
        self.mixed_pending: Optional[PendingDecode] = None
        self._mixed_enabled = os.environ.get("PEGAINFER_MIXED_FUSED", "1") != "0"
        # the last fused piece's sampled tokens [B] on the device (set by
        # _init_blocks) and its request ids: the scheduler applies a piece's
        # tokens only after the next piece is dispatched, so the next piece
        # of the same batch takes its inputs from here (the host's token ids
        # are one behind)
        self._mixed_rids: Optional[tuple] = None
        # what ran, for callers that check the path (chip_smoke.py): whole
        # prefills, chunked-prefill pieces (fused or not), fused mixed
        # pieces; decode steps and blocks (_init_blocks)
        self.prefills = 0
        self.chunk_pieces = 0
        self.mixed_pieces = 0
        self._init_blocks(opts)

    # ── scheduler-facing accounting ──────────────────────────────────

    def page_size(self) -> int:
        return self._page_size

    def available_pages(self) -> int:
        avail = self.acct.pool.available
        if self.prefix_cache is not None:
            # pages only the cache holds are reclaimed on alloc (eviction
            # hook), so they count as available for admission
            avail += self.prefix_cache.evictable()
        return avail

    def max_request_pages(self) -> int:
        return self._max_pages

    def is_stop_token(self, token_id: int) -> bool:
        return token_id in self._stop_ids

    def release_request(self, request_id: int) -> None:
        self.acct.release(request_id)

    # ── prefill ──────────────────────────────────────────────────────

    def _first_token(self, item, last_logits) -> PrefillRequestResult:
        # a method, so that a caller can watch each prompt's last logits
        return first_token(item, last_logits)

    def _maybe_seed_prefix(self, item, st) -> None:
        """Seed ``st`` with the cached prefix pages of this prompt (once; a
        no-op when the cache is off or the request already has pages)."""
        if (self.prefix_cache is None or st.pages or st.length > 0 or st.prefix_checked
                or wants_prompt_logprobs(item)):  # echo needs the cached rows' logits
            return
        st.prefix_checked = True
        if self._hybrid_cache:
            n_tok, pages, st.prefix_snap = self.prefix_cache.match_hybrid(item.prompt_tokens)
        else:
            n_tok, pages = self.prefix_cache.match(item.prompt_tokens)
        if n_tok:
            st.pages = list(pages)
            st.prefix_len = n_tok

    def _cache_insert(self, item, st, snaps=()) -> None:
        if self.prefix_cache is not None:
            T = len(item.prompt_tokens)
            self.prefix_cache.insert(item.prompt_tokens, st.pages[: T // self._page_size])
            for pos, snap in snaps:
                self.prefix_cache.insert_snapshot(item.prompt_tokens, pos, snap)

    def supports_chunked_prefill(self, item) -> bool:
        return self.prefill_chunk is not None and len(item.prompt_tokens) > self.prefill_chunk

    def prefill_stepper(self, item):
        """Generator running one prefill piece per ``next()`` and yielding
        the piece's end while the prompt is not done; its return value is
        the PrefillRequestResult. The scheduler runs decode between pieces
        (or hands the stepper decode rows to fuse, ``mixed_items``), so
        streams stall for one piece, not the whole prompt."""
        st = self.acct.state(item.request_id)
        T = len(item.prompt_tokens)
        ps, chunk = self._page_size, self.prefill_chunk
        self._maybe_seed_prefix(item, st)
        start = st.prefix_len
        st.ensure_capacity(self.acct.pool, T)
        tokens = torch.tensor(item.prompt_tokens, dtype=torch.int32, device=self.device)
        table = torch.tensor(st.pages, dtype=torch.int32, device=self.device)
        if st.prefix_snap is not None:  # a hybrid cache hit: its state first
            self.slot_import(st.prefix_snap, self._slot(item.request_id))
            st.prefix_snap = None
        fine_tail = self._hybrid_cache and self._small_piece < chunk
        snaps = []  # [(pos, snapshot)]: the deepest interior one, the aligned end
        want_all = wants_prompt_logprobs(item)
        lps = []  # echo: each piece's [Tc] prompt logprobs, on the device
        while start < T:
            # planned one piece at a time: decode_active may flip between
            end = plan_piece(T, start, chunk, self.prefill_chunk_mixed, self._small_piece,
                             self.decode_active, fine_tail, ps)
            if want_all:  # never fused: the scheduler decodes after the piece
                logits = self._chunk_model(item, tokens[start:end], start, end - start, table,
                                           all_logits=True)
                last_logits = logits[-1]
                # row i predicts prompt token start + i + 1
                targets = tokens[start + 1:end + 1]
                lps.append(smp.token_logprob(logits[: targets.shape[0]], targets))
            elif self.mixed_items:
                mi, self.mixed_items = self.mixed_items, None
                last_logits = self._run_mixed_piece(item, mi, tokens[start:end], start,
                                                    end - start, table)
            else:
                last_logits = self._chunk_model(item, tokens[start:end], start,
                                                end - start, table)
            self.chunk_pieces += 1
            start = end
            if self._hybrid_cache and ((end < T and T - end <= chunk)
                                       or (end == T and T % ps == 0)):
                # the state after exactly `end` tokens; only a boundary within
                # a chunk of the end can be the deepest, so earlier ones take
                # no copy
                if snaps and snaps[-1][0] < T and end < T:
                    snaps.pop()
                snaps.append((end, self.slot_export(self._slot(item.request_id))))
            if end < T:
                yield end
        st.advance(T)
        self._cache_insert(item, st, snaps)
        res = self._first_token(item, last_logits)
        return replace(res, prompt_logprobs=prompt_logprobs(lps)) if want_all else res

    def _prefill_one(self, item) -> PrefillRequestResult:
        T = len(item.prompt_tokens)
        st = self.acct.state(item.request_id)
        self._maybe_seed_prefix(item, st)  # a cache hit goes through the stepper
        if self.prefill_chunk is not None and (T > self.prefill_chunk or st.prefix_len):
            gen = self.prefill_stepper(item)
            while True:
                try:
                    next(gen)
                except StopIteration as done:
                    return done.value
        st.ensure_capacity(self.acct.pool, T)
        tokens = torch.tensor(item.prompt_tokens, dtype=torch.int32, device=self.device)
        table = torch.tensor(st.pages, dtype=torch.int32, device=self.device)
        want_all = wants_prompt_logprobs(item)
        if want_all:
            logits = self._prefill_model(item, tokens, table, all_logits=True)
            last_logits = logits[T - 1]
        else:
            last_logits = self._prefill_model(item, tokens, table)
        st.advance(T)
        self.prefills += 1
        self._cache_insert(item, st)
        res = self._first_token(item, last_logits)
        if want_all:  # row t predicts prompt token t + 1
            lps = prompt_logprobs([smp.token_logprob(logits[: T - 1], tokens[1:])])
            res = replace(res, prompt_logprobs=lps)
        return res

    def _prefill_model(self, item, tokens, table, all_logits: bool = False):
        """The model call of one whole-prompt prefill: last logits [V], or
        with ``all_logits`` every row's [T, V]."""
        last_logits, every = q3.prefill(self.cfg, self.params, self.kv_pages, tokens, table,
                                        return_all_logits=all_logits)
        return every if all_logits else last_logits

    def _chunk_model(self, item, chunk_tokens, start: int, valid: int, table,
                     all_logits: bool = False):
        """The model call of one prefill piece: last logits [V], or with
        ``all_logits`` every row's [valid, V]."""
        return q3.prefill_chunk(self.cfg, self.params, self.kv_pages, chunk_tokens, start,
                                valid, table, return_all_logits=all_logits)

    def execute_prefill(self, plan: PrefillPlan) -> PrefillResult:
        return PrefillResult(requests=[self._prefill_one(it) for it in plan.requests])

    # ── decode ───────────────────────────────────────────────────────

    def precompile(self) -> None:
        """The JAX executor's ``precompile``: one decode graph per batch
        bucket up to ``bucket_batch(max_batch)`` at table width 8 (the
        static buffers alone on the CPU). Other widths are captured at first
        use."""
        if self._graphs is not None:
            for B in self._graphs.buckets:
                self._graphs.prepare(B, 8)

    def _decode_host(self, items, extra_tokens: int = 0):
        """Host-side batch assembly, as numpy: one more token per request,
        pages for ``1 + extra_tokens`` writes, the batch padded to its
        bucket with dead rows and the table, sized from the pages after
        that growth, to its power-of-two width with null pages."""
        B = bucket_batch(len(items))
        tokens = np.zeros(B, np.int32)
        positions = np.zeros(B, np.int32)
        seq_lens = np.zeros(B, np.int32)
        states = []
        for i, it in enumerate(items):
            st = self.acct.state(it.request_id)
            pos = st.length
            st.ensure_capacity(self.acct.pool, pos + 1 + extra_tokens)
            states.append(st)
            tokens[i] = it.token_id
            positions[i] = pos
            seq_lens[i] = pos + 1
        P = bucket_pow2(max(len(st.pages) for st in states), 8, self._table_cap)
        tables = np.full((B, P), PagePool.NULL_PAGE, np.int32)
        for i, st in enumerate(states):
            tables[i, : len(st.pages)] = st.pages
        return (tokens, positions, tables, seq_lens), states

    def _decode_model(self, items, tokens, positions, tables, seq_lens):
        """The model call of one decode step over the padded batch: logits
        [B, V]."""
        return q3.decode(self.cfg, self.params, self.kv_pages, tokens, positions, tables,
                         seq_lens)

    def _graph_step(self):
        """The decode step the graphs capture, over ``_decode_host``'s
        arrays in their order."""
        return partial(q3.decode, self.cfg, self.params, self.kv_pages)

    def _graph_family(self) -> Family:
        return QWEN3

    # ── fused mixed step (prefill piece ‖ decode rows, one forward) ───

    def supports_mixed_step(self, items) -> bool:
        return self._mixed_enabled and len(items) <= self.max_batch

    def _run_mixed_piece(self, item, items, chunk_tokens, start: int, valid: int, table):
        """One fused piece of ``item``'s prompt with ``items``' decode rows
        (called from the stepper). Returns the chunk's last logits; the
        decode rows' sampled tokens are left in ``mixed_pending`` for the
        scheduler."""
        n = len(items)
        dec, states = self._decode_inputs(items)
        rids = tuple(it.request_id for it in items)
        if self._mixed_toks is not None and self._mixed_rids == rids:
            dec[0] = self._mixed_toks
        tokens = dec[0]
        last_logits, dec_logits = self._mixed_model(
            item, items, chunk_tokens, start, valid, table, tuple(dec))
        for st in states:
            st.advance(1)
        self.mixed_pieces += 1
        if self.mixed_rand is not None:
            items = [replace(it, random_val=r) for it, r in zip(items, self.mixed_rand[0])]
        dec_logits = dec_logits[:n]
        host, dev = sample_tokens(dec_logits, items)
        self._mixed_toks = torch.zeros_like(tokens)
        self._mixed_toks[:n] = dev
        self._mixed_rids = rids
        self.mixed_pending = PendingDecode(items=list(items), tokens=host,
                                           logprobs=token_logprobs(dec_logits, dev, items))
        return last_logits

    def _mixed_model(self, item, items, chunk_tokens, start: int, valid: int, table, dec):
        """The model call of one fused piece; ``dec`` = ``_decode_inputs``'
        device tensors of the padded decode batch (tokens, positions,
        tables, seq_lens). Returns (last logits [V], decode logits [B,
        V])."""
        return q3.mixed_chunk(self.cfg, self.params, self.kv_pages, chunk_tokens, start,
                              valid, table, *dec)

    # ── PD handoff hooks (engine/pd.py) ──────────────────────────────

    def export_pages(self, page_ids):
        """A copy of the pages ``page_ids`` of every layer."""
        return q3.export_pages(self.kv_pages, page_ids)

    def import_pages(self, rows, page_ids) -> None:
        q3.import_pages(self.kv_pages, rows, page_ids)

    # ── unified ──────────────────────────────────────────────────────

    def execute_unified(self, plan: UnifiedPlan) -> UnifiedResult:
        """Prefill the new prompts, then one decode step for the active set."""
        prefill = self.execute_prefill(PrefillPlan(requests=plan.prefill_requests))
        decode = self.execute_decode(DecodePlan(requests=plan.decode_requests))
        return UnifiedResult(prefill_requests=prefill.requests,
                             decode_requests=decode.requests)
