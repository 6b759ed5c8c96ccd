"""The decode step under CUDA graphs, for Qwen3, the Qwen3.5 hybrid,
DeepSeek-V4 and DeepSeek-V2-Lite: the port's analog of the JAX executor's
one compiled decode program per shape (``JaxExecutor.precompile``, its
bucket ladder) and of the modelled system's graph per bucket
(``CudaGraphState::run_or_capture``).

A ``Family`` says what a model's step takes: its [B] int32 inputs in order,
each with the value a padding row holds (a padded row's state slot is the
dead slot, never slot 0: a padding row of the hybrid or a DeepSeek model
writes its slot's rows), whether a [B, P] page table follows them (padded with null
pages), the kernel wrappers the step reaches, and the device state those
kernels keep (K1's ticket counters, K6's zero expert ids at one expert).
``QWEN3``, ``hybrid(dead)``, ``dsv4(dead)`` and ``dsv2lite(dead)`` are the
four.

``DecodeGraphs`` keeps, per (B, P) (P = 0 without a table), static input
buffers (all the inputs in one device buffer that one copy fills) and, on
``cuda``, one CUDA graph of the step over them, whose static output is the
logits [B, V] f32. ``run`` writes every row of the buffers, padding rows
included (a stale row of an earlier, larger batch would write its k/v into
a live request's page, or its state into a live slot), then replays. On
the CPU there is nothing to capture: ``run`` fills the same buffers and
calls the step on them.

A capture (``prepare``) first runs the step (a block graph: two of its
steps) once eagerly on the capture stream over padding rows only, which
write the null page and the dead slot. That warm-up builds and loads the kernels, sets their one-time
attributes and makes the cached device tensors that a capture must not
make. The capture follows, under ``no_grad``, on that stream, into the
memory pool that every graph shares (replays run in one stream order, so
the graphs' scratch may overlap). The family's kernel state is made before
the first capture: K1's ticket counters of the capture stream, sized for
the largest bucket, and K6's zero expert ids of every bucket. A failed
capture raises; nothing falls back to the eager step.

Block graphs (``run_block``): the JAX executor's ``_decode_sampled``, one
graph per (B, P, N, greedy, lp_k), captured at first use, holding N steps
of the family's step (``decode_block``) with sampling on the card: each
step's sampled tokens [B] feed the next, positions and seq_lens go up by
one a step (padding rows too, as in the JAX scan: they stay on the null
page and the dead slot), and with ``lp_k`` each step's chosen logprob and
top ``lp_k`` logprobs are kept. A sampled graph also takes temperature,
top_k, top_p [B] and the draws rand [N, B] in its flat buffer (floats as
their int32 bits). Its static output is one flat int32 tensor: tokens
[N, B], then with ``lp_k`` chosen [N, B], top values [N, B, lp_k] (f32
bits) and top ids [N, B, lp_k], so one copy takes it to the host. A
block's first tokens may come from the previous block's last row on the
card (``tokens``), copied into the input buffer after the buffers' copy
and before the replay. Each (B, P) or block key has two pinned stages,
used in turn, so a pipeline's next dispatch never waits for the copy of
the block in flight. On the CPU, ``run_block`` runs ``decode_block``
eagerly on the same buffers.

The kernel wrappers' ``launches`` counters count Python calls, which a
replay does not make: each graph keeps the counters' increase during its
capture and adds it at every replay (a block graph's is N steps'); the
warm-up's and the capture's own launches are taken back out.
"""

from __future__ import annotations

import gc
import logging
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pegainfer_tpu_torch.engine.kv import PagePool
from pegainfer_tpu_torch.ops import sampling as smp
from pegainfer_tpu_torch.ops.cuda import (fp4_chain, fp4_gemv, fp8_gemv, int8_chain, int8_gemv,
                                          paged_decode)

log = logging.getLogger("pegainfer_torch.decode_graphs")

# int32s: each input of the flat buffer starts on a 64-byte boundary, as a
# tensor of its own would, so its kernels take the eager step's code paths
ALIGN = 16


@dataclass(frozen=True)
class Family:
    """What a family's decode step takes and runs. ``rows``: its [B] int32
    inputs in buffer order, each with a padding row's value; ``args``: the
    step's positional arguments by name, "table" the [B, P] page table that
    follows the rows in the buffer; ``counted``: the kernel wrappers it
    reaches; ``k1`` / ``k6_one_expert``: the kernel state made before the
    first capture (K1's ticket counters; K6's zero ids of a dense launch)."""

    rows: Tuple[Tuple[str, int], ...]
    args: Tuple[str, ...]
    counted: Tuple[ModuleType, ...]
    k1: bool
    k6_one_expert: bool

    @property
    def table(self) -> bool:
        return "table" in self.args


_PAGED_ROWS = (("tokens", 0), ("positions", 0), ("seq_lens", 0))
_PAGED_ARGS = ("tokens", "positions", "table", "seq_lens")
# K1, and K6 at one expert in the int8 mode
QWEN3 = Family(_PAGED_ROWS, _PAGED_ARGS, (paged_decode, int8_gemv), True, True)


def hybrid(dead_slot: int) -> Family:
    """The Qwen3.5 hybrid's step (``models/qwen35.py::decode``): Qwen3's
    inputs and the rows' state slots, padding rows on ``dead_slot``."""
    return Family(_PAGED_ROWS + (("slots", dead_slot),), _PAGED_ARGS + ("slots",),
                  QWEN3.counted, True, True)


_SLOT_ARGS = ("tokens", "positions", "slots")


def _slot_rows(dead_slot: int):
    return (("tokens", 0), ("positions", 0), ("slots", dead_slot))


def dsv4(dead_slot: int) -> Family:
    """DeepSeek-V4's step (``models/dsv4.py::decode``): tokens, positions
    and slots, no table; K3 / K4, K6 and the chains K8 / K9."""
    return Family(_slot_rows(dead_slot), _SLOT_ARGS,
                  (fp4_gemv, fp8_gemv, int8_gemv, int8_chain, fp4_chain), False, False)


def dsv2lite(dead_slot: int) -> Family:
    """DeepSeek-V2-Lite's step (``models/dsv2lite.py::decode``): DSv4's
    inputs, and no counted kernel (its step is torch ops)."""
    return Family(_slot_rows(dead_slot), _SLOT_ARGS, (), False, False)


def _up(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def offsets(family: Family, B: int, P: int) -> Tuple[Dict[str, int], int]:
    """Each input's offset in the flat buffer (the rows in order, then the
    table), and its length."""
    off = {name: i * _up(B) for i, (name, _) in enumerate(family.rows)}
    n = len(family.rows) * _up(B)
    if family.table:
        off["table"] = n
        n += B * P
    return off, n


def block_offsets(family: Family, B: int, P: int, N: int, greedy: bool
                  ) -> Tuple[Dict[str, int], int]:
    """``offsets`` of a block graph's buffer: a sampled one's temperature,
    top_k and top_p [B] and rand [N, B] follow the table."""
    off, n = offsets(family, B, P)
    if not greedy:
        for name in ("temperature", "top_k", "top_p"):
            off[name] = n
            n += _up(B)
        off["rand"] = n
        n += N * B
    return off, n


SAMPLING = ("temperature", "top_k", "top_p", "rand")


def decode_block(step: Callable, args: Dict[str, torch.Tensor], order: Sequence[str],
                 n_steps: int, sampling: Optional[Sequence[torch.Tensor]] = None,
                 lp_k: int = 0) -> torch.Tensor:
    """``n_steps`` decode steps with sampling on the device, the JAX
    executor's ``_decode_sampled`` body: ``step(*(args[a] for a in order))``
    gives logits [B, V]; each step's sampled tokens are the next step's
    ``tokens``, and ``positions`` and ``seq_lens`` (where ``args`` has them)
    go up by one. ``sampling``: (temperature, top_k, top_p [B], rand [N,
    B]), None for greedy. Returns the flat int32 outputs (``run_block``'s
    layout; ``unpack_block`` reads them)."""
    args = dict(args)
    toks, chosen, vals, ids = [], [], [], []
    for i in range(n_steps):
        logits = step(*(args[a] for a in order))
        if sampling is None:
            tok = smp.sample_greedy(logits)
        else:
            temperature, top_k, top_p, rand = sampling
            tok = smp.sample(logits, temperature, top_k, top_p, rand[i])
        toks.append(tok)
        if lp_k:
            v, t = smp.top_logprobs(logits, lp_k)
            chosen.append(smp.token_logprob(logits, tok))
            vals.append(v)
            ids.append(t)
        if i + 1 < n_steps:
            args["tokens"] = tok
            args["positions"] = args["positions"] + 1
            if "seq_lens" in args:
                args["seq_lens"] = args["seq_lens"] + 1
    parts = [torch.stack(toks).reshape(-1)]
    if lp_k:
        parts += [torch.stack(chosen).reshape(-1).view(torch.int32),
                  torch.stack(vals).reshape(-1).view(torch.int32),
                  torch.stack(ids).reshape(-1)]
    return torch.cat(parts)


def unpack_block(out: np.ndarray, N: int, B: int, lp_k: int):
    """``decode_block``'s flat outputs as numpy: tokens [N, B], and with
    ``lp_k`` (chosen [N, B], top values [N, B, K], top ids [N, B, K]),
    else None."""
    toks = out[:N * B].reshape(N, B)
    if not lp_k:
        return toks, None
    n, nk = N * B, N * B * lp_k
    return toks, (out[n:2 * n].view(np.float32).reshape(N, B),
                  out[2 * n:2 * n + nk].view(np.float32).reshape(N, B, lp_k),
                  out[2 * n + nk:2 * n + 2 * nk].reshape(N, B, lp_k))


def layout(B: int, P: int) -> Tuple[int, int, int, int]:
    """Qwen3's offsets of positions, seq_lens and the table in the flat
    buffer (the tokens at 0), and its length."""
    off, n = offsets(QWEN3, B, P)
    return off["positions"], off["seq_lens"], off["table"], n


@dataclass
class GraphStep:
    """The static buffers of one (B, P) or block key and, on ``cuda``, its
    graph."""

    B: int
    P: int
    flat: torch.Tensor  # device int32: the rows, then the table (a block: its sampling)
    views: Dict[str, torch.Tensor]  # each input's view of ``flat``
    inputs: Tuple[torch.Tensor, ...]  # the step's inputs in its argument order
    # what ``run`` writes, in turn: pinned host memory (cuda), ``flat`` (CPU)
    stages: List[torch.Tensor] = field(default_factory=list)
    copied: List["torch.cuda.Event"] = field(default_factory=list)  # after each stage's copy
    turn: int = 0
    graph: Optional["torch.cuda.CUDAGraph"] = None
    # the graph's static output: a one-token graph's logits [B, V], a block
    # graph's flat outputs
    out: Optional[torch.Tensor] = None
    launches: Dict = field(default_factory=dict)  # wrapper module -> launches a replay
    N: int = 1
    greedy: bool = True
    lp_k: int = 0

    @property
    def sampling(self) -> Optional[Tuple[torch.Tensor, ...]]:
        return None if self.greedy else tuple(self.views[k] for k in SAMPLING)

    def next_stage(self) -> torch.Tensor:
        """The pinned stage to write next, once the copy from it last time
        has run (on the CPU: ``flat``)."""
        if not self.stages:
            return self.flat
        self.turn ^= 1
        ev = self.copied[self.turn]
        if not ev.query():
            ev.synchronize()
        return self.stages[self.turn]

    def upload(self, stage: torch.Tensor) -> None:
        """The stage's copy into ``flat``, on the current stream."""
        if stage is not self.flat:
            self.flat.copy_(stage, non_blocking=True)
            self.copied[self.turn].record()


class DecodeGraphs:
    """One decode graph per (B, P) over static buffers. ``step(*inputs)``
    is the model's decode step in ``family.args`` order (logits [B, V]);
    ``buckets`` the batch buckets it serves, for which the family's kernel
    state is made up front (K1's tickets ``kv_heads`` a row)."""

    def __init__(self, step: Callable, device: torch.device, buckets: Sequence[int],
                 kv_heads: int, family: Family = QWEN3):
        self.step = step
        self.device = device
        self.buckets = tuple(buckets)
        self.family = family
        self.steps: Dict[Tuple[int, int], GraphStep] = {}
        # block graphs by (B, P, N, greedy, lp_k)
        self.blocks: Dict[Tuple[int, int, int, bool, int], GraphStep] = {}
        # (B, P, N, seconds, host clock at its end) of each capture; N 1 for
        # a one-token graph
        self.capture_log: List[Tuple[int, int, int, float, float]] = []
        # each capture's seconds inside the capture (the steps' dispatch)
        # and in its end (the graph's instantiation), in capture_log's order
        self.capture_split: List[Tuple[float, float]] = []
        self.pool_bytes = 0  # reserved device bytes the captures added
        self._cuda = device.type == "cuda"
        if self._cuda:
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()
            if family.k1:
                paged_decode.ticket_buffer(device, self.stream, max(self.buckets) * kv_heads)
            if family.k6_one_expert:
                for B in self.buckets:
                    int8_gemv.zero_idx(B, device)

    def _buffers(self, B: int, P: int, N: int = 1, greedy: bool = True,
                 lp_k: int = 0) -> GraphStep:
        """A key's buffers, every row a padding row (a sampled block's
        sampling zero: temperature 0 samples greedily)."""
        off, n = block_offsets(self.family, B, P, N, greedy)
        flat = torch.zeros(n, dtype=torch.int32, device=self.device)
        views = {}
        for name, pad in self.family.rows:
            views[name] = flat[off[name]:off[name] + B].fill_(pad)
        if self.family.table:
            views["table"] = flat[off["table"]:off["table"] + B * P].view(B, P).fill_(
                PagePool.NULL_PAGE)
        if not greedy:
            views["temperature"] = flat[off["temperature"]:off["temperature"] + B].view(
                torch.float32)
            views["top_k"] = flat[off["top_k"]:off["top_k"] + B]
            views["top_p"] = flat[off["top_p"]:off["top_p"] + B].view(torch.float32)
            views["rand"] = flat[off["rand"]:off["rand"] + N * B].view(N, B).view(torch.float32)
        st = GraphStep(B=B, P=P, flat=flat, views=views,
                       inputs=tuple(views[a] for a in self.family.args),
                       N=N, greedy=greedy, lp_k=lp_k)
        if self._cuda:
            st.stages = [torch.empty(n, dtype=torch.int32, pin_memory=True) for _ in range(2)]
            st.copied = [torch.cuda.Event() for _ in range(2)]
        return st

    def prepare(self, B: int, P: int = 0) -> GraphStep:
        """The buffers of (B, P), captured on ``cuda`` (once); they start as
        padding rows."""
        st = self.steps.get((B, P))
        if st is None:
            st = self._buffers(B, P)
            if self._cuda:
                self._capture(st, lambda n=1: self.step(*st.inputs))
            self.steps[(B, P)] = st
        return st

    def prepare_block(self, B: int, P: int, N: int, greedy: bool, lp_k: int) -> GraphStep:
        """The buffers of a block key, captured on ``cuda`` (once)."""
        key = (B, P, N, greedy, lp_k)
        st = self.blocks.get(key)
        if st is None:
            st = self._buffers(B, P, N, greedy, lp_k)
            if self._cuda:
                self._capture(st, lambda n=N: decode_block(
                    self.step, st.views, self.family.args, n, st.sampling, lp_k))
            self.blocks[key] = st
        return st

    def _capture(self, st: GraphStep, fn: Callable) -> None:
        """Capture ``fn()`` into ``st``'s graph after a warm-up ``fn(n)`` of
        up to two steps on the same buffers, which launches every kernel the
        capture launches (a module loaded lazily inside a capture
        invalidates it); its output is ``st.out``. The garbage collector is
        off during the capture: a CUDA graph it freed then would free its
        memory and invalidate the capture."""
        t = time.perf_counter()
        counted = self.family.counted
        before = {m: m.launches for m in counted}
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.no_grad():
            with torch.cuda.stream(self.stream):
                fn(min(st.N, 2))  # the warm-up, on padding rows
            warm = {m: m.launches for m in counted}
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                      capture_error_mode="thread_local"):
                    t_body = time.perf_counter()
                    out = fn()
                    t_body = time.perf_counter() - t_body
                    t_end = time.perf_counter()
                t_end = time.perf_counter() - t_end
            finally:
                if collecting:
                    gc.enable()
        cur.wait_stream(self.stream)
        st.launches = {m: m.launches - warm[m] for m in counted}
        for m in counted:
            m.launches = before[m]
        st.graph, st.out = graph, out
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        secs = time.perf_counter() - t
        self.capture_log.append((st.B, st.P, st.N, secs, time.perf_counter()))
        self.capture_split.append((t_body, t_end))
        log.info("captured the decode graph B=%d P=%d N=%d greedy=%s lp_k=%d in %.3f s "
                 "(%.3f s capturing, %.3f s instantiating)", st.B, st.P, st.N, st.greedy,
                 st.lp_k, secs, t_body, t_end)

    def _fill(self, st: GraphStep, arrays: Sequence[np.ndarray], extra=()) -> None:
        """Write every row of ``st``'s inputs (``arrays`` in ``family.args``
        order, then ``extra``: (name, array) pairs) and copy them to the
        device."""
        off, _ = block_offsets(self.family, st.B, st.P, st.N, st.greedy)
        stage = st.next_stage()
        host = stage.numpy()
        for name, a in (*zip(self.family.args, arrays), *extra):
            if a.shape[0] != st.B and name != "rand":
                raise ValueError(f"{name} has {a.shape[0]} rows, the batch {st.B}")
            host[off[name]:off[name] + a.size] = a.reshape(-1).view(np.int32)
        st.upload(stage)

    def _shape(self, arrays) -> Tuple[int, int]:
        B = arrays[0].shape[0]
        args = self.family.args
        return B, arrays[args.index("table")].shape[1] if self.family.table else 0

    def _replay(self, st: GraphStep) -> None:
        st.graph.replay()
        for m, n in st.launches.items():
            m.launches += n

    def run(self, *arrays: np.ndarray, tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [B, V] of one step over the padded batch: numpy int32
        arrays in ``family.args`` order, every row given (``tokens``: the
        rows' tokens on the device instead, a block's last row). The
        buffers of (B, P) are written whole, then the graph replays (on the
        CPU: the step runs on them). The logits stay valid until the next
        ``run`` at this (B, P)."""
        st = self.prepare(*self._shape(arrays))
        self._fill(st, arrays)
        if tokens is not None:
            st.views["tokens"].copy_(tokens)
        if st.graph is None:
            with torch.no_grad():
                return self.step(*st.inputs)
        self._replay(st)
        return st.out

    def run_block(self, arrays: Sequence[np.ndarray], n_steps: int,
                  sampling: Optional[Sequence[np.ndarray]] = None, lp_k: int = 0,
                  tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``decode_block``'s flat outputs of ``n_steps`` steps over the
        padded batch (``arrays`` as ``run``'s; ``sampling``: temperature,
        top_k, top_p [B] and rand [N, B] as numpy, None for greedy;
        ``tokens``: the first step's tokens on the device instead). The
        block graph of (B, P, N, greedy, lp_k) replays (captured at its
        first use); on the CPU ``decode_block`` runs on its buffers. The
        outputs stay valid until the next ``run_block`` at this key."""
        B, P = self._shape(arrays)
        st = self.prepare_block(B, P, n_steps, sampling is None, lp_k)
        extra = () if sampling is None else tuple(zip(SAMPLING, sampling))
        self._fill(st, arrays, extra)
        if tokens is not None:
            st.views["tokens"].copy_(tokens)
        if st.graph is None:
            with torch.no_grad():
                return decode_block(self.step, st.views, self.family.args, n_steps,
                                    st.sampling, lp_k)
        self._replay(st)
        return st.out
