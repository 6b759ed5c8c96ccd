"""The decode step under CUDA graphs, for Qwen3, the Qwen3.5 hybrid and
DeepSeek-V4: the port's analog of the JAX executor's one compiled decode
program per shape (``JaxExecutor.precompile``, its bucket ladder) and of the
modelled system's graph per bucket (``CudaGraphState::run_or_capture``).

A ``Family`` says what a model's step takes: its [B] int32 inputs in order,
each with the value a padding row holds (a padded row's state slot is the
dead slot, never slot 0: a padding row of the hybrid or DSv4 writes its
slot's rows), whether a [B, P] page table follows them (padded with null
pages), the kernel wrappers the step reaches, and the device state those
kernels keep (K1's ticket counters, K6's zero expert ids at one expert).
``QWEN3``, ``hybrid(dead)`` and ``dsv4(dead)`` are the three.

``DecodeGraphs`` keeps, per (B, P) (P = 0 without a table), static input
buffers (all the inputs in one device buffer that one copy fills) and, on
``cuda``, one CUDA graph of the step over them, whose static output is the
logits [B, V] f32. ``run`` writes every row of the buffers, padding rows
included (a stale row of an earlier, larger batch would write its k/v into
a live request's page, or its state into a live slot), then replays. On
the CPU there is nothing to capture: ``run`` fills the same buffers and
calls the step on them.

A capture (``prepare``) first runs the step once eagerly on the capture
stream over padding rows only, which write the null page and the dead
slot. That warm-up builds and loads the kernels, sets their one-time
attributes and makes the cached device tensors that a capture must not
make. The capture follows, under ``no_grad``, on that stream, into the
memory pool that every graph shares (replays run in one stream order, so
the graphs' scratch may overlap). The family's kernel state is made before
the first capture: K1's ticket counters of the capture stream, sized for
the largest bucket, and K6's zero expert ids of every bucket. A failed
capture raises; nothing falls back to the eager step.

The kernel wrappers' ``launches`` counters count Python calls, which a
replay does not make: each graph keeps the counters' increase during its
capture and adds it at every replay; the warm-up's and the capture's own
launches are taken back out.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pegainfer_tpu_torch.engine.kv import PagePool
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


def dsv4(dead_slot: int) -> Family:
    """DeepSeek-V4's step (``models/dsv4.py::decode``): tokens, positions
    and slots, no table; K3 / K4, K6 and the chains K8 / K9."""
    return Family((("tokens", 0), ("positions", 0), ("slots", dead_slot)),
                  ("tokens", "positions", "slots"),
                  (fp4_gemv, fp8_gemv, int8_gemv, int8_chain, fp4_chain), False, False)


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


def layout(B: int, P: int) -> Tuple[int, int, int, int]:
    """Qwen3's offsets of positions, seq_lens and the table in the flat
    buffer (the tokens at 0), and its length."""
    off, n = offsets(QWEN3, B, P)
    return off["positions"], off["seq_lens"], off["table"], n


@dataclass
class GraphStep:
    """The static buffers of one (B, P) and, on ``cuda``, its graph."""

    B: int
    P: int
    flat: torch.Tensor  # device int32: the rows, then the table
    stage: torch.Tensor  # what ``run`` writes: pinned host memory (cuda), ``flat`` (CPU)
    inputs: Tuple[torch.Tensor, ...]  # views of ``flat`` in the step's argument order
    graph: Optional["torch.cuda.CUDAGraph"] = None
    logits: Optional[torch.Tensor] = None  # the graph's output [B, V]
    launches: Dict = field(default_factory=dict)  # wrapper module -> launches a replay
    copied: Optional["torch.cuda.Event"] = None  # after the last copy from ``stage``


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
        # (B, P, seconds, host clock at its end) of each capture
        self.capture_log: List[Tuple[int, int, float, float]] = []
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

    def prepare(self, B: int, P: int = 0) -> GraphStep:
        """The buffers of (B, P), captured on ``cuda`` (once); they start as
        padding rows."""
        st = self.steps.get((B, P))
        if st is not None:
            return st
        off, n = offsets(self.family, B, P)
        flat = torch.zeros(n, dtype=torch.int32, device=self.device)
        views = {}
        for name, pad in self.family.rows:
            views[name] = flat[off[name]:off[name] + B].fill_(pad)
        if self.family.table:
            views["table"] = flat[off["table"]:].view(B, P).fill_(PagePool.NULL_PAGE)
        st = GraphStep(B=B, P=P, flat=flat, stage=flat,
                       inputs=tuple(views[a] for a in self.family.args))
        if self._cuda:
            st.stage = torch.empty(n, dtype=torch.int32, pin_memory=True)
            st.copied = torch.cuda.Event()
            self._capture(st)
        self.steps[(B, P)] = st
        return st

    def _capture(self, st: GraphStep) -> None:
        t = time.perf_counter()
        counted = self.family.counted
        before = {m: m.launches for m in counted}
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.no_grad():
            with torch.cuda.stream(self.stream):
                self.step(*st.inputs)  # the warm-up, on padding rows
            warm = {m: m.launches for m in counted}
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                logits = self.step(*st.inputs)
        cur.wait_stream(self.stream)
        st.launches = {m: m.launches - warm[m] for m in counted}
        for m in counted:
            m.launches = before[m]
        st.graph, st.logits = graph, logits
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        secs = time.perf_counter() - t
        self.capture_log.append((st.B, st.P, secs, time.perf_counter()))
        log.info("captured the decode graph B=%d P=%d in %.3f s", st.B, st.P, secs)

    def run(self, *arrays: np.ndarray) -> torch.Tensor:
        """Logits [B, V] of one step over the padded batch: numpy int32
        arrays in ``family.args`` order, every row given. The buffers of
        (B, P) are written whole, then the graph replays (on the CPU: the
        step runs on them). The logits stay valid until the next ``run`` at
        this (B, P).

        The pinned stage is rewritten only once the last copy from it has
        run (a caller that reads each step's tokens finds it done; a
        resume's back-to-back steps wait for it)."""
        args = self.family.args
        B = arrays[0].shape[0]
        P = arrays[args.index("table")].shape[1] if self.family.table else 0
        st = self.prepare(B, P)
        if st.copied is not None and not st.copied.query():
            st.copied.synchronize()
        off, _ = offsets(self.family, B, P)
        host = st.stage.numpy()
        for name, a in zip(args, arrays):
            if a.shape[0] != B:
                raise ValueError(f"{name} has {a.shape[0]} rows, the batch {B}")
            host[off[name]:off[name] + a.size] = a.reshape(-1)
        if st.graph is None:
            with torch.no_grad():
                return self.step(*st.inputs)
        st.flat.copy_(st.stage, non_blocking=True)
        st.copied.record()
        st.graph.replay()
        for m, n in st.launches.items():
            m.launches += n
        return st.logits
