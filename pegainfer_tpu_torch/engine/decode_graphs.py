"""Qwen3's decode step under CUDA graphs: the port's analog of the JAX
executor's bucket ladder (``JaxExecutor.precompile``, one compiled decode
program per (batch bucket, table width)) and of the modelled system's graph
per bucket (``CudaGraphState::run_or_capture``).

``DecodeGraphs`` keeps, per (B, P), static input buffers (tokens,
positions and seq_lens [B] and the page table [B, P], int32, in one device
buffer that one copy fills) and, on ``cuda``, one CUDA graph of the step
over them, whose static output is the logits [B, V] f32. ``run`` writes
every row of the buffers, padding rows as token 0, position 0, seq_len 0
and null pages (a stale row of an earlier, larger batch would write its
k/v into a live request's page), then replays. On the CPU there is nothing
to capture: ``run`` fills the same buffers and calls the step on them.

A capture (``prepare``) first runs the step once eagerly on the capture
stream over padding rows only, which write the null page. That warm-up
builds and loads the kernels, sets their one-time attributes and makes the
cached device tensors that a capture must not make. The capture follows,
under ``no_grad``, on that stream, into the memory pool that every graph
shares (replays run in one stream order, so the graphs' scratch may
overlap). K1's ticket counters of the capture stream, sized for the
largest bucket, and K6's zero expert ids of every bucket are made before
the first capture. A failed capture raises; nothing falls back to the eager
step.

The kernel wrappers' ``launches`` counters count Python calls, which a
replay does not make: each graph keeps the counters' increase during its
capture and adds it at every replay; the warm-up's and the capture's own
launches are taken back out.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pegainfer_tpu_torch.engine.kv import PagePool
from pegainfer_tpu_torch.ops.cuda import int8_gemv, paged_decode

log = logging.getLogger("pegainfer_torch.decode_graphs")

# the kernel wrappers a Qwen3 decode step reaches: K1, and K6 in the int8 mode
COUNTED = (paged_decode, int8_gemv)
# int32s: each input of the flat buffer starts on a 64-byte boundary, as a
# tensor of its own would, so its kernels take the eager step's code paths
ALIGN = 16


def _up(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def layout(B: int, P: int) -> Tuple[int, int, int, int]:
    """Offsets of positions, seq_lens and the table in the flat buffer (the
    tokens at 0), and its length."""
    pos, lens = _up(B), 2 * _up(B)
    table = 3 * _up(B)
    return pos, lens, table, table + B * P


@dataclass
class GraphStep:
    """The static buffers of one (B, P) and, on ``cuda``, its graph."""

    B: int
    P: int
    flat: torch.Tensor  # device int32: tokens | positions | seq_lens | table
    stage: torch.Tensor  # what ``run`` writes: pinned host memory (cuda), ``flat`` (CPU)
    inputs: Tuple[torch.Tensor, ...]  # views of ``flat``: tokens, positions, table, seq_lens
    graph: Optional["torch.cuda.CUDAGraph"] = None
    logits: Optional[torch.Tensor] = None  # the graph's output [B, V]
    launches: Dict = field(default_factory=dict)  # wrapper module -> launches a replay


class DecodeGraphs:
    """One decode graph per (B, P) over static buffers. ``step(tokens,
    positions, tables, seq_lens)`` is the model's decode step (logits [B,
    V]); ``buckets`` the batch buckets it serves, for which the K1 tickets
    (``kv_heads`` a row) and K6's ids are made up front."""

    def __init__(self, step: Callable, device: torch.device, buckets: Sequence[int],
                 kv_heads: int):
        self.step = step
        self.device = device
        self.buckets = tuple(buckets)
        self.steps: Dict[Tuple[int, int], GraphStep] = {}
        # (B, P, seconds, host clock at its end) of each capture
        self.capture_log: List[Tuple[int, int, float, float]] = []
        self.pool_bytes = 0  # reserved device bytes the captures added
        self._cuda = device.type == "cuda"
        if self._cuda:
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()
            paged_decode.ticket_buffer(device, self.stream, max(self.buckets) * kv_heads)
            for B in self.buckets:
                int8_gemv.zero_idx(B, device)

    def prepare(self, B: int, P: int) -> GraphStep:
        """The buffers of (B, P), captured on ``cuda`` (once)."""
        st = self.steps.get((B, P))
        if st is not None:
            return st
        pos, lens, tab, n = layout(B, P)
        flat = torch.zeros(n, dtype=torch.int32, device=self.device)
        table = flat[tab:].view(B, P)
        table.fill_(PagePool.NULL_PAGE)
        st = GraphStep(B=B, P=P, flat=flat, stage=flat,
                       inputs=(flat[:B], flat[pos:pos + B], table, flat[lens:lens + B]))
        if self._cuda:
            st.stage = torch.empty(n, dtype=torch.int32, pin_memory=True)
            self._capture(st)
        self.steps[(B, P)] = st
        return st

    def _capture(self, st: GraphStep) -> None:
        t = time.perf_counter()
        before = {m: m.launches for m in COUNTED}
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.no_grad():
            with torch.cuda.stream(self.stream):
                self.step(*st.inputs)  # the warm-up, on padding rows
            warm = {m: m.launches for m in COUNTED}
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                logits = self.step(*st.inputs)
        cur.wait_stream(self.stream)
        st.launches = {m: m.launches - warm[m] for m in COUNTED}
        for m in COUNTED:
            m.launches = before[m]
        st.graph, st.logits = graph, logits
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        secs = time.perf_counter() - t
        self.capture_log.append((st.B, st.P, secs, time.perf_counter()))
        log.info("captured the decode graph B=%d P=%d in %.3f s", st.B, st.P, secs)

    def run(self, tokens: np.ndarray, positions: np.ndarray, tables: np.ndarray,
            seq_lens: np.ndarray) -> torch.Tensor:
        """Logits [B, V] of one step over the padded batch (numpy int32
        arrays, every row given): the buffers of (B, P) are written whole,
        then the graph replays (on the CPU: the step runs on them). The
        logits stay valid until the next ``run`` at this (B, P).

        The pinned stage is written while no copy from it is pending: the
        caller reads each step's sampled tokens before the next step."""
        B, P = tables.shape
        st = self.prepare(B, P)
        pos, lens, tab, _ = layout(B, P)
        host = st.stage.numpy()
        host[:B] = tokens
        host[pos:pos + B] = positions
        host[lens:lens + B] = seq_lens
        host[tab:] = tables.reshape(-1)
        if st.graph is None:
            with torch.no_grad():
                return self.step(*st.inputs)
        st.flat.copy_(st.stage, non_blocking=True)
        st.graph.replay()
        for m, n in st.launches.items():
            m.launches += n
        return st.logits
