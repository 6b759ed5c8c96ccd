"""Timing on the card for the studies: device time by CUDA events,
host-inclusive wall time, and the card line to print beside them."""

from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np
import torch

SLEEP_CYCLES = 100_000_000  # about 50 ms of device sleep at H100 clocks


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call ``fn(i)``, by CUDA events over ``iters``
    calls. A device sleep ahead of the start event keeps the card busy
    while the host enqueues the calls, so the host's launch rate is not
    timed; if the sleep ran out first, it doubles and the timing repeats.
    Keep a window to a few hundred launches (the device's launch queue)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        fed = not start.query()
        torch.cuda.synchronize()
        if fed:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise RuntimeError("timing: the host could not enqueue the calls within the device sleep")


def wall_ms(fn, reps: int, warmup: int = 3) -> dict:
    """Host clock around one call ``fn(i)`` and ``synchronize``, over
    ``reps`` calls on an idle card: median, quartiles, min and max in ms."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    q1, q3 = np.percentile(ts, [25, 75])
    return {"median": statistics.median(ts), "q1": float(q1), "q3": float(q3),
            "min": min(ts), "max": max(ts), "reps": reps}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
