"""The device group's collectives of a tensor-parallel Qwen3-4B step, timed
(``parallel/group.py``), with no JAX counterpart to replace (GSPMD inserts
them there).

    python -m pegainfer_tpu_torch.studies.tp_collectives_study [--ranks 2] [--cpu]

Ranks 1..n-1 are spawned processes; every rank runs on card 0 (gloo, as
the smoke's [29] shares the one card) or, with ``--cpu``, on the CPU. At
each shape of a step, each rank calls the collective ``CALLS`` times after
``WARMUP`` calls; the host clock around the calls (each waits for its
result) gives the time a call, the ranks' worst reported:

- ``all_reduce_sum`` of the f32 partial sums of wo / w_down: a decode step's
  rows (1, 2, 8, 64) and a 1,024-token prefill's, of width 2,560;
- ``gather_vocab`` of the head's f32 shard: [1 | 2 | 8 | 64, 151,936 / n].

A step makes 2 x 36 reductions and one gather, so ``step_ms`` = 72 x
reduce + gather at each row count: the floor that the collectives put
under a tensor-parallel step over this backend. Prints JSON with the card
line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import torch
import torch.multiprocessing as mp

from pegainfer_tpu_torch.parallel.group import RankGroups

HIDDEN, VOCAB, LAYERS = 2560, 151936, 36
ROWS = (1, 2, 8, 64, 1024)
WARMUP, CALLS = 3, 20


def _time(fn, calls: int) -> float:
    for _ in range(WARMUP):
        fn()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t) / calls * 1e3


def rank_main(rank: int, size: int, store: str, device: str, out) -> None:
    """One rank: its groups, then each collective at each shape; rank
    ``rank``'s {name: ms a call} into the queue ``out``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    g = RankGroups(rank, size, store, "gloo")
    res = {}
    for M in ROWS:
        x = torch.randn((M, HIDDEN), device=dev)
        res[f"all_reduce_sum M={M}"] = _time(lambda: g.all_reduce_sum(x), CALLS)
        if M <= 64:
            shard = torch.randn((M, VOCAB // size), device=dev)
            res[f"gather_vocab M={M}"] = _time(lambda: g.gather_vocab(shard), CALLS)
    g.barrier()
    out.put((rank, res))


def run(size: int, device: str) -> dict:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    d = tempfile.mkdtemp(prefix="pegainfer-tp-study-")
    store = os.path.join(d, "store")
    procs = [ctx.Process(target=rank_main, args=(r, size, store, device, out), daemon=True,
                         name=f"pegainfer-tp-study-rank{r}") for r in range(1, size)]
    for p in procs:
        p.start()
    rank_main(0, size, store, device, out)
    got = dict(out.get(timeout=600) for _ in range(size))  # drained before the joins
    for p in procs:
        p.join(60)
    shutil.rmtree(d, ignore_errors=True)
    worst = {k: max(got[r][k] for r in got) for k in got[0]}
    steps = {M: 2 * LAYERS * worst[f"all_reduce_sum M={M}"] + worst[f"gather_vocab M={M}"]
             for M in ROWS if M <= 64}
    return {"ranks": size, "device": device, "ms": worst,
            "step_ms": {f"M={M}": v for M, v in steps.items()},
            "prefill_1024_ms": 2 * LAYERS * worst["all_reduce_sum M=1024"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--cpu", action="store_true", help="ranks on the CPU")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu")
    res = run(args.ranks, "cpu" if args.cpu else "cuda:0")
    if not args.cpu:
        from pegainfer_tpu_torch.studies.timing import card_line

        res["card"] = card_line()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
