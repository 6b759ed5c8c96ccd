"""DeepSeek-V4 split as mp8 ranks over cards of their own, timed and held
to one process: the model-parallel engine (``models/dsv4_engine.py``,
``tp_size`` N) with one card a rank and NCCL between them, beside one
process on card 0, on the same random weights. No JAX counterpart to
replace (the JAX engine runs its MP8 mesh under GSPMD).

    python -m pegainfer_tpu_torch.studies.dsv4_tp_study [--tp 4] [--layers 8]
    python -m pegainfer_tpu_torch.studies.dsv4_tp_study --cpu   # tiny, gloo

DeepSeek-V4-Flash at its published widths cut to its first ``--layers``
layers (compress ratios 0, 0, 4, 128, 4, 128, 4, 128; 3 hash layers),
random resident fp8 / fp4 weights made on card 0 from the seed
(``dsv4.init_random_resident_device``); ``start_engine_from_params(...,
tp_size=N)`` on the first N cards, each rank cutting its shard onto its
card; the eager step (``precompile=False``), one token a dispatch, 2 slots.
Each engine serves 1024/32 twice (the second timed: TTFT and TPOT p50,
host clock) and 300/16 + 500/16 at once. The second 1024/32 of each runs
under ``torch.profiler`` in the process of rank 0: its device time, the
share of it in NCCL kernels (the collectives' share), and the window's
wall. One process runs first and records its route tape
(``dsv4.RouteTape``) and each token's logits. The split engine serves the
traffic with the ranks' own routing (timed; the ranks' tapes must be
equal), then again with the one-process tape replayed on every rank: the
ranks must make the one-process calls, and rank 0's streams must hold rule
7 against one process's at every step up to the first where they part
(``hold_streams``); the flips count the rows where a rank's own choice
differs. ``--cpu``: a tiny config on CPU ranks over gloo (no times worth
reading; a rehearsal of the path). Prints JSON with the card line, and
exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from pegainfer_tpu_torch.engine import contract
from pegainfer_tpu_torch.models import dsv4, dsv4_engine

SEED = 1234
MAIN = (1024, 32)
PAIR = ((300, 16), (500, 16))
ONE_TOKEN = dict(decode_block=1, decode_block_max=1, decode_pipeline_depth=1)
RULE7_RTOL = 5e-2  # rule 7's limit, a share of max |logit| (the smoke's DSV4_LOGITS_RTOL)

FLASH = dict(
    vocab_size=129280, dim=4096, moe_inter_dim=2048, n_layers=8, num_attention_heads=64,
    head_dim=512, q_lora_rank=1024, qk_rope_head_dim=64, o_groups=8, o_lora_rank=1024,
    sliding_window=128, n_routed_experts=256, n_shared_experts=1, n_activated_experts=6,
    n_hash_layers=3, routed_scaling_factor=1.5, swiglu_limit=7.0, rms_norm_eps=1e-6,
    index_n_heads=64, index_head_dim=128, index_topk=512, max_position_embeddings=1048576,
    rope_theta=10000.0, compress_rope_theta=10000.0,
    compress_ratios=(0, 0, 4, 128, 4, 128, 4, 128), yarn_original_seq_len=65536,
    yarn_factor=16.0)
TINY = dict(FLASH, vocab_size=256, dim=256, moe_inter_dim=128, num_attention_heads=16,
            head_dim=128, q_lora_rank=128, qk_rope_head_dim=64, o_lora_rank=128,
            sliding_window=16, n_routed_experts=16, index_n_heads=8, index_head_dim=128,
            index_topk=16)


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def request(handle, prompt, n):
    """One greedy request: (tokens, times of the tokens, submit time)."""
    t0 = time.perf_counter()
    return (*drain(submit(handle, prompt, n)), t0)


def submit(handle, prompt, n) -> contract.TokenChannel:
    ch = contract.TokenChannel()
    handle.submit(contract.GenerateRequest(prompt_tokens=list(prompt), max_tokens=n,
                                           params=contract.SamplingParams(ignore_eos=True),
                                           channel=ch))
    return ch


def drain(ch):
    """A request's tokens and their times; raises unless it finished."""
    toks, times = [], []
    while True:
        ev = ch.get(timeout=600)
        if ev is None:
            raise RuntimeError("no event from the engine in time")
        if isinstance(ev, contract.Token):
            toks.append(ev.id)
            times.append(time.perf_counter())
        elif contract.is_terminal(ev):
            if not isinstance(ev, contract.Finished):
                raise RuntimeError(f"the request ended with {ev}")
            return toks, times


def profiled(fn, cuda: bool):
    """``fn()`` under torch.profiler: (its result, {wall_ms, device_ms,
    nccl_ms, nccl_share}); the device figures of the CUDA activity of this
    process (rank 0's, on a card)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    t = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    dev = nccl = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0) or 0.0
        dev += us
        if "nccl" in e.key.lower():
            nccl += us
    return out, {"wall_ms": wall, "device_ms": dev / 1e3, "nccl_ms": nccl / 1e3,
                 "nccl_share_of_device": nccl / dev if dev else None}


def traffic(label, handle, cfg, cuda: bool, profile: bool) -> dict:
    """The study's traffic on ``handle``: 1024/32 twice (the second timed,
    and profiled with ``profile``), then 300/16 + 500/16 queued in one
    drain (the interpreter's switch interval raised while they are
    submitted, so every engine runs the same calls). Returns the
    figures."""
    rng = np.random.default_rng(SEED + 7)
    main_prompt = rng.integers(0, cfg.vocab_size, MAIN[0]).tolist()
    pair = [(rng.integers(0, cfg.vocab_size, n).tolist(), m) for n, m in PAIR]
    first, _, _ = request(handle, main_prompt, MAIN[1])
    if profile:
        (toks, times, t0), prof = profiled(lambda: request(handle, main_prompt, MAIN[1]), cuda)
    else:
        (toks, times, t0), prof = request(handle, main_prompt, MAIN[1]), None
    gaps = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    old = sys.getswitchinterval()
    sys.setswitchinterval(10.0)
    try:
        chans = [submit(handle, p, m) for p, m in pair]
    finally:
        sys.setswitchinterval(old)
    pair_toks = [drain(ch)[0] for ch in chans]
    rec = {"ttft_ms": (times[0] - t0) * 1e3, "tpot_p50_ms": statistics.median(gaps),
           "tpot_p95_ms": float(np.percentile(gaps, 95)), "profile": prof,
           "tokens_repeat": toks == first, "streams": [first, toks, *pair_toks]}
    print(f"{label}: TTFT {rec['ttft_ms']:.1f} ms, TPOT p50 {rec['tpot_p50_ms']:.2f} ms "
          f"(p95 {rec['tpot_p95_ms']:.2f})" + (
              f"; profiled request: wall {prof['wall_ms']:.1f} ms, device "
              f"{prof['device_ms']:.1f} ms, NCCL {prof['nccl_ms']:.1f} ms" if prof else ""),
          flush=True)
    return rec


def shut(handle) -> None:
    handle.shutdown()
    handle._thread.join(timeout=120)


# ── holding a split run to one process ───────────────────────────────────


def catch_step_logits(ex):
    """Record on ``ex`` (a ``SlotExecutor``: one process's, or rank 0's
    ``TPExecutor.local``) each request's logits [V] f32 a token: its
    prefill's last row, then its row of every decode step. Returns (logs
    {request id: [logits]}, the request ids in prefill order, a function
    that puts the executor back)."""
    logs, order, model = {}, [], ex.model

    def prefill_one(item):
        order.append(item.request_id)
        return type(ex)._prefill_one(ex, item)

    def prefill(*args):
        out = model.prefill(*args)
        logs.setdefault(order[-1], []).append(out[0].float().clone())
        return out

    def decode_model(items, *args):
        out = type(ex)._decode_model(ex, items, *args)
        for i, it in enumerate(items):
            logs[it.request_id].append(out[i].float().clone())
        return out

    ex._prefill_one, ex._decode_model = prefill_one, decode_model
    ex.model = dataclasses.replace(model, prefill=prefill)

    def restore():
        del ex._prefill_one, ex._decode_model
        ex.model = model

    return logs, order, restore


def hold_streams(got, want, got_logs, want_logs, rtol: float = RULE7_RTOL) -> dict:
    """Streams ``got`` (rank 0's, its step logits ``got_logs``) against
    ``want`` (one process's, ``want_logs``), run with the one-process
    routing and selections replayed on every rank: each step up to and
    including the first where the tokens part holds rule 7 against the
    one-process logits there (max |diff| within ``rtol`` x max |logit|;
    the argmax equal unless the one-process top-2 gap is below the diff),
    so the streams part only at a near-tie within rule 7's own limit.
    Returns a record a stream and ``ok``."""
    recs = []
    for g, w, lg, lw in zip(got, want, got_logs, want_logs):
        k = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        n = len(w) if k is None else k + 1
        ok, worst = len(g) == len(w) and len(lg) >= n and len(lw) >= n, 0.0
        for i in range(min(n, len(lg), len(lw))):
            diff = (lg[i] - lw[i]).abs().max().item()
            limit = rtol * lw[i].abs().max().item()
            top2 = torch.topk(lw[i], 2).values
            argmax = int(lg[i].argmax()) == int(lw[i].argmax()) or (
                (top2[0] - top2[1]).item() < diff)
            ok = ok and diff <= limit and argmax
            worst = max(worst, diff / limit)
        recs.append({"tokens": len(g), "first_diff_step": k, "steps_held": n,
                     "worst_share_of_limit": worst, "ok": ok})
    return {"streams": recs, "ok": bool(recs) and all(r["ok"] for r in recs)}


def tapes_equal(tapes) -> bool:
    """Whether every rank's route tape (``take_route_tape``) holds rank 0's
    decisions, entry by entry."""
    t0 = tapes[0]["entries"]
    return len(t0) > 0 and all(
        len(t["entries"]) == len(t0) and all(
            k0 == k1 and all(torch.equal(a, b) for a, b in zip(x0, x1))
            for (k0, x0), (k1, x1) in zip(t0, t["entries"]))
        for t in tapes[1:])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--tp", type=int, default=4)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    cuda = not args.cpu
    if cuda and torch.cuda.device_count() < args.tp:
        raise SystemExit(f"--tp {args.tp} needs {args.tp} cards, this machine has "
                         f"{torch.cuda.device_count()}")
    if args.cpu:  # the ranks take rank 0's thread count: one each, not the cores each
        torch.set_num_threads(1)
    base = TINY if args.cpu else FLASH
    n = min(args.layers, 8)
    cfg = dsv4.DSv4Config(**dict(base, n_layers=n, compress_ratios=base["compress_ratios"][:n],
                                 n_hash_layers=min(3, n)))
    dev = "cuda:0" if cuda else "cpu"
    t = time.perf_counter()
    if cuda:
        from pegainfer_tpu_torch.ops.cuda import build

        build.load("fp4_gemv")
        params = dsv4.init_random_resident_device(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    else:
        params = dsv4.quantize_params_resident(dsv4.init_random_params(cfg, seed=SEED))
    print(f"{n} layers at {'full' if cuda else 'tiny'} width: "
          f"{dsv4.params_bytes(params) / 1e9:.2f} GB in {time.perf_counter() - t:.1f} s; "
          f"{card_line() if cuda else 'cpu'}", flush=True)
    opts = contract.EngineLoadOptions(precompile=False, max_batch_size=2, max_model_len=2048,
                                      seed=SEED, prefill_chunk=None, enable_prefix_cache=False,
                                      **ONE_TOKEN)
    out = {"layers": n, "tp": args.tp, "device": dev, "card": card_line() if cuda else "cpu",
           "params_bytes": dsv4.params_bytes(params)}
    # one process first: its streams, each token's logits and its route tape
    one = dsv4_engine.start_engine_from_params(cfg, params, opts, device=dev)
    one_ex = one._scheduler.executor
    dsv4_engine.start_route_tape(one_ex)
    logs, order, _ = catch_step_logits(one_ex)
    try:
        out["one_process"] = traffic("one process", one, cfg, cuda, profile=True)
    finally:
        shut(one)
    one_tape = dsv4_engine.take_route_tape(one_ex)["entries"]
    want_logs = [logs[r] for r in order]
    del one, one_ex, logs
    t = time.perf_counter()
    handle = dsv4_engine.start_engine_from_params(cfg, params, opts, device=dev,
                                                  tp_size=args.tp)
    out["tp_start_s"] = time.perf_counter() - t
    ex = handle._scheduler.executor
    try:
        # the ranks' own routing: timed, and the ranks' decisions compared
        ex.on_ranks(dsv4_engine.start_route_tape)
        out["tp_run"] = traffic(f"TP {args.tp}", handle, cfg, cuda, profile=True)
        own = ex.on_ranks(dsv4_engine.take_route_tape)
        # the one-process routing and selections replayed on every rank
        ex.on_ranks(dsv4_engine.start_route_tape, one_tape)
        logs, order, restore = catch_step_logits(ex.local)
        try:
            replayed = traffic(f"TP {args.tp}, one-process routing replayed", handle, cfg,
                               cuda, profile=False)
        finally:
            restore()
        rep = ex.on_ranks(dsv4_engine.take_route_tape)
        out["ranks"] = [{k: st[k] for k in ("rank", "device", "backend", "params_bytes",
                                             "collectives", "prefills", "decode_steps")}
                        for st in ex.rank_stats()]
    finally:
        shut(handle)
    held = hold_streams(replayed["streams"], out["one_process"]["streams"],
                        [logs[r] for r in order], want_logs)
    out["own_routing"] = {
        "tapes_equal_on_ranks": tapes_equal(own), "decisions": len(own[0]["entries"]),
        "streams_equal": [a == b for a, b in zip(out["tp_run"]["streams"],
                                                  out["one_process"]["streams"])]}
    out["replayed"] = {
        "calls_as_one_process": all(len(t["entries"]) == len(one_tape) for t in rep),
        "tapes_equal_on_ranks": tapes_equal(rep),
        "flips": [(t["flips"], t["rows"]) for t in rep], **held}
    out["ok"] = (out["own_routing"]["tapes_equal_on_ranks"]
                 and out["replayed"]["calls_as_one_process"]
                 and out["replayed"]["tapes_equal_on_ranks"] and held["ok"])
    print(f"own routing: tapes equal on the ranks {out['own_routing']['tapes_equal_on_ranks']}"
          f" ({out['own_routing']['decisions']} decisions), streams equal to one process's "
          f"{out['own_routing']['streams_equal']}; replayed: the one-process calls "
          f"{out['replayed']['calls_as_one_process']}, flips {out['replayed']['flips']}, "
          f"streams {held['streams']}", flush=True)
    print(json.dumps(out))
    if not out["ok"]:
        raise SystemExit("the split run disagrees with one process (record above)")
    return out


if __name__ == "__main__":
    main()
