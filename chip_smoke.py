"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. the card (name, power limit) and the torch / CUDA versions;
2. build the hand-written kernels from ``pegainfer_tpu_torch/csrc`` with
   nvcc for sm_90a and print ptxas's registers / shared memory / spills;
3. hold each kernel against its plain PyTorch version at the main path's
   shapes (bf16 tolerances of the JAX package's kernel tests: 3e-2 decode,
   2e-2 prefill);
4. serve Qwen3-4B (full width and depth, random weights from a seed) through
   ``start_engine_from_params`` -> ``EngineHandle.submit``: one greedy
   1024-token prompt with 256 output tokens, then two shorter requests at
   once so decode runs at batch 2;
5. every request must end in ``Finished`` with its full token count;
6. the kernels' launch counters must equal 36 x prefills (flash prefill)
   and 36 x decode steps (paged decode);
7. the 1024-token prefill's last logits with the kernels against the same
   model with the plain attention: max |diff| <= LOGITS_RTOL x max |logit|,
   and the argmax agrees unless the plain run's top-2 gap is below the diff;
8. timings: TTFT and TPOT p50 of the 1024/256 request, and each kernel's
   time against its bound, its plain version and a library call.

The last lines are the kernels' JSON record, the card line from nvidia-smi
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 1234
PAGE = 64
PROMPT, OUT = 1024, 256  # the main path's traffic
SHORT = ((300, 64), (500, 64))  # two concurrent requests: decode at B = 2
DECODE_TOL, PREFILL_TOL = 3e-2, 2e-2
# bf16 activations through 36 layers: the kernels round where the f32 plain
# attention does not (its output is cast to bf16 once), and each layer's
# difference rides the residual stream to the logits
LOGITS_RTOL = 5e-2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12
TOP_OPS = 8  # device operations listed per profiled step, by device time
SLEEP_CYCLES = 100_000_000  # about 50 ms of device sleep at H100 clocks


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def qwen3_4b_config(q3):
    """Qwen3-4B (bench.py's config): the HF Qwen/Qwen3-4B config.json."""
    return q3.Qwen3Config(
        hidden_size=2560, intermediate_size=9728, num_hidden_layers=36,
        num_attention_heads=32, num_key_value_heads=8, head_dim=128,
        vocab_size=151936, rms_norm_eps=1e-6, rope_theta=1000000.0,
        tie_word_embeddings=True, eos_token_id=151645, stop_token_ids=(151645,),
        max_position_embeddings=40960,
    )


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls.

    A device-side sleep ahead of the start event keeps the card busy while
    the host enqueues all calls, so a call made of many small launches is
    timed on the device and not at the host's launch rate (which varies
    from call to call with the load on the host). If the sleep ran out
    before the host finished, the sleep doubles and the timing repeats.
    Keep a window to a few hundred launches: more than the device's queue
    of pending launches would block the host until the sleep ends."""
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
        fed = not start.query()  # the card had not reached the start yet
        torch.cuda.synchronize()
        if fed:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise SystemExit("timing: the host could not enqueue the calls within the device sleep")


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ── phase 3: kernels against their plain versions ───────────────────────


def _pages_for(seq_lens, ps, first=1):
    tables, nxt = [], first
    P = max(1, max(-(-s // ps) for s in seq_lens))
    for s in seq_lens:
        n = -(-s // ps)
        tables.append(list(range(nxt, nxt + n)) + [0] * (P - n))
        nxt += n
    return tables, nxt


def decode_case(gen, cfg, seq_lens, form, layers=2):
    """Inputs of one paged-decode call at the main path's head shapes."""
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    tables, n_pages = _pages_for(seq_lens, PAGE)
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    pool = rnd(layers, Hkv, n_pages, 2, PAGE, hd)
    B = len(seq_lens)
    args = dict(
        q=rnd(B, Hq, hd),
        page_tables=torch.tensor(tables, dtype=torch.int32, device=dev),
        seq_lens=torch.tensor(seq_lens, dtype=torch.int32, device=dev),
        scale=hd ** -0.5,
    )
    if form in ("pool", "pool_cur"):
        args.update(k_pages=pool, v_pages=pool, layer_id=layers - 1)
    else:
        args.update(k_pages=pool[0, :, :, 0], v_pages=pool[0, :, :, 1])
    if form in ("layer_cur", "pool_cur"):
        args.update(cur_k=rnd(B, Hkv, hd), cur_v=rnd(B, Hkv, hd))
    return args


def check_kernels(cfg, pd, fp):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    errs = {"paged_decode": 0.0, "flash_prefill": 0.0}
    decode_cases = [
        ("B=1 ctx 1024, per-layer pages", [1024], "layer"),
        ("B=1 ctx 1024, pool + layer_id + cur", [1024], "pool_cur"),
        ("B=5 ragged {1,63,700,1280} + dead row, pool + layer_id", [1, 63, 700, 1280, 0], "pool"),
        ("B=5 ragged {1,63,700,1280} + dead row, pool + layer_id + cur",
         [1, 63, 700, 1280, 0], "pool_cur"),
        ("B=5 ragged + dead row, per-layer pages + cur", [1, 63, 700, 1280, 0], "layer_cur"),
    ]
    for name, seq_lens, form in decode_cases:
        a = decode_case(gen, cfg, seq_lens, form)
        out = pd.paged_attention_decode(**a)
        torch.cuda.synchronize()
        ref = pd.paged_attention_decode_plain(**a)
        err = (out.float() - ref.float()).abs().max().item()
        dead = [b for b, s in enumerate(seq_lens) if s == 0]
        dead_ok = all(out[b].abs().max().item() == 0.0 for b in dead)
        ok = err <= DECODE_TOL and dead_ok and bool(torch.isfinite(out).all())
        log(f"  K1 paged_decode  {name}: max_abs_err {err:.3e} (tol {DECODE_TOL})"
            f"{' dead row 0' if dead else ''} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("paged decode kernel disagrees with its plain version")
        errs["paged_decode"] = max(errs["paged_decode"], err)

    prefill_cases = [
        ("T=S=1024", 1024, 1024, 1024, 0),
        ("T=S=1000 (not a multiple of 128)", 1000, 1000, 1000, 0),
        ("chunk continuation T=256 at q_offset 768, S=1024", 256, 1024, 1024, 768),
    ]
    for name, T, S, kv_valid, q_offset in prefill_cases:
        q = torch.randn((T, Hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((S, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((S, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        out = fp.flash_attention(q, k, v, kv_valid, q_offset, hd ** -0.5)
        torch.cuda.synchronize()
        ref = fp.att.causal_attention(q, k, v, kv_valid, q_offset, hd ** -0.5)
        live = min(T, kv_valid - q_offset)
        err = (out[:live].float() - ref[:live].float()).abs().max().item()
        ok = err <= PREFILL_TOL and bool(torch.isfinite(out[:live]).all())
        log(f"  K2 flash_prefill {name}: max_abs_err {err:.3e} (tol {PREFILL_TOL}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("flash prefill kernel disagrees with its plain version")
        errs["flash_prefill"] = max(errs["flash_prefill"], err)
    return errs


# ── phase 4: serve through the engine ───────────────────────────────────


def run_request(contract, handle, prompt, max_tokens):
    """Submit one greedy request that ignores EOS. Returns (channel, submit
    time)."""
    ch = contract.TokenChannel()
    t0 = time.perf_counter()
    handle.submit(contract.GenerateRequest(
        prompt_tokens=prompt, max_tokens=max_tokens,
        params=contract.SamplingParams(ignore_eos=True), channel=ch))
    return ch, t0


def drain(contract, ch, timeout_s=600):
    toks, times = [], []
    while True:
        ev = ch.get(timeout=timeout_s)
        if ev is None:
            raise SystemExit("no event from the engine within the time limit")
        if isinstance(ev, contract.Token):
            toks.append(ev.id)
            times.append(time.perf_counter())
        elif contract.is_terminal(ev):
            return toks, ev, times


def expect_finished(contract, label, toks, fin, want):
    ok = isinstance(fin, contract.Finished) and fin.completion_tokens == want \
        and len(toks) == want
    log(f"  {label}: {type(fin).__name__} {len(toks)}/{want} tokens "
        f"{'ok' if ok else 'FAIL ' + repr(fin)}")
    if not ok:
        raise SystemExit(f"request {label} did not finish with {want} tokens")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "pegainfer_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: pegainfer_tpu_torch/ is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))  # the checkout's package, not an installed one
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.models import qwen3 as q3
    from pegainfer_tpu_torch.models.qwen3_engine import start_engine_from_params
    from pegainfer_tpu_torch.ops import attention as att
    from pegainfer_tpu_torch.ops.cuda import build
    from pegainfer_tpu_torch.ops.cuda import flash_prefill as fp
    from pegainfer_tpu_torch.ops.cuda import paged_decode as pd

    t_start = time.perf_counter()
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    build.load("paged_decode")
    log(f"[2] kernels built and loaded in {time.perf_counter() - t:.1f} s")
    for name, text in build.build_logs.items():
        log(f"  --- ptxas: {name} ---")
        for line in text.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "Compiling entry" in line):
                log("  " + line.strip())

    cfg = qwen3_4b_config(q3)
    log("[3] kernels against their plain versions")
    errs = check_kernels(cfg, pd, fp)

    log("[4] serving Qwen3-4B bf16 (36 layers, random weights) through the engine")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t = time.perf_counter()
    params = q3.init_random_params_device(cfg, gen, "cuda")
    torch.cuda.synchronize()
    log(f"  weights: {q3.params_bytes(params) / 1e9:.2f} GB in {time.perf_counter() - t:.1f} s")
    handle = start_engine_from_params(
        cfg, params, contract.EngineLoadOptions(kv_memory_fraction=0.5, seed=SEED),
        device="cuda")
    ex = handle._scheduler.executor
    log(f"  KV pool: {ex.kv_pages.shape[2]} pages x {PAGE} tokens "
        f"({ex.kv_pages.numel() * 2 / 1e9:.1f} GB)")
    rng = np.random.default_rng(SEED)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    try:
        # warm-up (cuBLAS handles, allocator) before the counted run
        ch, _ = run_request(contract, handle, prompt(64), 4)
        toks, fin, _ = drain(contract, ch)
        expect_finished(contract, "warm-up 64/4", toks, fin, 4)

        pd.launches = fp.launches = 0
        ex.prefills = ex.decode_steps = 0
        main_prompt = prompt(PROMPT)
        ch, t0 = run_request(contract, handle, main_prompt, OUT)
        toks, fin, times = drain(contract, ch)
        expect_finished(contract, f"main {PROMPT}/{OUT}", toks, fin, OUT)
        ttft_ms = (times[0] - t0) * 1e3
        gaps = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
        steps_alone = ex.decode_steps
        chans = [(run_request(contract, handle, prompt(n), m)[0], n, m) for n, m in SHORT]
        for ch, n, m in chans:
            toks_s, fin_s, _ = drain(contract, ch)
            expect_finished(contract, f"concurrent {n}/{m}", toks_s, fin_s, m)
        steps_pair = ex.decode_steps - steps_alone
        launches = {"paged_decode": pd.launches, "flash_prefill": fp.launches}
        prefills, decode_steps = ex.prefills, ex.decode_steps
    finally:
        handle.shutdown()
        handle._thread.join(timeout=60)

    L = cfg.num_hidden_layers
    log(f"[5] all requests Finished with their token counts; the concurrent pair "
        f"took {steps_pair} decode steps for {sum(m - 1 for _, m in SHORT)} decode tokens")
    if steps_pair >= sum(m - 1 for _, m in SHORT):
        raise SystemExit("the two concurrent requests never decoded in one batch")
    want = {"flash_prefill": L * prefills, "paged_decode": L * decode_steps}
    log(f"[6] launches {launches}; expected {want} "
        f"({prefills} prefills, {decode_steps} decode steps, {L} layers)")
    if launches != want:
        raise SystemExit("kernel launch counts do not match the path")

    log("[7] 1024-token prefill logits: kernels vs plain attention, on the card")
    kv = q3.make_kv_pages(cfg, PROMPT // PAGE + 1, PAGE, device="cuda")
    toks_t = torch.tensor(main_prompt, dtype=torch.int32, device="cuda")
    table = torch.arange(1, PROMPT // PAGE + 1, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        lk, _ = q3.prefill(cfg, params, kv, toks_t, table)
        lp, _ = q3.prefill(cfg, params, kv, toks_t, table, plain_attention=True)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(lk).all()) and lk.shape == (cfg.vocab_size,)):
        raise SystemExit("kernel-path logits are not finite [V]")
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    top2 = torch.topk(lp, 2).values
    gap = (top2[0] - top2[1]).item()
    argmax_same = int(lk.argmax()) == int(lp.argmax())
    log(f"  max |diff| {diff:.4e}, max |logit| {scale:.4e}, tolerance "
        f"{LOGITS_RTOL} x max |logit| = {LOGITS_RTOL * scale:.4e}; argmax agrees: "
        f"{argmax_same} (plain top-2 gap {gap:.4e})")
    if diff > LOGITS_RTOL * scale or (not argmax_same and gap > diff):
        raise SystemExit("kernel-path logits disagree with the plain-attention model")
    del kv

    log("[8] timings")
    steps = step_profile(cfg, q3, params, toks_t, int(lk.argmax()))
    tpot = statistics.median(gaps)
    tpot95 = float(np.percentile(gaps, 95))  # 12 of the 255 gaps lie beyond it
    log(f"  main {PROMPT}/{OUT}: TTFT {ttft_ms:.3f} ms, TPOT p50 {tpot:.3f} ms, "
        f"p95 {tpot95:.3f} ms over {len(gaps)} gaps (host clock, per streamed token)")
    for name, (wall, dev, n) in steps.items():
        log(f"  {name}: wall {wall:.3f} ms, device time {dev:.3f} ms in {n:.0f} "
            f"kernels and copies (torch.profiler), device idle {1 - dev / wall:.1%}")
    records = time_kernels(cfg, pd, fp, att, errs, launches)
    for r in records:
        log(f"  {r['name']}: {r['ms'] * 1e3:.2f} us vs bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']}), plain {r['plain_ms'] * 1e3:.2f} us, library "
            + (f"{r['library_ms'] * 1e3:.2f} us" if r["library_ms"] is not None else "none"))
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records, "serving": {
        "ttft_ms": ttft_ms, "tpot_p50_ms": tpot, "tpot_p95_ms": tpot95,
        "prompt": PROMPT, "output": OUT},
        "steps": {k: {"wall_ms": w, "device_ms": d, "device_ops": n}
                  for k, (w, d, n) in steps.items()}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def step_profile(cfg, q3, params, prompt_t, first_token, iters=5):
    """Wall time (host clock, each call ending in a synchronize, as the
    executor's token read does), device time and the number of device
    operations (kernels and copies; torch.profiler, CUDA activity only) of
    one 1024-token prefill and one B = 1 decode step at context 1025,
    called directly on the model."""
    from torch.profiler import ProfilerActivity, profile

    kv = q3.make_kv_pages(cfg, PROMPT // PAGE + 2, PAGE, device="cuda")
    table = torch.arange(1, PROMPT // PAGE + 2, dtype=torch.int32, device="cuda")
    dec = [torch.tensor(x, dtype=torch.int32, device="cuda") for x in
           ([first_token], [PROMPT], [table.tolist()], [PROMPT + 1])]
    calls = {
        f"prefill {PROMPT}": lambda: q3.prefill(cfg, params, kv, prompt_t, table[:-1]),
        f"decode step B=1 ctx {PROMPT + 1}": lambda: q3.decode(cfg, params, kv, *dec),
    }
    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(iters):
                fn()
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t) / iters * 1e3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                    torch.cuda.synchronize()
            ka = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                        key=lambda e: -e.self_device_time_total)
            dev = sum(e.self_device_time_total for e in ka) / iters / 1e3
            out[name] = (wall, dev, sum(e.count for e in ka) / iters)
            for e in ka[:TOP_OPS]:
                log(f"    {name}: {e.self_device_time_total / iters / 1e3:7.3f} ms in "
                    f"{e.count / iters:4.0f} x {e.key[:90]}")
    return out


def time_kernels(cfg, pd, fp, att, errs, launches):
    """Each kernel at the main path's shape, its bound from these inputs,
    its plain version and (K2) one library call on the same inputs."""
    L, Hq, Hkv, hd = (cfg.num_hidden_layers, cfg.num_attention_heads,
                      cfg.num_key_value_heads, cfg.head_dim)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # K1: B = 1 in mid-decode (context 1152 = 1024 + 128), full pool with
    # layer_id and the in-flight token as the main path calls it; cycling
    # the layer over all 36 keeps the pages out of L2, as in a real step
    ctx = PROMPT + OUT // 2
    a = decode_case(gen, cfg, [ctx], "pool_cur", layers=L)
    pool = a["k_pages"]

    def k1(i):
        a["layer_id"] = i % L
        pd.paged_attention_decode(**a)

    def k1_plain(i):
        a["layer_id"] = i % L
        pd.paged_attention_decode_plain(**a)

    saved = pd.launches
    k1_ms = time_ms(k1, 360)
    pd.launches = saved
    k1_plain_ms = time_ms(k1_plain, 12)
    past = ctx - 1
    b1 = (2 * Hq * hd * 2  # q in, out
          + 2 * past * Hkv * hd * 2  # live k and v rows
          + 2 * Hkv * hd * 2  # cur k, v
          + a["page_tables"].numel() * 4 + 4)
    f1 = 2 * 2 * Hq * hd * ctx
    k1_bound, k1_by = bound(b1, f1)
    del pool, a

    # K2: whole 1024-token prompt
    T = PROMPT
    q = torch.randn((T, Hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((T, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((T, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    scale = hd ** -0.5
    saved = fp.launches
    k2_ms = time_ms(lambda i: fp.flash_prefill(q, k, v, T, scale), 100)
    fp.launches = saved
    k2_plain_ms = time_ms(lambda i: att.prefill_attention(q, k, v, T, scale), 10)
    # library yardstick: SDPA on [1, H, T, hd], k/v heads repeated to Hq
    # outside the timed call
    G = Hq // Hkv
    qh = q.transpose(0, 1).unsqueeze(0).contiguous()
    kh, vh = (x.repeat_interleave(G, dim=1).transpose(0, 1).unsqueeze(0).contiguous()
              for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    k2_lib_ms = time_ms(lambda i: sdpa(qh, kh, vh, is_causal=True, scale=scale), 100)
    b2 = (2 * T * Hq * hd + 2 * T * Hkv * hd) * 2
    f2 = 2 * 2 * Hq * hd * (T * (T + 1) // 2)
    k2_bound, k2_by = bound(b2, f2)
    return [
        {"name": "paged_decode", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/paged_decode.cu",
         "replaces": "pegainfer_tpu/ops/pallas/paged_decode.py:248",
         "launches": launches["paged_decode"], "max_abs_err": errs["paged_decode"],
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "flash_prefill", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/flash_prefill.cu",
         "replaces": "pegainfer_tpu/ops/pallas/flash_prefill.py:114",
         "launches": launches["flash_prefill"], "max_abs_err": errs["flash_prefill"],
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": k2_lib_ms},
    ]


if __name__ == "__main__":
    sys.exit(main())
