"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. the card (name, power limit) and the torch / CUDA versions;
2. build the hand-written kernels from ``pegainfer_tpu_torch/csrc`` (K1-K9,
   the bf16 weight streams, the int8 expert stream and the fp4 decode
   variants; one nvcc per source, all at once, sm_90a)
   and print ptxas's registers / shared memory / spills;

The bf16 weight streams (the TPU studies S2 and S1, at Qwen3-4B's shapes),
while the card is empty:

2a. stream_sum (bulk and ldg forms), gemv and layer_gemv against their plain
    versions (``gemv_stream_study.check``) at the gate_up-, lm_head- and
    qkv-like shapes, a ragged N and a ragged K; then the stream study's sweep
    (``pegainfer_tpu_torch/studies/gemv_stream_study.py``) over bytes a
    stage, stages and blocks an SM on the three shapes, W rotated over
    copies beyond 2 x L2, beside torch.sum and torch's GEMV in both layouts:
    the **read ceiling** (the best stream_sum form above L2, the median of
    its re-timings) and the records at the wrappers' defaults;
2b. gemv_chain, 36 layers of gate_up (3.59 GB), against its plain chain
    (``gemv_chain_study.check``: one layer, every layer on the kernel's own
    x, whole chains of 2 and 36 within twice the f32 plain chains' drift
    from f64), then the five chain forms (eager torch GEMVs, their CUDA
    graph, layer_gemv launches, their graph, gemv_chain), each with device
    and wall time;

The int8 expert stream and the fp4 decode variants (the TPU studies S3 and
S4, at DeepSeek-V4-Flash's expert shapes), on weights made on the card from
the seed:

2c. expert_gemv (convert and native forms, 16 / 32 / 64 rows a block) and
    expert_gemv_in_flight against their plain versions, each routed row to
    its own limit, the native form bit for bit
    (``expert_stream_study.check``: q int8 [256, 2048, 4096], 2.15 GB, at M
    12 with repeated experts and M 1; a ragged OUT of 2018; sums near 2^24),
    then the study's forms timed beside K6 and torch's bmm
    (``pegainfer_tpu_torch/studies/expert_stream_study.py``);
2d. fp4_variant_gemv (floor, bits_noscale, bits, arith x 16 / 32 / 64 rows)
    against their plain versions, row by row (``fp4_kernel_study.check``:
    q uint8 [256, 2048, 2048] and bf16 scales, 1.2 GB; the same cases;
    bits and arith weight for weight), the scale loads of floor and
    bits_noscale counted in the SASS, then the sweep beside K3 and its bmm
    (``pegainfer_tpu_torch/studies/fp4_kernel_study.py``);

Qwen3-4B bf16 (full width and depth, random weights from a seed):

3. hold K1 and K2 against their plain versions at the main path's shapes
   (bf16 tolerances of the JAX package's kernel tests: 3e-2 decode, 2e-2
   prefill);
4. serve through ``start_engine_from_params`` -> ``EngineHandle.submit``:
   one greedy 1024-token prompt with 256 output tokens, then two shorter
   requests at once so decode runs at batch 2;
5. every request must end in ``Finished`` with its full token count;
6. the launch counters must equal 36 x prefills (K2) and 36 x decode steps
   (K1);
7. the 1024-token prefill's last logits with the kernels against the same
   model with the plain attention: max |diff| <= LOGITS_RTOL x max |logit|,
   and the argmax agrees unless the plain run's top-2 gap is below the diff;
8. timings: TTFT and TPOT of the 1024/256 request, a torch.profiler step
   profile, and each kernel's time against its bound, its plain version and
   a library call (SDPA for both; K1 also at K1_SHAPES). The engine, weights
   and KV pool are then freed.

DeepSeek-V4-Flash, 8 layers at full width, random resident fp8 / packed-fp4
weights made on the card from the seed:

9. build the weights (about 33 GB);
10. hold K3, K4 and K5 against their plain versions on the model's weights
    at the path's shapes and at ragged cases (K4 at the seven shapes of a
    decode step at M = 1, 2 and 8; K3 at M 1, 6 and 12 with repeated
    experts, B = 2's shared experts and ids -1 and E, whose rows must be
    exactly 0; skewed routing with empty experts, segments across tiles, a
    tile of 56 rows; K3 and K5 also with w1's scales given random bf16
    mantissas), K5 each row within GROUPED_ROW_RTOL of its max |ref|;
11. serve through ``dsv4_engine.start_engine_from_params`` (2 slots,
    max_model_len 2048): a 16/4 warm-up, the greedy 1024/64 request, then
    300/32, 500/32 and 200/16 at once;
12. every request ends in ``Finished`` with its count; the third concurrent
    request is prefilled only after a slot frees, and the first two decode
    at B = 2; launches equal 24 x prefills (K5), 24 x decode steps (K3) and
    59 x decode steps (K4); the 1024-token prefill's last logits, and one
    decode step after it from the plain prefill's caches, with the kernels
    against ``plain_kernels=True``, the kernel run routed as the plain run
    (same rule as 7, DSV4_LOGITS_RTOL);
13. timings: TTFT and TPOT of the 1024/64 request, a torch.profiler step
    profile of one prefill and one B = 1 decode step (K4's and K3's device
    time in it), and K3-K5 against their bounds, plain versions and a library call
    each (bmm, matmul, grouped_mm on bf16 weights); K3 at w1 and w2 at B = 1
    and at B = 2's shared routing, and its sum over a B = 1 step's launches;
    K4 at each of the seven shapes of a decode step and their sum over the
    step's launches; K5 at
    w1, at w2 and at skewed routing, each beside one grouped_mm, and its
    plan's time.

On the same weights, the opt-in fp4 chain and then the int8-experts mode:

14. K9 (the fused fp4 chain) against its plain version on one score-gated
    layer at M = 6, 12 (repeated experts) and 16 (one expert), in both
    perm13 forms (permuted copies of the layer's w1 / w3, freed after), each
    row within CHAIN_ROW_RTOL of its max |ref|; its timing at B = 1 and 2
    beside the chain-off sequence (K3, SwiGLU, K3, K3); the 300/32 + 500/32
    pair served with ``moe_chain=True`` (launches: L x decode steps K9, no
    K3, 3L x prefills K5); one decode step's logits, chain vs plain, under
    the plain run's routing, and that step profiled with the chain on and
    off;
15. requantize the experts to int8 through ``start_engine_from_params(
    quantize="int8-experts")``: time, bytes before and after, peak reserved
    memory, and the codes of one expert that differ from the host
    ``quantize_int8_stack`` (none expected);
16. K6, K7 and K8 against their plain versions on the model's int8 weights
    (K6 each row within INT8_GEMV_RTOL of its max |ref|, y NaN-filled
    first, at w1 / w2 / w3 and M 1, 6, 12, 18, 20 with distinct, repeated
    and B = 2's shared experts, 20 rows on one expert and ids -1 and E,
    whose rows must be exactly 0; K7 at phase 10's skews and tiles, each row
    within GROUPED_ROW_RTOL of its max |ref|; K8 at M = 1, 6, 12, 16);
17. serve phase 11's traffic in int8 (K7 prefill, K8 decode): Finished
    counts, the slot wait, B = 2, launches (3L x prefills K7, L x decode
    steps K8, 59 x decode steps K4, no K3 / K5 / K6), prefill and decode
    logits against the plain versions; then the 300/32 + 500/32 pair with
    ``moe_chain=False`` (3L x decode steps K6, no K8);
18. timings: TTFT and TPOT of the int8 1024/64 request, torch.profiler
    step profiles with the chain on and off (K4's and K6's device time in
    them), and K6-K9 against their bounds, plain versions and (K6, K7) a
    library call; K6 at w1 and w2 at M 1, 6, 12 and B = 2's shared 12 beside
    bmm (and matmul at M 1), and its sum over a chain-off step's launches;
    K7 at w1, at w2 and at skewed routing, each beside one grouped_mm, and
    its plan's time.

The last lines are the kernels' JSON record (the weight streams, the S3 /
S4 kernels and K1-K9; with the read ceiling, and the S3 / S4 kernels, K3,
K4, K6, K8 and K9 also bound by their bytes over it as
``measured_bound_ms``), the card line from nvidia-smi and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import logging
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
# K1 is also timed at the concurrent pair's contexts and at one long context
K1_SHAPES = ([300, 500], [8192])
DECODE_TOL, PREFILL_TOL = 3e-2, 2e-2
# K1 is held row by row to min(DECODE_TOL, DECODE_RTOL x the row's max
# |ref|): a decode output averages n tokens' values and is about sqrt(e / n)
# in size (0.013 at 16,384), below a fixed 3e-2; 2e-2 of the row's largest
# output is about 2.5 bf16 ulps of it
DECODE_RTOL = 2e-2
# K2 likewise, each query row (position, head) to min(PREFILL_TOL,
# PREFILL_RTOL x the row's max |ref|): a late row of a 1,024-token prompt
# averages about a thousand values and is about 0.05 in size, so a fixed 2e-2
# passes a kernel that drops a key tile; a right kernel rounds p and the
# output to bf16 once, a fraction of a percent of the row's largest value
PREFILL_RTOL = 2e-2
# K2 is also timed at a long prompt at Qwen3-4B's heads and at Qwen3.5's
# full-attention heads (pegainfer_tpu/models/qwen35.py:285): (T, Hq, Hkv, hd)
K2_SHAPES = ((4096, 32, 8, 128), (1024, 16, 2, 256))
# bf16 activations through 36 layers: the kernels round where the f32 plain
# attention does not (its output is cast to bf16 once), and each layer's
# difference rides the residual stream to the logits
LOGITS_RTOL = 5e-2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12
TOP_OPS = 8  # device operations listed per profiled step, by device time
# the decode GEMVs whose device time a step profile picks out: (record
# name, kernel, the CUDA kernel's name)
STEP_KERNELS = (("fp8_gemv", "K4", "fp8_gemv_kernel"), ("moe_fp4_gemv", "K3", "fp4_gemv_kernel"),
                ("moe_int8_gemv", "K6", "int8_gemv_kernel"))

# DeepSeek-V4-Flash phases
DSV4_LAYERS = 8
DSV4_SLOTS = 2
DSV4_MAX_MODEL_LEN = 2048
DSV4_WARMUP = (16, 4)
DSV4_PROMPT, DSV4_OUT = 1024, 64  # scripts/dsv4_flagship_engine.py's defaults
DSV4_CONCURRENT = ((300, 32), (500, 32), (200, 16))  # the third waits for a slot
# K3 / K4 form the same exact f32 products as their plain versions, in
# another summation order (the JAX kernel tests' atol, on unit-RMS outputs)
QUANT_GEMV_TOL = 2e-5
# K4's linears in a decode step (models/dsv4.py), one of each shape
K4_STEP_KEYS = ("wq_a", "wq_b", "wkv", "wo_b", "shared_w1", "shared_w2", "idx_wq_b")
# the library yardsticks of K3, K5 and K7 round their products or outputs
# to bf16 (the JAX grouped test's 2e-2 of max |y|)
GROUPED_RTOL = 2e-2
# the kernel run is routed as the plain run (RoutingReplay); through 8
# random layers bf16 roundings of the activations (in both runs) turn the
# kernels' f32 sum-order differences into bf16-ulp differences; as for
# Qwen3, 5% of max |logit|
DSV4_LOGITS_RTOL = 5e-2
# int8 phases: K6 forms its plain version's exact f32 products in another
# order, on unscaled outputs of magnitude 1e4 (codes up to 127), so its
# tolerance is relative; the chains K8 / K9 round act to bf16, where an f32
# sum-order difference moves an element by one bf16 ulp now and then
INT8_GEMV_RTOL = 1e-5
CHAIN_RTOL = 2e-3
# K9 holds each row to CHAIN_ROW_RTOL of the row's max |ref|, and a row of an
# invalid expert id to exactly 0. A right kernel's products are exact and
# only their f32 sum order differs (its worst row at 6e-6 of its max on an
# H100, scripts/k9_study.py); an act element that this moves across a bf16
# rounding boundary moves y by one ulp of it times one weight, at most
# about 3e-4 of the row's max. One dropped product of act and w2, or one
# act channel lost, moves y by that element times a weight, 256 times the
# ulp (scripts/k7_mutant_check.py --kernel k9)
CHAIN_ROW_RTOL = 1e-3
# the grouped GEMMs K5 and K7 form the same exact f32 products as their
# plain versions on the tensor cores (K5 rounds each weight to bf16 once, as
# its plain version does), only summed in another order: each row within
# 1e-4 of the row's max |ref| (rows of about 1e4 for K7's unscaled codes,
# about 1 for K5); a row of zeros must be exactly 0. 2e-2 of the global max
# passes a kernel that drops one product of one row
# (scripts/k7_mutant_check.py [--kernel k5])
GROUPED_ROW_RTOL = 1e-4
DSV4_CHAIN_PAIR = ((300, 32), (500, 32))  # the chain-switch runs' traffic

# phases 2a-2b: the bf16 weight streams (S2, S1). The limits of their checks
# are the studies' (gemv_stream_study.check: stream_sum to 1e-5 of sqrt(N K)
# max |W|, a GEMV to 1e-5 of max |y|; gemv_chain_study.check for the chain).
CHAIN_L, CHAIN_N, CHAIN_K = 36, 19456, 2560  # Qwen3-4B's gate_up, 36 layers
# the GEMV kernels whose byte bound the measured read ceiling restates
MEASURED_BOUND_KERNELS = ("moe_fp4_gemv", "fp8_gemv", "moe_int8_gemv", "moe_int8_chain",
                          "moe_fp4_chain", "expert_gemv_convert", "expert_gemv_native",
                          "expert_gemv_in_flight", "fp4_variant_floor", "fp4_variant_bits_noscale",
                          "fp4_variant_bits", "fp4_variant_arith")
INT8_OPS = 1979e12  # H100 SXM dense int8 (NVIDIA data sheet)


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
    """Mean device time of one call ``fn(i)``, by CUDA events over ``iters``
    calls, a device sleep ahead of the start event hiding the host's
    enqueue (``pegainfer_tpu_torch/studies/timing.py::device_ms``). Keep a
    window to a few hundred launches: more than the device's queue of
    pending launches would block the host until the sleep ends."""
    from pegainfer_tpu_torch.studies.timing import device_ms

    return device_ms(fn, iters, warmup)


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


def row_err(out, ref, dims, tol, rtol):
    """max |diff| of a kernel to its plain version and the worst row's share
    of its limit, min(tol, rtol x the row's max |ref|), a row's values
    spanning ``dims``. A row whose limit is 0 must be exactly 0."""
    d = (out.float() - ref.float()).abs().amax(dim=dims)
    lim = torch.clamp(rtol * ref.float().abs().amax(dim=dims), max=tol)
    share = torch.where(d > 0, d / lim, torch.zeros_like(d))  # d > 0 at lim 0: inf
    return d.max().item(), share.max().item()


def decode_err(out, ref):
    """K1's error: each row (request) against min(DECODE_TOL, DECODE_RTOL x
    its max |ref|); a dead row must be exactly 0."""
    return row_err(out, ref, (1, 2), DECODE_TOL, DECODE_RTOL)


def prefill_err(out, ref):
    """K2's error: each query row (position, head) against min(PREFILL_TOL,
    PREFILL_RTOL x its max |ref|)."""
    return row_err(out, ref, 2, PREFILL_TOL, PREFILL_RTOL)


def grouped_err(out, ref):
    """K5's and K7's error: each row against GROUPED_ROW_RTOL x its max
    |ref| (no cap)."""
    return row_err(out, ref, 1, float("inf"), GROUPED_ROW_RTOL)


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
        # long contexts (many pages a split), a row shorter than one split
        # beside a long one, and 64 rows (one split, no merge)
        ("B=2 ctx 8192 + dead row, pool + layer_id + cur", [8192, 0], "pool_cur"),
        ("B=1 ctx 16384, per-layer pages", [16384], "layer"),
        ("B=3 {40, 3000} + dead row, pool + layer_id + cur", [40, 3000, 0], "pool_cur"),
        ("B=64 ragged + dead row, pool + layer_id + cur",
         [(37 * i) % 900 + 1 for i in range(63)] + [0], "pool_cur"),
    ]
    for name, seq_lens, form in decode_cases:
        a = decode_case(gen, cfg, seq_lens, form)
        out = pd.paged_attention_decode(**a)
        torch.cuda.synchronize()
        ref = pd.paged_attention_decode_plain(**a)
        err, share = decode_err(out, ref)
        dead = [b for b, s in enumerate(seq_lens) if s == 0]
        dead_ok = all(out[b].abs().max().item() == 0.0 for b in dead)
        ok = share <= 1.0 and dead_ok and bool(torch.isfinite(out).all())
        log(f"  K1 paged_decode  {name}: max_abs_err {err:.3e}, worst row at {share:.3f} of "
            f"its limit min({DECODE_TOL}, {DECODE_RTOL} x max |ref|)"
            f"{' dead row 0' if dead else ''} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("paged decode kernel disagrees with its plain version")
        errs["paged_decode"] = max(errs["paged_decode"], err)

    # (name, T, S, kv_valid, q_offset, Hq, Hkv, hd)
    prefill_cases = [
        ("T=S=1024", 1024, 1024, 1024, 0, Hq, Hkv, hd),
        ("T=S=1000 (not a multiple of the query tile)", 1000, 1000, 1000, 0, Hq, Hkv, hd),
        ("chunk continuation T=256 at q_offset 768, S=1024", 256, 1024, 1024, 768, Hq, Hkv, hd),
        ("chunk T=256 at q_offset 768, kv_valid 1000 < S=1280", 256, 1280, 1000, 768, Hq, Hkv,
         hd),
        ("T=S=4096", 4096, 4096, 4096, 0, Hq, Hkv, hd),
        # the end of a 32k context: there a dropped key tile stays under 2e-2
        ("chunk T=64 at q_offset 32704, S=32768", 64, 32768, 32768, 32704, Hq, Hkv, hd),
    ] + [(f"T=S={T}, Hq {hq}, Hkv {hkv}, hd {d}", T, T, T, 0, hq, hkv, d)
         for T, hq, hkv, d in K2_SHAPES[1:]]
    for name, T, S, kv_valid, q_offset, hq, hkv, d in prefill_cases:
        q = torch.randn((T, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((S, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((S, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
        out = fp.flash_attention(q, k, v, kv_valid, q_offset, d ** -0.5)
        torch.cuda.synchronize()
        ref = fp.att.causal_attention(q, k, v, kv_valid, q_offset, d ** -0.5)
        live = min(T, kv_valid - q_offset)
        err, share = prefill_err(out[:live], ref[:live])
        ok = share <= 1.0 and bool(torch.isfinite(out[:live]).all())
        log(f"  K2 flash_prefill {name}: max_abs_err {err:.3e}, worst row at {share:.3f} of its "
            f"limit min({PREFILL_TOL}, {PREFILL_RTOL} x max |ref|) {'ok' if ok else 'FAIL'}")
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
    from pegainfer_tpu_torch.ops.cuda import build

    t_start = time.perf_counter()
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    build.load("paged_decode")  # builds every source, in parallel
    log(f"[2] kernels built and loaded in {time.perf_counter() - t:.1f} s")
    for name, text in build.build_logs.items():
        log(f"  --- ptxas: {name} ---")
        for line in text.splitlines():
            if "spill" in line or ("ptxas" in line and ("registers" in line
                                                        or "Compiling entry" in line)):
                log("  " + line.strip())

    s_records, read_ceiling, s_extra, layer_err = run_streams()
    ceiling = read_ceiling["bytes_per_s"]
    c_records, c_extra = run_chain(layer_err)
    gc.collect()
    torch.cuda.empty_cache()
    e_records, e_extra = run_expert_stream()
    gc.collect()
    torch.cuda.empty_cache()
    f_records, f_extra = run_fp4_study()
    gc.collect()
    torch.cuda.empty_cache()

    q_records, q_serving, q_steps = run_qwen3()
    # the Qwen3 engine, weights and KV pool are gone with run_qwen3's frame
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  Qwen3 freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    cfg, params, d_records, d_serving, d_steps = run_dsv4()
    k9_record, chain_serving = run_dsv4_fp4_chain(cfg, params)
    i_records, i_serving, i_steps = run_dsv4_int8(cfg, params, k9_record)
    records = s_records + c_records + e_records + f_records + q_records + d_records + i_records
    for r in records:
        if r["name"] in MEASURED_BOUND_KERNELS:
            # the same bytes over the measured ceiling (every one is bound by bytes)
            r["measured_bound_ms"] = (r["bound_ms"] * HBM_BYTES_PER_S / ceiling
                                      if r["bound_by"] == "bytes" else None)
            for sub in r.get("shapes", {}).values():  # K4's shapes of a decode step
                sub["measured_bound_ms"] = sub["bound_ms"] * HBM_BYTES_PER_S / ceiling
            if "step_bound_ms" in r:
                r["step_measured_bound_ms"] = r["step_bound_ms"] * HBM_BYTES_PER_S / ceiling
                log(f"  {r['name']} over a decode step: {r['step_ms'] * 1e3:.2f} us, "
                    f"{r['step_measured_bound_ms'] / r['step_ms']:.1%} of its bound at the "
                    "measured read ceiling")
            log(f"  {r['name']}: {r['ms'] * 1e3:.2f} us, {r['bound_ms'] / r['ms']:.1%} of its "
                f"nominal bound, {r['bound_ms'] * HBM_BYTES_PER_S / ceiling / r['ms']:.1%} of "
                "its bound at the measured read ceiling")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records, "read_ceiling_bytes_per_s": ceiling,
                      "read_ceiling": read_ceiling, "weight_streams": s_extra, "gemv_chain": c_extra,
                      "expert_stream": e_extra, "fp4_study": f_extra,
                      "serving": q_serving, "steps": q_steps,
                      "dsv4": {"serving": d_serving, "steps": d_steps},
                      "dsv4_fp4_chain": {"serving": chain_serving},
                      "dsv4_int8": {"serving": i_serving, "steps": i_steps}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ── phases 2a-2b: the bf16 weight streams ──────────────────────────────


def stream_err(label, got, ref, limit):
    err = (got - ref).abs().max().item()
    log(f"  {label}: max |diff| {err:.3e} of {limit:.3e} "
        f"{'ok' if err <= limit else 'FAIL'}")
    if not err <= limit:
        raise SystemExit(f"{label}: the kernel disagrees with its plain version")
    return err


def run_streams():
    """Phase 2a: stream_sum (both forms), gemv and layer_gemv against their
    plain versions (gemv_stream_study.check); then the study's sweep on the
    three shapes (the main path, counted) and the wrappers' defaults timed.
    Returns (records, the read ceiling, the sweep's best per shape,
    layer_gemv's largest error)."""
    from pegainfer_tpu_torch.ops.cuda import gemv_stream as gs
    from pegainfer_tpu_torch.studies import gemv_stream_study as study

    # the plain versions' f32 products in true f32, not TF32 (torch's
    # default already; set so that the oracle is never looser than the kernel)
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[2a] bf16 weight streams (S2: stream_sum, gemv; S1a: layer_gemv) against their "
        "plain versions")
    saved = dict(gs.launches)
    rows = study.check(seed=SEED + 11)
    gs.launches.update(saved)
    errs = {k: 0.0 for k in gs.launches}
    for name, err, lim in rows:
        log(f"  {name}: max |diff| {err:.3e} of {lim:.3e} {'ok' if err <= lim else 'FAIL'}")
        kernel = name.split()[0]
        errs[kernel] = max(errs[kernel], err)
    if not all(err <= lim for _, err, lim in rows):
        raise SystemExit("a weight-stream kernel disagrees with its plain version")

    for k in gs.launches:
        gs.launches[k] = 0
    log(f"  sweep (pegainfer_tpu_torch/studies/gemv_stream_study.py): defaults {gs.RING}, "
        f"{gs.LDG}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    results = []
    for N, K in study.SHAPES:
        W = (torch.randn((N, K), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
        x = (torch.randn((1, K), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
        s = torch.zeros((1, 1), device="cuda")
        log(f"  W [{N}, {K}] = {N * K * 2 / 1e6:.1f} MB over {study.copies_for(N * K * 2)} "
            "copies")
        results.append(study.study_shape(W, x, s))
        if (N, K) == study.SHAPES[0]:  # the records: gate_up, the defaults
            records = stream_records(gs, study, W, x, s, errs, results[-1])
        del W
        torch.cuda.empty_cache()
    for r in records:
        r["launches"] = gs.launches[r["name"]]
    ceiling = study.read_ceiling(results)
    log(f"  read ceiling {ceiling['bytes_per_s'] / 1e12:.4f} TB/s ({ceiling['kind']} "
        f"{ceiling['cfg']} at [{ceiling['N']}, {ceiling['K']}], median of {ceiling['retimes']} "
        f"re-timings, range {ceiling['min_bytes_per_s'] / 1e12:.4f}-"
        f"{ceiling['max_bytes_per_s'] / 1e12:.4f}), "
        f"{ceiling['bytes_per_s'] / HBM_BYTES_PER_S:.1%} of {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
        f"launches {gs.launches}")
    log_records(records)
    for r in records:
        if r["launches"] < 1:
            raise SystemExit(f"{r['name']} was not launched on its path")
    return records, ceiling, [{"N": r["N"], "K": r["K"], "copies": r["copies"],
                               "best": r["best"], "library_call": r["library_call"]}
                              for r in results], errs["layer_gemv"]


def stream_records(gs, study, W, x, s, errs, res):
    """Records of stream_sum (bulk, ldg) and gemv at the gate_up shape with
    the wrappers' defaults, W rotated over copies beyond 2 x L2; the plain
    versions; the library calls from the sweep's rows."""
    N, K = W.shape
    n = study.copies_for(N * K * 2)
    ws = [W] + [W.clone() for _ in range(n - 1)]
    lib = {r["kind"]: r for r in res["rows"] if r["kind"].startswith("torch")}
    src = "pegainfer_tpu_torch/csrc/gemv_stream.cu"
    out = []
    for name, fn, plain, nbytes, flops, replaces, lib_kind in (
            ("stream_sum_bulk", lambda i: gs.stream_sum(ws[i % n], s, "bulk"),
             lambda i: gs.stream_sum_plain(ws[i % n], s), N * K * 2 + 8, N * K,
             "scripts/gemv_stream_study.py:41", "torch.sum"),
            ("stream_sum_ldg", lambda i: gs.stream_sum(ws[i % n], s, "ldg"),
             lambda i: gs.stream_sum_plain(ws[i % n], s), N * K * 2 + 8, N * K,
             "scripts/gemv_stream_study.py:41", "torch.sum"),
            ("gemv", lambda i: gs.gemv(x, ws[i % n], s),
             lambda i: gs.gemv_plain(x, ws[i % n], s), N * K * 2 + K * 2 + 4 + N * 4,
             2 * N * K, "scripts/gemv_stream_study.py:90", "torch gemv [N,K]")):
        b, by = bound(nbytes, flops)
        out.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                    "launches": None, "max_abs_err": errs[name], "ms": time_ms(fn, 100),
                    "plain_ms": time_ms(plain, 10), "bound_ms": b, "bound_by": by,
                    "library_ms": lib[lib_kind]["ms"],
                    "library_call": f"{lib_kind} {lib[lib_kind]['cfg']}", "shape": [N, K]})
    out[-1]["library_kn_ms"] = lib["torch gemv [K,N]"]["ms"]
    return out


def run_chain(layer_err):
    """Phase 2b: gemv_chain against its plain chain (gemv_chain_study.check:
    L 1, every layer of 36 on the kernel's own x, whole chains of 2 and 36;
    the same for a square chain of 4 layers, whose x needs every block),
    then the study's five chain forms (the main path, counted); layer_gemv
    timed at the chain's shape. Returns (layer_gemv and gemv_chain records,
    the forms)."""
    from pegainfer_tpu_torch.ops.cuda import gemv_chain as gc
    from pegainfer_tpu_torch.ops.cuda import gemv_stream as gs
    from pegainfer_tpu_torch.studies import gemv_chain_study as study
    from pegainfer_tpu_torch.studies.gemv_stream_study import LIBRARY_GEMV, library_gemv

    log(f"[2b] the persistent GEMV chain (S1b) against its plain chain, L {CHAIN_L}, "
        f"N {CHAIN_N}, K {CHAIN_K}")
    x, stack = study.card_inputs(CHAIN_L, CHAIN_N, CHAIN_K, seed=SEED)
    saved = gc.launches
    rows = study.check(x, stack)
    gc.launches = saved
    for name, err, lim in rows:
        if not name.startswith("layer") or not err <= lim:
            log(f"  {name}: max |diff| {err:.3e} of {lim:.3e} {'ok' if err <= lim else 'FAIL'}")
    worst = max(rows[1:CHAIN_L], key=lambda r: r[1] / r[2])
    log(f"  layers 1-{CHAIN_L - 1} on the kernel's own x: worst {worst[0]} at "
        f"{worst[1] / worst[2]:.3f} of its limit")
    if not all(err <= lim for _, err, lim in rows):
        raise SystemExit("gemv_chain disagrees with its plain chain")

    gc.launches = 0
    gs.launches["layer_gemv"] = 0
    log("  the five chain forms (pegainfer_tpu_torch/studies/gemv_chain_study.py):")
    forms = study.time_forms(x, stack)
    L = CHAIN_L
    layer_ms = time_ms(lambda i: gs.layer_gemv(x, stack, i % L), 100)
    launches = {"layer_gemv": gs.launches["layer_gemv"], "gemv_chain": gc.launches}
    log(f"  launches {launches}")
    if min(launches.values()) < 1:
        raise SystemExit(f"a chain kernel was not launched on its path: {launches}")
    nbytes = CHAIN_N * CHAIN_K * 2
    lb, lby = bound(nbytes + CHAIN_K * 2 + CHAIN_N * 4, 2 * CHAIN_N * CHAIN_K)
    cb, cby = bound(L * nbytes + CHAIN_K * 2 + CHAIN_N * 4, 2 * L * CHAIN_N * CHAIN_K)
    records = [
        {"name": "layer_gemv", "route": "cuda", "source": "pegainfer_tpu_torch/csrc/gemv_stream.cu",
         "replaces": "scripts/gemv_chain_study.py:41", "launches": launches["layer_gemv"],
         "max_abs_err": layer_err, "ms": layer_ms,
         "plain_ms": time_ms(lambda i: gs.layer_gemv_plain(x, stack, i % L), 10),
         "bound_ms": lb, "bound_by": lby,
         "library_ms": time_ms(lambda i: library_gemv(x, stack[i % L].T), 100),
         "library_call": LIBRARY_GEMV},
        {"name": "gemv_chain", "route": "cuda", "source": "pegainfer_tpu_torch/csrc/gemv_chain.cu",
         "replaces": "scripts/gemv_chain_study.py:96", "launches": launches["gemv_chain"],
         "max_abs_err": max(err for _, err, _ in rows), "ms": forms["gemv_chain"]["device_ms"],
         "plain_ms": time_ms(lambda i: gc.gemv_chain_plain(x, stack), 2),
         "bound_ms": cb, "bound_by": cby, "library_ms": None,
         "library_call": "none (no one call); the chain forms beside it"},
    ]
    log_records(records)
    return records, {"checks": rows, "forms": forms}


# ── phases 2c-2d: the int8 expert stream and the fp4 decode variants ────


def log_checks(rows, label):
    """Log a study's check rows; fail if one is over its limit. Returns the
    largest error of each kernel (the first word of a row's name)."""
    errs = {}
    for name, err, lim in rows:
        log(f"  {name}: max |diff| {err:.3e} of {lim:.3e} {'ok' if err <= lim else 'FAIL'}")
        kernel = name.split()[0]
        errs[kernel] = max(errs.get(kernel, 0.0), err)
    if not all(err <= lim for _, err, lim in rows):
        raise SystemExit(f"a {label} kernel disagrees with its plain version")
    return errs


def check_launched(launches, label):
    log(f"  launches {launches}")
    if min(launches.values()) < 1:
        raise SystemExit(f"a {label} kernel was not launched on its path: {launches}")


def run_expert_stream():
    """Phase 2c: expert_gemv (both forms) and expert_gemv_in_flight against
    their plain versions (expert_stream_study.check) on q int8 [256, 2048,
    4096] made on the card; then the study's forms timed (the main path,
    counted), K6 and torch's bmm beside them. Records at rows 32 (the
    wrapper's default), bounds over the distinct experts of the timed calls.
    Returns (records, the study's table)."""
    from pegainfer_tpu_torch.ops.cuda import expert_stream as es
    from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
    from pegainfer_tpu_torch.studies import expert_stream_study as study

    t0 = time.perf_counter()
    E, I, D, M = study.E, study.I, study.D, study.M
    log(f"[2c] int8 expert stream (S3: expert_gemv convert / native, expert_gemv_in_flight) "
        f"against its plain versions, q int8 [{E}, {I}, {D}]")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    q = torch.randint(-127, 128, (E, I, D), generator=gen, dtype=torch.int8, device="cuda")
    saved = dict(es.launches)
    errs = log_checks(study.check(q=q, seed=SEED + 14), "expert-stream")
    es.launches.update(saved)

    x8 = torch.randint(-127, 128, (M, D), generator=gen, dtype=torch.int8, device="cuda")
    idx_all = torch.randint(0, E, (study.ITERS, M), generator=gen, device="cuda").int()
    for k in es.launches:
        es.launches[k] = 0
    k6_saved = k6.launches
    log("  forms (pegainfer_tpu_torch/studies/expert_stream_study.py):")
    res = study.study(q, x8, idx_all)
    k6.launches = k6_saved
    launches = dict(es.launches)
    check_launched(launches, "expert-stream")
    by = {r["form"]: r for r in res["table"]}
    xb = x8.to(torch.bfloat16)
    n = study.ITERS
    plain = {"expert_gemv_convert": lambda i: es.expert_gemv_plain(xb, q, idx_all[i % n]),
             "expert_gemv_native": lambda i: es.expert_gemv_plain(x8, q, idx_all[i % n], True)}
    plain["expert_gemv_in_flight"] = plain["expert_gemv_convert"]
    distinct = res["distinct_bytes"]
    src = "pegainfer_tpu_torch/csrc/expert_stream.cu"
    records = []
    for name, form, replaces, peak in (
            ("expert_gemv_convert", "convert rows 32", "scripts/expert_stream_study.py:123",
             BF16_FLOPS),
            ("expert_gemv_native", "native rows 32", "scripts/expert_stream_study.py:123",
             INT8_OPS),
            ("expert_gemv_in_flight", "in flight", "scripts/expert_stream_study.py:155",
             BF16_FLOPS)):
        x_bytes = M * D * (1 if name == "expert_gemv_native" else 2)
        nbytes = distinct + x_bytes + M * 4 + M * I * 4
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * M * I * D / peak * 1e3
        records.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": by[form]["ms"],
            "plain_ms": time_ms(plain[name], 10), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": by[study.LIBRARY_CALL]["ms"], "library_call": study.LIBRARY_CALL,
            "library_gather_ms": by[study.GATHER_CALL]["ms"], "form": form,
            **res["bytes_in_flight"][form]})
    log_records(records)
    log(f"  [2c] took {time.perf_counter() - t0:.1f} s")
    del q
    return records, res


def run_fp4_study():
    """Phase 2d: fp4_variant_gemv in its four variants and three tiles
    against their plain versions (fp4_kernel_study.check) on q uint8 [256,
    2048, 2048] and bf16 scales made on the card, bits and arith weight for
    weight; the scale loads of floor and bits_noscale in the SASS; then the
    sweep (the main path, counted) beside K3 and its bmm. Records at rows 32
    (the wrapper's default), bounds over the distinct experts of the timed
    calls. Returns (records, the sweep's table, decode's cost, the SASS
    counts)."""
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
    from pegainfer_tpu_torch.ops.cuda import fp4_study as fs
    from pegainfer_tpu_torch.studies import fp4_kernel_study as study
    from pegainfer_tpu_torch.studies.expert_stream_study import distinct_bytes

    t0 = time.perf_counter()
    E, OUT, IN, M = study.E, study.OUT, study.IN, study.M
    S = IN // study.GROUP
    log(f"[2d] fp4 decode variants (S4: floor, bits_noscale, bits, arith) against their plain "
        f"versions, q uint8 [{E}, {OUT}, {IN // 2}], s bf16 [{E}, {OUT}, {S}]")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    q = torch.randint(0, 256, (E, OUT, IN // 2), generator=gen, dtype=torch.uint8, device="cuda")
    s = study.random_scales(gen, (E, OUT, S), "cuda", pow2=True)
    saved = dict(fs.launches)
    errs = log_checks(study.check(q=q, s=s, seed=SEED + 16), "fp4 decode")
    fs.launches.update(saved)
    loads = study.scale_loads()
    log(f"  16-bit global (scale) loads in the SASS: {loads}")
    if not study.scale_loads_kept(loads):
        raise SystemExit("a floor or bits_noscale kernel lost its scale loads")

    xb = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
    idx_all = torch.randint(0, E, (study.ITERS, M), generator=gen, device="cuda").int()
    for k in fs.launches:
        fs.launches[k] = 0
    k3_saved = k3.launches
    log("  sweep (pegainfer_tpu_torch/studies/fp4_kernel_study.py):")
    table = study.sweep(q, s, xb, idx_all)
    k3.launches = k3_saved
    launches = dict(fs.launches)
    check_launched(launches, "fp4 decode")
    cost = study.decode_cost(table)
    log("  decode above floor (us, by rows): " + json.dumps(
        {k: {r: round(v * 1e3, 3) for r, v in d.items()} for k, d in cost.items()
         if k.endswith("floor")}) + f"; best {cost['best']}; K3 {cost['K3_ms'] * 1e3:.2f} us")
    by = {r["form"]: r for r in table}
    n = study.ITERS
    # each distinct expert's packed codes and scales, x, idx, y
    nbytes = (distinct_bytes(idx_all.cpu().numpy(), OUT, IN // 2 + S * 2)
              + M * IN * 2 + M * 4 + M * OUT * 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * M * OUT * IN / BF16_FLOPS * 1e3
    records = []
    for v in fs.VARIANTS:
        name = f"fp4_variant_{v}"
        records.append({
            "name": name, "route": "cuda", "source": "pegainfer_tpu_torch/csrc/fp4_study.cu",
            "replaces": "scripts/fp4_kernel_study.py:105", "launches": launches[name],
            "max_abs_err": errs[name], "ms": by[f"{v} rows 32"]["ms"],
            "plain_ms": time_ms(
                lambda i, v=v: fs.fp4_variant_gemv_plain(xb, q, s, idx_all[i % n], v), 10),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "library_ms": by[study.LIBRARY_CALL]["ms"],
            "library_call": study.LIBRARY_CALL, "form": f"{v} rows 32",
            "best_rows": cost["best"][v]["rows"], "best_ms": cost["best"][v]["ms"],
            "scale_loads_in_sass": {k: c for k, c in loads.items() if k.split()[0] == v}})
    log_records(records)
    log(f"  [2d] took {time.perf_counter() - t0:.1f} s")
    del q, s
    return records, {"table": table, "decode_cost": cost, "scale_loads": loads}


def run_qwen3():
    """Phases 3-8 on Qwen3-4B. Returns (K1/K2 records, serving, steps)."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.models import qwen3 as q3
    from pegainfer_tpu_torch.models.qwen3_engine import start_engine_from_params
    from pegainfer_tpu_torch.ops import attention as att
    from pegainfer_tpu_torch.ops.cuda import flash_prefill as fp
    from pegainfer_tpu_torch.ops.cuda import paged_decode as pd

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
    del handle, ex  # the executor holds the KV pool

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
    check_logits(lk, lp, LOGITS_RTOL, "kernel-path logits disagree with the "
                 "plain-attention model")
    del kv

    log("[8] timings")
    steps = step_profile(cfg, q3, params, toks_t, int(lk.argmax()))
    tpot = statistics.median(gaps)
    tpot95 = float(np.percentile(gaps, 95))  # 12 of the 255 gaps lie beyond it
    log(f"  main {PROMPT}/{OUT}: TTFT {ttft_ms:.3f} ms, TPOT p50 {tpot:.3f} ms, "
        f"p95 {tpot95:.3f} ms over {len(gaps)} gaps (host clock, per streamed token)")
    log_steps(steps)
    records, k1_shapes, k2_shapes = time_kernels(cfg, pd, fp, att, errs, launches)
    log_records(records)
    serving = {"ttft_ms": ttft_ms, "tpot_p50_ms": tpot, "tpot_p95_ms": tpot95,
               "prompt": PROMPT, "output": OUT, "paged_decode_shapes": k1_shapes,
               "flash_prefill_shapes": k2_shapes}
    return records, serving, steps_json(steps)


def check_logits(lk, lp, rtol, message):
    """max |diff| <= rtol x max |logit| of the plain run, and the argmax
    agrees unless the plain run's top-2 gap is below the diff."""
    diff = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    top2 = torch.topk(lp, 2).values
    gap = (top2[0] - top2[1]).item()
    argmax_same = int(lk.argmax()) == int(lp.argmax())
    log(f"  max |diff| {diff:.4e}, max |logit| {scale:.4e}, tolerance "
        f"{rtol} x max |logit| = {rtol * scale:.4e}; argmax agrees: "
        f"{argmax_same} (plain top-2 gap {gap:.4e})")
    if diff > rtol * scale or (not argmax_same and gap > diff):
        raise SystemExit(message)


def log_steps(steps):
    for name, (wall, dev, n, *_) in steps.items():
        log(f"  {name}: wall {wall:.3f} ms, device time {dev:.3f} ms in {n:.0f} "
            f"kernels and copies (torch.profiler), device idle {1 - dev / wall:.1%}")


def steps_json(steps):
    """A step's times, and its kernels' where the profile picked them out."""
    return {k: {"wall_ms": w, "device_ms": d, "device_ops": n, **(more[0] if more else {})}
            for k, (w, d, n, *more) in steps.items()}


def log_records(records):
    for r in records:
        log(f"  {r['name']}: {r['ms'] * 1e3:.2f} us vs bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']}), plain {r['plain_ms'] * 1e3:.2f} us, library "
            + (f"{r['library_ms'] * 1e3:.2f} us" if r["library_ms"] is not None
               else r.get("library_call", "none")))


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
            walls = []
            for _ in range(iters):
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            wall = statistics.mean(walls)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                    torch.cuda.synchronize()
            ka = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                        key=lambda e: -e.self_device_time_total)
            dev = sum(e.self_device_time_total for e in ka) / iters / 1e3
            out[name] = (wall, dev, sum(e.count for e in ka) / iters)
            attn = sum(e.self_device_time_total for e in ka
                       if "flash_prefill" in e.key or "paged_decode" in e.key) / iters / 1e3
            log(f"    {name}: wall per call {min(walls):.3f}-{max(walls):.3f} ms over {iters} "
                f"calls; attention kernel (K1 / K2) {attn:.3f} ms, {attn / dev:.1%} of device time")
            for e in ka[:TOP_OPS]:
                log(f"    {name}: {e.self_device_time_total / iters / 1e3:7.3f} ms in "
                    f"{e.count / iters:4.0f} x {e.key[:90]}")
    return out


def time_decode(gen, cfg, pd, seq_lens, plain=False):
    """K1 at one shape: rows of contexts ``seq_lens``, each row's last token
    in flight, read from the full 36-layer pool with the layer cycled so the
    pages stay out of L2, as in a decode step; its bound from these inputs;
    with ``plain`` its plain version; and the SDPA yardstick
    (``sdpa_decode_library``)."""
    L, Hq, Hkv, hd = (cfg.num_hidden_layers, cfg.num_attention_heads,
                      cfg.num_key_value_heads, cfg.head_dim)
    a = decode_case(gen, cfg, seq_lens, "pool_cur", layers=L)

    def k1(i):
        a["layer_id"] = i % L
        return pd.paged_attention_decode(**a)

    def k1_plain(i):
        a["layer_id"] = i % L
        pd.paged_attention_decode_plain(**a)

    saved = pd.launches
    out = {"seq_lens": list(seq_lens), "ms": time_ms(k1, 360)}
    if plain:
        out["plain_ms"] = time_ms(k1_plain, 12)
    B = len(seq_lens)
    nbytes = (2 * B * Hq * hd * 2  # q in, out
              + sum(2 * (s - 1) * Hkv * hd * 2 for s in seq_lens)  # live k and v rows
              + 2 * B * Hkv * hd * 2  # cur k, v
              + a["page_tables"].numel() * 4 + B * 4)
    out["bound_ms"], out["bound_by"] = bound(nbytes, sum(2 * 2 * Hq * hd * s for s in seq_lens))
    out["library_ms"], out["library_call"] = sdpa_decode_library(a, L, k1(0))
    pd.launches = saved
    return out


def sdpa_decode_library(a, L, ref):
    """K1's library yardstick: the device time of
    ``torch.nn.functional.scaled_dot_product_attention`` on the
    [B, Hq, 1, hd] queries and one layer's live K / V (paged tokens, then the
    in-flight one), gathered out of the pages into contiguous
    [B, Hkv, ctx, hd] tensors per layer before the timed call, the layer
    cycled as K1's is. ``is_causal`` stays False: with one query row a
    causal mask aligns top-left and leaves that query only the first key.
    Held against K1's output on layer 0 (``ref``) at DECODE_TOL. The call
    takes ``enable_gqa=True``. Where this torch refuses it, or where rows of
    unequal length are masked (a masked call may leave the fused backends),
    the call on K / V whose kv heads are repeated outside the timed call
    (bytes counted in no bound) is timed too; with a mask, so is one
    unmasked call a row on that row's own keys (the B calls timed as one).
    The fastest is the yardstick. Returns (ms, what was called), or (None,
    "none: why")."""
    q, pool, tables, seq_lens = a["q"], a["k_pages"], a["page_tables"], a["seq_lens"]
    B, Hq, hd = q.shape
    Hkv, ps = pool.shape[1], pool.shape[4]
    lens = seq_lens.tolist()
    ctx = max(lens)
    ks, vs = [], []
    for layer in range(L):
        k = torch.zeros((B, Hkv, ctx, hd), dtype=q.dtype, device=q.device)
        v = torch.zeros_like(k)
        for b, n in enumerate(lens):
            pages = pool[layer][:, tables[b, : -(-n // ps)].long()]  # [Hkv, n, 2, ps, hd]
            k[b, :, : n - 1] = pages[:, :, 0].reshape(Hkv, -1, hd)[:, : n - 1]
            v[b, :, : n - 1] = pages[:, :, 1].reshape(Hkv, -1, hd)[:, : n - 1]
            k[b, :, n - 1], v[b, :, n - 1] = a["cur_k"][b], a["cur_v"][b]
        ks.append(k)
        vs.append(v)
    mask = None
    if min(lens) < ctx:
        mask = (torch.arange(ctx, device=q.device)[None, :] < seq_lens[:, None])[:, None, None]
    qh = q[:, :, None, :]
    scale = a["scale"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    got, why = {}, []

    def attempt(name, call, iters):
        """``call(layer)`` returns the outputs of its rows, in order."""
        try:
            y = torch.cat(call(0))
            torch.cuda.synchronize()
        except (RuntimeError, TypeError) as exc:
            log(f"  K1 library: {name} refused ({str(exc).splitlines()[0][:160]})")
            why.append(f"{name} refused")
            return
        err = (y[:, :, 0].float() - ref.float()).abs().max().item()
        if not err <= DECODE_TOL:
            log(f"  K1 library: {name} disagrees with K1 by {err:.4g} (tol {DECODE_TOL})")
            why.append(f"{name} disagrees with K1")
            return
        got[name] = time_ms(lambda i: call(i % L), iters)
        log(f"  K1 library: {name} on contexts {lens}: {got[name] * 1e3:.2f} us "
            f"(max |diff| to K1 {err:.3e}, tol {DECODE_TOL})")

    # a masked call of several launches must still fit time_ms's sleep window
    iters = 360 if mask is None else 32
    masked = " masked" if mask is not None else ""
    attempt(f"scaled_dot_product_attention(enable_gqa=True){masked}",
            lambda l: [sdpa(qh, ks[l], vs[l], attn_mask=mask, scale=scale, enable_gqa=True)],
            iters)
    if mask is not None:
        rows = [[(k[b:b + 1, :, :n].contiguous(), v[b:b + 1, :, :n].contiguous())
                 for b, n in enumerate(lens)] for k, v in zip(ks, vs)]
        attempt("scaled_dot_product_attention(enable_gqa=True), one unmasked call a row",
                lambda l: [sdpa(qh[b:b + 1], kb, vb, scale=scale, enable_gqa=True)
                           for b, (kb, vb) in enumerate(rows[l])], 360 // B)
    if not got or mask is not None:
        G = Hq // Hkv
        kr = [k.repeat_interleave(G, dim=1) for k in ks]
        vr = [v.repeat_interleave(G, dim=1) for v in vs]
        attempt(f"scaled_dot_product_attention (kv heads repeated){masked}",
                lambda l: [sdpa(qh, kr[l], vr[l], attn_mask=mask, scale=scale)], iters)
    if not got:
        return None, "none: " + "; ".join(why)
    name = min(got, key=got.get)
    return got[name], name


def time_prefill(gen, fp, att, T, Hq, Hkv, hd, plain=False):
    """K2 on one whole prompt of T tokens at these heads: its time, its bound
    from these inputs, with ``plain`` its plain version's time, and the SDPA
    yardstick (``sdpa_prefill_library``)."""
    q = torch.randn((T, Hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((T, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((T, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    scale = hd ** -0.5
    saved = fp.launches
    out = {"T": T, "Hq": Hq, "Hkv": Hkv, "hd": hd,
           "ms": time_ms(lambda i: fp.flash_prefill(q, k, v, T, scale), 100)}
    ref = fp.flash_prefill(q, k, v, T, scale)
    fp.launches = saved
    if plain:
        out["plain_ms"] = time_ms(lambda i: att.prefill_attention(q, k, v, T, scale), 10)
    nbytes = (2 * T * Hq * hd + 2 * T * Hkv * hd) * 2
    out["bound_ms"], out["bound_by"] = bound(nbytes, 2 * 2 * Hq * hd * (T * (T + 1) // 2))
    out["library_ms"], out["library_call"] = sdpa_prefill_library(q, k, v, scale, ref)
    return out


def sdpa_prefill_library(q, k, v, scale, ref):
    """K2's library yardstick: ``scaled_dot_product_attention(is_causal=True)``
    on [1, H, T, hd] copies made outside the timed call, once with
    ``enable_gqa=True`` on the Hkv heads and once on kv heads repeated to Hq
    (bytes counted in no bound), each held against K2's output ``ref`` at
    K2's row limit. The faster is the yardstick. Returns (ms, what was
    called), or (None, "none: why")."""
    T, Hq, hd = q.shape
    G = Hq // k.shape[1]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (x.transpose(0, 1).unsqueeze(0).contiguous() for x in (q, k, v))
    kr, vr = (x.repeat_interleave(G, dim=1) for x in (kh, vh))
    calls = {
        "scaled_dot_product_attention(is_causal=True, enable_gqa=True)":
            lambda i: sdpa(qh, kh, vh, is_causal=True, scale=scale, enable_gqa=True),
        "scaled_dot_product_attention(is_causal=True), kv heads repeated":
            lambda i: sdpa(qh, kr, vr, is_causal=True, scale=scale),
    }
    got, why = {}, []
    for name, call in calls.items():
        try:
            y = call(0)[0].transpose(0, 1)
            torch.cuda.synchronize()
        except (RuntimeError, TypeError) as exc:
            log(f"  K2 library: {name} refused ({str(exc).splitlines()[0][:160]})")
            why.append(f"{name} refused")
            continue
        err, share = prefill_err(y, ref)
        if not share <= 1.0:
            log(f"  K2 library: {name} disagrees with K2 (worst row at {share:.3f} of its limit)")
            why.append(f"{name} disagrees with K2")
            continue
        got[name] = time_ms(call, 100)
        log(f"  K2 library: {name} at T={T}, Hq {Hq}, hd {hd}: {got[name] * 1e3:.2f} us "
            f"(max |diff| to K2 {err:.3e}, worst row at {share:.3f} of K2's limit)")
    if not got:
        return None, "none: " + "; ".join(why)
    name = min(got, key=got.get)
    return got[name], name


def k2_host_cost(fp, T, Hq, Hkv, hd, iters=200):
    """Host time of K2's launch path at one shape: one cuTensorMapEncodeTiled
    of its Q map through libcuda by ctypes (less an empty driver call, the
    ctypes cost), and one whole wrapper call (plan, four encodes, launch),
    enqueued behind a device sleep. Means over ``iters`` calls, host clock."""
    import ctypes

    from pegainfer_tpu_torch.studies.timing import SLEEP_CYCLES
    q = torch.zeros((T, Hq, hd), dtype=torch.bfloat16, device="cuda")
    k = torch.zeros((T, Hkv, hd), dtype=torch.bfloat16, device="cuda")
    G = Hq // Hkv
    cuda = ctypes.CDLL("libcuda.so.1")
    buf = ctypes.create_string_buffer(128 + 64)
    args = (ctypes.c_void_p((ctypes.addressof(buf) + 63) & ~63),
            ctypes.c_int(9), ctypes.c_uint32(3), ctypes.c_void_p(q.data_ptr()),  # bf16, 3-D
            (ctypes.c_uint64 * 3)(hd, Hq, T), (ctypes.c_uint64 * 2)(hd * 2, Hq * hd * 2),
            (ctypes.c_uint32 * 3)(64, G, 128 // G), (ctypes.c_uint32 * 3)(1, 1, 1),
            ctypes.c_int(0), ctypes.c_int(3), ctypes.c_int(3), ctypes.c_int(0))  # SW128, L2 256B
    version = ctypes.c_int()

    def per_call_us(fn):
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) / iters * 1e6

    if cuda.cuTensorMapEncodeTiled(*args) != 0:
        raise SystemExit("cuTensorMapEncodeTiled refused K2's Q map")
    encode = per_call_us(lambda: cuda.cuTensorMapEncodeTiled(*args))
    empty = per_call_us(lambda: cuda.cuDriverGetVersion(ctypes.byref(version)))
    saved = fp.launches
    fp.flash_prefill(q, k, k, T, hd ** -0.5)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    call = per_call_us(lambda: fp.flash_prefill(q, k, k, T, hd ** -0.5))
    torch.cuda.synchronize()
    fp.launches = saved
    log(f"  K2 host cost: cuTensorMapEncodeTiled {encode:.2f} us a call by ctypes (an empty "
        f"driver call {empty:.2f} us), the whole wrapper {call:.2f} us a call")
    return {"encode_us": encode, "empty_driver_call_us": empty, "wrapper_call_us": call}


def time_kernels(cfg, pd, fp, att, errs, launches):
    """Each kernel at the main path's shape, its bound from these inputs,
    its plain version and one library call on the same inputs; K1 also at
    K1_SHAPES, K2 also at K2_SHAPES (and its host cost in its record).
    Returns (records, K1 at K1_SHAPES, K2 at K2_SHAPES)."""
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # K1: B = 1 in mid-decode (context 1152 = 1024 + 128), full pool with
    # layer_id and the in-flight token as the main path calls it
    k1 = time_decode(gen, cfg, pd, [PROMPT + OUT // 2], plain=True)
    shapes = [time_decode(gen, cfg, pd, s) for s in K1_SHAPES]
    for r in shapes:
        log(f"  paged_decode at contexts {r['seq_lens']}: {r['ms'] * 1e3:.2f} us vs bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), library "
            + (f"{r['library_ms'] * 1e3:.2f} us" if r["library_ms"] is not None
               else r["library_call"]))
    torch.cuda.empty_cache()

    # K2: the whole 1024-token prompt, then K2_SHAPES
    k2 = time_prefill(gen, fp, att, PROMPT, Hq, Hkv, hd, plain=True)
    k2_shapes = [time_prefill(gen, fp, att, *shape) for shape in K2_SHAPES]
    for r in k2_shapes:
        log(f"  flash_prefill at T=S={r['T']}, Hq {r['Hq']}, Hkv {r['Hkv']}, hd {r['hd']}: "
            f"{r['ms'] * 1e3:.2f} us vs bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
            "library " + (f"{r['library_ms'] * 1e3:.2f} us" if r["library_ms"] is not None
                          else r["library_call"]))
    return [
        {"name": "paged_decode", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/paged_decode.cu",
         "replaces": "pegainfer_tpu/ops/pallas/paged_decode.py:248",
         "launches": launches["paged_decode"], "max_abs_err": errs["paged_decode"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
         "library_call": k1["library_call"]},
        {"name": "flash_prefill", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/flash_prefill.cu",
         "replaces": "pegainfer_tpu/ops/pallas/flash_prefill.py:114",
         "launches": launches["flash_prefill"], "max_abs_err": errs["flash_prefill"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
         "library_call": k2["library_call"], "host": k2_host_cost(fp, PROMPT, Hq, Hkv, hd)},
    ], shapes, k2_shapes


# ── DeepSeek-V4-Flash, 8 layers, resident fp8 / fp4 weights ────────────


def dsv4_flash_config(d4):
    """DeepSeek-V4-Flash at its published widths (huggingface.co/deepseek-ai/
    DeepSeek-V4-Flash config.json, as scripts/dsv4_flagship_probe.py sets
    them: hidden 4096, 64 heads of 512, q-LoRA 1024, o-LoRA 8 x 1024, rope
    64, window 128, 256 routed experts top-6 of width 2048, indexer 64 x 128
    top-512, vocab 129,280, 3 hash layers), cut to its first 8 layers; their
    compress ratios [0, 0, 4, 128, 4, 128, 4, 128] cover every attention
    class and both gates."""
    return d4.DSv4Config(
        vocab_size=129280, dim=4096, moe_inter_dim=2048, n_layers=DSV4_LAYERS,
        num_attention_heads=64, head_dim=512, q_lora_rank=1024, qk_rope_head_dim=64,
        o_groups=8, o_lora_rank=1024, sliding_window=128, n_routed_experts=256,
        n_shared_experts=1, n_activated_experts=6, n_hash_layers=3,
        routed_scaling_factor=1.5, swiglu_limit=7.0, rms_norm_eps=1e-6,
        index_n_heads=64, index_head_dim=128, index_topk=512,
        max_position_embeddings=1048576, rope_theta=10000.0, compress_rope_theta=10000.0,
        compress_ratios=(0, 0, 4, 128, 4, 128, 4, 128), yarn_original_seq_len=65536,
        yarn_factor=16.0)


def fp8_per_decode_step(cfg):
    """K4 launches in one decode step: 7 fp8 linears a layer (wq_a, wq_b,
    wkv, wo_b, shared w1 / w3 / w2) and idx_wq_b on the ratio-4 layers."""
    return sum(7 + (r == 4) for r in cfg.compress_ratios)


def run_dsv4():
    """Phases 9-13 on DeepSeek-V4-Flash. Returns (cfg, the fp4 params, K3-K5
    records, serving, steps)."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.models import dsv4 as d4
    from pegainfer_tpu_torch.models import dsv4_engine as d4e
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
    from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
    from pegainfer_tpu_torch.ops.cuda import fp8_gemv as k4

    cfg = dsv4_flash_config(d4)
    log(f"[9] DeepSeek-V4-Flash, {cfg.n_layers} layers at full width, random resident "
        f"fp8 / fp4 weights (seed {SEED})")
    t = time.perf_counter()
    params = d4.init_random_resident_device(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    log(f"  weights: {d4.params_bytes(params) / 1e9:.2f} GB in "
        f"{time.perf_counter() - t:.1f} s")

    log("[10] K3, K4, K5 against their plain versions on the model's weights")
    errs = check_quant_kernels(cfg, params, k3, k4, k5)

    log(f"[11] serving through dsv4_engine.start_engine_from_params "
        f"({DSV4_SLOTS} slots, max_model_len {DSV4_MAX_MODEL_LEN})")
    kernels = {"moe_fp4_gemv": k3, "fp8_gemv": k4, "moe_fp4_grouped": k5}
    run = serve_dsv4(cfg, contract, dsv4_engine(cfg, contract, d4e, params), kernels)
    launches, prefills, decode_steps = run["launches"], run["prefills"], run["decode_steps"]
    main_prompt, ttft_ms, gaps = run["main_prompt"], run["ttft_ms"], run["gaps"]
    log("[12] all requests Finished with their token counts; " + check_slot_events(
        run["events"], third_waits=True))
    L = cfg.n_layers
    want = {"moe_fp4_gemv": 3 * L * decode_steps,
            "fp8_gemv": fp8_per_decode_step(cfg) * decode_steps,
            "moe_fp4_grouped": 3 * L * prefills}
    log(f"  launches {launches}; expected {want} ({prefills} prefills, {decode_steps} "
        f"decode steps, {L} layers, {fp8_per_decode_step(cfg)} fp8 linears a step)")
    if launches != want:
        raise SystemExit("DSv4 kernel launch counts do not match the path")

    log(f"  {DSV4_PROMPT}-token prefill and one decode step: kernels vs plain versions, "
        f"the kernel run routed as the plain run")
    toks_t = torch.tensor(main_prompt, dtype=torch.int32, device="cuda")
    state_k, step = check_dsv4_logits(cfg, d4, d4e, params, toks_t)

    log("[13] DSv4 timings")
    steps = dsv4_step_profile(cfg, d4, params, toks_t, state_k, step)
    tpot = statistics.median(gaps)
    tpot95 = float(np.percentile(gaps, 95))
    log(f"  main {DSV4_PROMPT}/{DSV4_OUT}: TTFT {ttft_ms:.3f} ms, TPOT p50 {tpot:.3f} ms, "
        f"p95 {tpot95:.3f} ms over {len(gaps)} gaps (host clock, per streamed token)")
    log_steps(steps)
    records = time_quant_kernels(cfg, params, k3, k4, k5, errs, launches)
    log_records(records)
    serving = {"ttft_ms": ttft_ms, "tpot_p50_ms": tpot, "tpot_p95_ms": tpot95,
               "prompt": DSV4_PROMPT, "output": DSV4_OUT}
    return cfg, params, records, serving, steps_json(steps)


def check_dsv4_logits(cfg, d4, d4e, params, toks_t, prefill=True, moe_chain=None,
                      label=""):
    """The prompt's last prefill logits (with ``prefill``) and one decode
    step after it from the plain prefill's caches, with the kernels against
    ``plain_kernels=True``, the kernel run routed as the plain run (rule of
    phase 7, DSV4_LOGITS_RTOL). Returns the kernel run's state and the
    step's inputs."""
    blocks = d4e.max_blocks_for(cfg, DSV4_MAX_MODEL_LEN)
    state_k = d4.make_state(cfg, 1, blocks, dtype=torch.bfloat16, device="cuda")
    state_p = d4.make_state(cfg, 1, blocks, dtype=torch.bfloat16, device="cuda")
    replay = RoutingReplay(d4)
    kw = dict(moe_chain=moe_chain)
    try:
        with torch.no_grad():
            replay.record()
            lp, _ = d4.prefill(cfg, params, toks_t, state=state_p, slot=0, last_only=True,
                               plain_kernels=True, **kw)
            if prefill:
                replay.replay()
                lk, _ = d4.prefill(cfg, params, toks_t, state=state_k, slot=0, last_only=True,
                                   **kw)
                torch.cuda.synchronize()
                if not (bool(torch.isfinite(lk).all()) and lk.shape == (1, cfg.vocab_size)):
                    raise SystemExit(f"DSv4{label} kernel-path prefill logits are not finite "
                                     "[1, V]")
                replay.report("prefill")
                check_logits(lk[0], lp[0], DSV4_LOGITS_RTOL,
                             f"DSv4{label} kernel-path prefill logits disagree with the plain "
                             "versions")
            # the decode step starts both runs from the plain prefill's
            # caches, so it holds the decode kernels alone against their
            # plain versions
            for ls_k, ls_p in zip(state_k["layers"], state_p["layers"]):
                for key, cache in ls_p.items():
                    ls_k[key].copy_(cache)
            step = [torch.tensor([x], dtype=torch.int32, device="cuda")
                    for x in (int(lp.argmax()), toks_t.shape[0], 0)]
            replay.record()
            dp = d4.decode(cfg, params, state_p, *step, plain_kernels=True, **kw)
            replay.replay()
            dk = d4.decode(cfg, params, state_k, *step, **kw)
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(dk).all()) and dk.shape == (1, cfg.vocab_size)):
                raise SystemExit(f"DSv4{label} kernel-path decode logits are not finite [1, V]")
            replay.report("decode step")
            check_logits(dk[0], dp[0], DSV4_LOGITS_RTOL,
                         f"DSv4{label} kernel-path decode logits disagree with the plain "
                         "versions")
    finally:
        replay.restore()
    return state_k, step


def dsv4_engine(cfg, contract, d4e, params, quantize=None, moe_chain=None):
    return d4e.start_engine_from_params(
        cfg, params, contract.EngineLoadOptions(
            max_batch_size=DSV4_SLOTS, max_model_len=DSV4_MAX_MODEL_LEN, seed=SEED,
            quantize=quantize),
        device="cuda", moe_chain=moe_chain)


def serve_dsv4(cfg, contract, handle, kernels, warmup=True, main=True,
               concurrent=DSV4_CONCURRENT):
    """Phase 11's traffic on ``handle``, prompts from one seeded stream: a
    warm-up, then (counters of ``kernels`` and of the executor at 0) the
    greedy main request and the concurrent ones. Shuts the engine down and
    returns the counts, the slot events from the main request on and the
    main request's prompt, TTFT and token gaps."""
    ex = handle._scheduler.executor
    events = record_slot_events(ex)
    rng = np.random.default_rng(SEED + 3)
    out = {"main_prompt": None, "ttft_ms": None, "gaps": []}

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    try:
        if warmup:
            ch, _ = run_request(contract, handle, prompt(DSV4_WARMUP[0]), DSV4_WARMUP[1])
            toks, fin, _ = drain(contract, ch)
            expect_finished(contract, "warm-up %d/%d" % DSV4_WARMUP, toks, fin,
                            DSV4_WARMUP[1])
        for mod in kernels.values():
            mod.launches = 0
        ex.prefills = ex.decode_steps = 0
        events.clear()
        if main:
            out["main_prompt"] = prompt(DSV4_PROMPT)
            ch, t0 = run_request(contract, handle, out["main_prompt"], DSV4_OUT)
            toks, fin, times = drain(contract, ch)
            expect_finished(contract, f"main {DSV4_PROMPT}/{DSV4_OUT}", toks, fin, DSV4_OUT)
            out["ttft_ms"] = (times[0] - t0) * 1e3
            out["gaps"] = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
            events.clear()
        chans = [(run_request(contract, handle, prompt(n), m)[0], n, m) for n, m in concurrent]
        for ch, n, m in chans:
            toks_c, fin_c, _ = drain(contract, ch)
            expect_finished(contract, f"concurrent {n}/{m}", toks_c, fin_c, m)
        out["launches"] = {name: mod.launches for name, mod in kernels.items()}
        out["prefills"], out["decode_steps"] = ex.prefills, ex.decode_steps
    finally:
        handle.shutdown()
        handle._thread.join(timeout=60)
    out["events"] = events
    return out


def check_slot_events(events, third_waits):
    """The concurrent requests decoded at B = 2 and, with ``third_waits``,
    the third was prefilled only after a slot freed. Returns the summary."""
    rids = sorted({rid for kind, rid in events if kind == "prefill"})
    batches = [n for kind, n in events if kind == "decode"]
    text = f"decode batch sizes {sorted(set(batches))}"
    if third_waits:
        third = events.index(("prefill", rids[2]))
        freed = [i for i, (kind, rid) in enumerate(events)
                 if kind == "release" and rid in rids[:2]]
        text = (f"the third concurrent request was prefilled at event {third}, after a slot "
                f"freed at event {freed[0] if freed else None}; " + text)
        if not freed or third < freed[0]:
            raise SystemExit("the third request was scheduled before a slot freed")
    if DSV4_SLOTS not in batches:
        raise SystemExit(f"the first two requests never decoded at B = {DSV4_SLOTS}")
    return text


def check_launches(launches, want, label):
    log(f"  launches {launches}; expected {want} ({label})")
    if launches != want:
        raise SystemExit("DSv4 kernel launch counts do not match the path")


def max_err_verdict(errs, name, label, err, tol):
    ok = err <= tol
    log(f"  {name} {label}: max_abs_err {err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version")
    errs[name] = max(errs.get(name, 0.0), err)


def _distinct_idx(gen, E, M, repeat):
    idx = torch.randperm(E, generator=gen, device="cuda")[:M].to(torch.int32)
    if repeat:
        idx[M // 2:] = idx[: M - M // 2]
    return idx


# ── phase 14: the opt-in fp4 chain ──────────────────────────────────────


def run_dsv4_fp4_chain(cfg, params):
    """Phase 14 on the fp4 params. Returns (the K9 record, serving)."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.models import dsv4 as d4
    from pegainfer_tpu_torch.models import dsv4_engine as d4e
    from pegainfer_tpu_torch.ops.cuda import fp4_chain as k9
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
    from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
    from pegainfer_tpu_torch.ops.cuda import fp8_gemv as k4

    log("[14] the fp4 chain (K9): against its plain version, served with moe_chain=True")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    errs = {}
    lw = params["layers"][3]  # a score-gated layer
    E, D, limit = cfg.n_routed_experts, cfg.dim, cfg.swiglu_limit
    natural = (lw["experts_w1"], lw["experts_w3"])
    permuted = tuple(k9.permute_w13(w) for w in natural)
    for perm13, (w1, w3) in ((False, natural), (True, permuted)):
        for M, routing in ((6, "distinct"), (12, "repeated experts"), (16, "one expert")):
            x = torch.randn((M, D), generator=gen, device="cuda")
            idx = _distinct_idx(gen, E, M, routing == "repeated experts")
            if routing == "one expert":
                idx[:] = idx[0]
            y = k9.moe_fp4_chain(x, w1, w3, lw["experts_w2"], idx, limit, perm13=perm13)
            torch.cuda.synchronize()
            ref = k9.moe_fp4_chain_plain(x, w1, w3, lw["experts_w2"], idx, limit, perm13)
            err, share = row_err(y, ref, 1, float("inf"), CHAIN_ROW_RTOL)
            log(f"  moe_fp4_chain M={M} {routing} perm13={perm13}: max_abs_err {err:.3e}, "
                f"worst row at {share:.4f} of {CHAIN_ROW_RTOL:g} x its max |ref| "
                f"{'ok' if share <= 1.0 else 'FAIL'}")
            if not share <= 1.0:
                raise SystemExit("moe_fp4_chain disagrees with its plain version")
            errs["moe_fp4_chain"] = max(errs.get("moe_fp4_chain", 0.0), err)
    del permuted
    torch.cuda.empty_cache()
    record = time_fp4_chain(cfg, params, k9, errs)

    kernels = {"moe_fp4_chain": k9, "moe_fp4_gemv": k3, "fp8_gemv": k4, "moe_fp4_grouped": k5}
    run = serve_dsv4(cfg, contract, dsv4_engine(cfg, contract, d4e, params, moe_chain=True),
                     kernels, warmup=False, main=False, concurrent=DSV4_CHAIN_PAIR)
    log("  the pair Finished with its token counts; " + check_slot_events(
        run["events"], third_waits=False))
    L, steps, prefills = cfg.n_layers, run["decode_steps"], run["prefills"]
    check_launches(run["launches"], {"moe_fp4_chain": L * steps, "moe_fp4_gemv": 0,
                                     "fp8_gemv": fp8_per_decode_step(cfg) * steps,
                                     "moe_fp4_grouped": 3 * L * prefills},
                   f"{prefills} prefills, {steps} decode steps, {L} layers")
    record["launches"] = run["launches"]["moe_fp4_chain"]
    log("  one decode step after a 300-token prefill: the chain vs its plain version, the "
        "kernel run routed as the plain run")
    prompt = np.random.default_rng(SEED + 6).integers(0, cfg.vocab_size, 300).tolist()
    state, step = check_dsv4_logits(cfg, d4, d4e, params, torch.tensor(
        prompt, dtype=torch.int32, device="cuda"), prefill=False, moe_chain=True,
        label=" fp4-chain")
    log("  one decode step at B = 1, context 301, with the chain on (K9) and off (K3)")
    prof = {}
    for chain in (True, False):
        prof.update(dsv4_step_profile(cfg, d4, params, None, state, step, moe_chain=chain))
    log_steps(prof)
    return record, {"launches": run["launches"], "decode_steps": steps, "prefills": prefills,
                    "steps": steps_json(prof)}


def time_fp4_chain(cfg, params, k9, errs):
    """K9 at B = 1 (6 distinct routed rows) and B = 2 (two tokens' top-6
    experts, 12 rows, repeats as they fall), each call on the next layer's
    weights (a layer's routed bytes for 6 rows are 85 MB, beyond L2), beside
    the path's sequence with the chain off at the same rows: K3 on w1 and on
    w3, the SwiGLU, K3 on w2 (``models/dsv4.py``). Bounds over every routed
    row's weights and, at B = 2, over the distinct experts' alone."""
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
    from pegainfer_tpu_torch.ops.moe import swiglu

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    layers, E, D, limit = params["layers"], cfg.n_routed_experts, cfg.dim, cfg.swiglu_limit
    L = len(layers)
    ws = [(lw["experts_w1"], lw["experts_w3"], lw["experts_w2"]) for lw in layers]
    w1, w3, w2 = ws[0]
    I = w1["q"].shape[1]
    w_bytes = sum(w["q"][0].numel() + w["s"][0].numel() * 2 for w in (w1, w3, w2))

    def chain_off(x, w1, w3, w2, idx):
        act = swiglu(k3.moe_fp4_gemv(x, w1["q"], w1["s"], idx),
                     k3.moe_fp4_gemv(x, w3["q"], w3["s"], idx), limit)
        return k3.moe_fp4_gemv(act, w2["q"], w2["s"], idx)

    out = {}
    for label, tokens in (("B=1", 1), ("B=2", 2)):
        M = 6 * tokens
        x = torch.randn((M, D), generator=gen, device="cuda")
        idxs = [torch.cat([torch.randperm(E, generator=gen, device="cuda")[:6]
                           for _ in range(tokens)]).to(torch.int32) for _ in range(L)]
        saved = k9.launches, k3.launches
        ms = time_ms(lambda i: k9.moe_fp4_chain(x, *ws[i % L], idxs[i % L], limit), 100)
        # about 10 launches a call: a window the device's queue holds
        off_ms = time_ms(lambda i: chain_off(x, *ws[i % L], idxs[i % L]), 24)
        k9.launches, k3.launches = saved
        io = x.numel() * 4 + M * 4 + M * D * 4
        flops = 2 * M * 3 * I * D
        distinct = sum(int(torch.unique(i).numel()) for i in idxs) / L
        bound_ms, by = bound(M * w_bytes + io, flops)
        distinct_ms, _ = bound(distinct * w_bytes + io, flops)
        out[label] = {"ms": ms, "chain_off_ms": off_ms, "bound_ms": bound_ms, "bound_by": by,
                      "distinct_experts": distinct, "bound_distinct_ms": distinct_ms}
        log(f"  moe_fp4_chain {label} ({M} rows, {distinct:.2f} distinct experts a layer): "
            f"{ms * 1e3:.2f} us, chain off (K3, SwiGLU, K3, K3) {off_ms * 1e3:.2f} us, bound "
            f"{bound_ms * 1e3:.2f} us over every row ({by}), {distinct_ms * 1e3:.2f} us over "
            "the distinct experts")
        if label == "B=1":  # the plain version at B = 1 only: it gathers and decodes
            plain_ms = time_ms(
                lambda i: k9.moe_fp4_chain_plain(x, *ws[i % L], idxs[i % L], limit), 8)
    b1 = out["B=1"]
    return {"name": "moe_fp4_chain", "route": "cuda",
            "source": "pegainfer_tpu_torch/csrc/fp4_chain.cu",
            "replaces": "pegainfer_tpu/ops/pallas/fp4_gemm.py:1047",
            "launches": None, "max_abs_err": errs["moe_fp4_chain"], "ms": b1["ms"],
            "plain_ms": plain_ms, "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
            "library_ms": None, "chain_off_ms": b1["chain_off_ms"], "b2": out["B=2"]}


# ── phases 15-18: the int8-experts mode ─────────────────────────────────


def run_dsv4_int8(cfg, params, k9_record):
    """Phases 15-18: requantize ``params`` to int8 in place, check and
    serve. Returns (K6-K9 records, serving, steps)."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.models import dsv4 as d4
    from pegainfer_tpu_torch.models import dsv4_engine as d4e
    from pegainfer_tpu_torch.ops import quant
    from pegainfer_tpu_torch.ops.cuda import fp4_chain as k9
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
    from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
    from pegainfer_tpu_torch.ops.cuda import fp8_gemv as k4
    from pegainfer_tpu_torch.ops.cuda import int8_chain as k8
    from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
    from pegainfer_tpu_torch.ops.cuda import int8_grouped as k7

    log("[15] int8 requantization through start_engine_from_params(quantize='int8-experts')")
    probe = params["layers"][3]["experts_w1"]
    slice_q, slice_s = probe["q"][7:8].cpu(), probe["s"][7:8].cpu()
    del probe
    host = quant.quantize_int8_stack(quant.dequant_any({"q": slice_q, "s": slice_s},
                                                       torch.float32).numpy())
    before = d4.params_bytes(params)
    gc.collect()
    torch.cuda.empty_cache()
    engine_log = logging.getLogger("pegainfer_torch.dsv4")
    engine_log.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("  engine: %(message)s"))
    engine_log.addHandler(handler)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    handle = dsv4_engine(cfg, contract, d4e, params, quantize="int8-experts")
    torch.cuda.synchronize()
    requant_s = time.perf_counter() - t
    after = d4.params_bytes(params)
    peak = torch.cuda.max_memory_reserved()
    new = params["layers"][3]["experts_w1"]
    differ = int((new["q"][7].cpu() != host["q"][0]).sum()) + int(
        (new["s"][7].cpu() != host["s"][0]).sum())
    log(f"  engine start with the requantization: {requant_s:.1f} s; params {before / 1e9:.2f} "
        f"GB -> {after / 1e9:.2f} GB; peak reserved {peak / 1e9:.2f} GB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB; layer 3 w1 "
        f"expert 7: {differ} codes and scales differ from the host quantize_int8_stack")
    if differ or new["q"].dtype != torch.int8:
        raise SystemExit("the device requantization differs from the host quantize_int8_stack")
    del new
    requant = {"seconds": requant_s, "bytes_before": before, "bytes_after": after,
               "peak_reserved_bytes": peak, "codes_differing": differ}

    log("[16] K6, K7, K8 against their plain versions on the model's int8 weights")
    errs = check_int8_kernels(cfg, params, k6, k7, k8)

    log("[17] serving phase 11's traffic with int8 experts (K7 prefill, K8 decode)")
    kernels = {"moe_int8_gemv": k6, "moe_int8_grouped": k7, "moe_int8_chain": k8,
               "moe_fp4_chain": k9, "moe_fp4_gemv": k3, "fp8_gemv": k4, "moe_fp4_grouped": k5}
    run = serve_dsv4(cfg, contract, handle, kernels)
    del handle
    log("  all requests Finished with their token counts; " + check_slot_events(
        run["events"], third_waits=True))
    L, steps, prefills = cfg.n_layers, run["decode_steps"], run["prefills"]
    zero = dict.fromkeys(kernels, 0)
    check_launches(run["launches"], {**zero, "moe_int8_grouped": 3 * L * prefills,
                                     "moe_int8_chain": L * steps,
                                     "fp8_gemv": fp8_per_decode_step(cfg) * steps},
                   f"{prefills} prefills, {steps} decode steps, {L} layers")
    launches = dict(run["launches"])
    log(f"  {DSV4_PROMPT}-token int8 prefill and one decode step: kernels vs plain versions, "
        f"the kernel run routed as the plain run")
    toks_t = torch.tensor(run["main_prompt"], dtype=torch.int32, device="cuda")
    state_k, step = check_dsv4_logits(cfg, d4, d4e, params, toks_t, label=" int8")
    log("  the 300/32 + 500/32 pair with moe_chain=False (K6 decode)")
    off = serve_dsv4(cfg, contract, dsv4_engine(cfg, contract, d4e, params,
                                                quantize="int8-experts", moe_chain=False),
                     kernels, warmup=False, main=False, concurrent=DSV4_CHAIN_PAIR)
    check_slot_events(off["events"], third_waits=False)
    check_launches(off["launches"], {**zero, "moe_int8_grouped": 3 * L * off["prefills"],
                                     "moe_int8_gemv": 3 * L * off["decode_steps"],
                                     "fp8_gemv": fp8_per_decode_step(cfg) * off["decode_steps"]},
                   f"{off['prefills']} prefills, {off['decode_steps']} decode steps")
    launches["moe_int8_gemv"] = off["launches"]["moe_int8_gemv"]

    log("[18] int8 timings")
    steps_prof = dsv4_step_profile(cfg, d4, params, toks_t, state_k, step)
    # the same decode step with the chain off: K6's three GEMVs a layer
    steps_prof.update(dsv4_step_profile(cfg, d4, params, None, state_k, step, moe_chain=False))
    gaps = run["gaps"]
    tpot, tpot95 = statistics.median(gaps), float(np.percentile(gaps, 95))
    log(f"  int8 main {DSV4_PROMPT}/{DSV4_OUT}: TTFT {run['ttft_ms']:.3f} ms, TPOT p50 "
        f"{tpot:.3f} ms, p95 {tpot95:.3f} ms over {len(gaps)} gaps (host clock, per "
        "streamed token)")
    log_steps(steps_prof)
    del state_k
    records, extra = time_int8_kernels(cfg, params, k6, k7, k8, errs, launches)
    records.append(k9_record)
    log_records(records)
    serving = {"ttft_ms": run["ttft_ms"], "tpot_p50_ms": tpot, "tpot_p95_ms": tpot95,
               "prompt": DSV4_PROMPT, "output": DSV4_OUT, "requantization": requant,
               "chain_off_pair": {"launches": off["launches"],
                                  "decode_steps": off["decode_steps"]}, **extra}
    return records, serving, steps_json(steps_prof)


def check_int8_kernels(cfg, params, k6, k7, k8):
    from pegainfer_tpu_torch.studies import k6_study as k6s

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    errs = {}
    lw, E, limit = params["layers"][3], cfg.n_routed_experts, cfg.swiglu_limit
    # K6 row by row: each row within INT8_GEMV_RTOL of its max |ref|, a row of
    # an invalid id exactly 0; y's block is NaN-filled first, so an element
    # left unwritten fails. The reference is the plain version on the valid
    # ids, with the rows of invalid ids 0.
    for key, M, routing in (("experts_w1", 6, "distinct"), ("experts_w2", 6, "distinct"),
                            ("experts_w1", 1, "distinct"), ("experts_w3", 12, "repeated"),
                            ("experts_w1", 12, "shared"), ("experts_w2", 12, "shared"),
                            ("experts_w1", 18, "repeated"), ("experts_w2", 20, "distinct"),
                            ("experts_w1", 20, "one"), ("experts_w1", 6, "invalid"),
                            ("experts_w2", 20, "invalid")):
        w = lw[key]
        idx = k6s.route(routing, M, E, torch.randperm(E, generator=gen, device="cuda"))
        x = torch.randn((M, w["q"].shape[2]), generator=gen, device="cuda")
        poison = torch.full((M, w["q"].shape[1]), float("nan"), device="cuda")
        del poison
        y = k6.moe_int8_gemv(x, w["q"], idx)
        torch.cuda.synchronize()
        valid = (idx >= 0) & (idx < E)
        ref = k6.moe_int8_gemv_plain(x, w["q"], torch.where(valid, idx, 0)) * valid[:, None]
        err, share = k6s.row_err(y, ref, INT8_GEMV_RTOL)
        log(f"  moe_int8_gemv {key} M={M} {routing} (unscaled): max_abs_err {err:.3e}, worst row "
            f"at {share:.3f} of {INT8_GEMV_RTOL:g} x its max |ref| {'ok' if share <= 1.0 else 'FAIL'}")
        if not share <= 1.0:
            raise SystemExit("moe_int8_gemv disagrees with its plain version")
        errs["moe_int8_gemv"] = max(errs.get("moe_int8_gemv", 0.0), err)
    for key, M, skew in (("experts_w1", 6 * DSV4_PROMPT, False),
                         ("experts_w2", 6 * DSV4_PROMPT, True),
                         ("experts_w3", 54, True), ("experts_w1", 300, False)):
        w = lw[key]
        x, tm, _, seg = grouped_inputs(gen, M, w["q"].shape[2], E, skew)
        y = k7.moe_int8_grouped(x, w["q"], *seg, tm=tm)
        torch.cuda.synchronize()
        ref = k7.moe_int8_grouped_plain(x, w["q"], *seg, tm=tm)
        err, share = grouped_err(y, ref)
        label = (f"{key} M={M} tm={tm} {'skewed, empty experts' if skew else 'spread'}, "
                 f"{int((seg[3]).max())} segments at most in a tile (unscaled)")
        log(f"  moe_int8_grouped {label}: max_abs_err {err:.3e}, global share "
            f"{err / ref.abs().max().item():.3e}, worst row at {share:.3f} of "
            f"{GROUPED_ROW_RTOL:g} x its max |ref| {'ok' if share <= 1.0 else 'FAIL'}")
        if not share <= 1.0:
            raise SystemExit("moe_int8_grouped disagrees with its plain version")
        errs["moe_int8_grouped"] = max(errs.get("moe_int8_grouped", 0.0), err)
    w1, w3, w2 = lw["experts_w1"], lw["experts_w3"], lw["experts_w2"]
    for M in (1, 6, 12, 16):
        idx = _distinct_idx(gen, E, M, M == 12)
        x = torch.randn((M, cfg.dim), generator=gen, device="cuda")
        args = (x, w1["q"], w3["q"], w2["q"], w1["s"], w3["s"], w2["s"], idx, limit)
        y = k8.moe_int8_chain(*args)
        torch.cuda.synchronize()
        ref = k8.moe_int8_chain_plain(*args)
        max_err_verdict(errs, "moe_int8_chain", f"M={M}{' repeated experts' if M == 12 else ''}",
                        (y - ref).abs().max().item(), CHAIN_RTOL * ref.abs().max().item())
    return errs


def time_int8_kernels(cfg, params, k6, k7, k8, errs, launches):
    """K6 (``time_int8_gemv``) at w1 and w2 at M 1, 6 and 12, and its sum
    over a chain-off step's launches; K7 at w1 over a 1,024-token prefill,
    K8 at B = 1 (6 distinct rows), each call on the next layer's weights;
    bounds from these inputs, at the bf16 peak for the operations; the plain
    versions; K7 (``time_grouped``) also at w2 and at skewed routing, each
    beside one bf16 grouped GEMM (``grouped_mm_library``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    layers, E, D, limit = params["layers"], cfg.n_routed_experts, cfg.dim, cfg.swiglu_limit
    L = len(layers)
    w1 = [lw["experts_w1"] for lw in layers]
    _, OUT, IN = w1[0]["q"].shape

    # K6 at w1 and w2 at M 1, 6 and 12 (distinct, and shared by two tokens);
    # the record's own numbers are w1's at M 6, the path's shape (B = 1)
    k6_cases = time_int8_gemv(layers, k6, gen, E)
    k6_main = k6_cases["w1 M=6"]
    k6_step_ms = 2 * L * k6_main["ms"] + L * k6_cases["w2 M=6"]["ms"]
    k6_step_bound = 2 * L * k6_main["bound_ms"] + L * k6_cases["w2 M=6"]["bound_ms"]
    log(f"  moe_int8_gemv over a chain-off decode step at B = 1 ({3 * L} launches): "
        f"{k6_step_ms * 1e3:.2f} us against a bound of {k6_step_bound * 1e3:.2f} us")

    # K7 over a 1,024-token prefill (6,144 routed rows): w1 with spread
    # routing (the record), then w2 and w1 with skewed routing; the plan is
    # built once outside the timed calls, as models/dsv4.py shares it
    M7 = 6 * DSV4_PROMPT
    x7, tm, e7, seg = grouped_inputs(gen, M7, IN, E, skew=False)
    k7_ms, k7_bound, k7_by, k7_lib_ms, k7_lib_call, k7_plan_ms = time_grouped(
        k7, "w1", x7, tm, e7, seg, w1, E)
    k7_plain_ms = time_synced_ms(lambda i: k7.moe_int8_grouped_plain(
        x7, w1[i % L]["q"], *seg, tm=tm), 3)
    w2 = [lw["experts_w2"] for lw in layers]
    x7b = torch.randn((x7.shape[0], w2[0]["q"].shape[2]), generator=gen,
                      device="cuda").to(torch.bfloat16)
    k7_w2 = time_grouped(k7, "w2", x7b, tm, e7, seg, w2, E)
    del x7b
    x7s, tms, e7s, segs = grouped_inputs(gen, M7, IN, E, skew=True)
    k7_skew = time_grouped(k7, "w1, skewed routing", x7s, tms, e7s, segs, w1, E)
    del x7s, x7

    # K8: B = 1, 6 distinct rows
    ws = [(lw["experts_w1"], lw["experts_w3"], lw["experts_w2"]) for lw in layers]
    x8 = torch.randn((6, D), generator=gen, device="cuda")
    idx8 = [_distinct_idx(gen, E, 6, False) for _ in range(L)]

    def k8_args(i):
        a, b, c = ws[i % L]
        return (x8, a["q"], b["q"], c["q"], a["s"], b["s"], c["s"], idx8[i % L], limit)

    saved = k8.launches
    k8_ms = time_ms(lambda i: k8.moe_int8_chain(*k8_args(i)), 200)
    k8.launches = saved
    k8_plain_ms = time_ms(lambda i: k8.moe_int8_chain_plain(*k8_args(i)), 8)
    b8 = 6 * 3 * OUT * IN + x8.numel() * 4 + 6 * 4 + 6 * (2 * OUT + D) * 4 + 6 * D * 4
    k8_bound, k8_by = bound(b8, 2 * 6 * 3 * OUT * IN)

    src = "pegainfer_tpu/ops/pallas/fp4_gemm.py"
    records = [
        {"name": "moe_int8_gemv", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/int8_gemv.cu", "replaces": f"{src}:521",
         "launches": launches["moe_int8_gemv"], "max_abs_err": errs["moe_int8_gemv"],
         "ms": k6_main["ms"], "plain_ms": k6_main["plain_ms"], "bound_ms": k6_main["bound_ms"],
         "bound_by": k6_main["bound_by"], "library_ms": k6_main["library_ms"],
         "library_call": k6_main["library_call"], "shapes": k6_cases, "step_ms": k6_step_ms,
         "step_bound_ms": k6_step_bound},
        {"name": "moe_int8_grouped", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/int8_grouped.cu", "replaces": f"{src}:644",
         "launches": launches["moe_int8_grouped"], "max_abs_err": errs["moe_int8_grouped"],
         "ms": k7_ms, "plain_ms": k7_plain_ms, "bound_ms": k7_bound, "bound_by": k7_by,
         "library_ms": k7_lib_ms, "library_call": k7_lib_call},
        {"name": "moe_int8_chain", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/int8_chain.cu", "replaces": f"{src}:787",
         "launches": launches["moe_int8_chain"], "max_abs_err": errs["moe_int8_chain"],
         "ms": k8_ms, "plain_ms": k8_plain_ms, "bound_ms": k8_bound, "bound_by": k8_by,
         "library_ms": None},
    ]
    extra = {"k7_plan_ms": k7_plan_ms}
    for name, (ms, b, by, lib, call, _) in (("k7_w2", k7_w2), ("k7_skewed", k7_skew)):
        extra[name] = {"ms": ms, "bound_ms": b, "bound_by": by, "library_ms": lib,
                       "library_call": call}
    return records, extra


def time_int8_gemv(layers, k6, gen, E):
    """K6 at w1 and w2 at M 1, 6 and 12 with distinct experts and at 12 rows
    routed as two tokens sharing 3 of their 6 experts (B = 2: 9 distinct),
    x in bf16, each call on the next layer's codes and expert ids (the 8
    layers' routed experts at M 6, 403 MB, come from device memory); beside
    the bound of the distinct experts' bytes; one ``torch.bmm`` of the
    routed experts gathered and converted to bf16 outside the timed call
    (sets for twice the L2), held against K6 at GROUPED_RTOL x max |y| (it
    rounds its output to bf16); at M 1 ``torch.matmul`` on the expert's bf16
    weight (copies for twice the L2); at w1 M 6 the plain version. Returns
    {case: record}."""
    from pegainfer_tpu_torch.studies import k6_study as k6s

    L = len(layers)
    perm = torch.randperm(E, generator=gen, device="cuda")
    out = {}
    for key, M, routing in (("w1", 1, "distinct"), ("w2", 1, "distinct"),
                            ("w1", 6, "distinct"), ("w2", 6, "distinct"),
                            ("w1", 12, "distinct"), ("w2", 12, "distinct"),
                            ("w1", 12, "shared"), ("w2", 12, "shared")):
        qs = [lw[f"experts_{key}"]["q"] for lw in layers]
        _, OUT, IN = qs[0].shape
        x = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
        idxs = [k6s.route(routing, M, E, perm, i) for i in range(L)]
        saved = k6.launches
        ms = time_ms(lambda i: k6.moe_int8_gemv(x, qs[i % L], idxs[i % L]), 200)
        y = k6.moe_int8_gemv(x, qs[0], idxs[0])
        k6.launches = saved
        n = k6s.distinct(routing, M)
        b, by = bound(k6s.bytes_moved(n, M, OUT, IN), 2 * M * OUT * IN)
        n_wg = min(L, max(2, -(-2 * k6s.L2_BYTES // (M * OUT * IN * 2)) + 1))
        wg = [qs[i][idxs[i].long()].to(torch.bfloat16) for i in range(n_wg)]
        xb = x[:, :, None]
        err = (torch.bmm(wg[0], xb)[:, :, 0].float() - y).abs().max().item()
        tol = GROUPED_RTOL * y.abs().max().item()
        lib_ms, lib_call = None, "none: torch.bmm disagrees with K6"
        if err <= tol:
            lib_ms = time_ms(lambda i: torch.bmm(wg[i % n_wg], xb), 100)
            lib_call = "torch.bmm (bf16, experts gathered ahead)"
        name = f"{key} M={M}{' shared' if routing == 'shared' else ''}"
        rec = {"OUT": OUT, "IN": IN, "M": M, "routing": routing, "experts": n, "ms": ms,
               "bound_ms": b, "bound_by": by, "library_ms": lib_ms, "library_call": lib_call,
               "launches_a_step": (2 if key == "w1" else 1) * L}
        if M == 1:
            rec["matmul_ms"] = time_ms(lambda i: torch.matmul(x, wg[i % n_wg][0].T), 200)
        if name == "w1 M=6":
            rec["plain_ms"] = time_ms(lambda i: k6.moe_int8_gemv_plain(x, qs[i % L],
                                                                       idxs[i % L]), 16)
        del wg
        out[name] = rec
        more = "" if M > 1 else f", torch.matmul {rec['matmul_ms'] * 1e3:.2f} us"
        log(f"  moe_int8_gemv {name} ({n} experts): {ms * 1e3:.2f} us ({b / ms:.1%} of "
            f"{b * 1e3:.2f} us), torch.bmm "
            f"{'none' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'} (max |diff| {err:.4g}, "
            f"tol {tol:.4g}){more}")
    return out


def time_grouped(mod, label, x, tm, e_sorted, seg, ws, E):
    """K5 (``mod`` the fp4_grouped module) or K7 (int8_grouped) on the rows
    ``x`` (sorted by ``e_sorted``, segments ``seg``), each call on the next
    layer's stack of ``ws``, with a plan built once; its bound from these
    inputs (each hit expert's codes, and K5's scales, read once); the plan's
    own time; one bf16 grouped GEMM on the first layer's stack as its
    library yardstick (K5: dequantized with its scales; K7: its codes,
    unscaled as K7's output is). Returns (ms, bound_ms, bound_by,
    library_ms, library_call, plan_ms)."""
    fp4 = hasattr(mod, "moe_fp4_grouped")
    name = "K5" if fp4 else "K7"
    L, (M, IN) = len(ws), x.shape
    OUT = ws[0]["q"].shape[1]

    def call(w, work):
        if fp4:
            return mod.moe_fp4_grouped(x, w["q"], w["s"], *seg, tm=tm, plan=work)
        return mod.moe_int8_grouped(x, w["q"], *seg, tm=tm, plan=work)

    work = mod.plan(*seg, tm, E)
    saved = mod.launches
    ms = time_ms(lambda i: call(ws[i % L], work), 24)
    plan_ms = time_ms(lambda i: mod.plan(*seg, tm, E), 10)  # about 60 launches a plan
    hit = int(torch.unique(e_sorted).numel())
    w_bytes = ws[0]["q"][0].nbytes + (ws[0]["s"][0].nbytes if fp4 else 0)  # one expert
    b_ms, by = bound(hit * w_bytes + x.numel() * 2 + M * OUT * 4, 2 * M * OUT * IN)
    y = call(ws[0], work)
    mod.launches = saved
    log(f"  {name} at {label}: {M} rows over {hit} experts, {int(work.n_items[0])} row "
        f"chunks: {ms * 1e3:.2f} us, {hit * w_bytes / ms / 1e9:.3f} TB/s of weights, bound "
        f"{b_ms * 1e3:.2f} us ({by}; the kernel at {b_ms / ms:.1%} of the bound's rate); its "
        f"plan {plan_ms * 1e3:.2f} us")
    # the stack in bf16 [E, IN, OUT] (column-major per expert; 4.3 GB at w1)
    wb = dequant_stack_bf16(ws[0]) if fp4 else ws[0]["q"].to(torch.bfloat16)
    lib_ms, lib_call = grouped_mm_library(name, x, e_sorted, wb.transpose(1, 2), y, label)
    del y, wb
    torch.cuda.empty_cache()
    return ms, b_ms, by, lib_ms, lib_call, plan_ms


def grouped_mm_library(label, x_sorted, e_sorted, wb, y_ref, what="w1"):
    """The library yardstick of a grouped GEMM kernel (K5, K7): the device
    time of one PyTorch grouped GEMM (``torch.nn.functional.grouped_mm``,
    else ``torch._grouped_mm``) of the rows of ``x_sorted`` (bf16, sorted by
    expert ``e_sorted``, no tile padding) with ``wb``, the weight stack in
    bf16 [E, IN, OUT], made outside the timed call; held against the
    kernel's output ``y_ref`` at GROUPED_RTOL. Its output is bf16 (torch
    2.11 refuses an f32 output for bf16 inputs). Returns (ms, what was
    called), or (None, why not) where this torch has no such call, it
    refuses these inputs or it disagrees."""
    fn = getattr(torch.nn.functional, "grouped_mm", None)
    name = "torch.nn.functional.grouped_mm"
    if fn is None:
        fn, name = getattr(torch, "_grouped_mm", None), "torch._grouped_mm"
    if fn is None:
        log(f"  {label} library: this torch has no grouped_mm")
        return None, "none: this torch has no grouped_mm"
    E = wb.shape[0]
    offs = torch.cumsum(torch.bincount(e_sorted.long(), minlength=E), 0).to(torch.int32)
    try:
        y = fn(x_sorted, wb, offs=offs)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as exc:
        log(f"  {label} library: {name} refused: {str(exc).splitlines()[0][:200]}")
        return None, f"none: {name} refused these inputs"
    err = (y.float() - y_ref).abs().max().item()
    tol = GROUPED_RTOL * y_ref.abs().max().item()
    del y
    if not err <= tol:
        log(f"  {label} library: {name} disagrees with {label} by {err:.4g} (tol {tol:.4g})")
        return None, f"none: {name} disagrees with {label}"
    ms = time_ms(lambda i: fn(x_sorted, wb, offs=offs), 24)
    log(f"  {label} library: {name} (bf16 out) on {what} in bf16, {x_sorted.shape[0]} rows: "
        f"{ms * 1e3:.2f} us (max |diff| to {label} {err:.4g}, tol {tol:.4g})")
    return ms, name


def dequant_stack_bf16(w):
    """An fp4 / fp8 / int8 expert stack {"q", "s"} -> bf16 [E, OUT, IN] with
    its scales applied, 16 experts at a time (one f32 intermediate of the
    whole stack would take 8.6 GB at DSv4-Flash's w1)."""
    from pegainfer_tpu_torch.ops import quant

    chunk = 16
    E = w["q"].shape[0]
    first = quant.dequant_any({"q": w["q"][:1], "s": w["s"][:1]}, torch.bfloat16)
    out = torch.empty((E, *first.shape[1:]), dtype=torch.bfloat16, device=first.device)
    for i in range(0, E, chunk):
        out[i:i + chunk] = quant.dequant_any({"q": w["q"][i:i + chunk], "s": w["s"][i:i + chunk]},
                                             torch.bfloat16)
    return out


class RoutingReplay:
    """Score-gate decisions of one run handed to the next. The plain run
    records each call's (weights, experts); the kernel run then routes as
    the plain run did and counts the token-layer decisions where its own
    choice of experts differs. A decision whose 6th and 7th expert scores
    are closer than the kernels' error (1e-6) flips on that error and swaps
    an expert, which moves the logits by far more than the kernels' error;
    replaying the routing keeps the comparison on the kernels."""

    def __init__(self, d4):
        self.d4, self.gate = d4, d4.score_gate
        self.saved, self.flips, self.decisions = [], 0, 0

    def record(self):
        self.saved.clear()

        def gate(*args, **kwargs):
            out = self.gate(*args, **kwargs)
            self.saved.append(out)
            return out

        self.d4.score_gate = gate

    def replay(self):
        saved = iter(self.saved)
        self.flips = self.decisions = 0

        def gate(*args, **kwargs):
            _, own = self.gate(*args, **kwargs)
            weights, experts = next(saved)
            same = (torch.sort(own, dim=-1).values
                    == torch.sort(experts, dim=-1).values).all(dim=-1)
            self.flips += int((~same).sum())
            self.decisions += same.numel()
            return weights, experts

        self.d4.score_gate = gate

    def report(self, label):
        log(f"  {label}: the kernel run's own routing differs in {self.flips} of "
            f"{self.decisions} token-layer decisions")

    def restore(self):
        self.d4.score_gate = self.gate


def record_slot_events(ex):
    """Log the executor's prefills (request id), releases (request id) and
    decode steps (batch size), in order."""
    events = []
    prefill_one, release, decode = ex._prefill_one, ex.release_request, ex.execute_decode

    def logged_prefill(item):
        events.append(("prefill", item.request_id))
        return prefill_one(item)

    def logged_release(request_id):
        events.append(("release", request_id))
        release(request_id)

    def logged_decode(plan):
        if plan.requests:
            events.append(("decode", len(plan.requests)))
        return decode(plan)

    ex._prefill_one, ex.release_request, ex.execute_decode = (
        logged_prefill, logged_release, logged_decode)
    return events


def _routing(gen, M, E, skew):
    """Sorted expert ids of M routed rows: skewed onto a few experts (the
    rest empty, long segments crossing tiles) or spread over all."""
    if skew:
        hot = torch.tensor([0, 3, 3, 3, 3, 3, 7, E * 25 // 32, E - 1], device="cuda")
        ids = hot[torch.randint(0, len(hot), (M,), generator=gen, device="cuda")]
    else:
        ids = torch.randint(0, E, (M,), generator=gen, device="cuda")
    return torch.sort(ids).values.to(torch.int32)


def grouped_inputs(gen, M, IN, E, skew):
    """x_sorted, tm and segments of one K5 call for M routed rows, padded as
    models/dsv4.py pads them."""
    from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5

    tm = 128 if M >= 128 else -(-M // 8) * 8
    Mp = -(-M // tm) * tm
    e = _routing(gen, M, E, skew)
    e = torch.cat([e, e[-1:].expand(Mp - M)])
    x = torch.randn((Mp, IN), generator=gen, device="cuda").to(torch.bfloat16)
    return x, tm, e, k5.tile_segments(e, tm, E)


def check_quant_kernels(cfg, params, k3, k4, k5):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    errs = {"moe_fp4_gemv": 0.0, "fp8_gemv": 0.0, "moe_fp4_grouped": 0.0}
    lw, lw4 = params["layers"][3], params["layers"][2]

    # K4 at the seven shapes of a decode step (shared_w3 has shared_w1's)
    for key in K4_STEP_KEYS:
        w = (lw4 if key == "idx_wq_b" else lw)[key]
        for M in (1, 2, 8):
            x = torch.randn((M, w["q"].shape[1]), generator=gen, device="cuda")
            y = k4.fp8_gemv(x, w["q"], w["s"])
            torch.cuda.synchronize()
            err = (y - k4.fp8_gemv_plain(x, w["q"], w["s"])).abs().max().item()
            max_err_verdict(errs, "fp8_gemv", f"{key} {tuple(w['q'].shape)} M={M}", err,
                            QUANT_GEMV_TOL)

    # K3: the model's scales are powers of two; w1 with random bf16 mantissas
    # makes the decode round each weight (K5 too, below); M 1, B = 2's shared
    # routing and ids -1 and E (rows of 0) beside the main path's rows
    from pegainfer_tpu_torch.studies import k3_study as k3s

    E = cfg.n_routed_experts
    w1 = lw["experts_w1"]
    mant = 1 + torch.rand(w1["s"].shape, generator=gen, device="cuda")
    w1_arb = {"q": w1["q"], "s": (w1["s"].float() * mant).to(torch.bfloat16)}
    del mant
    for key, w, M, routing in (("experts_w1", w1, 6, "distinct"),
                               ("experts_w1", w1, 12, "repeated"),
                               ("experts_w2", lw["experts_w2"], 12, "repeated"),
                               ("experts_w3", lw["experts_w3"], 12, "distinct"),
                               ("experts_w1", w1, 1, "distinct"),
                               ("experts_w2", lw["experts_w2"], 12, "shared"),
                               ("experts_w1 codes, bf16 scales", w1_arb, 6, "distinct"),
                               ("experts_w1 codes, bf16 scales", w1_arb, 12, "shared"),
                               ("experts_w2", lw["experts_w2"], 6, "invalid")):
        idx = k3s.route(routing, M, E, torch.randperm(E, generator=gen, device="cuda"))
        x = torch.randn((M, 2 * w["q"].shape[2]), generator=gen, device="cuda")
        y = k3.moe_fp4_gemv(x, w["q"], w["s"], idx)
        torch.cuda.synchronize()
        ref = k3.moe_fp4_gemv_plain(x, w["q"], w["s"], idx)
        err = (y - ref).abs().max().item()
        if routing == "invalid" and not (y[(ref == 0).all(dim=1)] == 0).all():
            err = float("inf")  # a row of an invalid id must be exactly 0
        max_err_verdict(errs, "moe_fp4_gemv", f"{key} M={M} {routing}", err, QUANT_GEMV_TOL)

    for key, w, M, skew in (("experts_w1", w1, 6 * DSV4_PROMPT, False),
                            ("experts_w2", lw["experts_w2"], 6 * DSV4_PROMPT, True),
                            ("experts_w3", lw["experts_w3"], 54, True),
                            ("experts_w1", w1, 300, False),
                            ("experts_w1 codes, bf16 scales", w1_arb, 6 * DSV4_PROMPT, False)):
        x, tm, _, seg = grouped_inputs(gen, M, 2 * w["q"].shape[2], E, skew)
        y = k5.moe_fp4_grouped(x, w["q"], w["s"], *seg, tm=tm)
        torch.cuda.synchronize()
        ref = k5.moe_fp4_grouped_plain(x, w["q"], w["s"], *seg, tm=tm)
        err, share = grouped_err(y, ref)
        label = (f"{key} M={M} tm={tm} {'skewed, empty experts' if skew else 'spread'}, "
                 f"{int((seg[3]).max())} segments at most in a tile")
        log(f"  moe_fp4_grouped {label}: max_abs_err {err:.3e}, global share "
            f"{err / ref.abs().max().item():.3e}, worst row at {share:.3f} of "
            f"{GROUPED_ROW_RTOL:g} x its max |ref| {'ok' if share <= 1.0 else 'FAIL'}")
        if not share <= 1.0:
            raise SystemExit("moe_fp4_grouped disagrees with its plain version")
        errs["moe_fp4_grouped"] = max(errs["moe_fp4_grouped"], err)
    del w1_arb
    return errs


def dsv4_step_profile(cfg, d4, params, prompt_t, state, step, iters=3, moe_chain=None):
    """Wall time (host clock, each call ending in a synchronize), device time
    and device operations (torch.profiler, CUDA activity) of one
    1,024-token prefill into a slot (unless ``prompt_t`` is None) and one
    B = 1 decode step at the context of ``step``, called directly on the
    model, with ``moe_chain`` as the model takes it; the device time and
    launches in each of the kernels of STEP_KERNELS (K4, K3, K6), logged
    where they launched."""
    from torch.profiler import ProfilerActivity, profile

    ctx = int(step[1]) + 1
    calls = {} if prompt_t is None else {
        f"dsv4 prefill {DSV4_PROMPT}": lambda: d4.prefill(
            cfg, params, prompt_t, state=state, slot=0, last_only=True)}
    chain = "" if moe_chain is None else f", chain {'on' if moe_chain else 'off'}"
    calls[f"dsv4 decode step B=1 ctx {ctx}{chain}"] = lambda: d4.decode(
        cfg, params, state, *step, moe_chain=moe_chain)
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
            more = {}
            for kernel, label, key in STEP_KERNELS:
                ev = [e for e in ka if key in e.key]
                more[f"{kernel}_ms"] = sum(e.self_device_time_total for e in ev) / iters / 1e3
                more[f"{kernel}_launches"] = sum(e.count for e in ev) / iters
            out[name] = (wall, dev, sum(e.count for e in ka) / iters, more)
            for e in ka[:TOP_OPS]:
                log(f"    {name}: {e.self_device_time_total / iters / 1e3:7.3f} ms in "
                    f"{e.count / iters:5.0f} x {e.key[:90]}")
            for kernel, label, _ in STEP_KERNELS:
                ms = more[f"{kernel}_ms"]
                if more[f"{kernel}_launches"]:
                    log(f"    {name}: {kernel} ({label}) {ms:.3f} ms in "
                        f"{more[f'{kernel}_launches']:.0f} launches, {ms / dev:.1%} of the "
                        "device time")
    return out


def time_synced_ms(fn, iters: int) -> float:
    """Host clock over calls that each end in a synchronize: for a plain
    version that reads back to the host inside the call (K5's picks its
    experts on the host), where the device-sleep timing cannot apply."""
    fn(0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(iters):
        fn(i)
        torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def time_quant_kernels(cfg, params, k3, k4, k5, errs, launches):
    """K3, K4 and K5 at the main path's shapes, each call on the next layer's
    weights so that the weights come from device memory as in a step (eight
    layers of wq_b are 268 MB, beyond the 50 MB L2); bounds from these
    inputs, at the bf16 peak for the operations (the products are of bf16
    values); the plain versions; the library yardsticks: K4 ``torch.matmul``
    on the bf16 weight, K3 ``torch.bmm`` (``bmm_library``), K5
    (``time_grouped``, also at w2 and at skewed routing) one bf16 grouped
    GEMM (``grouped_mm_library``)."""
    from pegainfer_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    layers = params["layers"]
    L, E = len(layers), cfg.n_routed_experts

    # K4 at B = 1 at each shape of a decode step; the record's own numbers
    # are wq_b's (32768 x 1024, the largest decode linear)
    k4_shapes = time_fp8_shapes(layers, k4, gen)
    k4_step_ms = sum(r["launches_a_step"] * r["ms"] for r in k4_shapes.values())
    k4_step_bound = sum(r["launches_a_step"] * r["bound_ms"] for r in k4_shapes.values())
    log(f"  fp8_gemv over a decode step ({fp8_per_decode_step(cfg)} launches at B = 1): "
        f"{k4_step_ms * 1e3:.2f} us against a bound of {k4_step_bound * 1e3:.2f} us")
    wq_b = k4_shapes["wq_b"]

    # K3 at w1 and w2, B = 1 (6 rows, distinct experts) and B = 2 (12 rows, two
    # tokens sharing 3 of their 6 experts); the record's own numbers are w1's
    # at B = 1
    k3_cases = time_fp4_gemv(layers, k3, gen, E)
    k3_main = k3_cases["w1 M=6"]
    k3_step_ms = 2 * L * k3_main["ms"] + L * k3_cases["w2 M=6"]["ms"]
    k3_step_bound = 2 * L * k3_main["bound_ms"] + L * k3_cases["w2 M=6"]["bound_ms"]
    log(f"  moe_fp4_gemv over a decode step at B = 1 ({3 * L} launches): "
        f"{k3_step_ms * 1e3:.2f} us against a bound of {k3_step_bound * 1e3:.2f} us")
    w1 = [lw["experts_w1"] for lw in layers]
    IN2 = w1[0]["q"].shape[2]

    # K5 over a 1,024-token prefill (6,144 routed rows): w1 with spread
    # routing (the record), then w2 and w1 with skewed routing; the plan is
    # built once outside the timed calls, as models/dsv4.py shares it
    M = 6 * DSV4_PROMPT
    x5, tm, e5, seg = grouped_inputs(gen, M, 2 * IN2, E, skew=False)
    k5_ms, k5_bound, k5_by, k5_lib_ms, k5_lib_call, k5_plan_ms = time_grouped(
        k5, "w1", x5, tm, e5, seg, w1, E)
    k5_plain_ms = time_synced_ms(lambda i: k5.moe_fp4_grouped_plain(
        x5, w1[i % L]["q"], w1[i % L]["s"], *seg, tm=tm), 3)
    w2 = [lw["experts_w2"] for lw in layers]
    x5b = torch.randn((x5.shape[0], 2 * w2[0]["q"].shape[2]), generator=gen,
                      device="cuda").to(torch.bfloat16)
    k5_more = {"w2": time_grouped(k5, "w2", x5b, tm, e5, seg, w2, E)}
    del x5b
    x5s, tms, e5s, segs = grouped_inputs(gen, M, 2 * IN2, E, skew=True)
    k5_more["skewed"] = time_grouped(k5, "w1, skewed routing", x5s, tms, e5s, segs, w1, E)
    del x5s, x5

    fp4_src = "pegainfer_tpu/ops/pallas/fp4_gemm.py"
    return [
        {"name": "moe_fp4_gemv", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/fp4_gemv.cu", "replaces": f"{fp4_src}:1139",
         "launches": launches["moe_fp4_gemv"], "max_abs_err": errs["moe_fp4_gemv"],
         "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"], "bound_ms": k3_main["bound_ms"],
         "bound_by": k3_main["bound_by"], "library_ms": k3_main["library_ms"],
         "library_call": k3_main["library_call"], "shapes": k3_cases, "step_ms": k3_step_ms,
         "step_bound_ms": k3_step_bound},
        {"name": "fp8_gemv", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/fp8_gemv.cu", "replaces": f"{fp4_src}:410",
         "launches": launches["fp8_gemv"], "max_abs_err": errs["fp8_gemv"],
         "ms": wq_b["ms"], "plain_ms": wq_b["plain_ms"], "bound_ms": wq_b["bound_ms"],
         "bound_by": wq_b["bound_by"], "library_ms": wq_b["library_ms"],
         "library_call": "torch.matmul (bf16, weight dequantized ahead)", "shapes": k4_shapes,
         "step_ms": k4_step_ms, "step_bound_ms": k4_step_bound},
        {"name": "moe_fp4_grouped", "route": "cuda",
         "source": "pegainfer_tpu_torch/csrc/fp4_grouped.cu", "replaces": f"{fp4_src}:283",
         "launches": launches["moe_fp4_grouped"], "max_abs_err": errs["moe_fp4_grouped"],
         "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound, "bound_by": k5_by,
         "library_ms": k5_lib_ms, "library_call": k5_lib_call, "plan_ms": k5_plan_ms,
         **{name: {"ms": ms, "bound_ms": b, "bound_by": by, "library_ms": lib,
                   "library_call": call, "plan_ms": plan}
            for name, (ms, b, by, lib, call, plan) in k5_more.items()}},
    ]


def time_fp8_shapes(layers, k4, gen):
    """K4 at B = 1 at each shape of a decode step (K4_STEP_KEYS), each call
    on the next of the layers' weights and clones of them, as many as the
    K4 study's copies (twice the L2; wkv's eight layers are 17 MB), so that
    no call finds its weight there; beside its bound, its plain version and
    ``torch.matmul`` on the weight dequantized to bf16 ahead (copies for
    twice the L2 too). Returns {key: record}."""
    from pegainfer_tpu_torch.ops import quant
    from pegainfer_tpu_torch.studies.k4_study import copies

    out = {}
    for key in K4_STEP_KEYS:
        ws = [lw[key] for lw in layers if key in lw]
        n_step = sum(key in lw for lw in layers) * (2 if key == "shared_w1" else 1)
        OUT, IN = ws[0]["q"].shape
        n = len(ws)
        for i in range(n, copies(OUT, IN)):
            ws.append({"q": ws[i % n]["q"].clone(), "s": ws[i % n]["s"]})
        x = torch.randn((1, IN), generator=gen, device="cuda").to(torch.bfloat16)
        saved = k4.launches
        ms = time_ms(lambda i: k4.fp8_gemv(x, ws[i % len(ws)]["q"], ws[i % len(ws)]["s"]), 200)
        k4.launches = saved
        plain_ms = time_ms(lambda i: k4.fp8_gemv_plain(x, ws[i % len(ws)]["q"],
                                                       ws[i % len(ws)]["s"]), 16)
        wd = [quant.dequant_any(w, torch.bfloat16)  # outside the timed call
              for w in ws[:max(2, copies(OUT, IN) // 2)]]
        lib_ms = time_ms(lambda i: torch.matmul(x, wd[i % len(wd)].T), 100)
        del wd
        b, by = bound(OUT * IN + ws[0]["s"].numel() * 2 + IN * 2 + OUT * 4, 2 * OUT * IN)
        out[key] = {"OUT": OUT, "IN": IN, "launches_a_step": n_step, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, "library_ms": lib_ms}
        log(f"  fp8_gemv {key} [{OUT}, {IN}] B = 1: {ms * 1e3:.2f} us ({b / ms:.1%} of "
            f"{b * 1e3:.2f} us), plain {plain_ms * 1e3:.2f} us, torch.matmul "
            f"{lib_ms * 1e3:.2f} us, {n_step} launches a step")
        del ws
        torch.cuda.empty_cache()
    return out


def time_fp4_gemv(layers, k3, gen, E):
    """K3 at w1 and w2 at B = 1 (6 rows, distinct experts) and B = 2 (12 rows
    routed as two tokens sharing 3 of their 6 experts: 9 distinct), x in
    bf16, each call on the next layer's weights and expert ids (the 8
    layers' routed experts, 225 MB at B = 1, come from device memory);
    beside the bound of the distinct experts' bytes, the bf16 ``torch.bmm``
    (``bmm_library``) and, at w1 B = 1, the plain version. Returns {case:
    record}."""
    from pegainfer_tpu_torch.studies import k3_study as k3s

    L = len(layers)
    perm = torch.randperm(E, generator=gen, device="cuda")
    out = {}
    for key, M, routing in (("w1", 6, "distinct"), ("w2", 6, "distinct"),
                            ("w1", 12, "shared"), ("w2", 12, "shared")):
        ws = [lw[f"experts_{key}"] for lw in layers]
        _, OUT, IN2 = ws[0]["q"].shape
        S = ws[0]["s"].shape[2]
        x = torch.randn((M, 2 * IN2), generator=gen, device="cuda").to(torch.bfloat16)
        idxs = [k3s.route(routing, M, E, perm, i) for i in range(L)]
        saved = k3.launches
        ms = time_ms(lambda i: k3.moe_fp4_gemv(x, ws[i % L]["q"], ws[i % L]["s"],
                                               idxs[i % L]), 200)
        k3.launches = saved
        n = k3s.distinct(routing, M)
        b, by = bound(n * (OUT * IN2 + OUT * S * 2) + x.numel() * 2 + M * OUT * 4,
                      2 * M * OUT * 2 * IN2)
        lib_ms, lib_call = bmm_library(k3, x, ws, idxs)
        name = f"{key} M={M}{' shared' if routing == 'shared' else ''}"
        out[name] = {"OUT": OUT, "IN": 2 * IN2, "M": M, "routing": routing, "experts": n,
                     "ms": ms, "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
                     "library_call": lib_call, "launches_a_step": (2 if key == "w1" else 1) * L}
        if name == "w1 M=6":
            out[name]["plain_ms"] = time_ms(lambda i: k3.moe_fp4_gemv_plain(
                x, ws[i % L]["q"], ws[i % L]["s"], idxs[i % L]), 16)
        log(f"  moe_fp4_gemv {name} ({n} experts): {ms * 1e3:.2f} us ({b / ms:.1%} of "
            f"{b * 1e3:.2f} us), torch.bmm "
            f"{'none' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}")
    return out


def bmm_library(k3, xs, ws, idxs):
    """K3's library yardstick: the device time of one ``torch.bmm`` of the
    routed experts of ``ws``, gathered and dequantized to bf16 outside the
    timed call (two layers, alternated, so the 100 MB of one call at 6 rows
    come from device memory), with x cast to bf16; held against K3's output
    at GROUPED_RTOL x max |y| (the call rounds its products and output to
    bf16, which QUANT_GEMV_TOL does not allow for). Returns (ms, what was
    called), or (None, "none: why")."""
    from pegainfer_tpu_torch.ops import quant

    saved = k3.launches
    ref = k3.moe_fp4_gemv(xs, ws[0]["q"], ws[0]["s"], idxs[0])
    k3.launches = saved
    wg = [quant.gather_dequant(ws[i], idxs[i].long(), torch.bfloat16) for i in range(2)]
    xb = xs.to(torch.bfloat16)[:, :, None]
    y = torch.bmm(wg[0], xb)[:, :, 0]
    err = (y.float() - ref).abs().max().item()
    tol = GROUPED_RTOL * ref.abs().max().item()
    if not err <= tol:
        log(f"  K3 library: torch.bmm disagrees with K3 by {err:.4g} (tol {tol:.4g})")
        return None, "none: torch.bmm disagrees with K3"
    ms = time_ms(lambda i: torch.bmm(wg[i % 2], xb), 100)
    log(f"  K3 library: torch.bmm on {xs.shape[0]} gathered bf16 experts: {ms * 1e3:.2f} us "
        f"(max |diff| to K3 {err:.4g}, tol {tol:.4g})")
    return ms, "torch.bmm"


if __name__ == "__main__":
    sys.exit(main())
