"""Weight-stream study on the H100: how fast can a kernel read bf16 weights,
and how close does a GEMV over the same stream come?

The H100 counterpart of ``scripts/gemv_stream_study.py`` (a TPU script).
For each shape, W [N, K] bf16 and x [1, K] are made as that script makes
them (``np.random.default_rng(0)``, scale 0.05), then timed on the card:

- ``stream_sum`` (sum(W) + s) in its two forms: ``bulk``, a ring of 1-D
  bulk copies in shared memory over a sweep of bytes a stage, stages and
  blocks an SM; ``ldg``, 16-byte loads in flight a thread, over a sweep
  of loads a thread and blocks an SM;
- ``gemv`` (y = x · Wᵀ + s) over the same rings;
- the yardsticks: ``torch.sum(W, dtype=torch.float32)``, and a GEMV by
  ``torch.mm(..., out_dtype=torch.float32)`` in the two layouts the TPU
  script times, x @ W.T on [N, K] and x @ W2 on the engine's [K, N].

Each call reads the next of enough copies of W to exceed twice the 50 MB L2,
so every byte comes from device memory. Each kernel's best configuration
is timed RETIMES times more; the **read ceiling** is the highest median of
those re-timings of a stream_sum form over the shapes larger than L2,
printed with their range. It is what ``chip_smoke.py`` divides the GEMV
kernels' bytes by for their measured bound. Times are device times by CUDA
events, with the card's name and power limit printed first.

    python -m pegainfer_tpu_torch.studies.gemv_stream_study          (on the card)
    python -m pegainfer_tpu_torch.studies.gemv_stream_study --check  (kernel checks)
    python -m pegainfer_tpu_torch.studies.gemv_stream_study --cpu    (plain versions)

``--check`` prints ``check``'s table (the checks of ``chip_smoke.py``'s
phase [2a]) as JSON and exits 1 if one fails; ``--cpu`` runs the plain
versions at the TPU script's ``--interpret`` size, (1024, 256), and times
nothing.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys

import numpy as np
import torch

from pegainfer_tpu_torch.ops.cuda import gemv_stream as gs
from pegainfer_tpu_torch.studies.timing import card_line, device_ms

SHAPES = ((19456, 2560), (151936, 2560), (6144, 2560))  # gate_up-, lm_head-, qkv-like
CPU_SHAPES = ((1024, 256),)
# the checks: the three shapes, a ragged N (its last chunk short: not a
# multiple of a stage's rows x blocks) and a ragged K; a stack of 3 layers
CHECK_SHAPES = SHAPES + ((19461, 2560), (1000, 264))
CHECK_STACK = (3, 19461, 2560)
# a sum or a GEMV of bf16 weights forms exact f32 products (bf16 x bf16),
# summed in another order than the plain versions': gemv and layer_gemv to
# EXACT_RTOL of max |y|, stream_sum to SUM_RTOL of sum_limit's scale
EXACT_RTOL = 1e-5
SUM_RTOL = 1e-5
RETIMES = 5  # re-timings of each kernel's best configuration
L2_BYTES = 50 * 10**6
SM_SMEM = 233472  # shared memory of an SM (228 KB)
BLOCK_RESERVED = 1024  # the system's shared memory a block
RINGS = tuple(gs.Ring(b, s, n) for b in (20480, 40960, 81920) for s in (2, 4, 8)
              for n in (1, 2))
LDGS = tuple(gs.Ldg(u, n) for u in (2, 4, 8) for n in (2, 4, 8))


def bf16(a: np.ndarray) -> torch.Tensor:
    """A host array as a bf16 CPU tensor: to f32, then rounded to nearest
    even, as ``jnp.asarray(a, jnp.bfloat16)`` rounds it."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def inputs(N: int, K: int, device) -> tuple:
    """W [N, K], x [1, K] bf16 as the TPU script makes them, and s = 0."""
    rng = np.random.default_rng(0)
    W = bf16(rng.standard_normal((N, K)) * 0.05).to(device)
    x = bf16(rng.standard_normal((1, K)) * 0.05).to(device)
    return W, x, torch.zeros((1, 1), dtype=torch.float32, device=device)


def fits(K: int, ring: gs.Ring) -> bool:
    """Whether ``ring.blocks_per_sm`` GEMV blocks fit on an SM together."""
    block = gs.ring_smem(K, ring, gemv=True) + 128 + BLOCK_RESERVED
    return gs.ring_smem(K, ring, True) <= gs.MAX_SMEM and ring.blocks_per_sm * block <= SM_SMEM


def copies_for(nbytes: int) -> int:
    """Copies of a tensor of ``nbytes`` whose round robin exceeds 2 x L2."""
    return 2 * L2_BYTES // nbytes + 1


LIBRARY_GEMV = "torch.mm(out_dtype=float32)"


def library_gemv(a, b):
    """torch's GEMV with an f32 output, as the kernel's."""
    return torch.mm(a, b, out_dtype=torch.float32)


def study_shape(W, x, s, rings=RINGS, ldgs=LDGS) -> dict:
    """Time every ring and ldg form, and the yardsticks, on W [N, K] and
    copies of it; then re-time the best configuration of each kernel
    RETIMES times. Returns the shape's rows and, a kernel, its best
    configuration with the median (and the range) of those re-timings."""
    N, K = W.shape
    nbytes = N * K * 2
    n = copies_for(nbytes)
    ws = [W] + [W.clone() for _ in range(n - 1)]
    iters = max(10, min(100, int(2e9 // nbytes)))
    rows, fns = [], {}

    def timed(kind, cfg, fn):
        ms = device_ms(fn, iters)
        rows.append({"kind": kind, "cfg": cfg, "ms": ms, "bytes_per_s": nbytes / ms * 1e3})
        fns[(kind, cfg)] = fn
        print(f"  {kind:16s} {cfg:34s} {ms * 1e3:9.2f} us  {nbytes / ms / 1e6:7.1f} GB/s",
              flush=True)

    for ring in rings:
        if not fits(K, ring):
            continue
        cfg = f"{ring.stage_bytes} B x {ring.stages} x {ring.blocks_per_sm}/SM"
        timed("stream_sum bulk", cfg, lambda i, r=ring: gs.stream_sum(ws[i % n], s, "bulk", r))
        timed("gemv", cfg, lambda i, r=ring: gs.gemv(x, ws[i % n], s, r))
    for ldg in ldgs:
        cfg = f"{ldg.unroll} loads x {ldg.blocks_per_sm}/SM"
        timed("stream_sum ldg", cfg, lambda i, c=ldg: gs.stream_sum(ws[i % n], s, "ldg", c))
    timed("torch.sum", "dtype=float32", lambda i: torch.sum(ws[i % n], dtype=torch.float32))
    timed("torch gemv [N,K]", LIBRARY_GEMV, lambda i: library_gemv(x, ws[i % n].T))

    def best(kind):
        r = min((r for r in rows if r["kind"] == kind), key=lambda r: r["ms"])
        ms = sorted(device_ms(fns[(kind, r["cfg"])], iters) for _ in range(RETIMES))
        med = statistics.median(ms)
        print(f"  {kind:16s} {r['cfg']:34s} re-timed {RETIMES}x: median {med * 1e3:.2f} us "
              f"({ms[0] * 1e3:.2f}-{ms[-1] * 1e3:.2f})", flush=True)
        return {"cfg": r["cfg"], "ms": med, "bytes_per_s": nbytes / med * 1e3,
                "retimed_ms": ms, "sweep_ms": r["ms"]}

    best_of = {k: best(k) for k in ("stream_sum bulk", "stream_sum ldg", "gemv")}
    fns.clear()  # their copies of W go with them
    del ws
    w2s = [W.T.contiguous() for _ in range(n)]  # the engine's [K, N] layout
    timed("torch gemv [K,N]", LIBRARY_GEMV, lambda i: library_gemv(x, w2s[i % n]))
    del w2s
    return {"N": N, "K": K, "bytes": nbytes, "copies": n, "rows": rows, "best": best_of,
            "library_call": LIBRARY_GEMV}


def read_ceiling(results) -> dict:
    """The read ceiling: of the stream_sum forms (bulk, ldg) on the shapes
    above L2, the highest median rate of a best configuration's re-timings;
    with the range of those re-timings and where it was read."""
    cands = [(r, k) for r in results if r["bytes"] > L2_BYTES
             for k in ("stream_sum bulk", "stream_sum ldg")]
    r, kind = max(cands, key=lambda c: c[0]["best"][c[1]]["bytes_per_s"])
    b, nbytes = r["best"][kind], r["bytes"]
    return {"bytes_per_s": b["bytes_per_s"],
            "min_bytes_per_s": nbytes / b["retimed_ms"][-1] * 1e3,
            "max_bytes_per_s": nbytes / b["retimed_ms"][0] * 1e3, "N": r["N"], "K": r["K"],
            "kind": kind, "cfg": b["cfg"], "retimes": len(b["retimed_ms"])}


def sum_limit(W) -> float:
    """stream_sum's limit against its plain version: SUM_RTOL x sqrt(N K) x
    max |W|. A random-signed sum of N K weights of size up to max |W|
    reaches about sqrt(N K) max |W|; f32 rounding in another order of
    partials moves it by about 1e-7 of that (at most 2.4e-4 on an H100 at
    (151936, 2560) and scale 0.05, against a limit of 0.060), while one
    dropped row of K weights moves it by about sqrt(K) times their size
    (2.5 at K 2560)."""
    return SUM_RTOL * math.sqrt(W.numel()) * W.float().abs().max().item()


def check(device="cuda", seed=0, shapes=CHECK_SHAPES, stack_shape=CHECK_STACK) -> list:
    """The kernels against their plain versions (``chip_smoke.py``'s phase
    [2a]): stream_sum in both forms (to ``sum_limit``) and gemv (to
    EXACT_RTOL of max |y|) at ``shapes``, W of scale 0.05; layer_gemv on
    every layer of a stack of ``stack_shape``, scale 1/sqrt(K). Inputs from
    a torch generator on ``device``. Returns rows (name, err, limit), each
    name starting with its kernel's key in ``gs.launches``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []

    def row(name, got, ref, limit):
        rows.append((name, (got - ref).abs().max().item(), limit))

    for N, K in shapes:
        W = (torch.randn((N, K), generator=gen, device=device) * 0.05).to(torch.bfloat16)
        x = (torch.randn((1, K), generator=gen, device=device) * 0.05).to(torch.bfloat16)
        s = torch.randn((1, 1), generator=gen, device=device)
        ref, limit = gs.stream_sum_plain(W, s), sum_limit(W)
        for mode in ("bulk", "ldg"):
            row(f"stream_sum_{mode} [{N}, {K}]", gs.stream_sum(W, s, mode), ref, limit)
        ref = gs.gemv_plain(x, W, s)
        row(f"gemv [{N}, {K}]", gs.gemv(x, W, s), ref, EXACT_RTOL * ref.abs().max().item())
        del W
    L, N, K = stack_shape
    stack = (torch.randn(stack_shape, generator=gen, device=device) / K ** 0.5).to(
        torch.bfloat16)
    x = torch.randn((1, K), generator=gen, device=device).to(torch.bfloat16)
    for l in range(L):
        ref = gs.layer_gemv_plain(x, stack, l)
        row(f"layer_gemv [{L}, {N}, {K}] layer {l}", gs.layer_gemv(x, stack, l), ref,
            EXACT_RTOL * ref.abs().max().item())
    return rows


def run_cpu(shapes=CPU_SHAPES) -> list:
    """The plain versions through the wrappers on CPU tensors; nothing timed."""
    out = []
    for N, K in shapes:
        W, x, s = inputs(N, K, "cpu")
        total = gs.stream_sum(W, s)
        y = gs.gemv(x, W, s)
        ref = (x.double() @ W.double().T).float()
        out.append({"N": N, "K": K, "sum": float(total), "sum_abs": float(W.float().abs().sum()),
                    "gemv_relerr": float((y - ref).abs().max() / ref.abs().max())})
        print(f"W [{N}, {K}] (cpu, plain versions): sum {float(total):.6f}, gemv relerr "
              f"against f64 {out[-1]['gemv_relerr']:.2e}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="plain versions at (1024, 256)")
    ap.add_argument("--check", action="store_true", help="the kernel checks only, as JSON")
    args = ap.parse_args(argv)
    if args.cpu:
        print(json.dumps({"cpu": run_cpu()}))
        return 0
    if not torch.cuda.is_available():
        print("gemv_stream_study: no CUDA device (use --cpu for the plain versions)",
              file=sys.stderr)
        return 2
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.check:
        rows = check()
        print(json.dumps({"card": card, "checks": rows}))
        return 0 if all(err <= lim for _, err, lim in rows) else 1
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    results = []
    for N, K in SHAPES:
        W, x, s = inputs(N, K, "cuda")
        print(f"== W [{N}, {K}] bf16 = {N * K * 2 / 1e6:.1f} MB, "
              f"{copies_for(N * K * 2)} copies", flush=True)
        results.append(study_shape(W, x, s))
        del W
        torch.cuda.empty_cache()
    ceiling = read_ceiling(results)
    print(f"read ceiling: {ceiling['bytes_per_s'] / 1e12:.4f} TB/s (re-timings "
          f"{ceiling['min_bytes_per_s'] / 1e12:.4f}-{ceiling['max_bytes_per_s'] / 1e12:.4f})",
          flush=True)
    print(json.dumps({"card": card, "read_ceiling": ceiling,
                      "shapes": [{k: v for k, v in r.items() if k != "rows"} for r in results]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
