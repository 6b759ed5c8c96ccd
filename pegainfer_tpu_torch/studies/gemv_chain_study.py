"""Decode-skeleton study on the H100: what does a layer boundary cost?

The H100 counterpart of ``scripts/gemv_chain_study.py`` (a TPU script). One
chain of L dependent bf16 GEMVs, y_l = x_l · stack[l]ᵀ and x_{l+1} =
bf16(y_l[:, :K]), over a stack [L, N, K] of Qwen3-4B's gate_up shape (L 36,
N 19456, K 2560: 3.59 GB), made as the TPU script makes it
(``np.random.default_rng(0)``, scale 1/sqrt(K), x unit normal). Five forms:

- (a) ``eager``: torch's GEMV (``torch.mm``, f32 out by ``out_dtype``)
  and a cast to bf16, 36 times from Python;
- (b) ``graph``: (a) captured once in a ``torch.cuda.CUDAGraph``, replayed;
- (c) ``layer_gemv``: 36 launches of the port's ``layer_gemv`` kernel
  (``csrc/gemv_stream.cu``) and the cast, from Python;
- (d) ``layer_gemv graph``: (c) captured in a graph;
- (e) ``gemv_chain``: one persistent kernel (``csrc/gemv_chain.cu``).

Each is timed twice: device time by CUDA events (a device sleep ahead of
the start event hides the host's enqueue), and wall time a chain on the
host clock around the enqueue and a ``synchronize``, with its spread. Every
form's output is held against the f64 plain chain within ``drift_limit``.

    python -m pegainfer_tpu_torch.studies.gemv_chain_study [--layers 36]   (on the card)
    python -m pegainfer_tpu_torch.studies.gemv_chain_study --check         (kernel checks)
    python -m pegainfer_tpu_torch.studies.gemv_chain_study --cpu           (plain versions)

``--check`` prints ``check``'s table (the checks of ``chip_smoke.py``'s
phase [2b]) on a stack made on the card from a seed, as JSON, and exits 1
if one fails; ``--cpu`` runs the plain versions at the TPU script's
``--interpret`` size, L 3, N 512, K 256, and times nothing.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from pegainfer_tpu_torch.ops.cuda import gemv_chain as gc
from pegainfer_tpu_torch.ops.cuda import gemv_stream as gs
from pegainfer_tpu_torch.studies.gemv_stream_study import EXACT_RTOL, bf16, library_gemv
from pegainfer_tpu_torch.studies.timing import card_line, device_ms, wall_ms

L_FULL, N_FULL, K_FULL = 36, 19456, 2560
L_CPU, N_CPU, K_CPU = 3, 512, 256
# a whole chain against the f64 plain chain: a difference in f32 sum order
# moves an element of x_{l+1} across a bf16 rounding boundary now and then
# (about one element in two layers at K 2560: the sums differ by about 1e-6,
# a bf16 ulp of a unit value is 8e-3), which then rides the chain. The limit
# is twice the largest such drift of two f32 plain chains (the products in
# one sum, and in two halves of K) from the f64 one; and since at a few
# layers those two may happen to flip nothing, at least FLIPS flips at the
# last layer's input, each a bf16 ulp of the largest |x| times the largest
# |w| of that layer
DRIFT_FACTOR = 2.0
FLIPS = 4


def inputs(L: int, N: int, K: int, device) -> tuple:
    """stack [L, N, K] and x [1, K] bf16 as the TPU script makes them, the
    stack a layer at a time (the generator's stream is the same)."""
    rng = np.random.default_rng(0)
    stack = torch.empty((L, N, K), dtype=torch.bfloat16, device=device)
    for l in range(L):
        stack[l] = bf16(rng.standard_normal((N, K)) * (1.0 / np.sqrt(K))).to(device)
    x = bf16(rng.standard_normal((1, K))).to(device)
    return x, stack


def card_inputs(L: int, N: int, K: int, seed: int = 0) -> tuple:
    """The same distributions made on the card from a torch seed (fast)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    stack = torch.empty((L, N, K), dtype=torch.bfloat16, device="cuda")
    for l in range(L):
        stack[l] = torch.randn((N, K), generator=gen, device="cuda") / K ** 0.5
    x = torch.randn((1, K), generator=gen, device="cuda").to(torch.bfloat16)
    return x, stack


def _chain_halves(x, stack):
    """The plain chain with each product summed in f32 in two halves of K."""
    K = stack.shape[2]
    h = K // 2
    for l in range(stack.shape[0]):
        w = stack[l].float()
        xf = x.float()
        y = xf[:, :h] @ w[:, :h].T + xf[:, h:] @ w[:, h:].T
        x = y[:, :K].to(torch.bfloat16)
    return y


def drift_limit(x, stack):
    """(the f64 plain chain, its limit): DRIFT_FACTOR x the larger drift of
    the two f32 plain chains from it, at least FLIPS flips at the last
    layer's input and EXACT_RTOL of its max |y|."""
    L, _, K = stack.shape
    p64 = gc.gemv_chain_plain(x, stack, torch.float64)
    drift = max((gc.gemv_chain_plain(x, stack) - p64).abs().max().item(),
                (_chain_halves(x, stack) - p64).abs().max().item())
    flip = 0.0
    if L > 1:
        top = gc.gemv_chain_plain(x, stack[: L - 1], torch.float64)[:, :K].abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)  # bf16 keeps 8 significant bits
        flip = ulp * stack[L - 1].abs().max().item()
    return p64, max(DRIFT_FACTOR * drift, FLIPS * flip, EXACT_RTOL * p64.abs().max().item())


def check(x, stack, ring=None) -> list:
    """The kernel against the plain chain. Returns rows (name, err, limit):

    - ``L 1``: one layer, to EXACT_RTOL of max |y|;
    - ``layer l, the kernel's x``: the kernel's chain of l + 1 layers
      against one plain layer on bf16 of the kernel's own chain of l layers
      (the kernel sums each row in the same order whatever the chain's
      length, so this is the exact-product limit for every layer, its
      restage and its rounding);
    - ``L n whole``: chains of 2 and of L layers against the f64 plain
      chain, within ``drift_limit``;
    - where N > K, ``square`` and the rows above for a chain of the first
      K rows of at most 4 layers: there every block's last chunk feeds the
      next x, so a restage that does not wait for the grid reads rows that
      are not written yet (with N > K the rows of x come from every block's
      first chunks, long done).
    """
    L, N, K = stack.shape
    rows = _check(x, stack, ring)
    if N > K:
        square = stack[: min(L, 4), :K].contiguous()
        rows += [("square " + n, e, lim) for n, e, lim in _check(x, square, ring)]
    return rows


def _check(x, stack, ring):
    L, _, K = stack.shape
    rows = []
    prev = None
    for l in range(L):
        y = gc.gemv_chain(x, stack[: l + 1], ring)
        xin = x if prev is None else prev[:, :K].to(torch.bfloat16)
        ref = gs.layer_gemv_plain(xin, stack, l)
        name = "L 1" if l == 0 else f"layer {l}, the kernel's x"
        rows.append((name, (y - ref).abs().max().item(), EXACT_RTOL * ref.abs().max().item()))
        prev = y
    for n in sorted({min(2, L), L}):
        p64, lim = drift_limit(x, stack[:n])
        y = gc.gemv_chain(x, stack[:n], ring)
        rows.append((f"L {n} whole", (y - p64).abs().max().item(), lim))
    return rows


def forms(x, stack) -> dict:
    """The five forms, each a function of the call index that runs one
    chain and returns its last y [1, N] f32."""
    L, _, K = stack.shape
    def eager(_i=0, x=x):
        for l in range(L):
            y = library_gemv(x, stack[l].T)
            x = y[:, :K].to(torch.bfloat16)
        return y.float()

    def kernels(_i=0, x=x):
        for l in range(L):
            y = gs.layer_gemv(x, stack, l)
            x = y[:, :K].to(torch.bfloat16)
        return y

    return {"eager": eager, "graph": _graph(eager), "layer_gemv": kernels,
            "layer_gemv graph": _graph(kernels),
            "gemv_chain": lambda _i=0: gc.gemv_chain(x, stack)}


def _graph(fn):
    """``fn`` captured once in a CUDA graph (after warm-up calls on a side
    stream, which also load the kernels); the returned function replays it
    and returns the graph's output tensor."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()

    def replay(_i=0):
        g.replay()
        return out
    replay.graph = g  # keeps the graph (and its memory) alive with the function
    return replay


def time_forms(x, stack, reps: int = 20) -> dict:
    """Device and wall time of each form; every output checked first."""
    fs = forms(x, stack)
    p64, lim = drift_limit(x, stack)
    out = {}
    for name, fn in fs.items():
        err = (fn() - p64).abs().max().item()
        if not err <= lim:
            raise RuntimeError(f"chain form {name}: max |y - f64 plain| {err:.3e} above {lim:.3e}")
        dev = device_ms(fn, iters=4)
        wall = wall_ms(fn, reps)
        out[name] = {"device_ms": dev, "wall_ms": wall, "max_abs_err": err, "limit": lim}
        print(f"  {name:17s} device {dev:.4f} ms, wall median {wall['median']:.4f} ms "
              f"(q1 {wall['q1']:.4f}, q3 {wall['q3']:.4f}, {wall['min']:.4f}-{wall['max']:.4f}, "
              f"{reps} reps); max |y - f64| {err:.2e} of {lim:.2e}", flush=True)
    return out


RINGS = tuple(gs.Stages(b, s) for b in (20480, 40960, 81920) for s in (2, 4))


def time_rings(x, stack, rings=RINGS) -> list:
    """Device time of gemv_chain over rings of bytes a stage and stages (the
    grid is what the occupancy query allows for each)."""
    out = []
    for ring in rings:
        if gs.ring_smem(stack.shape[2], ring, gemv=True) > gs.MAX_SMEM:
            continue
        ms = device_ms(lambda i, r=ring: gc.gemv_chain(x, stack, r), iters=5)
        out.append({"stage_bytes": ring.stage_bytes, "stages": ring.stages, "ms": ms})
        print(f"  gemv_chain {ring.stage_bytes} B x {ring.stages}: {ms:.4f} ms", flush=True)
    return out


def run_cpu() -> dict:
    """The plain versions at the TPU script's --interpret size; nothing timed."""
    x, stack = inputs(L_CPU, N_CPU, K_CPU, "cpu")
    rows = check(x, stack)
    for name, err, lim in rows:
        print(f"  {name:28s} {err:.3e} of {lim:.3e}", flush=True)
    return {"L": L_CPU, "N": N_CPU, "K": K_CPU, "checks": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="plain versions at L 3, N 512, K 256")
    ap.add_argument("--check", action="store_true", help="the kernel checks only, as JSON")
    ap.add_argument("--layers", type=int, default=L_FULL)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if args.cpu:
        print(json.dumps({"cpu": run_cpu()}))
        return 0
    if not torch.cuda.is_available():
        print("gemv_chain_study: no CUDA device (use --cpu for the plain versions)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    if args.check:
        rows = check(*card_inputs(args.layers, N_FULL, K_FULL))
        print(json.dumps({"card": card, "checks": rows}))
        return 0 if all(err <= lim for _, err, lim in rows) else 1
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    x, stack = inputs(args.layers, N_FULL, K_FULL, "cuda")
    nbytes = stack.numel() * 2
    print(f"stack [{args.layers}, {N_FULL}, {K_FULL}] = {nbytes / 1e9:.3f} GB; bound "
          f"{nbytes / 3.35e12 * 1e3:.4f} ms at 3.35 TB/s", flush=True)
    rows = check(x, stack)
    bad = [r for r in rows if not r[1] <= r[2]]
    print(f"checks: {len(rows) - len(bad)} of {len(rows)} within their limits", flush=True)
    result = time_forms(x, stack, args.reps)
    rings = time_rings(x, stack)
    print(json.dumps({"card": card, "L": args.layers, "bytes": nbytes, "forms": result,
                      "rings": rings, "failed_checks": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
