"""int8 linear study on the H100: the kernel of the int8 weight-only linears'
decode rows (``csrc/int8_linear.cu``) at the launches of a Qwen3-4B and a
Qwen3.5 decode step, beside what it replaced, and which of its parts costs.

    python -m pegainfer_tpu_torch.studies.int8_linear_study [--variants] [--sweep] [--out FILE]
    python -m pegainfer_tpu_torch.studies.int8_linear_study --mutants [--out FILE]
    python -m pegainfer_tpu_torch.studies.int8_linear_study --cpu

A decode step's int8 launches (``STEP_LAUNCHES``): Qwen3-4B's 145 (a layer's
wq / wk / wv in one launch, wo, w_gate_up, w_down, x 36, and the head) and
the Qwen3.5 ``bench_config()`` hybrid's 129 (a GDN layer's wq / wk / wv / wz
in one launch x 24, a full layer's wq / wgate / wk / wv x 8, out_proj / wo,
mlp_gate_up, mlp_down x 32, and the head), on random int8 stacks made on the
card with enough layers for twice the L2 (a timed call's weights come from
device memory, as in a decode step). At each of ``ROWS`` (the decode batch
buckets) each launch is held row by row to its plain version (y NaN-filled
first; bf16 within one ulp of the row's max, as ``row_err``), then these
forms are timed by CUDA events in turns, the layer rotated every call:

- ``kernel``: ``int8_linear``, one launch for the launch's weights, the
  scale and the cast in its epilogue;
- ``K6 + scale + cast``: K6 at one expert (``int8_gemv_dense``) weight by
  weight, then ``(y * s).to(bfloat16)``, the route it replaced;
- ``bf16 matmul``: ``x @ w`` on the bf16 weights (the bf16 mode's cost);
- ``JAX form``: ``quant.int8_mm`` (the codes made bf16, one product with
  f32 sums), then the scale and the cast;
- ``library``: ``torch._weight_int8pack_mm`` (codes, bf16 scales), where
  this torch runs it on the card;
- ``plain``: ``int8_linear_plain``.

Each stands beside the launch's bound: its codes, scales, x and y once over
the nominal 3.35 TB/s and over the measured read ceiling (``READ_CEILING``,
``gemv_stream_study``), and its products over 989 TFLOP/s. Then each form's
sum of launches x time over a step, by row count, and the gates: the
kernel's step below the K6 route's and below bf16 ``matmul``'s, and within
twice its measured bound.

``--variants`` adds copies of the source with a part taken out or a
constant changed (``studies/variants.py``, built into
``build/int8_linear_study/``), timed in turns at each launch and row count
with the production plan: ``loads-only`` (the codes copied through the
ring and read, XORed into the sums: no convert, no x, no products),
``no-mma`` (the convert and the x loads kept, the products an XOR),
``one-set`` (one set of accumulators at 1-16 rows, not two),
``stages-3`` / ``-4`` (the ring's depth, 2 in the source),
``one-block-64`` (registers for one block of 8 warps an SM at 64 rows,
not two), ``mma-sync-form`` (the warps' mma.sync form past 16 rows too, at
the warpgroup form's plan), and of the warpgroup form: ``wg-no-products``
(its wgmma taken out), ``wg-loads-only`` (its convert too), ``wg-no-x`` (no
copies of x: its rows stale), ``wg-no-overlap`` (each step's products
waited for before the next step, not left in flight). ``--sweep`` times the
kernel at every plan of 2, 4 or 8 warps a block at each launch and row
count, beside ``plan``'s.

``--mutants`` plants four faults, each in its own copy of the source, and
runs ``check`` through the wrapper on each: a dropped K part of the first
block, the last 16-channel tile never written, the last n8 group of rows
dropped, the last weight of a group skipped. It reports, for each, the cases
it fails and by what factor.

``--cpu`` prints the plans of the step's launches and runs the
plain version through the wrapper on CPU tensors against numpy at a small
size; it times nothing. Without a card and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
from pegainfer_tpu_torch.ops.cuda import int8_linear as il
from pegainfer_tpu_torch.studies.expert_stream_study import READ_CEILING
from pegainfer_tpu_torch.studies.k3_study import L2_BYTES
from pegainfer_tpu_torch.studies.timing import card_line, device_ms
from pegainfer_tpu_torch.studies.variants import compile_variants, in_turns, substitute

OUT_DIR = build.BUILD_DIR / "int8_linear_study"
SOURCE = build.CSRC_DIR / "int8_linear.cu"
# the kernel forms the plain version's exact f32 products and sums them in
# another order: f32 outputs each row to 1e-5 of its max |ref| (K6's
# INT8_GEMV_RTOL); a bf16 output is such a sum times s rounded once, so an
# element whose two sums straddle a rounding boundary lands one bf16 ulp
# away: each row to one ulp of its max |ref| (``row_err``)
RTOL = 1e-5
ROWS = (1, 2, 4, 8, 16, 32, 64)  # the decode batch buckets
CALLS = 60  # timed calls a timing
NOMINAL_BPS = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)

# (name, OUT of each weight, IN, launches a decode step) by family
STEP_LAUNCHES = {
    "qwen3": (("qwen3 wq / wk / wv", (4096, 1024, 1024), 2560, 36),
              ("qwen3 wo", (2560,), 4096, 36),
              ("qwen3 w_gate_up", (19456,), 2560, 36),
              ("qwen3 w_down", (2560,), 9728, 36),
              ("qwen3 lm_head", (151936,), 2560, 1)),
    "qwen35": (("qwen35 gdn wq / wk / wv / wz", (2048, 2048, 4096, 4096), 2048, 24),
               ("qwen35 full wq / wgate / wk / wv", (4096, 4096, 512, 512), 2048, 8),
               ("qwen35 out_proj / wo", (2048,), 4096, 32),
               ("qwen35 mlp_gate_up", (12288,), 2048, 32),
               ("qwen35 mlp_down", (2048,), 6144, 32),
               ("qwen35 lm_head", (151936,), 2048, 1)),
}
FORMS = ("kernel", "K6 + scale + cast", "bf16 matmul", "JAX form", "library", "plain")
TP_ROWS = (1, 8, 16, 64)  # rows of the shard-shape cases


# the launches whose weights a rank cuts on their inputs (their partial sums
# kept f32 by the f32-output epilogue and reduced across the ranks)
ROW_PARALLEL = ("qwen3 wo", "qwen3 w_down", "qwen35 out_proj / wo", "qwen35 mlp_down")
TP_WIDTHS = {"qwen3": (2, 4), "qwen35": (2,)}  # the widths the family's heads divide


def tp_launches(tp: int, family: str = "qwen3"):
    """``STEP_LAUNCHES[family]`` on one rank of a tensor-parallel engine at
    width ``tp`` (``parallel/sharding.py``: Qwen3's wq / wk / wv and
    w_gate_up, the hybrid's GDN and full-layer groups and mlp_gate_up cut
    on their outputs; ``ROW_PARALLEL`` on their inputs, their partial sums
    kept f32 by the f32-output epilogue; the head on the vocab): (name, OUT
    of each weight, IN, launches a decode step, f32_out)."""
    out = []
    for name, outs, IN, per_step in STEP_LAUNCHES[family]:
        label = name.replace(f"{family} ", f"{family} tp{tp} ", 1)
        if name in ROW_PARALLEL:
            out.append((label, outs, IN // tp, per_step, True))
        else:
            out.append((label, tuple(o // tp for o in outs), IN, per_step, False))
    return tuple(out)


LIBRARY_CALL = "torch._weight_int8pack_mm"

# text of csrc/int8_linear.cu the variants and the mutants replace
C_STAGES = "constexpr int kStages = 2;"
C_BLOCKS = "__host__ __device__ constexpr int min_blocks(int G) { return G >= 4 ? 2 : 3; }"
C_CONVERT = ("        s8x4_to_bf16x2(word(c0, k), af[k][0], af[k][2]);\n"
             "        s8x4_to_bf16x2(word(c1, k), af[k][1], af[k][3]);\n")
C_MMA = ("            mma_bf16(acc[k % kSets][n0 + n], af[k], word(xw[n][k >> 1], 2 * (k & 1)),\n"
         "                     word(xw[n][k >> 1], 2 * (k & 1) + 1));\n")
C_LD = "          const bool ld = xv[n0 + n] && in;\n"
C_STEPS = "  const int steps = o0 < OUT && nsteps > kp ?"
C_STORE = "    if (o >= OUT) continue;\n"
C_FIRST = "  const int lb = blockIdx.x - first;  // the block within its weight\n"
# the warpgroup form's (past 16 rows)
W_STEPS = "  const int steps = o_blk < OUT && nsteps > kp ?"
W_STORE = "    if (o >= OUT) continue;  // a channel past the weight\n"
W_FIRST = "  const int o_blk = lb * 64;  // the block's 64 channels\n"
W_XCOPY = "      for (int i = wt; i < M * 16; i += 128) {\n"
W_MMA = "    Wg<N>::rs(acc, af[kk], sw128_desc(xs + (kk >> 2) * slab + (kk & 3) * 32, 16, 1024));\n"
C_WG_FROM = "constexpr int kWgFromGroups = 4;"
W_CONVERT = (
    "    s8x4_to_bf16x2(prmt(t & 2 ? v0.y : v0.x, t & 2 ? v0.w : v0.z, sel), af[kk][0], af[kk][2]);\n"
    "    s8x4_to_bf16x2(prmt(t & 2 ? v1.y : v1.x, t & 2 ? v1.w : v1.z, sel), af[kk][1], af[kk][3]);\n")
W_XOR = "    acc[kk] += __uint_as_float(af[kk][0] ^ af[kk][3]) + xs;\n"
XOR = ("#pragma unroll\n"
       "            for (int i = 0; i < 4; ++i)\n"
       "              acc[0][n0 + n][i] = __uint_as_float(__float_as_uint(acc[0][n0 + n][i]) ^\n"
       "                                                  af[k][i] ^ xw[n][k >> 1].x);\n")
VARIANTS = {
    "loads-only": {C_CONVERT: "        af[k][0] = af[k][2] = word(c0, k);\n"
                              "        af[k][1] = af[k][3] = word(c1, k);\n",
                   C_LD: "          const bool ld = false;\n", C_MMA: XOR},
    "no-mma": {C_MMA: XOR},
    "one-set": {"  constexpr int kSets = G <= 2 ? 2 : 1;": "  constexpr int kSets = 1;"},
    "stages-3": {C_STAGES: "constexpr int kStages = 3;"},
    "stages-4": {C_STAGES: "constexpr int kStages = 4;"},
    "one-block-64": {C_BLOCKS: "__host__ __device__ constexpr int min_blocks(int G) { "
                               "return G >= 8 ? 1 : G >= 4 ? 2 : 3; }"},
    "mma-sync-form": {C_WG_FROM: "constexpr int kWgFromGroups = 16;"},
    "wg-no-products": {W_MMA: W_XOR},
    "wg-loads-only": {W_MMA: W_XOR, W_CONVERT: "    af[kk][0] = af[kk][2] = v0.x ^ v0.w;\n"
                                               "    af[kk][1] = af[kk][3] = v1.y ^ v1.z;\n"},
    "wg-no-x": {W_XCOPY: "      for (int i = wt; i < 0; i += 128) {\n"},
    "wg-no-overlap": {"    wgmma_wait<1>();  // step st - 1's products are done\n":
                      "    wgmma_wait<0>();  // step st - 1's products are done\n"},
}
SKIP_LAST = "  if (grp.n > 1 && first == grp.w[grp.n - 1].first_block) return;\n"
MUTANTS = {
    "dropped K part": {
        C_STEPS: "  const int steps = o0 < OUT && nsteps > kp && !(blockIdx.x == 0 && "
                 "kp == ks - 1 && ks > 1) ?",
        W_STEPS: "  const int steps = o_blk < OUT && nsteps > kp && !(blockIdx.x == 0 && "
                 "kp == ks - 1 && ks > 1) ?"},
    "last tile never written": {C_STORE: "    if (o >= (OUT - 1) / 16 * 16) continue;\n",
                                W_STORE: "    if (o >= (OUT - 1) / 16 * 16) continue;\n"},
    "last row group dropped": {C_MMA: "            if (n0 + n != (M - 1) / 8)\n" + C_MMA,
                               W_XCOPY: "      for (int i = wt; i < (M - 1) / 8 * 8 * 16; "
                                        "i += 128) {\n"},
    "last weight skipped": {C_FIRST: C_FIRST + SKIP_LAST, W_FIRST: W_FIRST + SKIP_LAST},
}


def step_shapes(family: str):
    return STEP_LAUNCHES[family]


def launch_bytes(outs, IN: int, M: int, y_bytes: int = 2) -> int:
    """Codes, f32 scales, x and the y (bf16, or f32 with ``y_bytes`` 4) of
    one launch, each once."""
    total = sum(outs)
    return total * IN + 4 * total + 2 * M * IN + y_bytes * M * total


def bounds(outs, IN: int, M: int, ceiling: float, y_bytes: int = 2) -> dict:
    nbytes = launch_bytes(outs, IN, M, y_bytes)
    ops = 2 * M * sum(outs) * IN
    return {"bytes": nbytes, "ops": ops,
            "bound_ms": max(nbytes / NOMINAL_BPS, ops / BF16_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / NOMINAL_BPS >= ops / BF16_FLOPS else "operations",
            "measured_bound_ms": max(nbytes / ceiling, ops / BF16_FLOPS) * 1e3}


def row_limits(ref) -> torch.Tensor:
    """Each row's limit: RTOL x max |ref[m]| for f32 outputs; for bf16 one
    ulp of the row's max |ref| (2^(floor(log2 max) - 7)), which no smaller
    element's ulp exceeds."""
    amax = ref.float().abs().amax(dim=1)
    if ref.dtype == torch.float32:
        return RTOL * amax
    return torch.where(amax > 0, torch.exp2(torch.floor(torch.log2(amax.clamp_min(1e-30))) - 7),
                       torch.zeros_like(amax))


def row_err(y, ref) -> tuple:
    """(max |y - ref|, the worst row's share of its limit ``row_limits``);
    inf where y is not finite."""
    if not bool(torch.isfinite(y).all()):
        return math.inf, math.inf
    err = (y.float() - ref.float()).abs().amax(dim=1)
    lim = row_limits(ref)
    share = torch.where(lim > 0, err / lim.clamp_min(1e-30),
                        torch.where(err > 0, torch.full_like(err, math.inf), torch.zeros_like(err)))
    return err.max().item(), share.max().item()


def random_weight(gen, L: int, OUT: int, IN: int, device, bf16: bool = False):
    """L layers of one weight: (q int8 [L, OUT, IN] over -127..127, s f32 [L,
    OUT] positive, w bf16 [L, IN, OUT] or None): the codes times the scale,
    so the bf16 product and the int8 one compute about the same values."""
    q = torch.randint(-127, 128, (L, OUT, IN), dtype=torch.int8, generator=gen, device=device)
    s = torch.rand((L, OUT), generator=gen, device=device).mul_(1e-3).add_(1e-4)
    w = (q.float() * s[:, :, None]).to(torch.bfloat16).transpose(1, 2).contiguous() if bf16 else None
    return q, s, w


def random_stacks(family: str, gen, bf16: bool = True) -> dict:
    """{launch name: [(q, s, w) a weight]} for a family's step, each launch
    with enough layers for twice the L2."""
    out = {}
    for name, outs, IN, _ in STEP_LAUNCHES[family]:
        L = max(2, -(-2 * L2_BYTES // (sum(outs) * IN)) + 1)
        out[name] = [random_weight(gen, L, o, IN, "cuda", bf16) for o in outs]
        torch.cuda.empty_cache()
    return out


def nan_poison(n_elems: int, device="cuda"):
    """A block of NaN the caching allocator hands to the next tensor of its
    size: an element a kernel leaves unwritten stays NaN."""
    poison = torch.full((n_elems,), float("nan"), device=device)
    del poison


def check_launch(ws, M: int, gen, dtype=torch.bfloat16, layer: int = 0) -> tuple:
    """The kernel against its plain version on layer ``layer`` of ``ws`` at
    M rows: (max |diff|, the worst row's share of its limit)."""
    qs, ss = [q[layer] for q, _, _ in ws], [s[layer] for _, s, _ in ws]
    x = torch.randn((M, qs[0].shape[1]), generator=gen, device="cuda").to(dtype)
    nan_poison(M * sum(q.shape[0] for q in qs) * (2 if dtype == torch.float32 else 1))
    ys = il.int8_linear(x, qs, ss)
    ref = il.int8_linear_plain(x, qs, ss)
    errs = [row_err(y, r) for y, r in zip(ys, ref)]
    return max(e for e, _ in errs), max(s for _, s in errs)


def library_refusal(x, q, s_b):
    """None where this torch runs ``torch._weight_int8pack_mm`` on the card,
    else why it does not."""
    try:
        torch._weight_int8pack_mm(x, q, s_b)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        return f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return None


def sweep_forms(stacks: dict, family: str, ceiling: float, rows=ROWS, calls: int = CALLS,
                log=print, turns: int = 2) -> list:
    """Each launch of the family's step at each row count: checked, then
    every form timed, in turns A B .. B A (``turns`` 2) or once each (1),
    the layer rotated each call. Rows of the table."""
    from pegainfer_tpu_torch.ops import quant

    n_step = {name: n for name, _, _, n in STEP_LAUNCHES[family]}
    table = []
    gen = torch.Generator(device="cuda").manual_seed(27)
    for name, ws in stacks.items():
        L = ws[0][0].shape[0]
        qs = [q for q, _, _ in ws]
        ss = [s for _, s, _ in ws]
        sb = [s.to(torch.bfloat16) for s in ss]
        outs, IN = [q.shape[1] for q in qs], qs[0].shape[2]
        for M in rows:
            err, share = check_launch(ws, M, gen)
            x = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
            refusal = library_refusal(x, qs[0][0], sb[0][0])
            fns = {
                "kernel": lambda i: il.int8_linear(x, [q[i % L] for q in qs], [s[i % L] for s in ss]),
                "K6 + scale + cast": lambda i: [(k6.int8_gemv_dense(x, q[i % L]) * s[i % L]).to(
                    torch.bfloat16) for q, s in zip(qs, ss)],
                "JAX form": lambda i: [(quant.int8_mm(x, q[i % L]) * s[i % L]).to(torch.bfloat16)
                                       for q, s in zip(qs, ss)],
                "plain": lambda i: il.int8_linear_plain(x, [q[i % L] for q in qs],
                                                        [s[i % L] for s in ss]),
            }
            if ws[0][2] is not None:
                fns["bf16 matmul"] = lambda i: [x @ w[i % L] for _, _, w in ws]
            if refusal is None:
                fns["library"] = lambda i: [torch._weight_int8pack_mm(x, q[i % L], s[i % L])
                                            for q, s in zip(qs, sb)]
            n = max(L, calls - calls % L)
            times = timed_in_turns(fns, n, L, turns)
            ms = {f: sum(t) / len(t) for f, t in times.items()}
            b = bounds(outs, IN, M, ceiling)
            p = il.plan(outs, IN, M)
            row = {"shape": name, "outs": outs, "IN": IN, "M": M, "layers": L,
                   "launches_a_step": n_step[name], "plan": list(p),
                   **{f"{f}_ms": ms.get(f) for f in FORMS},
                   **{f"{f}_each_ms": times.get(f) for f in FORMS},
                   "library_call": LIBRARY_CALL if refusal is None
                   else f"none ({LIBRARY_CALL}: {refusal})",
                   "max_abs_err": err, "row_share": share, **b}
            table.append(row)
            log(f"  {name} ({'+'.join(map(str, outs))} x {IN}) M={M:2d}: kernel "
                f"{ms['kernel'] * 1e3:8.2f} us ({b['measured_bound_ms'] / ms['kernel']:6.1%} of "
                f"{b['measured_bound_ms'] * 1e3:.2f}), K6 + scale + cast "
                f"{ms['K6 + scale + cast'] * 1e3:8.2f}, bf16 matmul "
                + (f"{ms['bf16 matmul'] * 1e3:8.2f}" if "bf16 matmul" in ms else "-")
                + f", JAX form {ms['JAX form'] * 1e3:8.2f}, library "
                + (f"{ms['library'] * 1e3:8.2f}" if refusal is None else "none")
                + f", plain {ms['plain'] * 1e3:8.2f}; plan {tuple(p)}; worst row "
                f"{share:.3f} of its limit {'ok' if share <= 1.0 else 'FAIL'}")
        torch.cuda.empty_cache()
    return table


def timed_in_turns(fns: dict, n: int, L: int, turns: int = 2) -> dict:
    """Each form timed in turns A B .. B A (``turns`` 2; 1: A B ..) over
    ``n`` calls, a yardstick that copies or allocates at each call
    (``plain``, ``library``) over ``L`` calls, one that still cannot be
    timed so left out: {form: [ms a turn]}."""
    calls = {f: (L if f in ("plain", "library") else n) for f in fns}
    times = {f: [] for f in fns}
    for f in (list(fns) + list(fns)[::-1])[:len(fns) * turns]:
        if times.get(f) is None:
            continue
        try:
            times[f].append(device_ms(fns[f], calls[f]))
        except RuntimeError:
            times[f] = None
    return {f: t for f, t in times.items() if t}


def step_totals(table: list, family: str) -> dict:
    """Per row count, each form's sum of launches x time over the family's
    decode step, and the bounds' sums."""
    out = {}
    for r in table:
        if not r["shape"].startswith(family + " "):
            continue
        d = out.setdefault(r["M"], {})
        n = r["launches_a_step"]
        for f in FORMS:
            if r[f"{f}_ms"] is not None:
                d[f] = d.get(f, 0.0) + n * r[f"{f}_ms"]
        for k in ("bound_ms", "measured_bound_ms"):
            d[k] = d.get(k, 0.0) + n * r[k]
    return out


def gates(totals: dict) -> dict:
    """Per row count: the kernel's step below the K6 route's, below bf16
    matmul's (where timed), within twice its measured bound."""
    out = {}
    for M, t in totals.items():
        k = t["kernel"]
        g = {"below_k6_route": k < t["K6 + scale + cast"],
             "below_bf16_matmul": k < t["bf16 matmul"] if "bf16 matmul" in t else None,
             "of_measured_bound": k / t["measured_bound_ms"]}
        g["within_2x_bound"] = g["of_measured_bound"] <= 2.0
        g["ok"] = g["below_k6_route"] and g["below_bf16_matmul"] is not False and g[
            "within_2x_bound"]
        out[M] = g
    return out


def log_steps(family, totals, gate, log=print):
    for M, t in totals.items():
        g = gate[M]
        log(f"  {family} decode step's int8 launches at {M:2d} rows: "
            + ", ".join(f"{f} {v * 1e3:.1f} us" for f, v in t.items())
            + f"; kernel at {g['of_measured_bound']:.2f}x its measured bound, gates "
            + ("met" if g["ok"] else "MISSED"))


def run_forms(ceiling: float = READ_CEILING, rows=ROWS, log=print) -> dict:
    """Both families' steps: the table, the step sums and the gates."""
    out = {"table": [], "steps": {}, "gates": {}}
    for family in STEP_LAUNCHES:
        gen = torch.Generator(device="cuda").manual_seed(270)
        stacks = random_stacks(family, gen)
        table = sweep_forms(stacks, family, ceiling, rows=rows, log=log)
        out["table"] += table
        out["steps"][family] = step_totals(table, family)
        out["gates"][family] = gates(out["steps"][family])
        log_steps(family, out["steps"][family], out["gates"][family], log)
        del stacks
        torch.cuda.empty_cache()
    return out


# ── variants and plans ────────────────────────────────────────────────────


def variant_sources(mutants: bool = False) -> dict:
    text = SOURCE.read_text()
    table = MUTANTS if mutants else VARIANTS
    out = {} if mutants else {"as-is": text}
    for name, subs in table.items():
        out[("mutant " if mutants else "") + name] = substitute(name, text, subs,
                                                               "csrc/int8_linear.cu")
    return out


def build_variants(sources: dict) -> dict:
    libs = compile_variants(sources, OUT_DIR)
    for lib in libs.values():
        build._declare_int8_linear(lib)
    return libs


def run_variants(libs: dict, rows=ROWS, log=print) -> list:
    """Every variant at each launch of both steps and each row count, the
    production plan, in turns."""
    table = []
    for family in STEP_LAUNCHES:
        gen = torch.Generator(device="cuda").manual_seed(271)
        stacks = random_stacks(family, gen, bf16=False)
        for name, ws in stacks.items():
            L = ws[0][0].shape[0]
            qs, ss = [q for q, _, _ in ws], [s for _, s, _ in ws]
            outs, IN = [q.shape[1] for q in qs], qs[0].shape[2]
            for M in rows:
                x = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
                p = il.plan(outs, IN, M)
                times = in_turns(list(libs), lambda v: lambda i: il._launch(
                    x, [q[i % L] for q in qs], [s[i % L] for s in ss], False, p, libs[v]),
                    max(L, CALLS - CALLS % L))
                b = bounds(outs, IN, M, READ_CEILING)
                for v, t in times.items():
                    ms = sum(t) / len(t)
                    table.append({"shape": name, "M": M, "variant": v, "ms": ms, "each_ms": t,
                                  "measured_bound_ms": b["measured_bound_ms"]})
                log(f"  {name} M={M:2d}: " + ", ".join(
                    f"{v} {sum(t) / len(t) * 1e3:.2f}" for v, t in times.items())
                    + f" us (bound {b['measured_bound_ms'] * 1e3:.2f})")
        del stacks
        torch.cuda.empty_cache()
    return table


def candidate_plans(outs, IN: int, M: int) -> list:
    """Every plan of 2, 4 or 8 warps a block whose K parts each keep a step
    and whose tiles are no more than the largest weight has."""
    G = il.row_groups(M)
    nsteps = -(-IN // il.STEP_K)
    tiles = -(-max(outs) // 16)
    return [il.Plan(G, rt, warps // rt) for warps in (2, 4, 8) for rt in (1, 2, 4, 8)
            if warps % rt == 0 and warps // rt <= nsteps and rt <= tiles]


def run_sweep(rows=ROWS, log=print) -> list:
    """The kernel at every candidate plan of each launch and row count, in
    turns; rows of the table, ``plan``'s own marked."""
    table = []
    for family in STEP_LAUNCHES:
        gen = torch.Generator(device="cuda").manual_seed(272)
        stacks = random_stacks(family, gen, bf16=False)
        for name, ws in stacks.items():
            L = ws[0][0].shape[0]
            qs, ss = [q for q, _, _ in ws], [s for _, s, _ in ws]
            outs, IN = [q.shape[1] for q in qs], qs[0].shape[2]
            for M in rows:
                x = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
                own = il.plan(outs, IN, M)
                plans = candidate_plans(outs, IN, M)
                if own not in plans:
                    plans.append(own)
                times = in_turns(plans, lambda p: lambda i: il._launch(
                    x, [q[i % L] for q in qs], [s[i % L] for s in ss], False, p),
                    max(L, CALLS - CALLS % L))
                rows_ = [{"shape": name, "M": M, "plan": list(p), "own": p == own,
                          "blocks": sum(p.blocks(o) for o in outs), "ms": sum(t) / 2}
                         for p, t in times.items()]
                table += rows_
                best = min(rows_, key=lambda r: r["ms"])
                mine = next(r for r in rows_ if r["own"])
                log(f"  {name} M={M:2d}: own {tuple(mine['plan'])} {mine['ms'] * 1e3:.2f} us; "
                    f"best {tuple(best['plan'])} ({best['blocks']} blocks) "
                    f"{best['ms'] * 1e3:.2f} us")
        del stacks
        torch.cuda.empty_cache()
    return table


# ── checks and planted faults ─────────────────────────────────────────────


def check_cases() -> list:
    """The card tests' cases: (label, OUTs, IN, M, dtype): Qwen3-4B's wq and
    wk and a ragged OUT 1000 x IN 400 alone, and the three groups (Qwen3's
    wq / wk / wv, the hybrid's GDN and full-layer four), at one row, the
    buckets, 17 and 33 (a last n8 group of one row); f32 rows at 1 and 17;
    a wide OUT 16384 x IN 512 at 17 and 33 (the warpgroup form, which the
    groups take at 64 rows)."""
    shapes = (("wq", (4096,), 2560), ("wk", (1024,), 2560), ("ragged", (1000,), 400),
              ("qwen3 qkv", (4096, 1024, 1024), 2560),
              ("qwen35 gdn", (2048, 2048, 4096, 4096), 2048),
              ("qwen35 full", (4096, 4096, 512, 512), 2048))
    cases = [(f"{n} M={M}", outs, IN, M, "bf16") for n, outs, IN in shapes
             for M in (1, 2, 8, 16, 17, 33, 64)]
    cases += [(f"{n} M={M} f32", outs, IN, M, "f32") for n, outs, IN in shapes[2:4]
              for M in (1, 17)]
    # 256 tiles of 64 channels: the warpgroup form at 17-32 rows too
    cases += [(f"wide M={M}", (16384,), 512, M, "bf16") for M in (17, 33)]
    return cases


def tp_check_cases(family: str = "qwen3") -> list:
    """The card tests' cases at the family's shard shapes (``tp_launches``;
    Qwen3-4B at TP 2 and TP 4, the hybrid's ``bench_config()`` at TP 2) at
    ``TP_ROWS``: bf16 rows, the outputs bf16, or f32 (``"f32_out"``) for the
    ``ROW_PARALLEL`` launches."""
    return [(f"{name} M={M}", outs, IN, M, "f32_out" if f32 else "bf16")
            for tp in TP_WIDTHS[family] for name, outs, IN, _, f32 in tp_launches(tp, family)
            for M in TP_ROWS]


def run_case(case, device="cuda", weights=None):
    """One check case through the wrapper after a NaN fill of a block of
    the outputs' size: (outputs, the plain version's outputs). The rows are
    f32 for ``"f32"``, else bf16; the outputs f32 for ``"f32"`` and
    ``"f32_out"``."""
    _, outs, IN, M, dt = case
    gen = torch.Generator(device=device).manual_seed(sum(outs) + IN + M)
    key = (outs, IN)
    if weights is None or key not in weights:
        ws = [random_weight(gen, 1, o, IN, device) for o in outs]
        if weights is not None:
            weights[key] = ws
    else:
        ws = weights[key]
    qs, ss = [q[0] for q, _, _ in ws], [s[0] for _, s, _ in ws]
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    f32_out = dt == "f32_out"
    x = torch.randn((M, IN), generator=gen, device=device).to(dtype)
    nan_poison(M * sum(outs) * (2 if dtype == torch.float32 or f32_out else 1), device)
    return (il.int8_linear(x, qs, ss, f32_out=f32_out),
            il.int8_linear_plain(x, qs, ss, f32_out=f32_out))


def check() -> list:
    """Each case of ``check_cases`` on the card: (label, max |diff|, the
    worst row's share of its limit over the case's weights)."""
    weights = {}
    rows = []
    for case in check_cases():
        ys, refs = run_case(case, weights=weights)
        errs = [row_err(y, r) for y, r in zip(ys, refs)]
        rows.append((case[0], max(e for e, _ in errs), max(s for _, s in errs)))
    return rows


def run_mutants(log=print) -> dict:
    """Each planted fault through the wrapper (its library in place of the
    kernel's): the cases it fails and the largest factor over its limit."""
    libs = build_variants(variant_sources(mutants=True))
    build.load("int8_linear")
    real = build._libs["int8_linear"]
    out = {}
    try:
        for name, lib in libs.items():
            build._libs["int8_linear"] = lib
            rows = check()
            failed = [label for label, _, share in rows if not share <= 1.0]
            worst = max(share for _, _, share in rows)
            out[name] = {"cases": len(rows), "failed": len(failed), "worst_factor": worst,
                         "passed": [label for label, _, share in rows if share <= 1.0]}
            log(f"  {name}: fails {len(failed)} of {len(rows)} cases, worst at {worst:.3g} x its "
                f"limit; passes {out[name]['passed'] or 'none'}")
    finally:
        build._libs["int8_linear"] = real
    return out


def run_cpu() -> dict:
    """The plans of the step's launches; the plain version
    through the wrapper on CPU tensors against numpy in f64."""
    plans = {f"{name} M={M}": {**il.plan(outs, IN, M)._asdict(),
                               "blocks": sum(il.plan(outs, IN, M).blocks(o) for o in outs)}
             for fam in STEP_LAUNCHES.values() for name, outs, IN, _ in fam for M in ROWS}
    rng = np.random.default_rng(0)
    outs, IN, M = (96, 40), 512, 5
    qs = [rng.integers(-127, 128, (o, IN)).astype(np.int8) for o in outs]
    ss = [(rng.random(o) * 1e-2 + 1e-3).astype(np.float32) for o in outs]
    x = rng.standard_normal((M, IN)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    want = np.concatenate([(xb @ q.astype(np.float64).T) * s for q, s in zip(qs, ss)], axis=1)
    before = il.launches
    got = il.int8_linear(torch.from_numpy(x), [torch.from_numpy(q) for q in qs],
                         [torch.from_numpy(s) for s in ss], joined=True)
    assert il.launches == before
    out = {"plans": plans, "max_rel_err": float(np.abs(got.numpy() - want).max()
                                                / np.abs(want).max())}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="plans and the plain version, no card")
    ap.add_argument("--variants", action="store_true", help="the source with parts taken out")
    ap.add_argument("--sweep", action="store_true", help="every plan of each launch")
    ap.add_argument("--mutants", action="store_true", help="plant faults and run the checks")
    ap.add_argument("--no-forms", action="store_true", help="skip the forms' comparison")
    ap.add_argument("--rows", help="row counts, comma-separated (default: the buckets)")
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    rows = tuple(int(r) for r in args.rows.split(",")) if args.rows else ROWS
    if args.cpu:
        run_cpu()
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("int8_linear_study: no CUDA device (use --cpu for the plans)")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    result = {"card": card}
    ok = True
    if args.mutants:
        result["mutants"] = run_mutants()
        ok = all(m["failed"] > 0 for m in result["mutants"].values())
    else:
        checks = check()
        worst = max(s for _, _, s in checks)
        print(f"  check: {len(checks)} cases, worst row at {worst:.3f} of its limit", flush=True)
        result["check"] = checks
        ok = worst <= 1.0
        if not args.no_forms:
            result.update(run_forms(rows=rows))
            ok = ok and all(r["row_share"] <= 1.0 for r in result["table"])
        if args.variants:
            result["variants"] = run_variants(build_variants(variant_sources()), rows)
        if args.sweep:
            result["sweep"] = run_sweep(rows)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result))
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
