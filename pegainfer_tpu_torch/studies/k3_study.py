"""K3 study on the H100: what holds the packed-fp4 expert GEMV
(``csrc/fp4_gemv.cu``) at the shapes of a DeepSeek-V4-Flash fp4 decode
step, and which of its parts costs.

    python -m pegainfer_tpu_torch.studies.k3_study [--parent FILE] [--out FILE]
    python -m pegainfer_tpu_torch.studies.k3_study --sweep [--out FILE]
    python -m pegainfer_tpu_torch.studies.k3_study --mutants [--out FILE]
    python -m pegainfer_tpu_torch.studies.k3_study --cpu

Variants are copies of a source with text substituted, built in parallel
into ``build/k3_study/`` (git-ignored, ``studies/variants.py``) and called
through their C interface. The variants follow the design of the source
they are cut from:

- the first design (a block a row and 32 output rows, a warp a row, lanes
  over 16-byte chunks, a shared-memory table decode, f32 FMAs;
  ``--parent FILE``, an earlier commit's source unpacked with ``git
  archive`` under ``build/``): ``as-is``; ``loads-only`` (the code loads
  alone, their words summed); ``bits`` (K5's table-free prmt decode in
  place of the table, as S4's ``bits``); ``no-products`` (the FMAs with x
  replaced by an XOR of the weights); ``no-scale-load`` (the scale taken as
  1, never loaded); ``no-round`` (the bf16 rounding of each weight taken
  out);
- the current design (rows grouped by expert, the plan, mma.sync):
  ``as-is``; ``loads-only`` (codes, scales and x loaded, their words
  summed); ``no-decode`` (the codes go to the mma as they are); ``no-mma``
  (the decode kept, the mma replaced by an XOR); ``no-scale-loads``;
  ``no-loads`` (the grouping, the launch and the block's sums alone);
  ``no-grouping`` (every row its own group, its expert read once a row, as
  the first design reads it); ``no-prefetch`` (a step's loads made only
  after the last step's products); ``runs-2`` (2 runs of 32 codes a thread
  a step, not 1); ``two-tiles`` (a warp two m16 tiles, not one);
  ``two-blocks`` (registers capped for two blocks an SM, not three);
  ``l2-256b`` (the code loads ask L2 for the 256 bytes around them).

Cases: w1 (2048 x 4096, as w3) and w2 (4096 x 2048) at M 1, 6 and 12 with
distinct experts and at M 12 routed as two tokens sharing 3 of their 6
experts (B = 2; 9 distinct). The stacks hold all 256 experts with
power-of-two group scales of 32 (1.2 GB each); the timed calls rotate over
SETS expert sets, consecutive sets disjoint, so no call finds its experts
in the 50 MB L2. Every variant and the yardstick, one ``torch.bmm`` of the
routed experts gathered and dequantized to bf16 ahead (as ``chip_smoke.py``
times it; sets enough for twice the L2), timed by CUDA events in turns A B
.. B A; each time beside its bound at the read ceiling that
``gemv_stream_study`` measured (3.1224 TB/s: the distinct experts' codes
and scales, x in bf16 and y in f32, once); the variants whose values are
right held to TOL against ``moe_fp4_gemv_plain``. Then the step's K3 time,
launches x time (16 w1 / w3 and 8 w2 launches of the smoke's 8 layers) at
M 6 (B = 1) and at the shared M 12 (B = 2). Prints the card line; ``--out``
writes every row as JSON.

``--sweep`` times ``as-is`` at every plan of 2, 4 or 8 warps a block at
each case, beside the plan ``ops/cuda/fp4_gemv.py::plan`` picks.

``--mutants`` plants five faults, each in its own copy of the current
source, and runs ``check`` (the card tests' cases, at their limit TOL, which
is also the smoke's ``QUANT_GEMV_TOL``) on each through the wrapper: a
dropped K part of the first block, the wrong scale for a row's second
group, the last 16-channel tile never written, the second row of a
repeated-expert group dropped, the rows of invalid ids never zeroed. It
reports, for each, the cases it fails and by what factor. ``check`` fills
the block that y will take with NaN first, so an element left unwritten
fails.

``--cpu`` prints the plans of the cases on 132 SMs and runs the plain
version through the wrapper on CPU tensors against a numpy reference at a
small size, with repeated and invalid ids; it times nothing. Without a card
and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
from pegainfer_tpu_torch.studies.expert_stream_study import READ_CEILING
from pegainfer_tpu_torch.studies.timing import card_line
from pegainfer_tpu_torch.studies.variants import compile_variants, in_turns, substitute

OUT_DIR = build.BUILD_DIR / "k3_study"
E = 256  # DeepSeek-V4-Flash's routed experts
GROUP = 32
# (name, OUT, IN, launches in a B = 1 decode step of the smoke's 8 layers;
# models/dsv4.py:620-629: w1 and w3 at w1's shape, then w2)
SHAPES = (("w1", 2048, 4096, 16), ("w2", 4096, 2048, 8))
CASES = ((1, "distinct"), (6, "distinct"), (12, "distinct"), (12, "shared"))
SETS = 64  # expert sets the timed calls rotate over
L2_BYTES = 50 * 2 ** 20  # an H100's L2
CALLS = 200  # timed calls a timing
SMS = 132  # an H100 SXM's SMs: the plans --cpu prints
# K3 forms the plain version's exact f32 products (bf16 weights and x) and
# sums them in another order: the JAX kernel tests' atol, on unit-RMS
# outputs (chip_smoke.QUANT_GEMV_TOL, tests/test_torch_kernels_cuda.GEMV_TOL)
TOL = 2e-5
CHECK_E = 64  # experts of the check cases' stacks
CPU_SHAPE = (4, 96, 512)  # E, OUT, IN of --cpu

# ── the variants of the first design (a block a row) ────────────────────
P_SCALE = "        const float sc = __bfloat162float(srow[(c * 32) / g]);\n"
P_FMA = ("            acc = fmaf(bf16_round(lut[byte & 0xF] * sc), xv[2 * b], acc);\n"
         "            acc = fmaf(bf16_round(lut[byte >> 4] * sc), xv[2 * b + 1], acc);\n")
P_DECODE = ("          for (int b = 0; b < 4; ++b) {\n"
            "            const uint32_t byte = (wd[h] >> (8 * b)) & 0xFF;\n", P_FMA)
P_BITS = """          for (int b = 0; b < 4; ++b) {
            uint32_t r[4];
            e2m1x8_bf16x2_unscaled(wd[h], r);
            const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[b]));
            acc = fmaf(bf16_round(w.x * sc), xv[2 * b], acc);
            acc = fmaf(bf16_round(w.y * sc), xv[2 * b + 1], acc);
"""
P_XOR = ("            acc += __uint_as_float((__float_as_uint(bf16_round(lut[byte & 0xF] * sc)) ^\n"
         "                                    __float_as_uint(bf16_round(lut[byte >> 4] * sc)))"
         " & 0x3FFFFFu);\n")
P_LOADS = "        acc += static_cast<float>((raw.x ^ raw.y ^ raw.z ^ raw.w) & 0xFFFFu);\n"
PARENT = {
    "as-is": ({}, True),
    "loads-only": ({(P_SCALE, P_FMA + "          }\n        }\n"): P_LOADS},
                   False),
    "bits": ({P_DECODE: P_BITS}, True),
    "no-products": ({P_FMA: P_XOR}, False),
    "no-scale-load": ({P_SCALE: "        const float sc = 1.f;\n"}, False),
    "no-round": ({P_FMA: P_FMA.replace("bf16_round(lut[byte & 0xF] * sc)", "lut[byte & 0xF] * sc")
                  .replace("bf16_round(lut[byte >> 4] * sc)", "lut[byte >> 4] * sc")}, False),
}

# ── the variants of the current design (grouped rows, the plan, mma.sync) ─
C_STEPS = "  const int steps = o0 < OUT ? (k1 - k0 + kStepK - 1) / kStepK : 0;\n"
C_SCALE = "        st.sc[u][h] = in ? __ldg(sr[h] + jj) * 0x10001u : 0u;\n"
C_DECODE = ("          for (int h = 0; h < kRows; ++h)\n"
            "            e2m1x8_bf16x2(word(cur.a[u][h], wi), cur.sc[u][h], r[h]);\n")
C_MMA = "              mma_bf16(cr[mt], af, word(xw, 2 * hh), word(xw, 2 * hh + 1));\n"
C_PRODUCTS = ("        float cr[kTiles][4] = {};\n",
              "          for (int i = 0; i < 4; ++i) c[mt][i] += cr[mt][i];\n")
C_GROUP = "  slot_group<kChunkRows>(idx, M, E, blockIdx.y, lane, expert, rows, invalid);\n"
C_STORE = "      if (o < OUT) y["
C_ZERO = "  if (blockIdx.y % kChunkRows == 0) {  // the chunk's rows of invalid ids are 0\n"
C_XV = "    const bool xv = n0 + g < cnt;\n"
C_PREFETCH = "      if (st + 1 < steps) load(nxt, base + kStepK, j, rem);\n"
CURRENT = {
    "as-is": ({}, True),
    "loads-only": ({C_PRODUCTS: """        {
          uint32_t v = 0;
#pragma unroll
          for (int h = 0; h < kRows; ++h)
            v ^= cur.a[u][h].x ^ cur.a[u][h].y ^ cur.a[u][h].z ^ cur.a[u][h].w ^ cur.sc[u][h];
#pragma unroll
          for (int wi = 0; wi < 4; ++wi) {
            const uint4 w = xv && in ? __ldg(reinterpret_cast<const uint4*>(xr + col) + wi) : zero;
            v ^= w.x ^ w.y ^ w.z ^ w.w;
          }
          c[0][0] += static_cast<float>(v & 0xFFFFu);
        }
"""}, False),
    "no-decode": ({C_DECODE: "          for (int h = 0; h < kRows; ++h) {\n"
                             "            const uint32_t w = word(cur.a[u][h], wi) ^ "
                             "cur.sc[u][h];\n"
                             "            r[h][0] = w, r[h][1] = w >> 8, r[h][2] = w >> 16, "
                             "r[h][3] = w >> 24;\n          }\n"}, False),
    "no-mma": ({C_MMA: "              cr[mt][hh] += __uint_as_float((af[0] ^ af[1] ^ af[2] ^ af[3] "
                       "^ xw.x ^ xw.y) & 0x3FFFFFFFu);\n"}, False),
    "no-scale-loads": ({C_SCALE: "        st.sc[u][h] = 0x3F803F80u;\n"}, False),
    # the grouping, the launch and the block's sums, no K loop
    "no-loads": ({C_STEPS: "  const int steps = 0;\n"}, False),
    # every valid row its own group, after the grouping (whose invalid mask stays)
    "no-grouping": ({C_GROUP: C_GROUP + """  {
    const int own = idx[blockIdx.y];
    expert = own >= 0 && own < E ? own : -1;
    rows = expert < 0 ? 0u : 1u << (blockIdx.y % kChunkRows);
  }
"""}, True),
    "no-prefetch": ({C_PREFETCH: "", "      cur = nxt;\n":
                     "      if (st + 1 < steps) load(cur, base + kStepK, j, rem);\n"}, True),
    "runs-2": ({"constexpr int kRuns = 1;": "constexpr int kRuns = 2;"}, True),
    "two-tiles": ({"constexpr int kTiles = 1;": "constexpr int kTiles = 2;"}, True),
    "two-blocks": ({"constexpr int kBlocksPerSm = 3;": "constexpr int kBlocksPerSm = 2;"}, True),
    "l2-256b": ({"ld.global.nc.L1::no_allocate.v4.u32":
                 "ld.global.nc.L1::no_allocate.L2::256B.v4.u32"}, True),
}
# the planted faults of --mutants, each a copy of the current source
MUTANTS = {
    "dropped K part": {C_STEPS: C_STEPS.replace(
        "o0 < OUT ?", "o0 < OUT && !(blockIdx.x == 0 && kp == ks - 1 && ks > 1) ?")},
    "wrong scale of a row's second group": {C_SCALE: C_SCALE.replace(
        "sr[h] + jj", "sr[h] + (jj == 1 ? 0 : jj)")},
    "last output tile skipped": {C_STORE: "      if (o < (OUT - 1) / 16 * 16) y["},
    "second row of a group dropped": {C_XV: "    const bool xv = n0 + g < cnt && n0 + g != 1;\n"},
    "invalid ids not zeroed": {C_ZERO: "  if (false) {\n"},
}


def is_parent(text: str) -> bool:
    """Whether a source is of the first design (its C interface takes no
    launch plan)."""
    return "int IN, int S, void* stream)" in text


def variant_sources(parent=None, mutants=False) -> dict:
    """name -> (source text, whether its values are right and checked)."""
    out = {}
    cur = (build.CSRC_DIR / "fp4_gemv.cu").read_text()
    if mutants:
        for name, subs in MUTANTS.items():
            out[f"mutant {name}"] = (substitute(name, cur, subs, "csrc/fp4_gemv.cu"), True)
        return out
    for name, (subs, checked) in CURRENT.items():
        out[name] = (substitute(name, cur, subs, "csrc/fp4_gemv.cu"), checked)
    if parent:
        text = Path(parent).read_text()
        if not is_parent(text):
            raise SystemExit(f"{parent} is not of the first design")
        for name, (subs, checked) in PARENT.items():
            out[f"parent {name}"] = (substitute(name, text, subs, parent), checked)
    return out


def build_variants(sources: dict) -> dict:
    """Each variant's library, built in parallel; prints ptxas's registers
    and spills. Returns {name: (library, checked, parent design)}."""
    built = compile_variants({name: text for name, (text, _) in sources.items()}, OUT_DIR)
    libs = {}
    for name, lib in built.items():
        parent = is_parent(sources[name][0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fp4_gemv.argtypes = [p] * 5 + [i] * (5 if parent else 8) + [p]
        lib.fp4_gemv.restype = i
        libs[name] = (lib, sources[name][1], parent)
    return libs


def launch(variant, x, q, s, idx, p=None):
    """One call of a variant's C interface: the first design at its own
    grid, the current one at ``p`` or its plan."""
    lib, _, parent = variant
    M, IN = x.shape
    E_, OUT, _ = q.shape
    S = s.shape[2]
    y = torch.empty((M, OUT), dtype=torch.float32, device=x.device)
    plan = () if parent else tuple(
        p or k3.plan(OUT, IN, IN // S, M, torch.cuda.get_device_properties(x.device)
                     .multi_processor_count))
    err = lib.fp4_gemv(x.data_ptr(), q.data_ptr(), s.data_ptr(), idx.data_ptr(), y.data_ptr(),
                       M, E_, OUT, IN, S, *plan, torch.cuda.current_stream().cuda_stream)
    build.check_launch("fp4_gemv (study)", err)
    return y


def fp4_weight(gen, E_: int, OUT: int, IN: int, device, group=GROUP, pow2=True):
    """Codes over all 256 byte values and bf16 group scales 2^e / (2.93
    sqrt(IN)) rounded to a power of two, e in {-1, 0, 1}, so that y has
    about unit RMS (tests/test_torch_kernels_cuda.py's ``_fp4``); without
    ``pow2`` each scale also has a random mantissa."""
    q = torch.randint(0, 256, (E_, OUT, IN // 2), dtype=torch.uint8, generator=gen,
                      device=device)
    e = torch.randint(-1, 2, (E_, OUT, IN // group), generator=gen, device=device)
    s = torch.exp2(e.float() - round(np.log2(2.93 * IN ** 0.5)))
    if not pow2:
        s = s * (1 + torch.rand(s.shape, generator=gen, device=device))
    return q, s.to(torch.bfloat16)


def route(kind: str, M: int, E_: int, perm: torch.Tensor, i: int = 0) -> torch.Tensor:
    """Expert ids of M rows, set ``i`` of a rotation over ``perm`` (a
    permutation of the experts; consecutive sets disjoint): "distinct";
    "repeated" (the second half repeats the first); "shared" (two tokens of
    6 rows sharing 3 experts: 9 distinct); "invalid" (distinct, with ids -1
    and E among them)."""
    n = {"shared": 9, "repeated": M - M // 2}.get(kind, M)
    ids = perm[(i * n + torch.arange(n, device=perm.device)) % E_]
    if kind == "repeated":
        ids = torch.cat([ids, ids[: M // 2]])
    elif kind == "shared":
        ids = ids[torch.tensor([0, 1, 2, 3, 4, 5, 6, 0, 7, 1, 8, 2], device=perm.device)]
    elif kind == "invalid":
        ids = ids.clone()
        ids[1 % M] = -1
        if M > 4:
            ids[4] = E_
    return ids.to(torch.int32)


def distinct(kind: str, M: int) -> int:
    """Distinct valid experts of ``route(kind, M, ...)``."""
    return {"shared": 9, "repeated": M - M // 2,
            "invalid": M - (M > 1) - (M > 4)}.get(kind, M)


def bytes_moved(n_experts: int, M: int, OUT: int, IN: int, group=GROUP) -> int:
    """The distinct experts' codes and scales, x in bf16 and y in f32, each
    once."""
    return n_experts * (OUT * IN // 2 + OUT * (IN // group) * 2) + 2 * M * IN + 4 * M * OUT


def step_bound_ms(M=6, kind="distinct") -> float:
    """The byte bound of a decode step's K3 launches at the read ceiling."""
    return sum(n * bytes_moved(distinct(kind, M), M, o, i)
               for _, o, i, n in SHAPES) / READ_CEILING * 1e3


def check_cases() -> list:
    """The card tests' K3 cases: (label, OUT, IN, group, M, routing, pow2),
    on stacks of CHECK_E experts."""
    shapes = (("w1", 2048, 4096), ("w2", 4096, 2048), ("w3", 2048, 4096))
    main = ((1, "distinct"), (2, "distinct"), (2, "repeated"), (6, "distinct"),
            (6, "repeated"), (12, "distinct"), (12, "repeated"), (12, "shared"))
    cases = [(f"{n} M={M} {r}", o, i, GROUP, M, r, True) for n, o, i in shapes for M, r in main]
    for n, o, i in shapes[:2]:
        cases += [(f"{n} M={M} {r}", o, i, GROUP, M, r, True)
                  for M in (20, 40) for r in ("distinct", "repeated")]
        cases += [(f"{n} M={M} {r} mantissa", o, i, GROUP, M, r, False)
                  for M, r in ((6, "distinct"), (12, "shared"), (40, "repeated"))]
        cases += [(f"{n} M={M} {r} group 64{' mantissa' * (not p)}", o, i, 64, M, r, p)
                  for M, r, p in ((6, "repeated", True), (12, "shared", False))]
        cases += [(f"{n} M={M} invalid", o, i, GROUP, M, "invalid", True) for M in (6, 12, 20)]
    return cases


def run_case(case, device="cuda", weights=None):
    """One check case through the wrapper, on a bf16 x (so the wrapper
    allocates only y) after a NaN fill of a block of y's size, which the
    caching allocator hands to y: an element left unwritten stays NaN.
    Returns (y, the plain version's y)."""
    _, OUT, IN, group, M, kind, pow2 = case
    key = (OUT, IN, group, pow2)
    gen = torch.Generator(device=device).manual_seed(OUT + IN + group + M + pow2)
    if weights is None or key not in weights:
        w = fp4_weight(gen, CHECK_E, OUT, IN, device, group, pow2)
        if weights is not None:
            weights[key] = w
    else:
        w = weights[key]
    perm = torch.randperm(CHECK_E, generator=gen, device=device)
    idx = route(kind, M, CHECK_E, perm)
    x = torch.randn((M, IN), generator=gen, device=device).to(torch.bfloat16)
    poison = torch.full((M, OUT), float("nan"), device=device)
    del poison
    y = k3.moe_fp4_gemv(x, *w, idx)
    return y, k3.moe_fp4_gemv_plain(x, *w, idx)


def max_err(y, ref) -> float:
    """max |y - ref|, inf where y is not finite."""
    err = (y - ref).abs().max().item()
    return err if math.isfinite(err) and bool(torch.isfinite(y).all()) else math.inf


def check() -> list:
    """Each case of ``check_cases`` through the wrapper on the card against
    ``moe_fp4_gemv_plain``: rows (label, max |diff|, TOL)."""
    weights = {}
    rows = []
    for case in check_cases():
        y, ref = run_case(case, weights=weights)
        rows.append((case[0], max_err(y, ref), TOL))
    return rows


def run_mutants() -> dict:
    """Each planted fault through the wrapper (its library in place of
    K3's): the cases it fails and the largest factor over TOL."""
    libs = build_variants(variant_sources(mutants=True))
    build.load("fp4_gemv")
    real = build._libs["fp4_gemv"]
    out = {}
    try:
        for name, (lib, _, _) in libs.items():
            build._libs["fp4_gemv"] = lib
            rows = check()
            failed = [label for label, err, lim in rows if not err <= lim]
            worst = max((err / lim for _, err, lim in rows), default=0.0)
            out[name] = {"cases": len(rows), "failed": len(failed), "worst_factor": worst,
                         "passed": [label for label, err, lim in rows if err <= lim]}
            print(f"  {name}: fails {len(failed)} of {len(rows)} cases, worst at "
                  f"{worst:.3g} x TOL; passes {out[name]['passed'] or 'none'}", flush=True)
    finally:
        build._libs["fp4_gemv"] = real
    return out


def time_cases(libs: dict) -> list:
    """Every variant and torch.bmm at each shape and case, in turns A B ..
    B A; rows of the table."""
    table = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    perm = torch.randperm(E, generator=gen, device="cuda")
    for name, OUT, IN, n_step in SHAPES:
        q, s = fp4_weight(gen, E, OUT, IN, "cuda")
        for M, kind in CASES:
            idxs = [route(kind, M, E, perm, i) for i in range(SETS)]
            x = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
            xb = x[:, :, None]
            # the yardstick's gathered bf16 experts: sets enough for twice the L2
            n_wg = max(2, -(-2 * L2_BYTES // (M * OUT * IN * 2)) + 1)
            wg = [quant.gather_dequant({"q": q, "s": s}, idxs[i].long(), torch.bfloat16)
                  for i in range(n_wg)]
            bound = bytes_moved(distinct(kind, M), M, OUT, IN) / READ_CEILING * 1e3
            forms = list(libs) + ["torch.bmm"]

            def fn(form):
                if form == "torch.bmm":
                    return lambda i: torch.bmm(wg[i % n_wg], xb)
                return lambda i: launch(libs[form], x, q, s, idxs[i % SETS])

            times = in_turns(forms, fn, CALLS)
            ref = k3.moe_fp4_gemv_plain(x, q, s, idxs[0])
            for f in forms:
                ms = sum(times[f]) / len(times[f])
                err = None
                if f != "torch.bmm" and libs[f][1]:
                    err = max_err(launch(libs[f], x, q, s, idxs[0]), ref)
                row = {"shape": name, "OUT": OUT, "IN": IN, "M": M, "routing": kind,
                       "experts": distinct(kind, M), "form": f, "ms": ms,
                       "each_ms": times[f], "bound_ms": bound, "of_bound": bound / ms,
                       "launches_a_step": n_step, "max_abs_err": err}
                table.append(row)
                verdict = ("" if err is None else
                           f"; err {err:.2e} {'ok' if err <= TOL else 'FAIL'}")
                print(f"  {name} M={M:2d} {kind:8s} {f:22s} {ms * 1e3:8.2f} us  "
                      f"{bound / ms:6.1%} of {bound * 1e3:.2f} us{verdict}", flush=True)
            del wg
            torch.cuda.empty_cache()
        del q, s
        torch.cuda.empty_cache()
    return table


def candidate_plans(OUT: int, IN: int, M: int) -> list:
    """Every plan of 2, 4 or 8 warps a block whose K parts each keep a unit
    and whose tiles are no more than the shape has."""
    base = k3.plan(OUT, IN, GROUP, M, SMS)
    nu, tiles = IN // base.unit, -(-OUT // k3.WARP_CH)
    return [k3.Plan(rt, warps // rt, base.unit)
            for warps in (2, 4, 8) for rt in (1, 2, 4, 8)
            if warps % rt == 0 and warps // rt <= nu and rt <= tiles]


def sweep(lib) -> list:
    """``as-is`` at every candidate plan of each shape and case, in turns A
    B .. B A; rows of the table, the plan's own marked."""
    table = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    perm = torch.randperm(E, generator=gen, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, OUT, IN, _ in SHAPES:
        q, s = fp4_weight(gen, E, OUT, IN, "cuda")
        for M, kind in CASES:
            idxs = [route(kind, M, E, perm, i) for i in range(SETS)]
            x = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
            bound = bytes_moved(distinct(kind, M), M, OUT, IN) / READ_CEILING * 1e3
            own = k3.plan(OUT, IN, GROUP, M, sms)
            plans = candidate_plans(OUT, IN, M)
            times = in_turns(plans, lambda p: lambda i: launch(lib, x, q, s, idxs[i % SETS], p),
                             CALLS)
            rows = [{"shape": name, "M": M, "routing": kind, "plan": list(p), "own": p == own,
                     "blocks": p.blocks(OUT) * M, "ms": sum(times[p]) / 2, "bound_ms": bound}
                    for p in plans]
            table += rows
            best = min(rows, key=lambda r: r["ms"])
            mine = next((r for r in rows if r["own"]), None)
            mine_text = (f"own plan {tuple(mine['plan'][:2])} {mine['ms'] * 1e3:7.2f} us"
                         if mine else f"own plan {tuple(own)[:2]} not in the family")
            print(f"  {name} M={M:2d} {kind:8s} {mine_text}; best {tuple(best['plan'][:2])} "
                  f"({best['blocks']} blocks) {best['ms'] * 1e3:7.2f} us, "
                  f"{bound / best['ms']:6.1%} of {bound * 1e3:.2f} us", flush=True)
        del q, s
        torch.cuda.empty_cache()
    return table


def step_totals(table: list) -> dict:
    """Launches x time, summed over the step's shapes, a form: at M 6 (B =
    1) and at the shared M 12 (B = 2)."""
    out = {}
    for r in table:
        for key, (M, kind) in (("B1", (6, "distinct")), ("B2", (12, "shared"))):
            if (r["M"], r["routing"]) == (M, kind):
                d = out.setdefault(r["form"], {})
                d[key] = d.get(key, 0.0) + r["launches_a_step"] * r["ms"]
    return out


def run_cpu() -> dict:
    """The plans of the cases on SMS SMs; the plain version through the
    wrapper on CPU tensors against numpy in f64 at CPU_SHAPE, with a
    repeated and an invalid id."""
    plans = {}
    for (name, OUT, IN, _), (M, kind) in itertools.product(SHAPES, CASES):
        p = k3.plan(OUT, IN, GROUP, M, SMS)
        plans[f"{name} M={M} {kind}"] = {**p._asdict(), "blocks": p.blocks(OUT) * M,
                                         "warps": p.rt * p.ks}
    E_, OUT, IN = CPU_SHAPE
    rng = np.random.default_rng(0)
    w = rng.standard_normal((E_, OUT, IN)).astype(np.float32) * 0.1
    c = quant.quantize_fp4_stack(w, group=GROUP)
    x = rng.standard_normal((6, IN)).astype(np.float32)
    idx = np.array([2, 0, 2, -1, 3, E_], np.int32)
    wq = quant.dequant_any(c, torch.bfloat16).double().numpy()
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    want = np.stack([wq[e] @ xb[m] if 0 <= e < E_ else np.zeros(OUT)
                     for m, e in enumerate(idx)])
    before = k3.launches
    got = k3.moe_fp4_gemv(torch.from_numpy(x), c["q"], c["s"], torch.from_numpy(idx)).numpy()
    assert k3.launches == before
    out = {"plans": plans, "cpu_shape": CPU_SHAPE,
           "max_abs_err": float(np.abs(got - want).max()),
           "step_bound_us": {"B1": step_bound_ms() * 1e3,
                             "B2": step_bound_ms(12, "shared") * 1e3}}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="plans and the plain version, no card")
    ap.add_argument("--mutants", action="store_true", help="plant faults and run the checks")
    ap.add_argument("--parent", help="a source of the first design: its parts too")
    ap.add_argument("--sweep", action="store_true", help="every plan of each case")
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    if args.cpu:
        run_cpu()
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("k3_study: no CUDA device (use --cpu for the plans)")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    if args.mutants:
        result = {"card": card, "mutants": run_mutants()}
        ok = all(m["failed"] > 0 for m in result["mutants"].values())
    elif args.sweep:
        sources = variant_sources()
        lib = build_variants({"as-is": sources["as-is"]})["as-is"]
        result = {"card": card, "sweep": sweep(lib)}
        ok = True
    else:
        libs = build_variants(variant_sources(args.parent))
        table = time_cases(libs)
        totals = step_totals(table)
        bounds = {"B1": step_bound_ms(), "B2": step_bound_ms(12, "shared")}
        for form, t in totals.items():
            print(f"  step (24 launches) {form:22s} B = 1 {t['B1'] * 1e3:8.2f} us "
                  f"({bounds['B1'] / t['B1']:6.1%} of {bounds['B1'] * 1e3:.2f}); B = 2 "
                  f"{t['B2'] * 1e3:8.2f} us ({bounds['B2'] / t['B2']:6.1%} of "
                  f"{bounds['B2'] * 1e3:.2f})", flush=True)
        result = {"card": card, "table": table, "step_ms": totals, "step_bound_ms": bounds}
        ok = all(r["max_abs_err"] is None or r["max_abs_err"] <= TOL for r in table)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result))
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
