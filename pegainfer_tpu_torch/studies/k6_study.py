"""K6 study on the H100: what holds the int8 expert GEMV
(``csrc/int8_gemv.cu``) at the shapes of a DeepSeek-V4-Flash int8 decode
step with the chain off, and which of its parts costs.

    python -m pegainfer_tpu_torch.studies.k6_study [--parent FILE] [--out FILE]
    python -m pegainfer_tpu_torch.studies.k6_study --sweep [--out FILE]
    python -m pegainfer_tpu_torch.studies.k6_study --mutants [--out FILE]
    python -m pegainfer_tpu_torch.studies.k6_study --dense [--out FILE]
    python -m pegainfer_tpu_torch.studies.k6_study --cpu

Variants are copies of a source with text substituted, built in parallel
into ``build/k6_study/`` (git-ignored, ``studies/variants.py``) and called
through their C interface. The variants follow the design of the source
they are cut from:

- the first design (a block a routed row and 32 output rows; a row routed
  to an expert that an earlier row has returns at once, the first row's
  block taking the expert's rows 4 at a time; x staged in shared memory; a
  warp a weight row, a lane 16-code chunks, 4 in flight; f32 FMAs; ``--parent
  FILE``, an earlier commit's source unpacked with ``git archive`` under
  ``build/``): ``as-is``; ``loads-only`` (the code loads alone, their words
  summed); ``no-convert`` (the code bits used as floats as they are);
  ``no-products`` (x's unpacking and the FMAs taken out, each chunk's
  converted codes summed by XOR); ``no-dedupe`` (every row streams its own
  expert, as S3's ``expert_gemv`` does); ``x-from-global`` (x read from
  global memory, no shared-memory staging or ``__syncthreads``);
  ``unroll-8`` (8 chunks in flight a lane, not 4);
- the current design (rows grouped by expert, the plan, mma.sync, a tile's
  K parts taking its steps in turn): ``as-is``; ``loads-only`` (codes and x loaded, their
  words summed); ``no-convert`` (the code words go to the mma as they are);
  ``no-mma`` (the convert kept, the mma replaced by an XOR); ``no-loads``
  (the grouping, the launch and the block's sums alone); ``no-grouping``
  (every row its own group, its expert read once a row); ``prefetch`` (the
  next step's codes loaded before this step's products);
  ``contiguous-parts`` (a K part a contiguous range of steps, not every
  ks-th step); ``runs-1`` / ``runs-4`` (1 or 4 runs of 16 codes a thread a
  step, not 2); ``two-blocks`` (registers capped for two blocks an SM, not
  three); ``l2-128b`` (the code loads ask L2 for their whole 128-byte
  line).

Cases: w1 (2048 x 4096, as w3) and w2 (4096 x 2048) at M 1, 6 and 12 with
distinct experts and at M 12 routed as two tokens sharing 3 of their 6
experts (B = 2; 9 distinct). The stacks hold all 256 experts' int8 codes
(2.15 GB each); the timed calls rotate over SETS expert sets, consecutive
sets disjoint, so no call finds its experts in the 50 MB L2. Every variant
and the yardsticks, timed by CUDA events in turns A B .. B A: one
``torch.bmm`` of the routed experts gathered and converted to bf16 ahead
(as ``chip_smoke.py`` times it; sets enough for twice the L2), at M 1
``torch.matmul`` on the expert's bf16 weight (copies for twice the L2), and
S3's ``expert_gemv`` convert form at 32 rows a block (no dedupe). Each time
stands beside its bound at the read ceiling that ``gemv_stream_study``
measured (3.1224 TB/s: the distinct experts' codes, x in bf16 and y in f32,
once); the variants whose values are right are held row by row to RTOL of
each row's max |ref| against ``moe_int8_gemv_plain``. Then the step's K6
time, launches x time (16 w1 / w3 and 8 w2 launches of the smoke's 8
layers) at M 6 (B = 1) and at the shared M 12 (B = 2). Prints the card
line; ``--out`` writes every row as JSON.

``--sweep`` times ``as-is`` at every plan of 2, 4 or 8 warps a block at
each case, beside the plan ``ops/cuda/int8_gemv.py::plan`` picks.

``--mutants`` plants four faults, each in its own copy of the current
source, and runs ``check`` (the card tests' cases, each row at RTOL of its
max |ref|, which is also the smoke's ``INT8_GEMV_RTOL``) on each through the
wrapper: a dropped K part of the first block, the last 16-channel tile
never written, the second row of a repeated-expert group dropped, the rows
of invalid ids never zeroed. It reports, for each, the cases it fails and
by what factor. ``check`` fills the block that y will take with NaN first,
so an element left unwritten fails.

``--dense`` runs K6 at one expert (``int8_gemv_dense``, which carried the
decode rows of the int8 weight-only linears of Qwen3 and Qwen3.5 until the
int8 linear kernel took them, ``studies/int8_linear_study.py``) on random
stacks at ``DENSE_SHAPES`` and ``DENSE_ROWS``: each row against its plain
version (y NaN-filled first), then each beside its plain version, bf16
``torch.matmul``, the JAX form (``quant.int8_mm``: codes made bf16, then
one product) and ``torch._weight_int8pack_mm`` where this torch runs it on
the card, and each family's decode-step sums (``chip_smoke.py`` holds K6
at one expert to its plain version on the served models' weights with
``dense_check``).

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
import re
import sys
from pathlib import Path

import numpy as np
import torch

from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda import expert_stream as es
from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
from pegainfer_tpu_torch.studies import k3_study
from pegainfer_tpu_torch.studies.expert_stream_study import READ_CEILING
from pegainfer_tpu_torch.studies.k3_study import CASES, L2_BYTES, SETS, SHAPES, SMS
from pegainfer_tpu_torch.studies.timing import card_line
from pegainfer_tpu_torch.studies.variants import compile_variants, in_turns, substitute

OUT_DIR = build.BUILD_DIR / "k6_study"
E = 256  # DeepSeek-V4-Flash's routed experts
CALLS = 200  # timed calls a timing
# K6 forms the plain version's exact f32 products and sums them in another
# order, on unscaled outputs of about 1e4 (codes up to 127): each row to
# 1e-5 of its max |ref| (chip_smoke.INT8_GEMV_RTOL,
# tests/test_torch_kernels_cuda.INT8_GEMV_RTOL); a row of an invalid id
# must be exactly 0
RTOL = 1e-5
CHECK_E = 64  # experts of the check cases' stacks
CPU_SHAPE = (4, 96, 512)  # E, OUT, IN of --cpu
S3_ROWS = 32  # output rows a block of S3's expert_gemv yardstick
YARDSTICKS = ("torch.bmm", "torch.matmul", "S3 expert_gemv")

# ── the variants of the first design (a block a routed row) ─────────────
P_LOAD = "          decode_s8x16(__ldg(qrow + c), w);\n"
P_ROWS = ("#pragma unroll\n          for (int r = 0; r < kGroup; ++r) {\n",
          "                for (int i = 0; i < 8; ++i) acc[r] = fmaf(w[8 * h + i], xv[i], acc[r]);\n"
          "              }\n            }\n          }\n")
P_DEDUPE = ("  if (valid) {\n    for (int j = 0; j < m; ++j)\n"
            "      if (idx[j] == e) return;  // an earlier row's block serves this expert\n  }\n")
P_STAGE = ("    __syncthreads();  // the previous group's products are done with xs\n",
           "    __syncthreads();\n    for (int o = o_begin + warp;")
P_XS = "                unpack_bf16x8(xs[r * units + swz(c * kUnitsPerChunk + h)], xv);\n"
PARENT = {
    "as-is": ({}, True),
    "loads-only": ({("          float w[16];\n", P_ROWS[1]):
                    "          const uint4 v = __ldg(qrow + c);\n"
                    "          acc[0] += static_cast<float>((v.x ^ v.y ^ v.z ^ v.w) & 0xFFFFu);\n"},
                   False),
    "no-convert": ({P_LOAD: "          {\n            const uint4 v = __ldg(qrow + c);\n"
                            "            const uint32_t wd[4] = {v.x, v.y, v.z, v.w};\n"
                            "#pragma unroll\n            for (int i = 0; i < 16; ++i) "
                            "w[i] = __uint_as_float(wd[i >> 2] >> (i & 3));\n          }\n"},
                   False),
    "no-products": ({P_ROWS: "          {\n            uint32_t v = 0;\n#pragma unroll\n"
                             "            for (int i = 0; i < 16; ++i) v ^= __float_as_uint(w[i]);\n"
                             "            acc[0] += __uint_as_float(v & 0x3FFFFFu);\n          }\n"},
                    False),
    "no-dedupe": ({P_DEDUPE: "",
                   "      if (j == m || (valid && idx[j] == e)) rows[n++] = j;\n":
                   "      if (j == m) rows[n++] = j;\n"}, True),
    "x-from-global": ({P_STAGE: "    for (int o = o_begin + warp;",
                       P_XS: "                unpack_bf16x8(__ldg(reinterpret_cast<const uint4*>("
                             "x + static_cast<size_t>(rows[r]) * IN) + c * kUnitsPerChunk + h), "
                             "xv);\n"}, True),
    "unroll-8": ({"#pragma unroll 4\n": "#pragma unroll 8\n"}, True),
}

# ── the variants of the current design (grouped rows, the plan, mma.sync) ─
C_STEPS = "  const int steps = nsteps > kp ? (nsteps - kp + ks - 1) / ks : 0;  // this part's\n"
C_BASE = "      const int base = (st * ks + kp) * kStepK;\n"
C_LOAD = ("        for (int h = 0; h < 2; ++h) a[u][h] = col < IN ? ld_codes(qr[h] + col) : zero;\n"
          "      }\n")
C_CONVERT = ("            s8x4_to_bf16x2(word(a[u][0], 2 * xi + hw), af[0], af[2]);\n"
             "            s8x4_to_bf16x2(word(a[u][1], 2 * xi + hw), af[1], af[3]);\n")
C_MMA = "            mma_bf16(cr, af, word(xw, 2 * hw), word(xw, 2 * hw + 1));\n"
C_PRODUCTS = ("        // the run's sums, in fresh registers, added to c once\n",
              "        for (int i = 0; i < 4; ++i) c[i] += cr[i];\n")
C_GROUP = "  slot_group<kChunkRows>(idx, M, E, slot, lane, expert, rows, invalid);\n"
C_STORE = "      if (o < OUT) y["
C_ZERO = "  if (slot % kChunkRows == 0) {  // the chunk's rows of invalid ids are 0\n"
C_XV = "    const bool xv = n0 + g < cnt;\n"
C_RUNS = "constexpr int kRuns = 2;"
C_LD = "ld.global.nc.L1::no_allocate.v4.u32"
CURRENT = {
    "as-is": ({}, True),
    "loads-only": ({C_PRODUCTS: """        {
          uint32_t v = 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) v ^= a[u][h].x ^ a[u][h].y ^ a[u][h].z ^ a[u][h].w;
#pragma unroll
          for (int xi = 0; xi < 2; ++xi) {
            const uint4 w = xv && in ? __ldg(reinterpret_cast<const uint4*>(xr + col) + xi) : zero;
            v ^= w.x ^ w.y ^ w.z ^ w.w;
          }
          c[0] += static_cast<float>(v & 0xFFFFu);
        }
"""}, False),
    "no-convert": ({C_CONVERT: "            af[0] = word(a[u][0], 2 * xi + hw), af[2] = af[0] >> 8;\n"
                               "            af[1] = word(a[u][1], 2 * xi + hw), af[3] = af[1] >> 8;\n"},
                   False),
    "no-mma": ({C_MMA: "            cr[hw] += __uint_as_float((af[0] ^ af[1] ^ af[2] ^ af[3] ^ "
                       "word(xw, 2 * hw) ^ word(xw, 2 * hw + 1)) & 0x3FFFFFFFu);\n"}, False),
    # the grouping, the launch and the block's sums, no K loop
    "no-loads": ({C_STEPS: "  const int steps = 0;\n"}, False),
    # every valid row its own group, after the grouping (whose invalid mask stays)
    "no-grouping": ({C_GROUP: C_GROUP + """  {
    const int own = idx[slot];
    expert = own >= 0 && own < E ? own : -1;
    rows = expert < 0 ? 0u : 1u << (slot % kChunkRows);
  }
"""}, True),
    # the next step's codes loaded before this step's products (a register
    # double buffer)
    "prefetch": ({("    for (int st = 0; st < steps; ++st) {\n", C_LOAD): """    uint4 nxt[kRuns][2];
    auto load = [&](int b) {
#pragma unroll
      for (int u = 0; u < kRuns; ++u) {
        const int col = b + 16 * t + 64 * u;
#pragma unroll
        for (int h = 0; h < 2; ++h) nxt[u][h] = col < IN ? ld_codes(qr[h] + col) : zero;
      }
    };
    if (steps > 0) load(kp * kStepK);
    for (int st = 0; st < steps; ++st) {
""" + C_BASE + """      uint4 a[kRuns][2];
#pragma unroll
      for (int u = 0; u < kRuns; ++u) a[u][0] = nxt[u][0], a[u][1] = nxt[u][1];
      if (st + 1 < steps) load(base + ks * kStepK);
"""}, True),
    # K part kp a contiguous range of steps, not every ks-th step
    "contiguous-parts": ({C_STEPS: "  const int s0 = kp * nsteps / ks, steps = (kp + 1) * nsteps / ks - s0;\n",
                          C_BASE: "      const int base = (s0 + st) * kStepK;\n"}, True),
    "runs-1": ({C_RUNS: "constexpr int kRuns = 1;"}, True),
    "runs-4": ({C_RUNS: "constexpr int kRuns = 4;"}, True),
    "two-blocks": ({"constexpr int kBlocksPerSm = 3;": "constexpr int kBlocksPerSm = 2;"}, True),
    "l2-128b": ({C_LD: "ld.global.nc.L1::no_allocate.L2::128B.v4.u32"}, True),
}
# the planted faults of --mutants, each a copy of the current source
MUTANTS = {
    "dropped K part": {C_STEPS: C_STEPS.replace(
        "nsteps > kp ?", "nsteps > kp && !(blockIdx.x == 0 && kp == ks - 1 && ks > 1) ?")},
    "last output tile skipped": {C_STORE: "      if (o < (OUT - 1) / 16 * 16) y["},
    "second row of a group dropped": {C_XV: "    const bool xv = n0 + g < cnt && n0 + g != 1;\n"},
    "invalid ids not zeroed": {C_ZERO: "  if (false) {\n"},
}


def is_parent(text: str) -> bool:
    """Whether a source is of the first design (its C interface takes no
    launch plan)."""
    return "int OUT, int IN, void* stream)" in text


def step_k(text: str) -> int:
    """Columns of a warp step of a current-design source (4 lanes x kRuns
    runs of 16 codes)."""
    return 64 * int(re.search(r"constexpr int kRuns = (\d+);", text).group(1))


def variant_sources(parent=None, mutants=False) -> dict:
    """name -> (source text, whether its values are right and checked)."""
    out = {}
    cur = (build.CSRC_DIR / "int8_gemv.cu").read_text()
    if mutants:
        return {f"mutant {name}": (substitute(name, cur, subs, "csrc/int8_gemv.cu"), True)
                for name, subs in MUTANTS.items()}
    for name, (subs, checked) in CURRENT.items():
        out[name] = (substitute(name, cur, subs, "csrc/int8_gemv.cu"), checked)
    if parent:
        text = Path(parent).read_text()
        if not is_parent(text):
            raise SystemExit(f"{parent} is not of the first design")
        for name, (subs, checked) in PARENT.items():
            out[f"parent {name}"] = (substitute(name, text, subs, parent), checked)
    return out


def build_variants(sources: dict) -> dict:
    """Each variant's library, built in parallel; prints ptxas's registers
    and spills. Returns {name: (library, checked, step columns or None for
    the first design)}."""
    built = compile_variants({name: text for name, (text, _) in sources.items()}, OUT_DIR)
    libs = {}
    for name, lib in built.items():
        text = sources[name][0]
        parent = is_parent(text)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_gemv.argtypes = [p] * 4 + [i] * (4 if parent else 7) + [p]
        lib.int8_gemv.restype = i
        libs[name] = (lib, sources[name][1], None if parent else step_k(text))
    return libs


def variant_plan(step: int, OUT: int, IN: int, M: int, sms: int) -> k3.Plan:
    """A current-design variant's plan: the wrapper's, with its own step."""
    return k3.split(OUT, IN, step, M, sms)


def launch(variant, x, q, idx, p=None):
    """One call of a variant's C interface: the first design at its own
    grid, the current one at ``p`` or its plan (rt, ks)."""
    lib, _, step = variant
    M, IN = x.shape
    E_, OUT, _ = q.shape
    y = torch.empty((M, OUT), dtype=torch.float32, device=x.device)
    plan = () if step is None else tuple(p or variant_plan(
        step, OUT, IN, M, torch.cuda.get_device_properties(x.device).multi_processor_count))[:2] + (
        M,)  # the routed rows' expert slots
    err = lib.int8_gemv(x.data_ptr(), q.data_ptr(), idx.data_ptr(), y.data_ptr(), M, E_, OUT, IN,
                        *plan, torch.cuda.current_stream().cuda_stream)
    build.check_launch("int8_gemv (study)", err)
    return y


def int8_weight(gen, E_: int, OUT: int, IN: int, device):
    """Codes over the whole int8 range but -128, as the quantizer gives."""
    return torch.randint(-127, 128, (E_, OUT, IN), dtype=torch.int8, generator=gen,
                         device=device)


def route(kind: str, M: int, E_: int, perm: torch.Tensor, i: int = 0) -> torch.Tensor:
    """K3's routings (``k3_study.route``: "distinct", "repeated", "shared",
    "invalid") and "one": all M rows on one expert (a group of more than 8
    rows takes a second pass)."""
    if kind == "one":
        return perm[i % E_].repeat(M).to(torch.int32)
    return k3_study.route(kind, M, E_, perm, i)


def distinct(kind: str, M: int) -> int:
    """Distinct valid experts of ``route(kind, M, ...)``."""
    return 1 if kind == "one" else k3_study.distinct(kind, M)


def bytes_moved(n_experts: int, M: int, OUT: int, IN: int) -> int:
    """The distinct experts' codes, x in bf16 and y in f32, each once."""
    return n_experts * OUT * IN + 2 * M * IN + 4 * M * OUT


def step_bound_ms(M=6, kind="distinct") -> float:
    """The byte bound of a decode step's K6 launches at the read ceiling."""
    return sum(n * bytes_moved(distinct(kind, M), M, o, i)
               for _, o, i, n in SHAPES) / READ_CEILING * 1e3


def row_err(y, ref, rtol=RTOL) -> tuple:
    """(max |y - ref|, the worst row's share of its limit rtol x max
    |ref[m]|): a row of zeros in ref must be exactly 0; inf where y is not
    finite."""
    err = (y.float() - ref.float()).abs().amax(dim=1)
    lim = rtol * ref.float().abs().amax(dim=1)
    if not bool(torch.isfinite(y).all()):
        return math.inf, math.inf
    share = torch.where(lim > 0, err / lim.clamp_min(1e-30),
                        torch.where(err > 0, torch.full_like(err, math.inf), torch.zeros_like(err)))
    return err.max().item(), share.max().item()


def check_cases() -> list:
    """The card tests' K6 cases: (label, OUT, IN, M, routing), on stacks of
    CHECK_E experts: w1 / w2 at the step's row counts and routings, two
    chunks of rows (M 20, 40), all rows on one expert (M 16, 20: a group of
    more than 8 rows takes a second pass), invalid ids, a ragged last tile (OUT 1000) and an IN no step
    divides (400: one K part, its last step part in)."""
    shapes = (("w1", 2048, 4096), ("w2", 4096, 2048))
    main = ((1, "distinct"), (2, "repeated"), (6, "distinct"), (6, "repeated"),
            (12, "distinct"), (12, "repeated"), (12, "shared"), (20, "distinct"),
            (20, "repeated"), (40, "repeated"), (16, "one"), (20, "one"), (6, "invalid"),
            (12, "invalid"), (20, "invalid"))
    cases = [(f"{n} M={M} {r}", o, i, M, r) for n, o, i in shapes for M, r in main]
    cases += [(f"OUT 1000 IN 400 M={M} {r}", 1000, 400, M, r)
              for M, r in ((1, "distinct"), (12, "shared"), (20, "invalid"))]
    return cases


def run_case(case, device="cuda", weights=None):
    """One check case through the wrapper, on a bf16 x (so the wrapper
    allocates only y) after a NaN fill of a block of y's size, which the
    caching allocator hands to y: an element left unwritten stays NaN.
    Returns (y, the plain version's y)."""
    _, OUT, IN, M, kind = case
    gen = torch.Generator(device=device).manual_seed(OUT + IN + M)
    if weights is None or (OUT, IN) not in weights:
        q = int8_weight(gen, CHECK_E, OUT, IN, device)
        if weights is not None:
            weights[(OUT, IN)] = q
    else:
        q = weights[(OUT, IN)]
    perm = torch.randperm(CHECK_E, generator=gen, device=device)
    idx = route(kind, M, CHECK_E, perm)
    x = torch.randn((M, IN), generator=gen, device=device).to(torch.bfloat16)
    poison = torch.full((M, OUT), float("nan"), device=device)
    del poison
    y = k6.moe_int8_gemv(x, q, idx)
    return y, k6.moe_int8_gemv_plain(x, q, idx)


def check() -> list:
    """Each case of ``check_cases`` through the wrapper on the card against
    ``moe_int8_gemv_plain``: rows (label, max |diff|, worst row's share of
    its limit)."""
    weights = {}
    rows = []
    for case in check_cases():
        y, ref = run_case(case, weights=weights)
        rows.append((case[0], *row_err(y, ref)))
    return rows


def run_mutants() -> dict:
    """Each planted fault through the wrapper (its library in place of
    K6's): the cases it fails and the largest factor over its limit."""
    libs = build_variants(variant_sources(mutants=True))
    build.load("int8_gemv")
    real = build._libs["int8_gemv"]
    out = {}
    try:
        for name, (lib, _, _) in libs.items():
            build._libs["int8_gemv"] = lib
            rows = check()
            failed = [label for label, _, share in rows if not share <= 1.0]
            worst = max((share for _, _, share in rows), default=0.0)
            out[name] = {"cases": len(rows), "failed": len(failed), "worst_factor": worst,
                         "passed": [label for label, _, share in rows if share <= 1.0]}
            print(f"  {name}: fails {len(failed)} of {len(rows)} cases, worst at "
                  f"{worst:.3g} x its limit; passes {out[name]['passed'] or 'none'}", flush=True)
    finally:
        build._libs["int8_gemv"] = real
    return out


def time_cases(libs: dict) -> list:
    """Every variant and the yardsticks at each shape and case, in turns A
    B .. B A; rows of the table."""
    table = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    perm = torch.randperm(E, generator=gen, device="cuda")
    for name, OUT, IN, n_step in SHAPES:
        q = int8_weight(gen, E, OUT, IN, "cuda")
        for M, kind in CASES:
            idxs = [route(kind, M, E, perm, i) for i in range(SETS)]
            x = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
            xb = x[:, :, None]
            # the yardsticks' bf16 weights: sets (and at M 1 single experts)
            # enough for twice the L2
            n_wg = max(2, -(-2 * L2_BYTES // (M * OUT * IN * 2)) + 1)
            wg = [q[idxs[i].long()].to(torch.bfloat16) for i in range(n_wg)]
            forms = list(libs) + ["torch.bmm", "S3 expert_gemv"]
            if M == 1:
                forms.append("torch.matmul")
                w1b = [w[0] for w in wg]
            bound = bytes_moved(distinct(kind, M), M, OUT, IN) / READ_CEILING * 1e3

            def fn(form):
                if form == "torch.bmm":
                    return lambda i: torch.bmm(wg[i % n_wg], xb)
                if form == "torch.matmul":
                    return lambda i: torch.matmul(x, w1b[i % n_wg].T)
                if form == "S3 expert_gemv":
                    return lambda i: es.expert_gemv(x, q, idxs[i % SETS], False, S3_ROWS)
                return lambda i: launch(libs[form], x, q, idxs[i % SETS])

            times = in_turns(forms, fn, CALLS)
            ref = k6.moe_int8_gemv_plain(x, q, idxs[0])
            for f in forms:
                ms = sum(times[f]) / len(times[f])
                err = share = None
                if f == "S3 expert_gemv":
                    err, share = row_err(es.expert_gemv(x, q, idxs[0], False, S3_ROWS), ref)
                elif f not in YARDSTICKS and libs[f][1]:
                    err, share = row_err(launch(libs[f], x, q, idxs[0]), ref)
                row = {"shape": name, "OUT": OUT, "IN": IN, "M": M, "routing": kind,
                       "experts": distinct(kind, M), "form": f, "ms": ms,
                       "each_ms": times[f], "bound_ms": bound, "of_bound": bound / ms,
                       "launches_a_step": n_step, "max_abs_err": err, "row_share": share}
                table.append(row)
                verdict = ("" if share is None else
                           f"; err {err:.3g}, worst row {share:.3f} of its limit "
                           f"{'ok' if share <= 1.0 else 'FAIL'}")
                print(f"  {name} M={M:2d} {kind:8s} {f:22s} {ms * 1e3:8.2f} us  "
                      f"{bound / ms:6.1%} of {bound * 1e3:.2f} us{verdict}", flush=True)
            del wg
            torch.cuda.empty_cache()
        del q
        torch.cuda.empty_cache()
    return table


def candidate_plans(OUT: int, IN: int, M: int) -> list:
    """Every plan of 2, 4 or 8 warps a block whose K parts each keep a unit
    and whose tiles are no more than the shape has."""
    base = k6.plan(OUT, IN, M, SMS)
    nu, tiles = IN // base.unit, -(-OUT // k6.WARP_CH)
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
        q = int8_weight(gen, E, OUT, IN, "cuda")
        for M, kind in CASES:
            idxs = [route(kind, M, E, perm, i) for i in range(SETS)]
            x = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
            bound = bytes_moved(distinct(kind, M), M, OUT, IN) / READ_CEILING * 1e3
            own = k6.plan(OUT, IN, M, sms)
            plans = candidate_plans(OUT, IN, M)
            times = in_turns(plans, lambda p: lambda i: launch(lib, x, q, idxs[i % SETS], p),
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
        del q
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


# ── dense launches: the int8 weight-only linears of Qwen3 and Qwen3.5 ──

# (name, OUT, IN, launches a decode step): each distinct projection shape of
# a Qwen3-4B decode step (6 a layer x 36 and the head: 217 launches) and of
# a Qwen3.5 bench_config() one (7 a layer x 32 and the head: 225) under
# quantize="int8"
DENSE_SHAPES = (
    ("qwen3 wq", 4096, 2560, 36), ("qwen3 wk / wv", 1024, 2560, 72),
    ("qwen3 wo", 2560, 4096, 36), ("qwen3 w_gate_up", 19456, 2560, 36),
    ("qwen3 w_down", 2560, 9728, 36), ("qwen3 lm_head", 151936, 2560, 1),
    ("qwen35 gdn wq / wk", 2048, 2048, 48), ("qwen35 gdn wv / wz, full wq / wgate", 4096, 2048, 64),
    ("qwen35 out_proj / wo", 2048, 4096, 32), ("qwen35 full wk / wv", 512, 2048, 16),
    ("qwen35 mlp_gate_up", 12288, 2048, 32), ("qwen35 mlp_down", 2048, 6144, 32),
    ("qwen35 lm_head", 151936, 2048, 1),
)
DENSE_ROWS = (1, 2, 4, 8, 16, 32, 64)  # the decode batch buckets
DENSE_FORMS = ("K6", "plain", "bf16 matmul", "dequant + mm", "library")


def dense_check_cases() -> list:
    """The card tests' dense K6 cases: (label, OUT, IN, M) at Qwen3-4B's
    wq and wk shapes and a ragged OUT 1000 x IN 400, at one row, the
    buckets, a chunk and one row more (17: a second grid row of one row),
    two chunks and a pass of one (33)."""
    shapes = (("wq", 4096, 2560), ("wk", 1024, 2560), ("ragged", 1000, 400))
    return [(f"{n} M={M}", o, i, M) for n, o, i in shapes for M in (1, 2, 8, 16, 17, 33, 64)]


def run_dense(x, q):
    """``int8_gemv_dense`` after a NaN fill of a block of y's size (an
    element left unwritten stays NaN), and its plain version."""
    poison = torch.full((x.shape[0], q.shape[0]), float("nan"), device=x.device)
    del poison
    return k6.int8_gemv_dense(x, q), k6.int8_gemv_dense_plain(x, q)


def run_dense_case(case, device="cuda"):
    """One ``dense_check_cases`` case: (y, the plain version's y)."""
    _, OUT, IN, M = case
    gen = torch.Generator(device=device).manual_seed(OUT + IN + M)
    q = int8_weight(gen, 1, OUT, IN, device)[0]
    x = torch.randn((M, IN), generator=gen, device=device).to(torch.bfloat16)
    return run_dense(x, q)


def dense_check(stacks: dict, rows=DENSE_ROWS) -> list:
    """K6 against its plain version, row by row (``row_err``), on layer 0 of
    each shape's stack at each row count: [(label, max |diff|, worst row's
    share of its limit)]. ``stacks``: name -> (q [L, OUT, IN], s [L, OUT],
    w bf16 [L, IN, OUT])."""
    out = []
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, (q, _, _) in stacks.items():
        for M in rows:
            x = torch.randn((M, q.shape[2]), generator=gen, device="cuda").to(torch.bfloat16)
            y, ref = run_dense(x, q[0])
            out.append((f"{name} M={M}", *row_err(y, ref)))
    return out


LIBRARY_CALL = "torch._weight_int8pack_mm"


def library_refusal(x, q, s_b):
    """None where this torch runs ``torch._weight_int8pack_mm`` on the card
    (int8 [OUT, IN] codes and one scale a channel in x's dtype: the scaled
    int8 linear in one PyTorch call), else why it does not."""
    try:
        torch._weight_int8pack_mm(x, q, s_b)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        return f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return None


def dense_sweep(stacks: dict, ceiling: float, rows=DENSE_ROWS, calls: int = 60) -> list:
    """Each shape's stack at each row count: K6 (``int8_gemv_dense``), its
    plain version, bf16 ``x @ w`` (the bf16 mode's cost), the JAX form
    (``quant.int8_mm``: the codes made bf16 in device memory, then one
    product with f32 sums) and one library call where this torch has one,
    each timed by CUDA events (``timing.device_ms``) with the layer rotated
    every call, so the weights stream from device memory as in a decode
    step. Each beside its bound: the codes, x and y once over the
    nominal 3.35 TB/s and over ``ceiling`` (bytes / s). Rows of the table."""
    from pegainfer_tpu_torch.ops import quant
    from pegainfer_tpu_torch.studies.timing import device_ms

    table = []
    gen = torch.Generator(device="cuda").manual_seed(8)
    for name, (q, s, w) in stacks.items():
        L, OUT, IN = q.shape
        s_b = s.to(torch.bfloat16)
        for M in rows:
            x = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
            refusal = library_refusal(x, q[0], s_b[0])
            fns = {"K6": lambda i: k6.int8_gemv_dense(x, q[i % L]),
                   "plain": lambda i: k6.int8_gemv_dense_plain(x, q[i % L]),
                   "bf16 matmul": lambda i: x @ w[i % L],
                   "dequant + mm": lambda i: quant.int8_mm(x, q[i % L])}
            if refusal is None:
                fns["library"] = lambda i: torch._weight_int8pack_mm(x, q[i % L], s_b[i % L])
            n = max(L, calls - calls % L) if L > 1 else calls // 3
            ms = {f: device_ms(fn, n) for f, fn in fns.items()}
            nbytes = bytes_moved(1, M, OUT, IN)
            bound = max(nbytes / 3.35e12, 2 * M * OUT * IN / 989e12) * 1e3
            row = {"shape": name, "OUT": OUT, "IN": IN, "M": M, "layers": L,
                   **{f"{f}_ms": ms.get(f) for f in DENSE_FORMS},
                   "library_call": LIBRARY_CALL if refusal is None
                   else f"none ({LIBRARY_CALL}: {refusal})", "bytes": nbytes, "bound_ms": bound,
                   "bound_by": "bytes" if nbytes / 3.35e12 >= 2 * M * OUT * IN / 989e12
                   else "operations", "measured_bound_ms": nbytes / ceiling * 1e3}
            table.append(row)
            print(f"  K6 dense {name} ({OUT} x {IN}) M={M:2d}: K6 {ms['K6'] * 1e3:8.2f} us "
                  f"({row['measured_bound_ms'] / ms['K6']:6.1%} of its measured bound "
                  f"{row['measured_bound_ms'] * 1e3:.2f} us), plain {ms['plain'] * 1e3:8.2f}, "
                  f"bf16 matmul {ms['bf16 matmul'] * 1e3:8.2f}, dequant + mm "
                  f"{ms['dequant + mm'] * 1e3:8.2f}, library "
                  + (f"{ms['library'] * 1e3:8.2f} us" if refusal is None else "none"), flush=True)
    return table


def dense_random_stacks(family: str, gen) -> dict:
    """``dense_sweep``'s stacks for a family's DENSE_SHAPES on random codes
    and scales (bf16 weights beside them), each with enough layers for
    twice the L2 (the weights of a timed call come from device memory)."""
    from pegainfer_tpu_torch.ops import quant

    out = {}
    for name, OUT, IN, _ in DENSE_SHAPES:
        if not name.startswith(family + " "):
            continue
        L = max(2, -(-2 * L2_BYTES // (OUT * IN)) + 1)
        w = torch.randn((L, IN, OUT), generator=gen, device="cuda").mul_(0.02).to(torch.bfloat16)
        c = quant.quantize_int8_linear(w)
        out[name] = (c["q"], c["s"], w)
    return out


def run_dense_study(ceiling: float = READ_CEILING) -> dict:
    """``--dense``: K6 at one expert on random stacks at DENSE_SHAPES,
    checked row by row (``dense_check``), swept (``dense_sweep``), and each
    family's decode-step sums by row count; family by family, so at most
    one family's stacks are on the card."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    out = {"check": [], "table": [], "steps": {}}
    for family in ("qwen3", "qwen35"):
        stacks = dense_random_stacks(family, gen)
        out["check"] += dense_check(stacks)
        table = dense_sweep(stacks, ceiling)
        out["table"] += table
        out["steps"][family] = dense_step_totals(table, family)
        for M, t in out["steps"][family].items():
            print(f"  {family} decode step's int8 linears at {M:2d} rows: "
                  + ", ".join(f"{f} {v * 1e3:.1f} us" for f, v in t.items()), flush=True)
        del stacks
        torch.cuda.empty_cache()
    worst = max(share for _, _, share in out["check"])
    print(f"  dense check: worst row at {worst:.3f} of its limit", flush=True)
    out["ok"] = worst <= 1.0
    return out


def dense_step_totals(table: list, family: str) -> dict:
    """Per row count, each form's sum of launches x time over a decode step
    of ``family`` ("qwen3" or "qwen35"), from the sweep's rows."""
    n_step = {name: n for name, _, _, n in DENSE_SHAPES}
    out = {}
    for r in table:
        if not r["shape"].startswith(family + " "):
            continue
        d = out.setdefault(r["M"], {})
        for f in DENSE_FORMS:
            if r[f"{f}_ms"] is not None:
                d[f] = d.get(f, 0.0) + n_step[r["shape"]] * r[f"{f}_ms"]
        d["bound"] = d.get("bound", 0.0) + n_step[r["shape"]] * r["measured_bound_ms"]
    return out


def run_cpu() -> dict:
    """The plans of the cases on SMS SMs; the plain version through the
    wrapper on CPU tensors against numpy in f64 at CPU_SHAPE, with a
    repeated and two invalid ids."""
    plans = {}
    for (name, OUT, IN, _), (M, kind) in itertools.product(SHAPES, CASES):
        p = k6.plan(OUT, IN, M, SMS)
        plans[f"{name} M={M} {kind}"] = {**p._asdict(), "blocks": p.blocks(OUT) * M,
                                         "warps": p.rt * p.ks}
    E_, OUT, IN = CPU_SHAPE
    rng = np.random.default_rng(0)
    q = rng.integers(-127, 128, (E_, OUT, IN)).astype(np.int8)
    x = rng.standard_normal((6, IN)).astype(np.float32)
    idx = np.array([2, 0, 2, -1, 3, E_], np.int32)
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    want = np.stack([q[e].astype(np.float64) @ xb[m] if 0 <= e < E_ else np.zeros(OUT)
                     for m, e in enumerate(idx)])
    before = k6.launches
    got = k6.moe_int8_gemv(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(idx))
    assert k6.launches == before
    out = {"plans": plans, "cpu_shape": CPU_SHAPE,
           "max_rel_err": float(np.abs(got.numpy() - want).max() / np.abs(want).max()),
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
    ap.add_argument("--dense", action="store_true",
                    help="K6 at one expert at the int8 weight-only linears' shapes")
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    if args.cpu:
        run_cpu()
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("k6_study: no CUDA device (use --cpu for the plans)")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    if args.mutants:
        result = {"card": card, "mutants": run_mutants()}
        ok = all(m["failed"] > 0 for m in result["mutants"].values())
    elif args.dense:
        result = {"card": card, **run_dense_study()}
        ok = result["ok"]
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
        ok = all(r["row_share"] is None or r["row_share"] <= 1.0 for r in table)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result))
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
