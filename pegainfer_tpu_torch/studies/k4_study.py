"""K4 study on the H100: what holds the fp8 dense-linear GEMV
(``csrc/fp8_gemv.cu``) at the seven shapes of a DeepSeek-V4-Flash decode
step, and which of its parts costs.

    python -m pegainfer_tpu_torch.studies.k4_study [--parent FILE] [--out FILE]
    python -m pegainfer_tpu_torch.studies.k4_study --sweep [--out FILE]
    python -m pegainfer_tpu_torch.studies.k4_study --mutants [--out FILE]
    python -m pegainfer_tpu_torch.studies.k4_study --cpu

Variants are copies of a source with text substituted, built in parallel
into ``build/k4_study/`` (git-ignored) and called through their C interface.
The variants follow the design of the source they are cut from:

- the first design (a warp a row, a lane loop over 16-byte chunks, f32
  FMAs; ``--parent FILE``, for example an earlier commit's source unpacked
  with ``git archive`` under ``build/``): ``as-is``; ``loads-only`` (the
  weight loads alone, their words summed as integers); ``no-products``
  (loads, scale loads and decode, the products replaced by an XOR of the
  weights); ``no-scale-load`` (the scale taken as 1, never loaded);
  ``no-division`` (the scale's column by a shift, right for 128-column
  blocks); ``no-round`` (the bf16 rounding of each weight taken out);
- the current design (the plan, mma.sync): ``as-is``; ``unroll-2`` (2
  chunks a thread loads before it decodes, not 4); ``loads-only`` (weights, x and scales loaded, their words summed);
  ``no-decode`` (the codes go to the mma as they are); ``no-mma`` (the
  decode kept, the mma replaced by an XOR); ``no-scale-loads``;
  ``no-loads`` (the launch and the block's sums alone).

At each of the seven shapes, at M = 1, 2 and 8: random E4M3 weights with
power-of-two 128 x 128 block scales around 1 / sqrt(IN), in copies that
hold twice the 50 MB L2 (8 at least), each call on the next so that no call
finds its weight in L2; every variant and the yardstick ``torch.matmul`` (x
bf16 against the weight dequantized to bf16 ahead, copies enough for twice
the L2 too) timed by CUDA events in
turns A B .. B A; each time beside its bound at the read ceiling that
``gemv_stream_study`` measured (3.1224 TB/s: q, s, x in bf16 and y in f32
once); the variants whose values are right held to TOL against
``fp8_gemv_plain``. Then the step's K4 time, launches x time at M = 1 summed
over the shapes, against the step's bound. Prints the card line; ``--out``
writes every row as JSON.

``--sweep`` times ``as-is`` and ``unroll-2`` at every plan of tiles of 8 or
16 rows and 4, 8 or 16 warps a block, at each shape at M = 1, beside the
plan ``ops/cuda/fp8_gemv.py::plan`` picks.

``--mutants`` plants four faults, each in its own copy of the current
source, and runs ``check`` (the card tests' cases, at their limit TOL, which
is also the smoke's ``QUANT_GEMV_TOL``) on each through the wrapper: a
dropped K part of the first block, the wrong scale for the second
128-column block of every row, the last 16-row tile never written, the
eighth row of x dropped. It reports, for each, the cases it fails and by
what factor.

``--cpu`` prints the plans of the seven shapes on 132 SMs and runs the plain
version through the wrapper on CPU tensors against a numpy reference at a
small size; it times nothing. Without a card and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda import fp8_gemv as k4
from pegainfer_tpu_torch.studies.expert_stream_study import READ_CEILING
from pegainfer_tpu_torch.studies.k3_study import max_err
from pegainfer_tpu_torch.studies.timing import card_line
from pegainfer_tpu_torch.studies.variants import compile_variants, in_turns, substitute

OUT_DIR = build.BUILD_DIR / "k4_study"
# (name, OUT, IN, launches in a decode step of the smoke's 8 layers;
# models/dsv4.py: wq_a :437, wq_b :438, wkv :445, wo_b :456, shared w1 / w3 /
# w2 :562-564, idx_wq_b :692 / :788 on the ratio-4 layers)
STEP_SHAPES = (("wq_a", 1024, 4096, 8), ("wq_b", 32768, 1024, 8), ("wkv", 512, 4096, 8),
               ("wo_b", 4096, 8192, 8), ("shared_w1/w3", 2048, 4096, 16),
               ("shared_w2", 4096, 2048, 8), ("idx_wq_b", 8192, 1024, 3))
MS = (1, 2, 8)
BLOCK = 128
COPIES = 8  # weight copies a shape at least, each call on the next
L2_BYTES = 50 * 2 ** 20  # an H100's L2; a shape's copies hold at least twice it
CALLS = 100  # timed calls a timing
SMS = 132  # an H100 SXM's SMs: the plans --cpu prints
# K4 forms the plain version's exact f32 products (bf16 weights and x) and
# sums them in another order: the JAX kernel tests' atol, on unit-RMS
# outputs (chip_smoke.QUANT_GEMV_TOL, tests/test_torch_kernels_cuda.GEMV_TOL)
TOL = 2e-5
# the card tests' other shapes: (OUT, IN, block rows, block columns); a
# block of 0 is the full dim (quant.quantize_fp8_tensor's fallback)
FULL_DIM_SHAPES = ((512, 400, BLOCK, 0), (1000, 512, 0, BLOCK), (384, 1024, BLOCK, 0))
OLD_TEST_SHAPES = ((256, 384),)
CPU_SHAPE = (96, 384)

# ── the variants of the first design (a warp a row) ─────────────────────
P_SCALE = "      const float sc = __bfloat162float(srow[(c * 16) / ri]);\n"
P_ROUND = "      for (int i = 0; i < 16; ++i) w[i] = bf16_round(w[i] * sc);\n"
P_PRODUCTS = ("      for (int m = 0; m < M; ++m) {\n",
              "          for (int i = 0; i < 8; ++i) acc[m] = fmaf(w[8 * h + i], xv[i], acc[m]);\n"
              "        }\n      }\n")
P_XOR = """      for (int m = 0; m < 1; ++m) {
        uint32_t v = 0;
#pragma unroll
        for (int i = 0; i < 16; ++i) v ^= __float_as_uint(w[i]);
        acc[0] += static_cast<float>(v & 0xFFFFu);
      }
"""
P_LOADS = ((P_SCALE, P_PRODUCTS[1]),
           "      acc[0] += static_cast<float>((raw.x ^ raw.y ^ raw.z ^ raw.w) & 0xFFFFu);\n")
PARENT = {
    "as-is": ({}, True),
    "loads-only": (dict([P_LOADS]), False),
    "no-products": ({P_PRODUCTS: P_XOR}, False),
    "no-scale-load": ({P_SCALE: "      const float sc = 1.f;\n"}, False),
    "no-division": ({P_SCALE: P_SCALE.replace("(c * 16) / ri", "(c * 16) >> 7")}, True),
    "no-round": ({P_ROUND: P_ROUND.replace("bf16_round(w[i] * sc)", "w[i] * sc")}, False),
}

# ── the variants of the current design (the plan, mma.sync) ─────────────
C_UNROLL = "constexpr int kUnroll = 4;"
C_LOOP = "  for (int base = k0; base < k1; base += kUnroll * kChunk) {\n"
C_BODY = ("      float c4[4] = {0.f, 0.f, 0.f, 0.f};\n",
          "      for (int i = 0; i < 2 * R; ++i) acc[i] += c4[i];\n")
C_A = ("        const uint32_t a[4] = {e4m3x2_scaled(a0, 0, sc0[u]),\n",
       "                               R > 1 ? e4m3x2_scaled(a1, 1, sc1[u]) : 0u};\n")
C_MMA = "        mma_bf16(c4, a, word(xw, 2 * (st & 1)), word(xw, 2 * (st & 1) + 1));\n"
C_SCALES = ("      sc0[u] = in ? __bfloat162float(s0[j]) : 0.f;\n"
            "      sc1[u] = R > 1 && in ? __bfloat162float(s1[j]) : 0.f;\n")
C_STORE = "    if (row < OUT) y["
C_VX = "vx = g < M;"
CURRENT = {
    "as-is": ({}, True),
    "unroll-2": ({C_UNROLL: C_UNROLL.replace("4", "2")}, True),
    "loads-only": ({C_BODY: """      {
        uint32_t v = w0[u].x ^ w0[u].y ^ w0[u].z ^ w0[u].w ^ w1[u].x ^ w1[u].y ^ w1[u].z;
        v ^= w1[u].w ^ xa[u].x ^ xa[u].y ^ xa[u].z ^ xa[u].w ^ xb[u].x ^ xb[u].y ^ xb[u].z;
        acc[0] += static_cast<float>((v ^ xb[u].w) & 0xFFFFu) + sc0[u] + sc1[u];
      }
"""}, False),
    "no-decode": ({C_A: "        const uint32_t a[4] = {a0, a1, a0 ^ __float_as_uint(sc0[u]), "
                        "a1 ^ __float_as_uint(sc1[u])};\n"}, False),
    "no-mma": ({C_MMA: "        c4[st & 1] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ "
                       "word(xw, 2 * (st & 1)) ^ word(xw, 2 * (st & 1) + 1)) & 0x3FFFFFFFu);\n"},
               False),
    "no-scale-loads": ({C_SCALES: "      sc0[u] = sc1[u] = 1.f;\n"}, False),
    # the launch and the block's sums, no K loop
    "no-loads": ({C_LOOP: C_LOOP.replace("base < k1;", "base < k0;")}, False),
}
# the variants --sweep times at every plan
SWEPT = ("as-is", "unroll-2")
# the planted faults of --mutants, each a copy of the current source
MUTANTS = {
    "dropped K part": {C_LOOP: C_LOOP.replace(
        "base < k1;", "base < (blockIdx.x == 0 && kp == ks - 1 && ks > 1 ? k0 : k1);")},
    "wrong scale block": {C_SCALES: C_SCALES.replace("s0[j]", "s0[j == 1 ? 0 : j]")
                          .replace("s1[j]", "s1[j == 1 ? 0 : j]")},
    "last row tile skipped": {C_STORE: "    if (row < (OUT - 1) / kTileRows * kTileRows) y["},
    "x row 8 dropped": {C_VX: "vx = g < M - (M == 8);"},
}


def is_parent(text: str) -> bool:
    """Whether a source is of the first design (its C interface takes a
    block count)."""
    return "int blocks, void* stream)" in text


def variant_sources(parent=None, mutants=False) -> dict:
    """name -> (source text, whether its values are right and checked)."""
    out = {}
    cur = (build.CSRC_DIR / "fp8_gemv.cu").read_text()
    if mutants:
        for name, subs in MUTANTS.items():
            out[f"mutant {name}"] = (substitute(name, cur, subs, "csrc/fp8_gemv.cu"), True)
        return out
    for name, (subs, checked) in CURRENT.items():
        out[name] = (substitute(name, cur, subs, "csrc/fp8_gemv.cu"), checked)
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
        lib.fp8_gemv.argtypes = [p] * 4 + [i] * (7 if parent else 10) + [p]
        lib.fp8_gemv.restype = i
        libs[name] = (lib, sources[name][1], parent)
    return libs


def launch(variant, x, q, s, p=None):
    """One call of a variant's C interface: the first design at its
    wrapper's grid (at most 4 blocks an SM of 8 rows each), the current
    one at ``p`` or its plan."""
    lib, _, parent = variant
    M, IN = x.shape
    OUT = q.shape[0]
    So, Si = s.shape
    y = torch.empty((M, OUT), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if parent:
        grid = (min(-(-OUT // 8), 4 * sms),)
    else:
        grid = tuple(p or k4.plan(OUT, IN, IN // Si, sms))
    err = lib.fp8_gemv(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), M, OUT, IN,
                       OUT // So, IN // Si, Si, *grid, torch.cuda.current_stream().cuda_stream)
    build.check_launch("fp8_gemv (study)", err)
    return y


def fp8_weight(gen, OUT: int, IN: int, device, mantissa=False, bo=BLOCK, bi=BLOCK):
    """E4M3 codes of N(0, 1) values and bf16 block scales 2^e / sqrt(IN),
    e in {-1, 0, 1}, so that y has about unit RMS; with ``mantissa`` each
    scale also has a random mantissa (any bf16 value of those exponents).
    A block of 0 is the full dim."""
    bo, bi = bo or OUT, bi or IN
    q = torch.randn((OUT, IN), generator=gen, device=device).to(quant.F8)
    e = torch.randint(-1, 2, (OUT // bo, IN // bi), generator=gen, device=device).float()
    s = torch.exp2(e - round(np.log2(IN) / 2))
    if mantissa:
        s = s * (1 + torch.rand(s.shape, generator=gen, device=device))
    return q, s.to(torch.bfloat16)


def copies(OUT: int, IN: int) -> int:
    """Weight copies of a shape: COPIES, and more for a small weight, so
    that the copies hold twice the L2 and no call finds its weight there."""
    return max(COPIES, -(-2 * L2_BYTES // (OUT * IN)))


def bytes_moved(M: int, OUT: int, IN: int, So: int, Si: int) -> int:
    """q, s, x in bf16 and y in f32, each once."""
    return OUT * IN + 2 * So * Si + 2 * M * IN + 4 * M * OUT


def step_bound_ms() -> float:
    """The byte bound of a decode step's K4 launches at M = 1, at the read
    ceiling."""
    return sum(n * bytes_moved(1, o, i, o // BLOCK, i // BLOCK)
               for _, o, i, n in STEP_SHAPES) / READ_CEILING * 1e3


def check_cases() -> list:
    """The card tests' K4 cases: (label, OUT, IN, M, mantissa, bo, bi)."""
    cases = []
    for name, OUT, IN, _ in STEP_SHAPES:
        for mantissa in (False, True):
            for M in MS:
                cases.append((f"{name} M={M}{' mantissa' if mantissa else ''}", OUT, IN, M,
                              mantissa, BLOCK, BLOCK))
    for OUT, IN in OLD_TEST_SHAPES:
        for M in MS:
            cases.append((f"{OUT}x{IN} M={M}", OUT, IN, M, False, BLOCK, BLOCK))
    for OUT, IN, bo, bi in FULL_DIM_SHAPES:
        for M in MS:
            cases.append((f"{OUT}x{IN} blocks {bo or OUT}x{bi or IN} M={M}", OUT, IN, M, True,
                          bo, bi))
    return cases


def run_poisoned(x, q, s):
    """K4 through the wrapper on a bf16 x (so the wrapper allocates only y)
    after a NaN fill of a block of y's size, which the caching allocator
    hands to y: an element the kernel leaves unwritten stays NaN."""
    poison = torch.full((x.shape[0], q.shape[0]), float("nan"), device=x.device)
    del poison
    return k4.fp8_gemv(x, q, s)


def check() -> list:
    """Each case of ``check_cases`` through the wrapper on the card, y
    NaN-filled first, against ``fp8_gemv_plain``: rows (label, max |diff|,
    TOL)."""
    rows = []
    for label, OUT, IN, M, mantissa, bo, bi in check_cases():
        gen = torch.Generator(device="cuda").manual_seed(OUT + IN + M)
        q, s = fp8_weight(gen, OUT, IN, "cuda", mantissa, bo, bi)
        x = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
        y = run_poisoned(x, q, s)
        rows.append((label, max_err(y, k4.fp8_gemv_plain(x, q, s)), TOL))
    return rows


def run_mutants() -> dict:
    """Each planted fault through the wrapper (its library in place of
    K4's): the cases it fails and the largest factor over TOL."""
    libs = build_variants(variant_sources(mutants=True))
    build.load("fp8_gemv")
    real = build._libs["fp8_gemv"]
    out = {}
    try:
        for name, (lib, _, _) in libs.items():
            build._libs["fp8_gemv"] = lib
            rows = check()
            failed = [(label, err / lim) for label, err, lim in rows if not err <= lim]
            worst = max((err / lim for _, err, lim in rows), default=0.0)
            out[name] = {"cases": len(rows), "failed": len(failed), "worst_factor": worst,
                         "passed": [label for label, err, lim in rows if err <= lim]}
            print(f"  {name}: fails {len(failed)} of {len(rows)} cases, worst at "
                  f"{worst:.3g} x TOL; passes {out[name]['passed'] or 'none'}", flush=True)
    finally:
        build._libs["fp8_gemv"] = real
    return out


def time_shapes(libs: dict) -> list:
    """Every variant and torch.matmul at each shape and M, in turns A B ..
    B A; rows of the table."""
    table = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, OUT, IN, n_step in STEP_SHAPES:
        ws = [fp8_weight(gen, OUT, IN, "cuda") for _ in range(copies(OUT, IN))]
        # the yardstick's bf16 weights: copies enough for twice the L2 too
        wd = [quant.dequant_any({"q": q, "s": s}, torch.bfloat16)
              for q, s in ws[:max(2, copies(OUT, IN) // 2)]]
        So, Si = ws[0][1].shape
        for M in MS:
            x = torch.randn((M, IN), generator=gen, device="cuda").to(torch.bfloat16)
            bound = bytes_moved(M, OUT, IN, So, Si) / READ_CEILING * 1e3
            forms = list(libs) + ["torch.matmul"]

            def fn(form):
                if form == "torch.matmul":
                    return lambda i: torch.matmul(x, wd[i % len(wd)].T)
                return lambda i: launch(libs[form], x, *ws[i % len(ws)])

            times = in_turns(forms, fn, CALLS)
            ref = k4.fp8_gemv_plain(x, *ws[0])
            for f in forms:
                ms = sum(times[f]) / len(times[f])
                err = None
                if f != "torch.matmul" and libs[f][1]:
                    err = (launch(libs[f], x, *ws[0]) - ref).abs().max().item()
                row = {"shape": name, "OUT": OUT, "IN": IN, "M": M, "form": f, "ms": ms,
                       "each_ms": times[f], "bound_ms": bound, "of_bound": bound / ms,
                       "launches_a_step": n_step, "max_abs_err": err}
                table.append(row)
                verdict = ("" if err is None else
                           f"; err {err:.2e} {'ok' if err <= TOL else 'FAIL'}")
                print(f"  {name:13s} M={M} {f:24s} {ms * 1e3:8.2f} us  {bound / ms:6.1%} of "
                      f"{bound * 1e3:.2f} us{verdict}", flush=True)
        del ws, wd
        torch.cuda.empty_cache()
    return table


def candidate_plans(OUT: int, IN: int) -> list:
    """Every plan of tiles of 8 or 16 rows and 4, 8 or 16 warps a block whose
    K parts each keep a 128-column unit."""
    nu, out = IN // BLOCK, []
    for tile_rows in (8, 16):
        for warps in (4, 8, 16):
            for rt in (1, 2, 4, 8, 16):
                ks = warps // rt
                if ks >= 1 and rt * ks == warps and ks <= nu:
                    out.append(k4.Plan(tile_rows, rt, ks, BLOCK))
    return out


def sweep(libs: dict) -> list:
    """SWEPT's variants at every candidate plan of each shape, M = 1, in
    turns A B .. B A; rows of the table, the plan's own marked."""
    table = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x_all = torch.randn((1, 8192), generator=gen, device="cuda").to(torch.bfloat16)
    for name, OUT, IN, _ in STEP_SHAPES:
        ws = [fp8_weight(gen, OUT, IN, "cuda") for _ in range(copies(OUT, IN))]
        x = x_all[:, :IN].contiguous()
        bound = bytes_moved(1, OUT, IN, OUT // BLOCK, IN // BLOCK) / READ_CEILING * 1e3
        own = k4.plan(OUT, IN, BLOCK, sms)
        runs = [(v, p) for p in candidate_plans(OUT, IN) for v in libs]
        times = in_turns(runs, lambda r: lambda i: launch(libs[r[0]], x, *ws[i % len(ws)], r[1]),
                         CALLS)
        for v, p in runs:
            table.append({"shape": name, "form": v, "plan": list(p), "own": p == own,
                          "blocks": p.blocks(OUT), "ms": sum(times[(v, p)]) / 2,
                          "bound_ms": bound})
        for v in libs:
            rows = [r for r in table if r["shape"] == name and r["form"] == v]
            best = min(rows, key=lambda r: r["ms"])
            mine = next(r for r in rows if r["own"])
            print(f"  {name:13s} {v:9s} own plan {tuple(mine['plan'][:3])} "
                  f"{mine['ms'] * 1e3:7.2f} us; best {tuple(best['plan'][:3])} "
                  f"({best['blocks']} blocks) {best['ms'] * 1e3:7.2f} us, "
                  f"{bound / best['ms']:6.1%} of {bound * 1e3:.2f} us", flush=True)
        del ws
        torch.cuda.empty_cache()
    return table


def step_totals(table: list) -> dict:
    """Launches x time at M = 1, summed over the step's shapes, a form."""
    out = {}
    for r in table:
        if r["M"] == 1:
            out[r["form"]] = out.get(r["form"], 0.0) + r["launches_a_step"] * r["ms"]
    return out


def run_cpu() -> dict:
    """The plans of the seven shapes on SMS SMs; the plain version through
    the wrapper on CPU tensors against numpy in f64 at CPU_SHAPE."""
    plans = {}
    for name, OUT, IN, _ in STEP_SHAPES:
        p = k4.plan(OUT, IN, BLOCK, SMS)
        plans[name] = {**p._asdict(), "blocks": p.blocks(OUT), "warps": p.rt * p.ks}
    OUT, IN = CPU_SHAPE
    rng = np.random.default_rng(0)
    w = rng.standard_normal((OUT, IN)).astype(np.float32) * 0.1
    c = quant.quantize_fp8_tensor(w, block=BLOCK)
    x = rng.standard_normal((8, IN)).astype(np.float32)
    (So, Si), s = c["s"].shape, c["s"].float().numpy()
    sc = np.repeat(np.repeat(s, OUT // So, 0), IN // Si, 1)
    wq = torch.from_numpy(c["q"].float().numpy() * sc).to(torch.bfloat16).double().numpy()
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    want = xb @ wq.T
    before = k4.launches
    got = k4.fp8_gemv(torch.from_numpy(x), c["q"], c["s"]).numpy()
    assert k4.launches == before
    out = {"plans": plans, "cpu_shape": CPU_SHAPE,
           "max_abs_err": float(np.abs(got - want).max()),
           "step_bound_us": step_bound_ms() * 1e3}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="plans and the plain version, no card")
    ap.add_argument("--mutants", action="store_true", help="plant faults and run the checks")
    ap.add_argument("--parent", help="a source of the first design: its parts too")
    ap.add_argument("--sweep", action="store_true", help="every plan of each shape at M 1")
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    if args.cpu:
        run_cpu()
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("k4_study: no CUDA device (use --cpu for the plans)")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    if args.mutants:
        result = {"card": card, "mutants": run_mutants()}
        ok = all(m["failed"] > 0 for m in result["mutants"].values())
    elif args.sweep:
        sources = variant_sources()
        result = {"card": card, "sweep": sweep(build_variants({v: sources[v] for v in SWEPT}))}
        ok = True
    else:
        libs = build_variants(variant_sources(args.parent))
        table = time_shapes(libs)
        totals = step_totals(table)
        bound = step_bound_ms()
        for form, ms in totals.items():
            print(f"  step ({sum(n for *_, n in STEP_SHAPES)} launches at M=1) {form:24s} "
                  f"{ms * 1e3:8.2f} us, {bound / ms:6.1%} of {bound * 1e3:.2f} us", flush=True)
        result = {"card": card, "table": table, "step_ms": totals, "step_bound_ms": bound}
        ok = all(r["max_abs_err"] is None or r["max_abs_err"] <= TOL for r in table)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result))
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
