"""Time K9 (``csrc/fp4_chain.cu``, the fused packed-fp4 decode chain) with
parts of its work taken out, on one H100.

    python3 scripts/k9_study.py [--parent FILE] [--against FILE]

Builds variants of the kernel into ``build/k9_study/`` (git-ignored), each a
copy of a source with text substituted. The variants follow the design of
the source they are cut from:

- the earlier design (one warp a (row, channel), a 16-entry table in
  shared memory and a bf16 rounding a weight, FFMA chains): ``as-is``;
  ``no-round`` (the bf16 rounding of each weight taken out); ``no-table``
  (the table lookup replaced by arithmetic on the code's bits);
  ``k5-decode`` (common.cuh's ``e2m1x8_bf16x2`` in place of the table and
  the rounding, the same values); ``loads-only`` (the same loads, the raw
  words summed as integers, no decode and no products); ``phase1-only``;
  ``barrier-only`` (the launch and the grid barrier alone);
- the current design (rows grouped by expert, the decode into mma.sync A
  fragments): ``as-is``; ``no-decode`` (each decode replaced by 4 integer
  operations a word); ``no-scale-loads`` (scales taken as 1, never
  loaded); ``loads-only`` (the same loads, no decode and no products);
  ``phase1-only``; ``barrier-only`` (on the kernel's grid of two blocks an
  SM); ``three-blocks`` and ``loads-only-three-blocks`` (registers held to
  three blocks an SM); ``codes-ldg``, ``codes-no-l1`` and ``codes-l2-128``
  (the codes loaded by ``__ldg``, or with other cache hints than L1
  no-allocate and an L2 fetch of 256 bytes).

``csrc/fp4_chain.cu`` gets the variants of its design; ``--parent FILE``
adds those of another source's design (for example an earlier commit's,
unpacked with ``git archive``); ``--against FILE`` adds another source as
it is, built where it lies so that it includes the ``common.cuh`` beside
it. Beside them it times the path's sequence with the chain off: K3 on w1
and on w3, the SwiGLU, K3 on w2 (``models/dsv4.py``).

On random packed-fp4 stacks at DeepSeek-V4-Flash's widths (E 256, I 2048,
D 4096, group 32, power-of-two scales; eight layers, each call on the next,
so the weights come from device memory, as ``chip_smoke.time_fp4_chain``),
at B = 1 (6 distinct experts) and B = 2 (two tokens' top-6 experts, 12
rows, repeats as they fall): each variant whose values are right against
the plain version (each row within chip_smoke.CHAIN_ROW_RTOL of its max
|ref|), and every variant's time by CUDA events (chip_smoke.time_ms), in
turns A B .. B A, beside the bound over all routed rows and over the
distinct experts. Prints ptxas's report of each variant, the blocks an SM
that its registers and shared memory allow, and the card line.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pegainfer_tpu_torch.ops.cuda import build  # noqa: E402
from pegainfer_tpu_torch.ops.cuda import fp4_chain as k9  # noqa: E402
from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3  # noqa: E402
from pegainfer_tpu_torch.ops.moe import swiglu  # noqa: E402

OUT_DIR = ROOT / "build" / "k9_study"
E, I, D, GROUP, LAYERS, LIMIT = 256, 2048, 4096, 32, 8, 7.0
THREADS = 256  # both designs' block

# ── the variants of the earlier design (one warp a (row, channel)) ────
P_DECODE = (
    "      lo[4 * h + b] = bf16_round(lut[byte & 0xF] * sc);\n"
    "      hi[4 * h + b] = bf16_round(lut[byte >> 4] * sc);\n")
P_DECODE_BODY = (
    "  const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};\n"
    "#pragma unroll\n"
    "  for (int h = 0; h < 4; ++h) {\n"
    "#pragma unroll\n"
    "    for (int b = 0; b < 4; ++b) {\n"
    "      const uint32_t byte = (wd[h] >> (8 * b)) & 0xFF;\n" + P_DECODE + "    }\n  }\n")
P_DECODE_HEAD = "// 16 packed bytes under one scale -> lo[b], hi[b]"
# an E2M1 code's value from its bits: 0.5 for magnitude 1, else exponent
# (m >> 1) - 1 and mantissa bit m & 1; the sign from bit 3
P_ARITH = """__device__ __forceinline__ float e2m1_arith(uint32_t c) {
  const uint32_t m = c & 7u;
  const uint32_t bits = m < 2u ? m * 0x3F000000u : (((m >> 1) + 126u) << 23) | ((m & 1u) << 22);
  return __uint_as_float(bits | ((c & 8u) << 28));
}

"""
P_PHASE1 = (
    "        float lo1[16], hi1[16], lo3[16], hi3[16];\n",
    "            u = fmaf(hi3[4 * h + b], xv[2 * b + 1], u);\n          }\n        }\n")
P_PHASE1_LOADS = """        const uint4 a = __ldg(r1 + c), b = __ldg(r3 + c);
        uint32_t v = a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w;
        v += __bfloat16_as_ushort(sr1[(32 * c) / g1]) + __bfloat16_as_ushort(sr3[(32 * c) / g1]);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const uint4 xw = __ldg(xr + 4 * c + h);
          v += xw.x ^ xw.y ^ xw.z ^ xw.w;
        }
        g += static_cast<float>(v & 0xFFFFu);
"""
P_PHASE2 = (
    "        float lo[16], hi[16];\n",
    "              acc = fmaf(hi[4 * h + b], av[2 * b + 1], acc);\n            }\n          }\n"
    "        }\n")
P_PHASE2_LOADS = """        const uint4 a = __ldg(r2 + c);
        uint32_t v = a.x ^ a.y ^ a.z ^ a.w;
        v += __bfloat16_as_ushort(sr2[(32 * c) / g2]);
        const uint4* ar = reinterpret_cast<const uint4*>(am + 32 * c);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const uint4 aw = __ldcg(ar + h);
          v += aw.x ^ aw.y ^ aw.z ^ aw.w;
        }
        acc += static_cast<float>(v & 0xFFFFu);
"""
P_LOOP1 = "  for (int t = gwarp; t < M * I; t += nwarps) {"
P_LOOP2 = "  for (int t = gwarp; t < M * D; t += nwarps) {"
# name -> (substitutions, whether its output is right and checked); a
# tuple key replaces the lines from its first string through its second
PARENT = {
    "as-is": ({}, True),
    "no-round": ({P_DECODE: P_DECODE.replace("bf16_round(", "(")}, False),
    "no-table": ({P_DECODE: P_DECODE.replace("lut[byte & 0xF]", "e2m1_arith(byte & 0xF)")
                  .replace("lut[byte >> 4]", "e2m1_arith(byte >> 4)"),
                  P_DECODE_HEAD: P_ARITH + P_DECODE_HEAD}, True),
    "k5-decode": ({P_DECODE_BODY: """  const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
  const uint32_t scb = pack_bf16x2(sc, sc);
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    uint32_t r[4];
    e2m1x8_bf16x2(wd[h], scb, r);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      lo[4 * h + b] = __uint_as_float(r[b] << 16);
      hi[4 * h + b] = __uint_as_float(r[b] & 0xFFFF0000u);
    }
  }
"""}, True),
    "loads-only": ({P_PHASE1: P_PHASE1_LOADS, P_PHASE2: P_PHASE2_LOADS}, False),
    "phase1-only": ({P_LOOP2: P_LOOP2.replace("t < M * D", "t < 0")}, False),
    "barrier-only": ({P_LOOP1: P_LOOP1.replace("t < M * I", "t < 0"),
                      P_LOOP2: P_LOOP2.replace("t < M * D", "t < 0")}, False),
}

# ── the variants of the current design (rows grouped by expert) ───────
C_DECODE = ("    for (int q = 0; q < 4; ++q) e2m1x8_bf16x2(word(st.a[q], wi), st.s[q], r[q]);\n")
C_SCALES = ("  st.s[0] = __ldg(sa + r0 * S + j) * 0x10001u;\n",
            "  st.s[3] = __ldg(s1 + (r1 + 8) * S + j) * 0x10001u;\n")
C_GRID = "  if (per_sm < 1) return cudaErrorInvalidConfiguration;\n"
C_MMA = "      mma_step(c, cur, b, ntl);\n"
C_PHASE1 = "  run_phase<false, kPerm13>(gr, red, x, w1, s1, w3, s3, act, y, I, D, S1, limit);\n"
C_PHASE2 = ("  run_phase<true, kPerm13>(gr, red, x, w2, s2, nullptr, nullptr, act, y, I, D, S2, "
            "limit);\n")
CURRENT = {
    "as-is": ({}, True),
    "no-decode": ({C_DECODE: """    for (int q = 0; q < 4; ++q) {
      const uint32_t w = word(st.a[q], wi);
      r[q][0] = w;
      r[q][1] = w ^ st.s[q];
      r[q][2] = w + st.s[q];
      r[q][3] = w - st.s[q];
    }
"""}, False),
    "no-scale-loads": ({C_SCALES: "  st.s[0] = st.s[1] = st.s[2] = st.s[3] = 0x3F803F80u;\n"},
                       False),
    "loads-only": ({C_MMA: """      {
        uint32_t v = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v += cur.a[q].x ^ cur.a[q].y ^ cur.a[q].z ^ cur.a[q].w ^ cur.s[q];
#pragma unroll
        for (int q = 0; q < 16; ++q) v += b[0][q] ^ b[1][q];
        c[0][0][0] += static_cast<float>(v & 0xFFFFu);
      }
"""}, False),
    "phase1-only": ({C_PHASE2: ""}, False),
    # on the kernel's own grid of two blocks an SM
    "barrier-only": ({C_PHASE1: "", C_PHASE2: "",
                      C_GRID: C_GRID + "  per_sm = per_sm < 2 ? per_sm : 2;\n"}, False),
}
# more warps an SM: the kernel, and its loads alone, held to the registers
# of three blocks an SM
C_BOUNDS = "__global__ void __launch_bounds__(kThreads, 2)"
THREE = {C_BOUNDS: C_BOUNDS.replace("2)", "3)")}
CURRENT["three-blocks"] = (THREE, True)
CURRENT["loads-only-three-blocks"] = ({**CURRENT["loads-only"][0], **THREE}, False)
# the codes' loads (ld_codes) with other cache hints, or by __ldg
C_HINT = ".L1::no_allocate.L2::256B"
CURRENT["codes-ldg"] = ({("  uint4 v;\n  asm(\"ld.global.nc", "  return v;\n"):
                         "  return __ldg(reinterpret_cast<const uint4*>(p));\n"}, True)
CURRENT["codes-no-l1"] = ({C_HINT: ".L1::no_allocate"}, True)
CURRENT["codes-l2-128"] = ({C_HINT: ".L1::no_allocate.L2::128B"}, True)


def design(text: str):
    """The variants that fit a source's design."""
    return PARENT if "decode_fp4x32(" in text else CURRENT


def substitute(name: str, src: str, subs: dict, where: str) -> str:
    for old, new in subs.items():
        if isinstance(old, tuple):  # the lines from old[0] through old[1]
            i = src.find(old[0])
            j = src.find(old[1], i)
            if i < 0 or j < i:
                raise SystemExit(f"{name}: '{old[0]}' .. is not in {where}")
            src = src[:i] + new + src[j + len(old[1]):]
            continue
        if src.count(old) != 1:
            raise SystemExit(f"{name}: '{old}' is not in {where} once")
        src = src.replace(old, new)
    return src


def blocks_per_sm(regs: int, smem: int) -> int:
    """Blocks of THREADS threads an H100 SM holds at once, from ptxas's
    registers a thread and shared bytes a block: 64 K registers in units
    of 256 a warp, 228 KB of shared memory less 1 KB a block, 64 warps."""
    warps = THREADS // 32
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps if per_warp else 64
    by_smem = (228 * 1024) // (smem + 1024)
    return min(by_regs, by_smem, 64 // warps, 32)


def build_variants(parent=None, against=None):
    """Each variant's library, built in parallel; prints ptxas's report.
    Returns {name: (library, checked)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}  # name -> (path of the .cu, checked)
    sources = [("", build.CSRC_DIR / "fp4_chain.cu")]
    if parent:
        sources.append(("parent ", Path(parent)))
    for prefix, path in sources:
        text = path.read_text()
        for vname, (subs, checked) in design(text).items():
            name = prefix + vname
            cu = OUT_DIR / f"{name.replace(' ', '-')}.cu"
            cu.write_text(substitute(name, text, subs, str(path)))
            jobs[name] = (cu, checked)
    if against:
        jobs["against"] = (Path(against).resolve(), True)
    procs = {}
    for name, (cu, _) in jobs.items():
        so = OUT_DIR / f"lib{name.replace(' ', '-')}.so"
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}", flush=True)
        regs = max(int(r) for r in re.findall(r"Used (\d+) registers", log))
        smem = max([int(s) for s in re.findall(r"(\d+) bytes smem", log)] or [0])
        print(f"  {name}: {regs} registers, {smem} B static shared memory -> "
              f"{blocks_per_sm(regs, smem)} blocks of {THREADS} threads an SM", flush=True)
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fp4_chain.argtypes = [p] * 10 + [i] * 6 + [ctypes.c_float, i, p]
        lib.fp4_chain.restype = i
        libs[name] = (lib, jobs[name][1])
    return libs


def launch(lib, x, w1, w3, w2, idx):
    """One call of a variant's C interface (natural order, no perm13)."""
    M = x.shape[0]
    act = torch.empty((M, I), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((M, D), dtype=torch.float32, device=x.device)
    err = lib.fp4_chain(x.data_ptr(), w1["q"].data_ptr(), w1["s"].data_ptr(),
                        w3["q"].data_ptr(), w3["s"].data_ptr(), w2["q"].data_ptr(),
                        w2["s"].data_ptr(), idx.data_ptr(), act.data_ptr(), y.data_ptr(),
                        M, E, I, D, D // GROUP, I // GROUP, LIMIT, 0,
                        torch.cuda.current_stream().cuda_stream)
    build.check_launch("fp4_chain (study)", err)
    return y


def chain_off(x, w1, w3, w2, idx):
    """The path's sequence with the chain off (models/dsv4.py)."""
    act = swiglu(k3.moe_fp4_gemv(x, w1["q"], w1["s"], idx),
                 k3.moe_fp4_gemv(x, w3["q"], w3["s"], idx), LIMIT)
    return k3.moe_fp4_gemv(act, w2["q"], w2["s"], idx)


def stacks(gen):
    """LAYERS layers of w1, w3 [E, I, D/2] and w2 [E, D, I/2] with
    power-of-two scales around 1 / (2.93 sqrt(in)), so g, u and y have
    about unit RMS."""
    def one(out_d, in_d):
        q = torch.randint(0, 256, (E, out_d, in_d // 2), dtype=torch.uint8, generator=gen,
                          device="cuda")
        e = torch.randint(-1, 2, (E, out_d, in_d // GROUP), generator=gen, device="cuda")
        s = torch.exp2(e.float() - round(math.log2(2.93 * in_d ** 0.5)))
        return {"q": q, "s": s.to(torch.bfloat16)}

    return [(one(I, D), one(I, D), one(D, I)) for _ in range(LAYERS)]


def row_share(y, ref):
    """The worst row's max |diff| over CHAIN_ROW_RTOL x its max |ref|."""
    d = (y - ref).abs().amax(dim=1)
    lim = cs.CHAIN_ROW_RTOL * ref.abs().amax(dim=1)
    return torch.where(d > 0, d / lim, torch.zeros_like(d)).max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("k9_study: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another source of csrc/fp4_chain.cu: its design's parts")
    ap.add_argument("--against", help="another source of csrc/fp4_chain.cu, as it is")
    args = ap.parse_args()
    print(f"card: {cs.card_line()}; torch {torch.__version__}", flush=True)
    libs = build_variants(args.parent, args.against)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    ws = stacks(gen)
    x = {}
    idxs = {}
    for label, tokens in (("B=1", 1), ("B=2", 2)):
        M = 6 * tokens
        x[label] = torch.randn((M, D), generator=gen, device="cuda").to(torch.bfloat16)
        idxs[label] = [torch.cat([torch.randperm(E, generator=gen, device="cuda")[:6]
                                  for _ in range(tokens)]).to(torch.int32)
                       for _ in range(LAYERS)]
    w_bytes = sum(w["q"][0].nbytes + w["s"][0].nbytes for w in ws[0])
    ok = True
    for label in ("B=1", "B=2"):
        xs, idx = x[label], idxs[label]
        M = xs.shape[0]
        distinct = sum(int(torch.unique(i).numel()) for i in idx) / LAYERS
        io = xs.numel() * 2 + M * 4 + M * D * 4
        flops = 2 * M * 3 * I * D
        b_rows, by = cs.bound(M * w_bytes + io, flops)
        b_dist, _ = cs.bound(distinct * w_bytes + io, flops)
        print(f"{label}: {M} rows, {distinct:.2f} distinct experts a layer on average; bound "
              f"{b_rows * 1e3:.2f} us over all rows ({by}), {b_dist * 1e3:.2f} us over the "
              f"distinct experts", flush=True)
        ref = k9.moe_fp4_chain_plain(xs, *ws[0], idx[0], LIMIT)
        names = list(libs) + ["chain-off"]
        times = {name: [] for name in names}
        for name in names + names[::-1]:  # A B .. B A
            lib = None if name == "chain-off" else libs[name][0]

            def fn(i, lib=lib):
                w, ix = ws[i % LAYERS], idx[i % LAYERS]
                return chain_off(xs, *w, ix) if lib is None else launch(lib, xs, *w, ix)

            times[name].append(cs.time_ms(fn, 64))
        for name in names:
            ms = sum(times[name]) / len(times[name])
            verdict = "not checked (its values differ by design)"
            if name == "chain-off" or libs[name][1]:
                y = (chain_off(xs, *ws[0], idx[0]) if name == "chain-off"
                     else launch(libs[name][0], xs, *ws[0], idx[0]))
                share = row_share(y, ref)
                ok &= share <= 1.0
                verdict = (f"worst row at {share:.3f} of {cs.CHAIN_ROW_RTOL:g} x its max |ref| "
                           f"{'ok' if share <= 1.0 else 'FAIL'}")
            each = ", ".join(f"{t * 1e3:.2f}" for t in times[name])
            print(f"  {label}, {name}: {ms * 1e3:.2f} us ({each}); {b_rows / ms:.1%} of the "
                  f"bound over all rows, {b_dist / ms:.1%} over the distinct experts; {verdict}",
                  flush=True)
    print(cs.card_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
