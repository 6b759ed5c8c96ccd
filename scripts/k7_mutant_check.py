"""Show that the per-row check of a grouped expert GEMM, K7 (int8) or K5
(packed fp4), or of the fused fp4 chain K9, fails a kernel that drops one
product of one row, where the old global check passes it.

    python3 scripts/k7_mutant_check.py                 (K7, on a machine with an H100)
    python3 scripts/k7_mutant_check.py --kernel k5     (K5)
    python3 scripts/k7_mutant_check.py --kernel k9     (K9)
    python3 scripts/k7_mutant_check.py [--kernel k5|k9] --tree DIR

With ``--tree`` it plants nothing and prints the same errors for the kernel
of another checkout, DIR (for example an earlier commit unpacked there with
``git archive``), to set the per-row limit from measured errors.

For each fault, copies the port and the card tests into
``build/<kernel>_mutant/<fault>/`` (git-ignored) and plants the fault in
the copy of ``csrc/int8_grouped.cu`` (K7) or ``csrc/fp4_grouped.cu`` (K5):

- ``last-row``: the last row of the last work item loses its last product
  (its x at k = IN - 1 is taken as 0 in the B fragment), an off-by-one at
  the very end of the work. The error is one product in one row, under
  2e-2 of the global max |y| and far above 1e-4 of that row's max.
- ``every-row``: the code at k = IN - 1 is taken as 0, so every row loses
  its last product (about 2% of the global max |y| at IN 4096 for K7).

For K9 the copy is of ``csrc/fp4_chain.cu``, and its faults hit the first
row of the first expert:

- ``last-w2-product``: the row loses its last w2 product (act at I - 1 is
  taken as 0 in phase 2's B fragment), in both perm13 forms;
- ``act-channel``: the row's act channel 0 is written as 0;
- ``largest-w2-product``: of the row's last 32 w2 products of one thread,
  the one with the largest act loses it;
- ``largest-act-channel``: of the row's act channels 0-15, the largest is
  written as 0.

The first two drop a term whose size is left to the data: where that act
element is near 0 the term can be below a right kernel's own error, and
no check can see it, so they are reported and not required; the last two
drop one term of an ordinary size.

It builds each copy and, on the inputs of ``chip_smoke.py``'s cases of the
kernel (random codes at DeepSeek-V4-Flash's widths with power-of-two group
scales as the model's; K9 at 6 distinct, 12 repeated and 16 rows of one
expert, in both perm13 forms), prints for each case the old check (max
|diff| against 2e-2 (K9: CHAIN_RTOL, 2e-3) x the global max |ref|) beside
the new one (the worst row's share of 1e-4 (K9: CHAIN_ROW_RTOL) x its max
|ref|), then runs the copy's card tests of the kernel. It exits 0 when the
new check and every card test fail each fault in every case (for K9 the
last two) and the old check passes the faults it is expected to pass
(``last-row`` for K5 and K7) in every case; the right kernel is the one in
the checkout.
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B_LOAD = "            const uint32_t bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};\n"
LAST_ROW = (B_LOAD, B_LOAD.replace("const ", "") + (
    "            if (item == live / n_ot - 1 && n == rows - 1 && kt == KT - 1 &&\n"
    "                kg == kBK / 64 - 1 && t == 3)\n"
    "              bw[7] &= 0x0000ffffu;\n"))
K7_A_LOAD = "            const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};\n"
K5_A_LOAD = ("            const uint2 raw = *reinterpret_cast<const uint2*>(\n"
             "                As + row * kARow + (((2 * kg + (t >> 1)) ^ (row & 2)) << 4)"
             " + (t & 1) * 8);\n")
K9_B_LOAD = "      mma_step(c, cur, b, ntl);\n"
K9_LAST_STEP = "      if (kPhase2 && k0 == I - kK && t == 3 && ex == 0 && g == 0)"
K9_ACT = "            __float2bfloat16_rn(1.f / (1.f + expf(-gs)) * gs * us);\n"
K9_ACT_WRITE = "        act[static_cast<size_t>(rows[col]) * I + o0 + ch] =\n" + K9_ACT
# kernel -> (source, card tests' -k, fault -> (anchor, replacement)); the
# faults hold only for IN % 128 == 0
KERNELS = {
    "k7": ("int8_grouped", "int8_grouped", {
        "last-row": LAST_ROW,
        "every-row": (K7_A_LOAD, K7_A_LOAD.replace("const ", "") + (
            "            if (kt == KT - 1 && kg == kBK / 64 - 1 && t == 3) wd[3] &= 0x00ffffffu;\n")),
    }),
    "k5": ("fp4_grouped", "fp4_grouped", {
        "last-row": LAST_ROW,
        "every-row": (K5_A_LOAD, K5_A_LOAD.replace("const uint2 raw", "uint2 raw") + (
            "            if (kt == KT - 1 && kg == kBK / 64 - 1 && t == 3) raw.y &= 0x0fffffffu;\n")),
    }),
    "k9": ("fp4_chain", "fp4_chain", {
        "last-w2-product": (K9_B_LOAD, K9_LAST_STEP + "\n        b[0][15] &= 0xffffu;\n"
                            + K9_B_LOAD),
        "act-channel": (K9_ACT, K9_ACT.replace(
            "__float2bfloat16_rn(",
            "__float2bfloat16_rn(ex == 0 && col == 0 && o0 + ch == 0 ? 0.f : ")),
        "largest-w2-product": (K9_B_LOAD, K9_LAST_STEP + """ {
        int arg = 0;
        uint32_t big = 0;
        for (int h = 0; h < 32; ++h) {
          const uint32_t v = (b[0][h >> 1] >> (16 * (h & 1))) & 0x7fffu;
          if (v > big) {
            big = v;
            arg = h;
          }
        }
        b[0][arg >> 1] &= (arg & 1) ? 0x0000ffffu : 0xffff0000u;
      }
""" + K9_B_LOAD),
        "largest-act-channel": (K9_ACT_WRITE, """        float v = 1.f / (1.f + expf(-gs)) * gs * us;
        if (ex == 0 && o0 == 0 && col == 0) {  // lanes 0-15 of warp 0
          float big = fabsf(v);
          for (int off = 8; off > 0; off >>= 1)
            big = fmaxf(big, __shfl_xor_sync(0xffffu, big, off));
          if (fabsf(v) == big) v = 0.f;
        }
        act[static_cast<size_t>(rows[col]) * I + o0 + ch] = __float2bfloat16_rn(v);
"""),
    }),
}
# faults whose dropped term may fall below a right kernel's own error (an
# act element near 0): reported, not required to be caught
MAY_HIDE = {"k9": {"last-w2-product", "act-channel"}}

# the faults the old check is expected to pass in every case
OLD_PASSES = {"k7": {"last-row"}, "k5": {"last-row"}, "k9": set()}

ROW_RTOL = 1e-4  # chip_smoke.py GROUPED_ROW_RTOL: the new check
GLOBAL_RTOL = 2e-2  # chip_smoke.py GROUPED_RTOL: the old check, on the global max

# (name, M, OUT, IN, skew): chip_smoke.py's cases of K7 and K5 (w1, w2, w3, w1)
CASES = [
    ("w1 M=6144 spread", 6144, 2048, 4096, False),
    ("w2 M=6144 skewed", 6144, 4096, 2048, True),
    ("w3 M=54 skewed", 54, 2048, 4096, True),
    ("w1 M=300 spread", 300, 2048, 4096, False),
]


def make_copy(kernel: str, fault: str) -> Path:
    source, _, faults = KERNELS[kernel]
    copy = ROOT / "build" / f"{kernel}_mutant" / fault
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(ROOT / "pegainfer_tpu_torch", copy / "pegainfer_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "tests").mkdir()
    shutil.copy(ROOT / "tests" / "test_torch_kernels_cuda.py", copy / "tests")
    shutil.copy(ROOT / "chip_smoke.py", copy)
    src = copy / "pegainfer_tpu_torch" / "csrc" / f"{source}.cu"
    text = src.read_text()
    anchor, fault_text = faults[fault]
    if text.count(anchor) != 1:
        raise SystemExit(f"the {fault} fault's anchor is not in csrc/{source}.cu once")
    src.write_text(text.replace(anchor, fault_text))
    return copy


def verdict(name, y, ref, row_rtol, global_rtol):
    """Prints the old and the new check of one case. Returns (the new check
    passed, the old check failed)."""
    import torch

    d = (y - ref).abs().amax(dim=1)
    lim = row_rtol * ref.abs().amax(dim=1)
    err = d.max().item()
    share = torch.where(d > 0, d / lim, torch.zeros_like(d)).max().item()
    old_lim = global_rtol * ref.abs().max().item()
    print(f"  {name}: max |diff| {err:.3e} ({err / old_lim:.2f} x {global_rtol:g} of the global "
          f"max, old check {'passes' if err <= old_lim else 'fails'}); worst row at "
          f"{share:.2f} x its limit (new check {'passes' if share <= 1.0 else 'fails'})",
          flush=True)
    return share <= 1.0, err > old_lim


def checks_k9() -> int:
    """K9's cases, as ``checks``."""
    import torch

    import chip_smoke as cs
    from pegainfer_tpu_torch.ops.cuda import fp4_chain as k9

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    E, I, D = 256, 2048, 4096

    def stack(out_d, in_d):
        q = torch.randint(0, 256, (E, out_d, in_d // 2), dtype=torch.uint8, generator=gen,
                          device="cuda")
        e = torch.randint(-1, 2, (E, out_d, in_d // 32), generator=gen, device="cuda")
        s = torch.exp2(e.float() - round(math.log2(2.93 * in_d ** 0.5))).to(torch.bfloat16)
        return {"q": q, "s": s}

    w1, w3, w2 = stack(I, D), stack(I, D), stack(D, I)
    missed, old_failed = False, False
    for perm13 in (False, True):
        a, b = (k9.permute_w13(w1), k9.permute_w13(w3)) if perm13 else (w1, w3)
        for M, routing in ((6, "distinct"), (12, "repeated experts"), (16, "one expert")):
            x = torch.randn((M, D), generator=gen, device="cuda")
            idx = torch.randperm(E, generator=gen, device="cuda")[:M].to(torch.int32)
            if routing == "repeated experts":
                idx[M // 2:] = idx[: M - M // 2]
            elif routing == "one expert":
                idx[:] = idx[0]
            y = k9.moe_fp4_chain(x, a, b, w2, idx, 7.0, perm13=perm13)
            torch.cuda.synchronize()
            ref = k9.moe_fp4_chain_plain(x, a, b, w2, idx, 7.0, perm13)
            passed, failed = verdict(f"M={M} {routing} perm13={perm13}", y, ref,
                                     cs.CHAIN_ROW_RTOL, cs.CHAIN_RTOL)
            missed |= passed
            old_failed |= failed
    return int(missed) | 2 * int(old_failed)


def checks(kernel: str) -> int:
    """Runs in a copy. Exit code bit 0: the new check passed some case; bit
    1: the old check failed some case."""
    if kernel == "k9":
        return checks_k9()
    import torch

    import chip_smoke as cs
    from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
    from pegainfer_tpu_torch.ops.cuda import int8_grouped as k7

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    E = 256
    missed, old_failed = False, False
    for name, M, OUT, IN, skew in CASES:
        if kernel == "k7":
            q = torch.randint(-127, 128, (E, OUT, IN), dtype=torch.int8, generator=gen,
                              device="cuda")
            x, tm, _, seg = cs.grouped_inputs(gen, M, IN, E, skew)
            y = k7.moe_int8_grouped(x, q, *seg, tm=tm)
            torch.cuda.synchronize()
            ref = k7.moe_int8_grouped_plain(x, q, *seg, tm=tm)
        else:
            q = torch.randint(0, 256, (E, OUT, IN // 2), dtype=torch.uint8, generator=gen,
                              device="cuda")
            e = torch.randint(-1, 2, (E, OUT, IN // 32), generator=gen, device="cuda")
            s = torch.exp2(e.float() - round(math.log2(2.93 * IN ** 0.5))).to(torch.bfloat16)
            x, tm, _, seg = cs.grouped_inputs(gen, M, IN, E, skew)
            y = k5.moe_fp4_grouped(x, q, s, *seg, tm=tm)
            torch.cuda.synchronize()
            ref = k5.moe_fp4_grouped_plain(x, q, s, *seg, tm=tm)
            del s, e
        passed, failed = verdict(name, y, ref, ROW_RTOL, GLOBAL_RTOL)
        missed |= passed
        old_failed |= failed
        del q
    return int(missed) | 2 * int(old_failed)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="k7")
    ap.add_argument("--tree", type=Path, help="print the errors of another checkout's kernel")
    ap.add_argument("--in-copy", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    me = [sys.executable, str(Path(__file__).resolve()), "--kernel", args.kernel, "--in-copy"]
    if args.in_copy:
        return checks(args.kernel)
    if args.tree:
        tree = args.tree.resolve()
        print(f"no fault: the {args.kernel.upper()} of {tree}", flush=True)
        subprocess.run(me, cwd=tree, env={**os.environ, "PYTHONPATH": str(tree)})
        return 0
    _, tests_k, faults = KERNELS[args.kernel]
    ok = True
    for fault in faults:
        copy = make_copy(args.kernel, fault)
        print(f"{args.kernel.upper()} {fault}: fault planted in {copy.relative_to(ROOT)}: "
              f"{' '.join(faults[fault][1].split())}", flush=True)
        env = {**os.environ, "PYTHONPATH": str(copy)}
        rc = subprocess.run(me, cwd=copy, env=env).returncode
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q", "-rp",
             "-p", "no:cacheprovider", "tests/test_torch_kernels_cuda.py", "-k", tests_k],
            cwd=copy, env=env, capture_output=True, text=True)
        lines = tests.stdout.strip().splitlines()
        print("\n".join([ln for ln in lines if ln.startswith("PASSED")] + lines[-1:]),
              flush=True)
        caught = rc in (0, 2) and tests.returncode != 0 and not any(
            ln.startswith("PASSED") for ln in lines)
        print(f"{args.kernel.upper()} {fault}: the new check and every card test "
              f"{'catch' if caught else 'do NOT all catch'} the fault"
              f"{'; the old check passes it in every case' if rc == 0 else ''}", flush=True)
        ok &= ((caught or fault in MAY_HIDE.get(args.kernel, ()))
               and (rc == 0 or fault not in OLD_PASSES[args.kernel]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
