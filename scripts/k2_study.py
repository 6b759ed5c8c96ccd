"""Where K2's time goes: variants of csrc/flash_prefill.cu, each with one
part of the work taken out, timed side by side on one card.

    python3 scripts/k2_study.py           (on a machine with an H100, about 60 s)
    python3 scripts/k2_study.py --trace   (one call's per-block phase stamps)
    python3 scripts/k2_study.py --source FILE   (another version of the kernel, as is)

Each variant is the kernel's source with one text substitution, built with
the flags of ops/cuda/build.py into ``build/k2_study/`` (git-ignored) and
called through its C interface at Qwen3-4B's heads (Hq 32, Hkv 8, hd 128),
T = S = 1024 and 4096, and at Qwen3.5's (Hq 16, Hkv 2, hd 256); the removed parts never run (they hide behind a test
of q_offset against a value it never takes), and outputs of the variants
other than ``base`` are wrong by design. Times are CUDA-event means
(chip_smoke.time_ms).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pegainfer_tpu_torch.ops.cuda import build  # noqa: E402
from pegainfer_tpu_torch.ops.cuda import flash_prefill as fp  # noqa: E402

OUT = ROOT / "build" / "k2_study"
NEVER = "q_offset == -12345"  # q_offset >= 0 on every call
# name -> [(text, replacement)], each text found once in the source
VARIANTS = {
    "base": [],
    "no P.V wgmma": [("Mma<C::NO>::rs(o[c], p[kk],", f"if ({NEVER}) Mma<C::NO>::rs(o[c], p[kk],")],
    "no wgmma": [("Mma<C::NO>::rs(o[c], p[kk],", f"if ({NEVER}) Mma<C::NO>::rs(o[c], p[kk],"),
                 ("Mma<BK>::ss(s,", f"if ({NEVER}) Mma<BK>::ss(s,")],
    "no exp": [("ex2(fmaf(s[i], sl2, -bb)), y = ex2(fmaf(s[i + 1], sl2, -bb))",
                "fmaf(s[i], sl2, -bb), y = fmaf(s[i + 1], sl2, -bb)")],
    "no mask": [("step(j, Masked<true>{});", "step(j, Masked<false>{});")],
    "no turns": [("auto my_turn = [&] { named_sync(2 + wg); };", "auto my_turn = [&] {};"),
                 ("auto pass_turn = [&] { named_arrive(3 - wg); };", "auto pass_turn = [&] {};"),
                 ("if (wg == 1 && n_tiles > 0) named_arrive(2);", "")],
    "copies only": [("    mbar_wait(k_full(st), par);\n",
                     "    mbar_wait(k_full(st), par);\n"
                     f"    if (!({NEVER})) {{ mbar_wait(v_full(st), par); __syncwarp();"
                     " if (lane == 0) mbar_arrive(empty(st)); return; }\n"),
                    ("if (wg == 1 && n_tiles > 0) named_arrive(2);", "")],
    "3 stages": [("static constexpr int STAGES = 2;",
                  "static constexpr int STAGES = HD == 256 ? 2 : 3;")],
}
SHAPES = ((1024, 32, 8, 128), (4096, 32, 8, 128), (1024, 16, 2, 256))

# the trace build: %globaltimer stamps by the first thread of each consumer
# warpgroup (entry, Q in; per tile: K in, S done, softmax done and V in, P.V
# done; loop end, epilogue), 64 slots a warpgroup, read back through
# trace_read
STAMP = "if (threadIdx.x % 128 == 0) g_trace[(blockIdx.x * 2 + threadIdx.x / 128) * 64 + (K)] = gtime();"
TRACE = [
    ("template <int HD>\n__global__ void __launch_bounds__",
     "__device__ unsigned long long g_trace[4096 * 128];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t; asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t)); return t; }\n"
     "template <int HD>\n__global__ void __launch_bounds__"),
    ("const uint32_t raw = smem_u32(smem_raw);\n",
     "const unsigned long long t_entry = gtime();\n  const uint32_t raw = smem_u32(smem_raw);\n"),
    ("mbar_wait(q_full, 0);\n",
     "mbar_wait(q_full, 0);\n  if (threadIdx.x % 128 == 0) {\n"
     "    unsigned long long* tr = g_trace + (blockIdx.x * 2 + threadIdx.x / 128) * 64;\n"
     "    unsigned sm; asm(\"mov.u32 %0, %smid;\" : \"=r\"(sm));\n"
     "    tr[0] = t_entry; tr[62] = n_tiles; tr[63] = sm; }\n  " +
     STAMP.replace("(K)", "1") + "\n"),
    ("mbar_wait(k_full(st), par);\n",
     "mbar_wait(k_full(st), par);\n    if (j < 8) " + STAMP.replace("(K)", "(2 + 4 * j)") + "\n"),
    ("reg_fence(s);\n", "reg_fence(s);\n    if (j < 8) " + STAMP.replace("(K)", "(3 + 4 * j)") + "\n"),
    ("mbar_wait(v_full(st), par);\n",
     "mbar_wait(v_full(st), par);\n    if (j < 8) " + STAMP.replace("(K)", "(4 + 4 * j)") + "\n"),
    ("    __syncwarp();\n    if (lane == 0) mbar_arrive(empty(st));\n",
     "    if (j < 8) " + STAMP.replace("(K)", "(5 + 4 * j)") +
     "\n    __syncwarp();\n    if (lane == 0) mbar_arrive(empty(st));\n"),
    ("\n  // normalise, write bf16", "\n  " + STAMP.replace("(K)", "34") +
     "\n  // normalise, write bf16"),
    ('asm volatile("bar.sync 1, %0;\\n" ::"n"(kConsumers) : "memory");\n',
     'asm volatile("bar.sync 1, %0;\\n" ::"n"(kConsumers) : "memory");\n  ' +
     STAMP.replace("(K)", "35") + "\n"),
]
TRACE_READ = """
extern "C" int trace_read(void* dst, unsigned long long bytes) {
  return cudaMemcpyFromSymbol(dst, g_trace, bytes);
}
"""


def build_variants(variants, src, tail=""):
    src = src + tail
    OUT.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC_DIR.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    procs = {}
    for i, (name, subs) in enumerate(variants.items()):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        cu = OUT / f"variant{i}.cu"
        cu.write_text(text)
        procs[name] = (cu, OUT / f"lib{i}.so", subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"lib{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (cu, so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name}: " + " | ".join(regs[2:4]), flush=True)  # the hd 128 instance
        lib = ctypes.CDLL(str(so))
        fn = lib.flash_prefill_bf16
        p, i_, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i_, i_, i_, i_, i_, i_, i_, f, i_, i_, i_, p]
        fn.restype = i_
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_study: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    args = sys.argv[1:]
    src = build.CSRC_DIR / "flash_prefill.cu"
    if "--source" in args:  # another version of the kernel: base only
        src = Path(args[args.index("--source") + 1])
    src = src.read_text()
    if "--trace" in args:
        return trace(build_variants({"trace": TRACE}, src, TRACE_READ)["trace"])
    libs = build_variants({"base": []} if "--source" in args else VARIANTS, src)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for T, Hq, Hkv, hd in SHAPES:
        q = torch.randn((T, Hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((T, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((T, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        out = torch.empty_like(q)
        plan = fp.plan(T, Hq // Hkv, hd)
        stream = torch.cuda.current_stream().cuda_stream
        bound_ms, _ = cs.bound((2 * T * Hq * hd + 2 * T * Hkv * hd) * 2,
                               2 * 2 * Hq * hd * (T * (T + 1) // 2))
        print(f"T = S = {T}, Hq {Hq}, Hkv {Hkv}, hd {hd} (bound {bound_ms * 1e3:.2f} us):",
              flush=True)
        for name, lib in libs.items():
            def call(i, fn=lib.flash_prefill_bf16):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), T, T, Hkv,
                         Hq // Hkv, hd, T, 0, hd ** -0.5, plan.bq, plan.bk, plan.q_tiles, stream)
                build.check_launch(name, err)
            ms = cs.time_ms(call, 50)
            print(f"  {name:>12}: {ms * 1e3:9.2f} us", flush=True)
    return 0


def trace(lib, T=1024, Hq=32, Hkv=8, hd=128):
    """One traced call at the main path's shape: where a block's time goes,
    mean over blocks and tiles, in us."""
    import numpy as np
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q = torch.randn((T, Hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((T, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((T, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
    out = torch.empty_like(q)
    plan = fp.plan(T, Hq // Hkv, hd)
    blocks = plan.q_tiles * Hkv
    for _ in range(3):  # the last call's stamps are read
        build.check_launch("trace", lib.flash_prefill_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), T, T, Hkv, Hq // Hkv,
            hd, T, 0, hd ** -0.5, plan.bq, plan.bk, plan.q_tiles,
            torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    buf = np.zeros(blocks * 2 * 64, np.uint64)
    lib.trace_read.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
    if lib.trace_read(buf.ctypes.data, buf.nbytes):
        raise SystemExit("trace_read failed")
    tr = buf.reshape(blocks, 2, 64).astype(np.int64)
    t0 = tr[:, :, 0].min()
    span = (tr[:, :, 35].max() - t0) / 1e3
    print(f"span {span:.2f} us over {blocks} blocks on {len(set(tr[:, 0, 63]))} SMs", flush=True)
    parts = {"Q in": [], "K wait": [], "turn + S": [], "softmax + V wait": [],
             "turn + P.V": [], "epilogue": []}
    for b in range(blocks):
        for w in range(2):
            r = tr[b, w]
            n = int(r[62])
            parts["Q in"].append(r[1] - r[0])
            prev = r[1]
            for j in range(min(n, 8)):
                kin, sd, vin, pvd = r[2 + 4 * j: 6 + 4 * j]
                parts["K wait"].append(kin - prev)
                parts["turn + S"].append(sd - kin)
                parts["softmax + V wait"].append(vin - sd)
                parts["turn + P.V"].append(pvd - vin)
                prev = pvd
            parts["epilogue"].append(r[35] - r[34])
    for name, xs in parts.items():
        xs = np.asarray(xs) / 1e3
        print(f"  {name:>18}: mean {xs.mean():.3f} us, p90 {np.percentile(xs, 90):.3f}, "
              f"n {len(xs)}", flush=True)
    # per SM: blocks, busy time (entry to epilogue end) and the gaps between blocks
    for sm in sorted(set(tr[:, 0, 63]))[:4]:
        rows = sorted((tr[b, 0, 0] - t0, tr[b, :, 35].max() - t0, int(tr[b, 0, 62]))
                      for b in range(blocks) if tr[b, 0, 63] == sm)
        print(f"  SM {sm}: " + ", ".join(f"[{a / 1e3:.2f}-{e / 1e3:.2f} us, {n} tiles]"
                                         for a, e, n in rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
