"""Time K5 (``csrc/fp4_grouped.cu``) at other block tiles and with parts of
its work taken out, on one H100.

    python3 scripts/k5_tile_study.py [--against FILE]

Builds variants of the kernel into ``build/k5_study/`` (git-ignored), each
a copy of the source with text substituted:

- ``128ch-4w-3st``: the source as it is: K7's tile, 128 output channels
  and 4 warps a block, 3 stages of 24 KB, three blocks (12 warps) an SM;
- ``128ch-4w-4st``: the same tile with 4 stages, two blocks an SM;
- ``256ch-8w``: 256 channels and 8 warps a block (a stage of 16 KB of
  codes, as K7's), 4 stages, half the re-reads of each row chunk's x, one
  block an SM;
- ``no-decode``: the E2M1 decode and the scale multiply (``csrc/common.cuh``'s
  ``e2m1x8_bf16x2``) replaced by 3 integer operations a word (wrong values;
  what the decode costs);
- ``no-scale-loads``: the scales taken as 1 and never loaded;
- ``copies-only``: no products: the cp.async ring, its barriers and the
  epilogue alone;
- ``against``, with ``--against FILE``: another version of the kernel's
  source (for example an earlier commit's), as it is, built where it lies
  so that it includes the ``common.cuh`` beside it.

Then, on random packed-fp4 stacks at DeepSeek-V4-Flash's widths (256
experts, group 32, power-of-two scales; four layers of each width, each
call on the next, so the codes come from device memory), 6,144 routed rows
(a 1,024-token prefill at top 6), at w1 (OUT 2048, IN 4096), w2 (OUT 4096,
IN 2048) and w1 at skewed routing: each whole variant's output against the
plain version (each row within chip_smoke.GROUPED_ROW_RTOL of its max |ref|),
and every variant's time by CUDA events (chip_smoke.time_ms), variants in
turns A B .. B A, beside the bound. Prints ptxas's report of each variant
and the card line.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pegainfer_tpu_torch.ops.cuda import build  # noqa: E402
from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5  # noqa: E402

OUT_DIR = ROOT / "build" / "k5_study"
# the two decodes of a thread's 8 code bytes (common.cuh's e2m1x8_bf16x2)
DECODE_CALLS = ("            e2m1x8_bf16x2(raw.x, sc[4 * kg + 2 * mt + h], r);\n"
                "            e2m1x8_bf16x2(raw.y, sc[4 * kg + 2 * mt + h], r + 4);\n")
FOUR_STAGES = {"constexpr int kMinBlocks = 3;": "constexpr int kMinBlocks = 2;",
               "constexpr int kStages = 3;": "constexpr int kStages = 4;"}
# name -> (substitutions, whether its output is right and checked)
VARIANTS = {
    "128ch-4w-3st": ({}, True),
    "128ch-4w-4st": (FOUR_STAGES, True),
    "256ch-8w": ({**FOUR_STAGES, "constexpr int kMinBlocks = 3;": "constexpr int kMinBlocks = 1;",
                  "constexpr int kThreads = 128;": "constexpr int kThreads = 256;",
                  "constexpr int kBM = 128;": "constexpr int kBM = 256;"}, True),
    "no-decode": ({DECODE_CALLS: "".join(
        f"            r[{4 * i}] = raw.{c};\n"
        f"            r[{4 * i + 1}] = raw.{c} ^ sc[4 * kg + 2 * mt + h];\n"
        f"            r[{4 * i + 2}] = raw.{c} + sc[4 * kg + 2 * mt + h];\n"
        f"            r[{4 * i + 3}] = raw.{c} - sc[4 * kg + 2 * mt + h];\n"
        for i, c in enumerate("xy"))}, False),
    "no-scale-loads": ({"v = __ldg(se + static_cast<size_t>(oi) * S + j);": "v = 0x3F80u;"}, False),
    "copies-only": ({"      for (int kg = 0; kg < kBK / 64; ++kg) {":
                     "      for (int kg = 0; kg < 0; ++kg) {"}, False),
}
LAYERS = 4
E = 256


def build_variants(against=None):
    """Each variant's library, built in parallel; prints ptxas's report."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC_DIR / "fp4_grouped.cu").read_text()
    if against:
        VARIANTS["against"] = ({}, True)
    procs = {}
    for name, (subs, _) in VARIANTS.items():
        if name == "against":  # built where it lies, beside its own common.cuh
            procs[name] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(OUT_DIR / f"lib{name}.so"),
                 str(Path(against).resolve())],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            continue
        src = text
        for old, new in subs.items():
            if src.count(old) != 1:
                raise SystemExit(f"{name}: '{old}' is not in csrc/fp4_grouped.cu once")
            src = src.replace(old, new)
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o",
             str(OUT_DIR / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fp4_grouped.argtypes = [p] * 8 + [i] * 6 + [p]
        lib.fp4_grouped.restype = i
        libs[name] = lib
    return libs


def launch(lib, x, w, work):
    Mp, IN = x.shape
    _, OUT, _ = w["q"].shape
    y = torch.empty((Mp, OUT), dtype=torch.float32, device=x.device)
    n_slots = work.items.shape[0]
    err = lib.fp4_grouped(x.data_ptr(), w["q"].data_ptr(), w["s"].data_ptr(),
                          work.row_e.data_ptr(), work.owner.data_ptr(), work.items.data_ptr(),
                          work.n_items.data_ptr(), y.data_ptr(), Mp, E, OUT, IN,
                          w["s"].shape[2], n_slots, torch.cuda.current_stream().cuda_stream)
    build.check_launch("fp4_grouped (study)", err)
    return y


def stacks(gen, OUT, IN):
    out = []
    for _ in range(LAYERS):
        q = torch.randint(0, 256, (E, OUT, IN // 2), dtype=torch.uint8, generator=gen,
                          device="cuda")
        e = torch.randint(-1, 2, (E, OUT, IN // 32), generator=gen, device="cuda")
        out.append({"q": q, "s": torch.exp2(e.float() - 7).to(torch.bfloat16)})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_tile_study: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another version of csrc/fp4_grouped.cu to time")
    args = ap.parse_args()
    print(f"card: {cs.card_line()}; torch {torch.__version__}", flush=True)
    libs = build_variants(args.against)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    ws = {"w1": stacks(gen, 2048, 4096), "w2": stacks(gen, 4096, 2048)}
    M = 6 * cs.DSV4_PROMPT
    ok = True
    for label, wkey, skew in (("w1", "w1", False), ("w2", "w2", False),
                              ("w1, skewed routing", "w1", True)):
        w = ws[wkey]
        OUT, IN = w[0]["q"].shape[1], 2 * w[0]["q"].shape[2]
        x, tm, e, seg = cs.grouped_inputs(gen, M, IN, E, skew)
        work = k5.plan(*seg, tm, E)
        ref = k5.moe_fp4_grouped_plain(x, w[0]["q"], w[0]["s"], *seg, tm=tm)
        hit = int(torch.unique(e).numel())
        w_bytes = w[0]["q"][0].nbytes + w[0]["s"][0].nbytes
        b_ms, by = cs.bound(hit * w_bytes + x.numel() * 2 + M * OUT * 4, 2 * M * OUT * IN)
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:  # A B B A
            lib = libs[name]
            times[name].append(cs.time_ms(lambda i: launch(lib, x, w[i % LAYERS], work), 24))
        for name, lib in libs.items():
            ms = sum(times[name]) / len(times[name])
            verdict = "not checked (its values are wrong by design)"
            if VARIANTS[name][1]:
                _, share = cs.grouped_err(launch(lib, x, w[0], work), ref)
                ok &= share <= 1.0
                verdict = f"worst row at {share:.3f} of its limit {'ok' if share <= 1.0 else 'FAIL'}"
            each = ", ".join(f"{t * 1e3:.2f}" for t in times[name])
            print(f"  {label}, {name}: {ms * 1e3:.2f} us ({each}), bound {b_ms * 1e3:.2f} us "
                  f"({by}, {b_ms / ms:.1%}); {verdict}", flush=True)
        del x, ref
    print(cs.card_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
