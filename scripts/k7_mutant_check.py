"""Show that K7's per-row check fails a kernel that drops one product of
one row, where the old global check passes it.

    python3 scripts/k7_mutant_check.py      (on a machine with an H100)
    python3 scripts/k7_mutant_check.py --tree DIR

With ``--tree`` it plants nothing and prints the same errors for the K7 of
another checkout, DIR (for example an earlier commit unpacked there with
``git archive``), to set the per-row limit from measured errors.

For each of two faults, copies the port and the card tests into
``build/k7_mutant/<fault>/`` (git-ignored) and plants the fault in the copy
of ``csrc/int8_grouped.cu``:

- ``last-row``: the last row of the last work item loses its last product
  (its x at k = IN - 1 is taken as 0 in the B fragment), an off-by-one at
  the very end of the work. The error is at most 127 |x| in one row, under
  2e-2 of the global max |y| and far above 1e-4 of that row's max.
- ``every-row``: the code at k = IN - 1 is taken as 0, so every row loses
  its last product (about 2% of the global max |y| at IN 4096).

It builds each copy and, on the inputs of ``chip_smoke.py``'s K7 cases
(random int8 codes at DeepSeek-V4-Flash's widths), prints for each case the
old check (max |diff| against 2e-2 x the global max |ref|) beside the new
one (the worst row's share of K7_ROW_RTOL x its max |ref|), then runs the
copy's K7 card tests. It exits 0 when the new check and the card tests fail
both faults in every case and the old check passes ``last-row`` in every
case; the right kernel is the one in the checkout.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPIES = ROOT / "build" / "k7_mutant"
B_LOAD = "            const uint32_t bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};\n"
A_LOAD = "            const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};\n"
# fault -> (anchor, replacement); both hold only for IN % 128 == 0
FAULTS = {
    "last-row": (B_LOAD, B_LOAD.replace("const ", "") + (
        "            if (item == live / n_ot - 1 && n == rows - 1 && kt == KT - 1 &&\n"
        "                kg == kBK / 64 - 1 && t == 3)\n"
        "              bw[7] &= 0x0000ffffu;\n")),
    "every-row": (A_LOAD, A_LOAD.replace("const ", "") + (
        "            if (kt == KT - 1 && kg == kBK / 64 - 1 && t == 3) wd[3] &= 0x00ffffffu;\n")),
}

ROW_RTOL = 1e-4  # chip_smoke.py K7_ROW_RTOL: the new check
GLOBAL_RTOL = 2e-2  # chip_smoke.py GROUPED_RTOL: the old check, on the global max

# (name, M, OUT, IN, skew): chip_smoke.py's K7 cases (w1, w2, w3, w1)
CASES = [
    ("w1 M=6144 spread", 6144, 2048, 4096, False),
    ("w2 M=6144 skewed", 6144, 4096, 2048, True),
    ("w3 M=54 skewed", 54, 2048, 4096, True),
    ("w1 M=300 spread", 300, 2048, 4096, False),
]


def make_copy(fault: str) -> Path:
    copy = COPIES / fault
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(ROOT / "pegainfer_tpu_torch", copy / "pegainfer_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "tests").mkdir()
    shutil.copy(ROOT / "tests" / "test_torch_kernels_cuda.py", copy / "tests")
    shutil.copy(ROOT / "chip_smoke.py", copy)
    src = copy / "pegainfer_tpu_torch" / "csrc" / "int8_grouped.cu"
    text = src.read_text()
    anchor, fault_text = FAULTS[fault]
    if text.count(anchor) != 1:
        raise SystemExit(f"the {fault} fault's anchor is not in csrc/int8_grouped.cu once")
    src.write_text(text.replace(anchor, fault_text))
    return copy


def checks() -> int:
    """Runs in a copy. Exit code bit 0: the new check passed some case; bit
    1: the old check failed some case."""
    import torch

    import chip_smoke as cs
    from pegainfer_tpu_torch.ops.cuda import int8_grouped as k7

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    E = 256
    missed, old_failed = False, False
    for name, M, OUT, IN, skew in CASES:
        q = torch.randint(-127, 128, (E, OUT, IN), dtype=torch.int8, generator=gen,
                          device="cuda")
        x, tm, _, seg = cs.grouped_inputs(gen, M, IN, E, skew)
        y = k7.moe_int8_grouped(x, q, *seg, tm=tm)
        torch.cuda.synchronize()
        ref = k7.moe_int8_grouped_plain(x, q, *seg, tm=tm)
        d = (y - ref).abs().amax(dim=1)
        lim = ROW_RTOL * ref.abs().amax(dim=1)
        err = d.max().item()
        share = torch.where(d > 0, d / lim, torch.zeros_like(d)).max().item()
        old_lim = GLOBAL_RTOL * ref.abs().max().item()
        missed |= share <= 1.0
        old_failed |= err > old_lim
        print(f"  {name}: max |diff| {err:.3e} ({err / old_lim:.2f} x 2e-2 of the global max, "
              f"old check {'passes' if err <= old_lim else 'fails'}); worst row at "
              f"{share:.2f} x its limit (new check {'passes' if share <= 1.0 else 'fails'})",
              flush=True)
        del q
    return int(missed) | 2 * int(old_failed)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--in-copy":
        return checks()
    if len(sys.argv) > 2 and sys.argv[1] == "--tree":
        tree = Path(sys.argv[2]).resolve()
        print(f"no fault: the K7 of {tree}", flush=True)
        env = {**os.environ, "PYTHONPATH": str(tree)}
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--in-copy"],
                       cwd=tree, env=env)
        return 0
    ok = True
    for fault in FAULTS:
        copy = make_copy(fault)
        print(f"{fault}: fault planted in {copy.relative_to(ROOT)}: "
              f"{' '.join(FAULTS[fault][1].split())}", flush=True)
        env = {**os.environ, "PYTHONPATH": str(copy)}
        rc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--in-copy"],
                            cwd=copy, env=env).returncode
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
             "-p", "no:cacheprovider", "tests/test_torch_kernels_cuda.py", "-k",
             "int8_grouped"], cwd=copy, env=env, capture_output=True, text=True)
        print("\n".join(tests.stdout.strip().splitlines()[-4:]), flush=True)
        caught = rc in (0, 2) and tests.returncode != 0
        print(f"{fault}: the new check {'catches' if caught else 'does NOT catch'} the fault"
              f"{'; the old check passes it in every case' if rc == 0 else ''}", flush=True)
        ok &= caught and (rc == 0 or fault != "last-row")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
