"""Show that K2's per-row check fails a kernel that skips one key tile.

    python3 scripts/k2_mutant_check.py      (on a machine with an H100)

Copies the port and the card tests into ``build/k2_mutant/`` (git-ignored),
plants one fault in the copy of ``csrc/flash_prefill.cu``: the last query
tile of kv head 0 drops key tile 1 (keys 128-255; the subtlest drop there
is, one block and one tile), builds the copy and, on the inputs of
``chip_smoke.py``'s K2 cases, prints for each case the old check (max |diff|
against a fixed 2e-2) beside the new one (the worst query row's share of
min(2e-2, 2e-2 x its max |ref|)), then runs the copy's K2 card tests. It
exits 0 when the new check fails every case and the card tests fail; the
right kernel is the one in the checkout.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "k2_mutant"
ANCHOR = "// the causal and kv_valid mask, on the tiles that cross them\n"
FAULT = ANCHOR + ("      if (j == 1 && qt == q_tiles - 1 && h == 0)\n"
                  "        for (int i = 0; i < BK / 2; ++i) s[i] = -CUDART_INF_F;\n")

# (name, T, S, kv_valid, q_offset, Hq, Hkv, hd): chip_smoke.py's K2 cases
CASES = [
    ("T=S=1024", 1024, 1024, 1024, 0, 32, 8, 128),
    ("T=S=1000", 1000, 1000, 1000, 0, 32, 8, 128),
    ("chunk T=256 at 768, S=1024", 256, 1024, 1024, 768, 32, 8, 128),
    ("chunk T=256 at 768, kv_valid 1000, S=1280", 256, 1280, 1000, 768, 32, 8, 128),
    ("T=S=4096", 4096, 4096, 4096, 0, 32, 8, 128),
    ("chunk T=64 at 32704, S=32768", 64, 32768, 32768, 32704, 32, 8, 128),
    ("T=S=1024, hd 256, G 8", 1024, 1024, 1024, 0, 16, 2, 256),
]


def make_copy() -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "pegainfer_tpu_torch", COPY / "pegainfer_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (COPY / "tests").mkdir()
    shutil.copy(ROOT / "tests" / "test_torch_kernels_cuda.py", COPY / "tests")
    shutil.copy(ROOT / "chip_smoke.py", COPY)
    src = COPY / "pegainfer_tpu_torch" / "csrc" / "flash_prefill.cu"
    text = src.read_text()
    if text.count(ANCHOR) != 1:
        raise SystemExit("the fault's anchor is not in csrc/flash_prefill.cu once")
    src.write_text(text.replace(ANCHOR, FAULT))


def checks() -> bool:
    """Runs in the copy. True when the new check fails every case."""
    import torch

    import chip_smoke as cs
    from pegainfer_tpu_torch.ops.cuda import flash_prefill as fp

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    caught = True
    for name, T, S, kv_valid, q_offset, Hq, Hkv, hd in CASES:
        q = torch.randn((T, Hq, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((S, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((S, Hkv, hd), generator=gen, device="cuda").to(torch.bfloat16)
        out = fp.flash_attention(q, k, v, kv_valid, q_offset, hd ** -0.5)
        torch.cuda.synchronize()
        ref = fp.att.causal_attention(q, k, v, kv_valid, q_offset, hd ** -0.5)
        live = min(T, kv_valid - q_offset)
        err, share = cs.prefill_err(out[:live], ref[:live])
        old = "passes" if err <= cs.PREFILL_TOL else "fails"
        new = "passes" if share <= 1.0 else "fails"
        caught &= share > 1.0
        print(f"  {name}: max |diff| {err:.3e} ({err / cs.PREFILL_TOL:.2f} x 2e-2, old check "
              f"{old}); worst row at {share:.2f} x its limit (new check {new})", flush=True)
    return caught


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--in-copy":
        return 0 if checks() else 1
    make_copy()
    print(f"fault planted in {COPY.relative_to(ROOT)}: {' '.join(FAULT.split())}", flush=True)
    env = {**os.environ, "PYTHONPATH": str(COPY)}
    rc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--in-copy"],
                        cwd=COPY, env=env).returncode
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
         "-p", "no:cacheprovider", "tests/test_torch_kernels_cuda.py", "-k", "flash_prefill"],
        cwd=COPY, env=env, capture_output=True, text=True)
    print("\n".join(tests.stdout.strip().splitlines()[-4:]), flush=True)
    ok = rc == 0 and tests.returncode != 0
    print("the new check catches the fault" if ok else "the fault was NOT caught", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
