"""Plant faults in copies of the bf16 weight-stream kernels and count the
checks of ``chip_smoke.py`` that each fails, and by what factor: the
persistent GEMV chain (``csrc/gemv_chain.cu``, ``gemv_chain_study.check``,
phase [2b]) or, with ``--kernel stream``, stream_sum
(``csrc/gemv_stream.cu``, ``gemv_stream_study.check``, phase [2a]), then
also its card tests.

    python -m pegainfer_tpu_torch.studies.chain_mutant_check [--layers 36]   (on the card)
    python -m pegainfer_tpu_torch.studies.chain_mutant_check --kernel stream

Each fault goes into a copy of the port under ``build/<kernel>_mutant/<fault>/``
(git-ignored), which builds its own kernels there; the checks run in a
process of their own in that copy (``<study> --check``), so a fault that
traps or hangs the kernel ends that process alone (after --timeout seconds).
The chain's faults:

- ``last-chunk``: the consumers skip the last chunk of every layer (they
  still wait for it and release it), so its rows of y keep what the scratch
  held;
- ``restage-early``: x_{l+1} is restaged from y_l before the grid barrier,
  while other blocks (and other warps of the block) may still be writing
  y_l or reading x_l (at N 19456 the first K rows of y_l come from every
  block's first chunks, written long before; the square chain's checks
  are the ones that can see it);
- ``no-empty-wait``: the producer no longer waits for a stage's release
  before it copies into it again.

stream_sum's faults (the card tests run are those of stream_sum,
``tests/test_torch_gemv_studies_cuda.py -k "stream_sum or sums_are"``):

- ``last-chunk``: the bulk form's consumers skip the last chunk (short
  where N is ragged: 5 rows at N 19461);
- ``drop-partial``: the second pass, shared by both forms, leaves out the
  last block's partial.

The checkout's own kernel runs first and must pass every check; the script
exits 0 when it does, whatever the faults do, and prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
LAST_CHUNK = ("      wring::rows_gemv(chunk, r, k8, xs, 0.f, yl + static_cast<size_t>(c) * rows, "
              "warp, lane);\n")
BARRIER = "      grid_barrier(bar);  // all of y_l is written\n"
RESTAGE = ("      for (int i = threadIdx.x; i < K; i += kConsumers) xh[i] = "
           "__float2bfloat16_rn(__ldcg(yl + i));\n")
PRODUCE = "    if (j >= stages) mbar_wait(empty(st), ((j / stages) & 1) ^ 1);\n"
SUM_CHUNK = ("      for (int i = threadIdx.x; i < r * k8; i += kConsumers) "
             "acc += sum_bf16x8(chunk[i]);\n")
PARTIALS = "  for (int i = threadIdx.x; i < n; i += 32) a += partials[i];\n"
# kernel -> (the faulted file under pegainfer_tpu_torch/, its study, card
# tests' -k or None, fault -> (anchor, replacement))
KERNELS = {
    "chain": ("csrc/gemv_chain.cu", "gemv_chain_study", None, {
        "last-chunk": (LAST_CHUNK,
                       LAST_CHUNK.replace("chunk, r,", "chunk, c == nchunks - 1 ? 0 : r,")),
        "restage-early": (BARRIER + RESTAGE, RESTAGE + BARRIER),
    }),
    "stream": ("csrc/gemv_stream.cu", "gemv_stream_study", "stream_sum or sums_are", {
        "last-chunk": (SUM_CHUNK,
                       SUM_CHUNK.replace("i < r * k8;", "i < (c == nchunks - 1 ? 0 : r) * k8;")),
        "drop-partial": (PARTIALS, PARTIALS.replace("i < n;", "i < n - 1;")),
    }),
}
# the chain's ring lives in common.cuh, shared with stream_sum: its empty
# wait is removed there, in the chain's copy only
RING_FAULTS = {"chain": {"no-empty-wait": (PRODUCE, "")}}


def make_copy(kernel: str, fault: str) -> Path:
    copy = ROOT / "build" / f"{kernel}_mutant" / fault
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(ROOT / "pegainfer_tpu_torch", copy / "pegainfer_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "tests").mkdir()
    shutil.copy(ROOT / "tests" / "test_torch_gemv_studies_cuda.py", copy / "tests")
    source, _, _, faults = KERNELS[kernel]
    if fault in RING_FAULTS.get(kernel, {}):
        source, (anchor, replacement) = "csrc/common.cuh", RING_FAULTS[kernel][fault]
    else:
        anchor, replacement = faults[fault]
    src = copy / "pegainfer_tpu_torch" / source
    text = src.read_text()
    if text.count(anchor) != 1:
        raise SystemExit(f"{fault}: its anchor is not in {source} once")
    src.write_text(text.replace(anchor, replacement))
    return copy


def run_checks(tree: Path, kernel: str, layers: int, timeout: float) -> dict:
    """``<study> --check`` in ``tree``: its rows, or why there are none."""
    cmd = [sys.executable, "-m", f"pegainfer_tpu_torch.studies.{KERNELS[kernel][1]}", "--check"]
    if kernel == "chain":
        cmd += ["--layers", str(layers)]
    try:
        proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"rows": None, "why": f"no result within {timeout:.0f} s (killed)"}
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("{"):
            return {"rows": json.loads(line)["checks"], "why": None}
    tail = (proc.stderr.strip().splitlines() or ["(no output)"])[-1]
    return {"rows": None, "why": f"exit {proc.returncode}: {tail[:200]}"}


def run_tests(tree: Path, select: str, timeout: float) -> dict:
    """The card tests ``-k select`` in ``tree``: pytest's counts."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
           "-p", "no:cacheprovider", "tests/test_torch_gemv_studies_cuda.py", "-k", select]
    try:
        proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"summary": f"no result within {timeout:.0f} s (killed)"}
    last = (proc.stdout.strip().splitlines() or ["(no output)"])[-1]
    counts = {k: int(n) for n, k in re.findall(r"(\d+) (passed|failed|error)", last)}
    return {**counts, "summary": last}


def summary(res: dict) -> dict:
    if res["rows"] is None:
        return {"failed": "all", "of": None, "why": res["why"]}
    bad = [(n, e / l) for n, e, l in res["rows"] if not e <= l]
    factors = [f for _, f in bad]
    return {"failed": len(bad), "of": len(res["rows"]),
            "factor_min": min(factors) if factors else None,
            "factor_max": max(factors) if factors else None,
            "first_failed": [n for n, _ in bad[:3]],
            "worst_passing": max((e / l for _, e, l in res["rows"] if e <= l), default=None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="chain")
    ap.add_argument("--layers", type=int, default=36)
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    select = KERNELS[args.kernel][2]

    def result(tree):
        out = summary(run_checks(tree, args.kernel, args.layers, args.timeout))
        if select:
            out["card_tests"] = run_tests(tree, select, args.timeout)
        return out

    out = {"right": result(ROOT)}
    print(f"right kernel: {out['right']}", flush=True)
    for fault in [*KERNELS[args.kernel][3], *RING_FAULTS.get(args.kernel, {})]:
        out[fault] = result(make_copy(args.kernel, fault))
        print(f"{fault}: {out[fault]}", flush=True)
    print(json.dumps({"kernel": args.kernel, **out}))
    return 0 if out["right"]["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
