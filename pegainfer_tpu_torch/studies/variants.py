"""Variants of a kernel source for the kernel studies (``k4_study``,
``k3_study``): copies with text substituted, built in parallel with nvcc
into a git-ignored directory, and timed by CUDA events in turns A B .. B A.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.studies.timing import device_ms


def substitute(name: str, src: str, subs: dict, where: str) -> str:
    """``src`` with each key of ``subs`` replaced by its value. A key found
    more or less than once raises; a tuple key (first, last) replaces the
    lines from its first text through its last."""
    for old, new in subs.items():
        if isinstance(old, tuple):
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


def compile_variants(texts: dict, out_dir: Path) -> dict:
    """Each source text of ``texts`` ({name: text}) built into its own
    library under ``out_dir``, all nvcc calls at once; prints ptxas's
    registers and spills. Returns {name: loaded ctypes library}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        stem = re.sub(r"[^A-Za-z0-9]+", "-", name)
        cu, so = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
        print(f"  {name}: ptxas {max(map(int, regs)) if regs else '?'} registers, "
              f"spill stores {spills or ['0']}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def in_turns(runs: list, fn, calls: int) -> dict:
    """Each run's mean device ms a call, ``fn(run)(i)`` timed over ``calls``
    calls, in turns A B .. B A: {run: [ms of the first turn, of the
    second]}."""
    times = {r: [] for r in runs}
    for r in runs + runs[::-1]:
        times[r].append(device_ms(fn(r), calls))
    return times
