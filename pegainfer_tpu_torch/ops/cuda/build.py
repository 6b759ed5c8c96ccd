"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with one ``nvcc`` call into
``build/lib<name>.so`` at the root of the checkout, with a plain C interface
that ``ctypes`` loads (no PyTorch headers, so a build takes seconds); the
device helpers they share are in ``csrc/common.cuh``. The sources build in
parallel on first use, and again whenever a source or a header of ``csrc/``
is newer than its library. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build"
SOURCES = ("paged_decode", "flash_prefill", "fp8_gemv", "fp4_gemv", "fp4_grouped",
           "int8_gemv", "int8_grouped", "int8_chain", "fp4_chain")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) per source,
# from the build this process ran; empty when the libraries were current
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def _stale(name: str) -> bool:
    lib = BUILD_DIR / f"lib{name}.so"
    inputs = (CSRC_DIR / f"{name}.cu", *CSRC_DIR.glob("*.cuh"))
    return not lib.exists() or lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build_all() -> Dict[str, str]:
    """Compile every stale source, all ``nvcc`` calls at once. Returns the
    ptxas reports of the sources built."""
    todo = [n for n in SOURCES if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # per-process temporary names and an atomic rename: processes that build
    # at once (test workers) never load a half-written library
    tmp = {name: BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp" for name in todo}
    procs = {}
    for name in todo:
        procs[name] = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp[name]), str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    logs, failed = {}, []
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed))
    for name in todo:
        os.replace(tmp[name], BUILD_DIR / f"lib{name}.so")
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if not _libs:
            build_logs.update(build_all())
            for n in SOURCES:
                _libs[n] = ctypes.CDLL(str(BUILD_DIR / f"lib{n}.so"))
            _declare(_libs)
        return _libs[name]


def _declare(libs: Dict[str, ctypes.CDLL]) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = libs["paged_decode"].paged_decode_bf16
    fn.argtypes = [p, p, p, p, p, p, p, p,  # q, k, v, cur_k, cur_v, tables, seq_lens, out
                   p, p, p,  # split scratch: part_acc, part_ml, tickets
                   i, i, i, i, i, i, i, i,  # B, Hkv, G, HD, P, ps, S, pages per split
                   ll, ll, f, i, p]  # head/page strides, scale, has_cur, stream
    fn.restype = i
    fn = libs["flash_prefill"].flash_prefill_bf16
    fn.argtypes = [p, p, p, p,  # q, k, v, out
                   i, i, i, i, i, i, i,  # T, S, Hkv, G, HD, kv_valid, q_offset
                   f, p]  # scale, stream
    fn.restype = i
    fn = libs["fp8_gemv"].fp8_gemv
    fn.argtypes = [p, p, p, p,  # x, q, s, y
                   i, i, i, i, i, i, i,  # M, OUT, IN, ro, ri, Si, blocks
                   p]  # stream
    fn.restype = i
    fn = libs["fp4_gemv"].fp4_gemv
    fn.argtypes = [p, p, p, p, p,  # x, q, s, idx, y
                   i, i, i, i, i,  # M, E, OUT, IN, S
                   p]  # stream
    fn.restype = i
    fn = libs["fp4_grouped"].fp4_grouped
    fn.argtypes = [p, p, p, p, p, p, p, p,  # x, q, s, seg_expert/lo/hi, n_seg, y
                   i, i, i, i, i, i,  # Mp, E, OUT, IN, S, tm
                   p]  # stream
    fn.restype = i
    fn = libs["int8_gemv"].int8_gemv
    fn.argtypes = [p, p, p, p,  # x, q, idx, y
                   i, i, i, i,  # M, E, OUT, IN
                   p]  # stream
    fn.restype = i
    fn = libs["int8_grouped"].int8_grouped
    fn.argtypes = [p, p, p, p, p, p, p,  # x, q, seg_expert/lo/hi, n_seg, y
                   i, i, i, i, i,  # Mp, E, OUT, IN, tm
                   p]  # stream
    fn.restype = i
    fn = libs["int8_chain"].int8_chain
    fn.argtypes = [p, p, p, p, p, p, p, p, p, p,  # x, w1, w3, w2, s1, s3, s2, idx, act, y
                   i, i, i, i, f,  # M, E, I, D, limit
                   p]  # stream
    fn.restype = i
    fn = libs["fp4_chain"].fp4_chain
    fn.argtypes = [p, p, p, p, p, p, p, p, p, p,  # x, w1, s1, w3, s3, w2, s2, idx, act, y
                   i, i, i, i, i, i, f, i,  # M, E, I, D, S1, S2, limit, perm13
                   p]  # stream
    fn.restype = i


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")
