"""fp4 decode study on the H100: does decoding packed E2M1 cost anything above
the load floor of an expert GEMV, and which tile wins?

The H100 counterpart of ``scripts/fp4_kernel_study.py`` (a TPU script), at
K3's shape, the [M, I, D] w13 GEMV over packed fp4: q uint8 [E 256, OUT
2048, IN/2 2048] (1.07 GB), s bf16 [E, OUT, IN/32] powers of two (134 MB),
x [M 12, IN 4096] standard normal, made as that script makes them
(``np.random.default_rng(0)``), with its idx table [ITERS 20, M], one row a
timed call. ``fp4_variant_gemv`` (``csrc/fp4_study.cu``) is swept over the
four variants (floor, bits_noscale, bits, arith) x ROWS output rows a block
(the TPU's TO), timed by CUDA events beside K3 (``ops/cuda/fp4_gemv.py``,
the port's production fp4 expert GEMV) and K3's library yardstick, one bf16
``bmm`` over the routed experts dequantized ahead.

The bound counts the scales: the TPU script's ``BYTES`` leaves them out
(":41: 1/32"), but a bf16 scale a 32 codes is 2 bytes a 16 packed bytes:
packed 50,331,648 B + scales 6,291,456 B = 56,623,104 B, 16.90 µs at 3.35
TB/s and 18.13 µs at the read ceiling ``gemv_stream_study`` measured on an
H100 (3.1224 TB/s, in PERF.md). The packed-only GB/s is printed too, as the TPU
script's. The result: decode's cost above ``floor`` (``bits`` - ``floor``,
``arith`` - ``floor``) at each tile, and the best tile, against K3's time.

``floor`` and ``bits_noscale`` load the scales they do not use, as the TPU
BlockSpec does; ``scale_loads`` counts each instantiation's 16-bit global
loads in ``cuobjdump -sass`` of the built library to show they remain.

    python -m pegainfer_tpu_torch.studies.fp4_kernel_study          (on the card)
    python -m pegainfer_tpu_torch.studies.fp4_kernel_study --check  (kernel checks)
    python -m pegainfer_tpu_torch.studies.fp4_kernel_study --cpu    (plain versions)

``--check`` prints ``check``'s table (``chip_smoke.py``'s phase [2d]) and
the SASS scale-load counts as JSON, and exits 1 if one fails; ``--cpu``
runs the plain versions at the TPU script's shapes cut to E 4, OUT 512, IN
512 against a numpy decode and times nothing. Without a card and without
``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
from pegainfer_tpu_torch.ops.cuda import fp4_study as fs
from pegainfer_tpu_torch.studies.expert_stream_study import (HBM_BYTES_PER_S, READ_CEILING,
                                                              row_check, time_one, to_device)
from pegainfer_tpu_torch.studies.gemv_stream_study import bf16
from pegainfer_tpu_torch.studies.timing import card_line

E, OUT, IN, M = 256, 2048, 4096, 12
ITERS = 20
GROUP = 32
PACKED_BYTES = M * OUT * IN // 2
SCALE_BYTES = M * OUT * (IN // GROUP) * 2
BYTES = PACKED_BYTES + SCALE_BYTES
CPU_SHAPE = (4, 512, 512)  # E, OUT, IN of --cpu
# products of bf16 weights and bf16 x are exact in f32, summed in another
# order than the plain version's: each row to RTOL of its max |y|
RTOL = 1e-5
RAGGED = (4, 2018)  # E, OUT of the ragged case: not a multiple of any tile
WEIGHTS_CASE = (2, 64, 512)  # E, OUT, IN read back weight for weight
LIBRARY_CALL = "torch.bmm (bf16, experts dequantized ahead)"


def numpy_inputs(E: int, OUT: int, IN: int, M: int, iters: int) -> tuple:
    """q (uint8), s (bf16 bits as a bf16 tensor), x (f32) and the idx table
    [iters, M] (int32), drawn as the TPU script draws them."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (E, OUT, IN // 2), dtype=np.uint8)
    s = bf16(np.exp2(rng.integers(-8, 0, (E, OUT, IN // GROUP))).astype(np.float32))
    x = rng.standard_normal((M, IN)).astype(np.float32)
    return q, s, x, rng.integers(0, E, (iters, M)).astype(np.int32)


def random_scales(gen, shape, device, pow2: bool):
    """bf16 scales: exp2 of integers in [-8, 0) (the TPU script's), or with
    random mantissas and signs (any bf16 value of those exponents)."""
    e = torch.randint(-8, 0, shape, generator=gen, device=device).float()
    if pow2:
        return torch.exp2(e).to(torch.bfloat16)
    mant = 1.0 + torch.rand(shape, generator=gen, device=device)
    sign = torch.randint(0, 2, shape, generator=gen, device=device).float() * 2 - 1
    return (torch.exp2(e) * mant * sign).to(torch.bfloat16)


def check(q=None, s=None, seed: int = 0, device="cuda", ragged=RAGGED,
          weights_case=WEIGHTS_CASE) -> list:
    """Every variant against its plain version, row by row, to RTOL of each
    row's max |y|, over ROWS: on q / s [E, OUT, ...] (made from ``seed`` if
    None) at M 12 with repeated experts and at M 1; on a ragged q of
    ``ragged`` (E, OUT), no multiple of any tile, with scales of random
    mantissas and signs. Then the weights read back one by one (x the rows
    of the identity, ``weights_case``'s E, OUT, IN, random-mantissa scales):
    bits and arith equal bit for bit (limit 0), and each variant equal to
    its plain weights. Returns rows (name, err, limit), each name starting
    with its kernel's key in ``fs.launches``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def packed(*shape):
        return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8, device=device)

    if q is None:
        q = packed(E, OUT, IN // 2)
        s = random_scales(gen, (E, OUT, IN // GROUP), device, pow2=True)
    Eq, _, IN2 = q.shape
    x = torch.randn((M, 2 * IN2), generator=gen, device=device)
    idx = torch.randint(0, Eq, (M,), generator=gen, device=device).int()
    idx[5], idx[11] = idx[2], idx[0]  # repeated experts
    qr = packed(ragged[0], ragged[1], IN2)
    sr = random_scales(gen, (ragged[0], ragged[1], s.shape[2]), device, pow2=False)
    cases = (("M 12, repeated experts", q, s, x, idx), ("M 1", q, s, x[:1], idx[:1].clone()),
             (f"OUT {ragged[1]}", qr, sr, x, idx % ragged[0]))
    rows = []
    for label, qq, ss, xx, ii in cases:
        for v in fs.VARIANTS:
            ref = fs.fp4_variant_gemv_plain(xx, qq, ss, ii, v)
            for r in fs.ROWS:
                rows.append(row_check(f"fp4_variant_{v} rows {r}, {label}",
                                      fs.fp4_variant_gemv(xx, qq, ss, ii, v, r), ref, RTOL))
    rows += check_weights(gen, device, *weights_case)
    return rows


def check_weights(gen, device, Ew: int, OUTw: int, INw: int) -> list:
    """x = the rows of the identity, all rows routed to one expert: y[k, o]
    is weight (o, k). bits against arith bit for bit, and every variant
    against its plain weights bit for bit."""
    q = torch.randint(0, 256, (Ew, OUTw, INw // 2), generator=gen, dtype=torch.uint8,
                      device=device)
    s = random_scales(gen, (Ew, OUTw, INw // GROUP), device, pow2=False)
    x = torch.eye(INw, device=device)
    rows = []
    for e in range(Ew):
        idx = torch.full((INw,), e, dtype=torch.int32, device=device)
        got = {v: fs.fp4_variant_gemv(x, q, s, idx, v) for v in fs.VARIANTS}
        for v in fs.VARIANTS:
            want = fs.variant_weights(q, s, idx[:1], v)[0].T  # [IN, OUT]
            rows.append((f"fp4_variant_{v} weights, expert {e}",
                         (got[v] - want).abs().max().item(), 0.0))
        rows.append((f"fp4_variant_bits == arith, weights of expert {e}",
                     (got["bits"] - got["arith"]).abs().max().item(), 0.0))
    return rows


def scale_loads(lib=None) -> dict:
    """16-bit global loads (the scale loads) of each (variant, rows)
    instantiation in ``cuobjdump -sass`` of the built library."""
    lib = lib or build.BUILD_DIR / "libfp4_study.so"
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found: the CUDA toolkit is needed for the SASS count")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out = count_scale_loads(sass)
    if len(out) != len(fs.VARIANTS) * len(fs.ROWS):
        raise RuntimeError(f"scale_loads: found {sorted(out)} in {lib}")
    return out


def count_scale_loads(sass: str) -> dict:
    """"variant rows R" -> the 16-bit global loads in that kernel's SASS."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        m = re.match(r"\S*fp4_variant_kernelILi(\d)ELi(\d+)E", part)
        if m:
            key = f"{fs.VARIANTS[int(m.group(1))]} rows {m.group(2)}"
            out[key] = len(re.findall(r"\bLDG\.E\.U16\b", part))
    return out


def scale_loads_kept(counts: dict) -> bool:
    """Whether every floor and bits_noscale kernel still loads scales."""
    return all(n > 0 for k, n in counts.items() if k.split()[0] in ("floor", "bits_noscale"))


def sweep(q, s, xb, idx_all, rows=fs.ROWS) -> list:
    """Every variant x rows, then K3 and its library call; each the median
    of RETIMES timings. Rows of the table: form, ms, range, GB/s with the
    scales and packed only, shares of the bound."""
    n = len(idx_all)
    Mx = xb.shape[0]
    _, OUTq, IN2 = q.shape
    packed, scales = Mx * OUTq * IN2, Mx * OUTq * s.shape[2] * 2
    table = []

    def row(name, t):
        ms = t["ms"]
        nominal = (packed + scales) / HBM_BYTES_PER_S * 1e3
        ceiling = (packed + scales) / READ_CEILING * 1e3
        r = {"form": name, **t, "gb_per_s": (packed + scales) / ms / 1e6,
             "packed_gb_per_s": packed / ms / 1e6, "of_nominal_bound": nominal / ms,
             "of_measured_bound": ceiling / ms}
        table.append(r)
        print(f"  {name:40s} {ms * 1e3:8.2f} us ({t['min_ms'] * 1e3:.2f}-{t['max_ms'] * 1e3:.2f})"
              f"  {r['gb_per_s']:7.1f} GB/s ({r['packed_gb_per_s']:6.1f} packed)  "
              f"{r['of_nominal_bound']:6.1%} of {nominal * 1e3:.2f} us, "
              f"{r['of_measured_bound']:6.1%} of {ceiling * 1e3:.2f} us", flush=True)

    for v in fs.VARIANTS:
        for r in rows:
            row(f"{v} rows {r}", time_one(
                lambda i, v=v, r=r: fs.fp4_variant_gemv(xb, q, s, idx_all[i % n], v, r)))
    row("K3 moe_fp4_gemv", time_one(lambda i: k3.moe_fp4_gemv(xb, q, s, idx_all[i % n])))
    wg = [quant.gather_dequant({"q": q, "s": s}, idx_all[i].long(), torch.bfloat16)
          for i in range(2)]
    xc = xb[:, :, None]
    row(LIBRARY_CALL, time_one(lambda i: torch.bmm(wg[i % 2], xc)))
    del wg
    return table


def decode_cost(table) -> dict:
    """bits - floor and arith - floor (and bits_noscale - floor) at each
    tile, in ms; each variant's best tile."""
    ms = {r["form"]: r["ms"] for r in table}
    out = {"best": {}}
    for v in fs.VARIANTS:
        best = min(fs.ROWS, key=lambda r: ms[f"{v} rows {r}"])
        out["best"][v] = {"rows": best, "ms": ms[f"{v} rows {best}"]}
    for v in ("bits_noscale", "bits", "arith"):
        out[f"{v} - floor"] = {r: ms[f"{v} rows {r}"] - ms[f"floor rows {r}"] for r in fs.ROWS}
    out["K3_ms"] = ms["K3 moe_fp4_gemv"]
    return out


def run_cpu(shape=CPU_SHAPE) -> dict:
    """The plain versions through the wrapper on CPU tensors against a numpy
    decode (E2M1 x scale, rounded to bf16) in f64; nothing timed."""
    Eq, OUTq, INq = shape
    q, s, x, idx_all = numpy_inputs(Eq, OUTq, INq, M, 1)
    idx = idx_all[0]
    codes = np.stack((q & 0xF, q >> 4), axis=-1).reshape(Eq, OUTq, INq)
    sc = np.repeat(s.float().numpy(), GROUP, axis=-1)
    w = {"floor": np.repeat(q, 2, axis=-1).astype(np.float64),
         "bits_noscale": np.asarray(fs.E2M1)[codes]}
    w["bits"] = w["arith"] = bf16(w["bits_noscale"] * sc).float().numpy().astype(np.float64)
    xb = bf16(x).float().numpy().astype(np.float64)
    qt, it = to_device((q, idx), "cpu")
    out = {"E": Eq, "OUT": OUTq, "IN": INq, "M": M}
    for v in fs.VARIANTS:
        want = np.einsum("mod,md->mo", w[v][idx], xb)
        got = fs.fp4_variant_gemv(torch.from_numpy(x), qt, s, it, v).numpy()
        out[f"{v}_relerr"] = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"q [{Eq}, {OUTq}, {INq // 2}] (cpu, plain versions): {out}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="plain versions at a small size")
    ap.add_argument("--check", action="store_true", help="the kernel checks only, as JSON")
    args = ap.parse_args(argv)
    if args.cpu:
        print(json.dumps({"cpu": run_cpu()}))
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("fp4_kernel_study: no CUDA device (use --cpu for the plain versions)")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.check:
        rows = check()
        loads = scale_loads()
        print(json.dumps({"card": card, "checks": rows, "scale_loads": loads}))
        ok = all(err <= lim for _, err, lim in rows) and scale_loads_kept(loads)
        return 0 if ok else 1
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    q, s, x, idx_all = numpy_inputs(E, OUT, IN, M, ITERS)
    q, idx_all = to_device((q, idx_all), "cuda")
    s, xb = s.cuda(), bf16(x).cuda()
    print(f"bytes: packed {PACKED_BYTES:,} + scales {SCALE_BYTES:,} = {BYTES:,}", flush=True)
    table = sweep(q, s, xb, idx_all)
    cost = decode_cost(table)
    loads = scale_loads()
    print(f"decode above floor (us): " + json.dumps(
        {k: {r: round(v * 1e3, 3) for r, v in d.items()} for k, d in cost.items()
         if k.endswith("floor")}), flush=True)
    print(f"scale loads in SASS: {loads}", flush=True)
    print(json.dumps({"card": card, "table": table, "decode_cost": cost, "scale_loads": loads}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
