"""Expert-stream study on the H100: what bounds an int8 expert GEMV, the
int8 -> bf16 convert or the byte rate, and do more bytes in flight help?

The H100 counterpart of ``scripts/expert_stream_study.py`` (a TPU script),
at its DeepSeek-V4-Flash expert shapes: q int8 [E 256, I 2048, D 4096]
(2.15 GB), x int8 [M 12, D] (in bf16 for the convert forms), 12 gathered
rows (B 2 x top-6). The inputs are made as that script makes them
(``np.random.default_rng(0)``: q, x, then its fixed idx). A deliberate
departure from that script: each timed call takes the next row of an
[ITERS, M] table of idx drawn from the same rng after them (as
``scripts/fp4_kernel_study.py:39`` already does), so no call finds its
experts in the 50 MB L2 left by the call before. Timed by CUDA events:

- ``expert_gemv``, the convert form (the TPU's ``run_auto(False)``, its
  "production form") and the native form (``run_auto(True)``, "w8a8": int8
  x, ``__dp4a``), each over ROWS output rows a block (the TPU's TO);
- ``expert_gemv_in_flight`` (``run_all_in_flight``): every copy of a
  block's M x T rows issued before its first wait, at the largest T that
  fits (T 4: 196,608 B a block, one block an SM) and at the smaller ones
  (more blocks an SM, fewer bytes each); and, as the TPU script's "dma-only,
  same blocks, no compute" row, its copies alone (the ``copies_only``
  probe);
- K6 (``ops/cuda/int8_gemv.py``, the port's production int8 expert GEMV,
  which reads each distinct expert once) at the same inputs, the TPU
  docstring's "production moe_int8_gemv" row;
- the yardsticks: torch's gather + bf16 ``bmm`` (``xla_int8``'s
  counterpart, gather and convert inside the call) and one ``bmm`` over the
  experts gathered in bf16 ahead (K6's library call).

Each form's median of RETIMES timings, its GB/s over M·I·D = 100,663,296
bytes, and its share of the bound at 3.35 TB/s (30.05 µs) and at the read
ceiling that ``gemv_stream_study`` measured on an H100 (3.1224 TB/s, in
PERF.md: 32.24 µs); the distinct-expert bytes of the timed idx beside M·I·D; the native
form's gain over the convert form, as the TPU script prints it; the bytes
in flight an SM of the in-flight form.

    python -m pegainfer_tpu_torch.studies.expert_stream_study          (on the card)
    python -m pegainfer_tpu_torch.studies.expert_stream_study --check  (kernel checks)
    python -m pegainfer_tpu_torch.studies.expert_stream_study --cpu    (plain versions)

``--check`` prints ``check``'s table (``chip_smoke.py``'s phase [2c]) on
inputs made on the card from a seed, as JSON, and exits 1 if one fails;
``--cpu`` runs the plain versions at a small size against a numpy integer
reference and times nothing. Without a card and without ``--cpu`` it
raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from pegainfer_tpu_torch.ops.cuda import expert_stream as es
from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
from pegainfer_tpu_torch.studies.timing import card_line, device_ms

E, I, D, M = 256, 2048, 4096, 12
ITERS = 20  # rows of the idx table: calls before an idx comes round again
NBYTES = M * I * D
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
READ_CEILING = 3.1224e12  # gemv_stream_study's read ceiling on an H100 (PERF.md)
RETIMES = 5
TIMED_CALLS = 100
CPU_SHAPE = (4, 512, 256)  # E, I, D of --cpu
# the convert forms form exact products of codes and bf16 x and sum them in
# f32 in another order than the plain version: each row to RTOL of its max
# |y|; the native form's integer sum is exact and rounds once: bit for bit
RTOL = 1e-5
RAGGED = (4, 2018)  # E, OUT of the ragged case: not a multiple of any tile
LIBRARY_CALL = "torch.bmm (bf16, experts gathered ahead)"
GATHER_CALL = "torch.bmm(q[idx].to(bf16), x) (gather + convert + bmm)"
COPIES_ONLY = "in flight, copies only (probe: no products)"


def numpy_inputs(E: int, I: int, D: int, M: int, iters: int) -> tuple:
    """q, x (int8), idx [M] and the idx table [iters, M] (int32) as numpy
    arrays, drawn as the TPU script draws them."""
    rng = np.random.default_rng(0)
    q = rng.integers(-127, 128, (E, I, D), dtype=np.int8)
    x = rng.integers(-127, 128, (M, D), dtype=np.int8)
    idx = rng.integers(0, E, M).astype(np.int32)
    return q, x, idx, rng.integers(0, E, (iters, M)).astype(np.int32)


def to_device(arrays, device) -> list:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def distinct_bytes(idx_all, I: int, D: int) -> float:
    """Mean bytes of the distinct experts of a timed call's idx."""
    return float(np.mean([len(set(r.tolist())) for r in idx_all])) * I * D


def row_check(name: str, got, ref, rtol: float) -> tuple:
    """The worst routed row of ``got`` against ``ref``: each row m held to
    rtol x max |ref[m]| (0: bit for bit). Returns (name with the row, its
    max |diff|, its limit)."""
    err = (got.float() - ref.float()).abs().amax(dim=1)
    lim = rtol * ref.float().abs().amax(dim=1)
    m = int(torch.argmax(err - lim))
    return (f"{name} (row {m})", err[m].item(), lim[m].item())


def check(q=None, seed: int = 0, device="cuda", ragged=RAGGED) -> list:
    """Every kernel form against its plain version, row by row: the native
    form bit for bit, the convert forms to RTOL of each row's max |y|. On q
    [E, OUT, D] (made from ``seed`` if None) at M 12 with repeated experts,
    at M 1, on a ragged q of ``ragged`` (E, OUT) whose OUT is no multiple
    of any tile, and on codes and x of one sign (sums near 2^24 at D 4096);
    the in-flight form also at its smaller tiles on the first case.
    Inputs from a torch generator on ``device``. Returns rows (name, err,
    limit), each name starting with its kernel's key in ``es.launches``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device=device)

    if q is None:
        q = codes(E, I, D)
    Eq, _, Dq = q.shape
    x8 = codes(M, Dq)
    idx = torch.randint(0, Eq, (M,), generator=gen, device=device).int()
    idx[5], idx[11] = idx[2], idx[0]  # repeated experts
    qr = codes(ragged[0], ragged[1], Dq)
    # codes and x of one sign: sums of D x 64^2 on average, about 2^24 at D
    # 4096, where the native form's f32 cast rounds
    qs = codes(4, 256, Dq).abs()
    cases = (("M 12, repeated experts", q, x8, idx), ("M 1", q, x8[:1], idx[:1].clone()),
             (f"OUT {ragged[1]}", qr, x8, idx % ragged[0]),
             ("sums of one sign", qs, x8.abs(), idx % 4))
    rows = []
    for label, qq, xx, ii in cases:
        xb = xx.to(torch.bfloat16)
        ref_c = es.expert_gemv_plain(xb, qq, ii)
        ref_n = es.expert_gemv_plain(xx, qq, ii, native=True)
        for r in es.ROWS:
            rows.append(row_check(f"expert_gemv_convert rows {r}, {label}",
                                  es.expert_gemv(xb, qq, ii, False, r), ref_c, RTOL))
            rows.append(row_check(f"expert_gemv_native rows {r}, {label}",
                                  es.expert_gemv(xx, qq, ii, True, r), ref_n, 0.0))
        rows.append(row_check(f"expert_gemv_in_flight {label}",
                              es.expert_gemv_in_flight(xb, qq, ii), ref_c, RTOL))
        if label == cases[0][0]:  # the smaller tiles the study times
            for t in es.IN_FLIGHT_TILES:
                if t < es.in_flight_tile(M, Dq) and es.tile_fits(M, Dq, t):
                    rows.append(row_check(f"expert_gemv_in_flight T {t}, {label}",
                                          es.expert_gemv_in_flight(xb, qq, ii, t), ref_c, RTOL))
    return rows


def forms(q, x8, idx_all, rows=es.ROWS) -> dict:
    """The timed forms: name -> fn(i), call i on idx_all[i % len]."""
    n = len(idx_all)
    xb = x8.to(torch.bfloat16)
    out = {}
    for r in rows:
        out[f"convert rows {r}"] = lambda i, r=r: es.expert_gemv(xb, q, idx_all[i % n], False, r)
    for r in rows:
        out[f"native rows {r}"] = lambda i, r=r: es.expert_gemv(x8, q, idx_all[i % n], True, r)
    out["in flight"] = lambda i: es.expert_gemv_in_flight(xb, q, idx_all[i % n])
    out[COPIES_ONLY] = lambda i: es.expert_gemv_in_flight(xb, q, idx_all[i % n],
                                                          copies_only=True)
    T = es.in_flight_tile(*x8.shape)
    for t in es.IN_FLIGHT_TILES:  # smaller tiles: more blocks an SM, fewer bytes each
        if t < T and es.tile_fits(*x8.shape, t):
            out[f"in flight T {t}"] = lambda i, t=t: es.expert_gemv_in_flight(
                xb, q, idx_all[i % n], t)
    out["K6 moe_int8_gemv"] = lambda i: k6.moe_int8_gemv(xb, q, idx_all[i % n])
    out[GATHER_CALL] = lambda i: torch.bmm(q[idx_all[i % n].long()].to(torch.bfloat16),
                                           xb[:, :, None])
    return out


def time_one(fn, retimes: int = RETIMES, calls: int = TIMED_CALLS) -> dict:
    """The median of ``retimes`` device timings of ``calls`` calls, with
    their range, in ms a call."""
    ms = sorted(device_ms(fn, calls) for _ in range(retimes))
    return {"ms": statistics.median(ms), "min_ms": ms[0], "max_ms": ms[-1]}


def library_bmm(q, x8, idx_all, copies: int = 2) -> dict:
    """One bf16 ``bmm`` over the experts of ``copies`` idx rows gathered and
    converted ahead, alternated (201 MB a copy at the full shape, beyond L2)."""
    xb = x8.to(torch.bfloat16)[:, :, None]
    wg = [q[idx_all[i].long()].to(torch.bfloat16) for i in range(copies)]
    res = time_one(lambda i: torch.bmm(wg[i % copies], xb))
    del wg
    return res


def report(name: str, t: dict, nbytes: int = NBYTES) -> dict:
    ms = t["ms"]
    nominal, ceiling = nbytes / HBM_BYTES_PER_S * 1e3, nbytes / READ_CEILING * 1e3
    row = {"form": name, **t, "gb_per_s": nbytes / ms / 1e6,
           "of_nominal_bound": nominal / ms, "of_measured_bound": ceiling / ms}
    print(f"  {name:58s} {ms * 1e3:8.2f} us ({t['min_ms'] * 1e3:.2f}-{t['max_ms'] * 1e3:.2f})  "
          f"{row['gb_per_s']:7.1f} GB/s  {row['of_nominal_bound']:6.1%} of {nominal * 1e3:.2f} us, "
          f"{row['of_measured_bound']:6.1%} of {ceiling * 1e3:.2f} us", flush=True)
    return row


def bytes_in_flight(M: int, D: int, rows=es.ROWS) -> dict:
    """Form -> blocks an SM and the code bytes they can have in flight: a
    block of expert_gemv has 8 warps x 32 lanes x 4 loads of 16 B (16 KiB);
    one of the in-flight form its M x T x D codes."""
    out = {}
    for form in ("convert", "native"):
        for r in rows:
            blocks = es.blocks_per_sm(form, r, M, D)
            out[f"{form} rows {r}"] = {"blocks_per_sm": blocks,
                                       "bytes_in_flight_per_sm": blocks * es.WARPS * 32 * 4 * 16}
    T = es.in_flight_tile(M, D)
    for t in es.IN_FLIGHT_TILES:
        if t <= T and es.tile_fits(M, D, t):
            blocks = es.blocks_per_sm("in_flight", t, M, D)
            out["in flight" if t == T else f"in flight T {t}"] = {
                "T": t, "block_bytes": M * t * D, "blocks_per_sm": blocks,
                "bytes_in_flight_per_sm": blocks * M * t * D}
    return out


def study(q, x8, idx_all) -> dict:
    """Time every form; returns the table and the derived figures."""
    Mx, Dx = x8.shape
    Iq = q.shape[1]
    print(f"bytes: M·I·D {Mx * Iq * Dx:,}; distinct experts of the timed idx "
          f"{distinct_bytes(idx_all.cpu().numpy(), Iq, Dx):,.0f} a call (mean)", flush=True)
    nbytes = Mx * Iq * Dx
    table = [report(name, time_one(fn), nbytes) for name, fn in forms(q, x8, idx_all).items()]
    table.append(report(LIBRARY_CALL, library_bmm(q, x8, idx_all), nbytes))
    by = {r["form"]: r for r in table}
    conv = min((r for r in table if r["form"].startswith("convert")), key=lambda r: r["ms"])
    nat = min((r for r in table if r["form"].startswith("native")), key=lambda r: r["ms"])
    gain = conv["ms"] / nat["ms"] - 1
    flight = bytes_in_flight(Mx, Dx)
    print(f"\nw8a8 native-dot gain over convert-dot (best of each): {gain * 100:.1f}% "
          f"({nat['form']} {nat['ms'] * 1e3:.2f} us against {conv['form']} "
          f"{conv['ms'] * 1e3:.2f} us)", flush=True)
    f = flight["in flight"]
    print(f"in flight: T {f['T']}, {f['block_bytes']:,} B a block", flush=True)
    for form, b in flight.items():
        print(f"  {form:12s} {b['blocks_per_sm']} block(s) an SM: {b['bytes_in_flight_per_sm']:,} B "
              f"in flight an SM; {by[form]['ms'] * 1e3:.2f} us", flush=True)
    return {"table": table, "native_gain": gain, "bytes_in_flight": flight,
            "distinct_bytes": distinct_bytes(idx_all.cpu().numpy(), Iq, Dx), "nbytes": nbytes}


def run_cpu(shape=CPU_SHAPE) -> dict:
    """The plain versions through the wrappers on CPU tensors against a
    numpy integer reference; nothing timed."""
    Eq, Iq, Dq = shape
    q, x, idx, _ = numpy_inputs(Eq, Iq, Dq, M, 1)
    want = np.stack([q[i].astype(np.int64) @ x[m].astype(np.int64) for m, i in enumerate(idx)])
    qt, xt, it = to_device((q, x, idx), "cpu")
    xb = xt.to(torch.bfloat16)
    out = {"E": Eq, "I": Iq, "D": Dq, "M": M,
           "native_equal": bool(np.array_equal(
               es.expert_gemv(xt, qt, it, native=True).numpy(), want.astype(np.float32)))}
    for name, y in (("convert", es.expert_gemv(xb, qt, it)),
                    ("in_flight", es.expert_gemv_in_flight(xb, qt, it))):
        out[f"{name}_relerr"] = float(np.abs(y.numpy() - want).max() / np.abs(want).max())
    print(f"q [{Eq}, {Iq}, {Dq}] (cpu, plain versions): {out}", flush=True)
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
        raise RuntimeError("expert_stream_study: no CUDA device (use --cpu for the plain versions)")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.check:
        rows = check()
        print(json.dumps({"card": card, "checks": rows}))
        return 0 if all(err <= lim for _, err, lim in rows) else 1
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    q, x8, _, idx_all = to_device(numpy_inputs(E, I, D, M, ITERS), "cuda")
    res = study(q, x8, idx_all)
    print(json.dumps({"card": card, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
