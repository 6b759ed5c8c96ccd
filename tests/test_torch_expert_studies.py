"""The int8 expert-stream kernels (``ops/cuda/expert_stream.py``) and the fp4
decode variants (``ops/cuda/fp4_study.py``) of the port, and their H100
studies, on the CPU.

- The TPU study kernels, run as the JAX package's own tests run Pallas on
  the CPU (``interpret=True``), against the port's CPU wrappers (the plain
  versions) on the same bits. The scripts build gigabytes or time a sweep
  at import, so their kernel functions are taken out with ``ast``
  (``run_auto``, ``run_all_in_flight``; ``decode_arith``, ``decode_bits``,
  ``expand_scales``, ``make_kernel``, ``build``) and run in a namespace of
  small constants (E 4, I 512, D 256, M 12; E 4, OUT 512, IN 512), the
  test's own q and s, and ``pl.pallas_call`` bound to ``interpret=True``.
  ``run_auto`` in both forms and ``run_all_in_flight`` at two TO each: the
  native form bit for bit, the convert forms to 1e-5 of each row's max |y|;
  ``build`` in all four variants at two TO, each to 1e-5 of each row's max.
- The studies' ``--cpu`` modes and checks, called in-process; the checks
  against plain versions that drop one routed row or the last output tile.
- The wrappers refuse a device without a kernel; the records cite the
  scripts' lines; the SASS count of the scale loads.
"""

import ast
import functools
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda import expert_stream as es
from pegainfer_tpu_torch.ops.cuda import fp4_study as fs
from pegainfer_tpu_torch.studies import expert_stream_study as s3
from pegainfer_tpu_torch.studies import fp4_kernel_study as s4

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
CSRC = ROOT / "pegainfer_tpu_torch" / "csrc"
RTOL = 1e-5
S3_SHAPE = dict(E=4, I=512, D=256, M=12)
S4_SHAPE = dict(E=4, OUT=512, IN=512, IN2=256, S=16, M=12)


def _extract(name, functions, consts):
    """The named functions of scripts/<name>.py, executed in a namespace of
    ``consts`` with Pallas calls in interpret mode."""
    path = SCRIPTS / f"{name}.py"
    tree = ast.parse(path.read_text())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in functions]
    assert sorted(n.name for n in body) == sorted(functions)

    class Pallas(types.ModuleType):
        def __getattr__(self, attr):
            return getattr(pl, attr)

    interp = Pallas("pl")
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns = dict(jax=jax, jnp=jnp, np=np, pl=interp, pltpu=pltpu, functools=functools, **consts)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    return ns


def _s3_inputs():
    c = S3_SHAPE
    q, x, idx, _ = s3.numpy_inputs(c["E"], c["I"], c["D"], c["M"], 1)
    idx[5], idx[11] = idx[2], idx[0]  # repeated experts
    return q, x, idx


@pytest.fixture(scope="module")
def tpu_s3():
    return _extract("expert_stream_study", ["run_auto", "run_all_in_flight"], S3_SHAPE)


@pytest.fixture(scope="module")
def s4_inputs():
    c = S4_SHAPE
    q, s, x, idx_all = s4.numpy_inputs(c["E"], c["OUT"], c["IN"], c["M"], 1)
    return q, s, x, idx_all[0]


@pytest.fixture(scope="module")
def tpu_s4(s4_inputs):
    q, s, _, _ = s4_inputs
    sj = jax.lax.bitcast_convert_type(jnp.asarray(s.view(torch.int16).numpy()), jnp.bfloat16)
    return _extract("fp4_kernel_study", ["decode_arith", "decode_bits", "expand_scales",
                                          "make_kernel", "build"],
                    dict(S4_SHAPE, q=jnp.asarray(q), s=sj))


def _tpu_rows(out, M):
    """The TPU's (GO, 16, TO) output as [M, I]."""
    out = np.asarray(out)
    return out.swapaxes(0, 1).reshape(out.shape[1], -1)[:M]


def _per_row_ok(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max(axis=1)
    return bool(np.all(err <= rtol * np.abs(want).max(axis=1)))


@pytest.mark.parametrize("TO", [128, 256])
@pytest.mark.parametrize("native", [False, True], ids=["convert", "native"])
def test_run_auto_matches_expert_gemv(tpu_s3, native, TO):
    q, x, idx = _s3_inputs()
    xin = jnp.asarray(x)[:, :, None]
    if not native:
        xin = xin.astype(jnp.bfloat16)
    want = _tpu_rows(tpu_s3["run_auto"](native, TO)(jnp.asarray(idx), xin, jnp.asarray(q)), 12)
    xt = torch.from_numpy(x)
    got = es.expert_gemv(xt if native else xt.to(torch.bfloat16), torch.from_numpy(q),
                         torch.from_numpy(idx), native=native).numpy()
    assert got.shape == (12, 512)
    if native:
        assert np.array_equal(got, want)
    else:
        assert _per_row_ok(got, want, RTOL)


@pytest.mark.parametrize("TO", [64, 128])
def test_run_all_in_flight_matches_expert_gemv_in_flight(tpu_s3, TO):
    q, x, idx = _s3_inputs()
    xb4 = jnp.asarray(x).astype(jnp.bfloat16)[None, :, :, None]
    want = _tpu_rows(tpu_s3["run_all_in_flight"](TO)(jnp.asarray(idx), xb4, jnp.asarray(q)), 12)
    got = es.expert_gemv_in_flight(torch.from_numpy(x).float(), torch.from_numpy(q),
                                   torch.from_numpy(idx)).numpy()
    assert _per_row_ok(got, want, RTOL)


@pytest.mark.parametrize("TO", [128, 256])
@pytest.mark.parametrize("variant", fs.VARIANTS)
def test_build_matches_fp4_variant_gemv(tpu_s4, s4_inputs, variant, TO):
    q, s, x, idx = s4_inputs
    want = np.asarray(tpu_s4["build"](variant, TO)(jnp.asarray(x), jnp.asarray(idx)))
    got = fs.fp4_variant_gemv(torch.from_numpy(x), torch.from_numpy(q), s,
                              torch.from_numpy(idx), variant).numpy()
    assert got.shape == want.shape == (12, 512)
    assert _per_row_ok(got, want, RTOL)


def test_native_plain_rounds_the_integer_sum_once():
    """Sums above 2^24 round to the nearest f32, ties to even, as numpy's
    (and the TPU's) int32 -> float32 cast does."""
    D = 4096
    q = np.full((1, 3, D), 127, np.int8)
    x = np.full((1, D), 127, np.int8)
    x[0, :3] = [126, 125, 1]  # sums that are no multiple of the f32 ulp (8 near 2^26)
    q[0, 1, :5] = -127
    want = (q[0].astype(np.int64) @ x[0].astype(np.int64)).astype(np.float32)
    assert np.abs(q[0].astype(np.int64) @ x[0].astype(np.int64)).max() > 2 ** 24
    got = es.expert_gemv(torch.from_numpy(x), torch.from_numpy(q),
                         torch.zeros(1, dtype=torch.int32), native=True).numpy()[0]
    assert np.array_equal(got, want)


def test_in_flight_tile():
    assert es.in_flight_tile(12, 4096) == 4  # 196,608 B of codes a block
    assert es.in_flight_tile(1, 4096) == 8
    assert es.in_flight_tile(50, 4096) == 1
    assert es.in_flight_smem(12, 4, 4096) == 196608 + 96 + 384
    assert [T for T in es.IN_FLIGHT_TILES if es.tile_fits(12, 4096, T)] == [4, 2, 1]
    assert not es.tile_fits(12, 4096, 3) and not es.tile_fits(12, 4112, 1)
    for M, D in ((51, 4096), (12, 4112)):
        with pytest.raises(ValueError):
            es.in_flight_tile(M, D)


def test_rows_out_of_range_give_zero():
    q = torch.ones((2, 8, 32), dtype=torch.int8)
    x = torch.ones((3, 32), dtype=torch.int8)
    idx = torch.tensor([0, 2, -1], dtype=torch.int32)
    y = es.expert_gemv(x, q, idx, native=True)
    assert y[0].eq(32).all() and y[1:].eq(0).all()
    qq = torch.ones((2, 8, 16), dtype=torch.uint8)  # floor: the byte 1 is both halves' weight
    s = torch.ones((2, 8, 1), dtype=torch.bfloat16)
    y = fs.fp4_variant_gemv(x.float(), qq, s, idx, "floor")
    assert y[0].eq(32).all() and y[1:].eq(0).all()


@pytest.mark.parametrize("study", [s3, s4], ids=["expert_stream", "fp4"])
def test_study_cpu_mode(study, capsys):
    assert study.main(["--cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["cpu"]
    if study is s3:
        assert out["native_equal"] and out["convert_relerr"] < RTOL
        assert out["in_flight_relerr"] < RTOL
    else:
        assert all(out[f"{v}_relerr"] < RTOL for v in fs.VARIANTS)


# the studies' checks at a small size: q / s given, a ragged OUT of 226 (no
# multiple of 4, 16, 32 or 64)
def _s3_check():
    q = torch.randint(-127, 128, (4, 512, 256), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(1))
    return s3.check(q=q, device="cpu", ragged=(4, 226))


def _s4_check():
    gen = torch.Generator().manual_seed(1)
    q = torch.randint(0, 256, (4, 512, 256), dtype=torch.uint8, generator=gen)
    s = s4.random_scales(gen, (4, 512, 16), "cpu", pow2=True)
    return s4.check(q=q, s=s, device="cpu", ragged=(4, 226), weights_case=(2, 16, 64))


def test_expert_check_on_the_cpu_passes_the_plain_versions():
    rows = _s3_check()
    assert len(rows) == 4 * (2 * 3 + 1) + 3  # and the in-flight form at T 4, 2, 1
    assert all(r[0].split()[0] in es.launches for r in rows)
    assert all(err <= lim for _, err, lim in rows)
    assert all(lim == 0.0 for name, _, lim in rows if "native" in name)


def test_fp4_check_on_the_cpu_passes_the_plain_versions():
    rows = _s4_check()
    assert len(rows) == 3 * 4 * 3 + 2 * 5
    assert all(r[0].split()[0] in fs.launches for r in rows)
    assert all(err <= lim for _, err, lim in rows)


def _dropping(plain, fault, tile):
    """A wrapper that computes the plain version and then drops the last
    routed row, or zeroes the last output tile of ``tile(rows)`` rows."""
    def call(*args, **kw):
        y = plain(*args, **kw).clone()
        if fault == "row":
            y[-1] = 0
        else:
            OUT, t = y.shape[1], tile(kw, args)
            y[:, (OUT - 1) // t * t:] = 0
        return y
    return call


def _rows_arg(kw, args, pos, default=32):
    return kw.get("rows", args[pos] if len(args) > pos else default)


S3_FAULTS = [("expert_gemv", f) for f in ("row", "tile")] + \
    [("expert_gemv_in_flight", f) for f in ("row", "tile")]


@pytest.mark.parametrize("wrapper,fault", S3_FAULTS, ids=[f"{w}-{f}" for w, f in S3_FAULTS])
def test_expert_check_fails_a_dropped_row_or_tile(monkeypatch, wrapper, fault):
    if wrapper == "expert_gemv":
        def plain(x, q, idx, native=False, rows=32):
            return es.expert_gemv_plain(x, q, idx, native)
        tile = functools.partial(_rows_arg, pos=4)
        prefixes = ("expert_gemv_convert", "expert_gemv_native")
    else:
        def plain(x, q, idx, tile=None, copies_only=False):
            return es.expert_gemv_in_flight_plain(x, q, idx, copies_only)

        def tile(kw, args):
            return es.in_flight_tile(args[0].shape[0], args[0].shape[1])
        prefixes = ("expert_gemv_in_flight",)
    monkeypatch.setattr(es, wrapper, _dropping(plain, fault, tile))
    rows = _s3_check()
    failed = {n for n, err, lim in rows if not err <= lim}
    assert failed == {n for n, _, _ in rows if n.split()[0] in prefixes}


@pytest.mark.parametrize("fault", ["row", "tile"])
def test_fp4_check_fails_a_dropped_row_or_tile(monkeypatch, fault):
    def plain(x, q, s, idx, variant, rows=32):
        return fs.fp4_variant_gemv_plain(x, q, s, idx, variant)

    monkeypatch.setattr(fs, "fp4_variant_gemv",
                        _dropping(plain, fault, functools.partial(_rows_arg, pos=5)))
    rows = _s4_check()
    failed = {n for n, err, lim in rows if not err <= lim}
    # every check fails but bits == arith, whose two sides drop alike
    assert failed == {n for n, _, _ in rows if "==" not in n}


def test_wrappers_raise_for_a_device_without_a_kernel():
    x = torch.zeros((2, 256), dtype=torch.bfloat16, device="meta")
    x8 = torch.zeros((2, 256), dtype=torch.int8, device="meta")
    q = torch.zeros((4, 64, 256), dtype=torch.int8, device="meta")
    q4 = torch.zeros((4, 64, 128), dtype=torch.uint8, device="meta")
    s = torch.zeros((4, 64, 8), dtype=torch.bfloat16, device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    for call in (lambda: es.expert_gemv(x, q, idx), lambda: es.expert_gemv(x8, q, idx, True),
                 lambda: es.expert_gemv_in_flight(x, q, idx),
                 lambda: fs.fp4_variant_gemv(x, q4, s, idx, "bits")):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()


def test_studies_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for study in (s3, s4):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            study.main([])


def test_records_cite_the_tpu_scripts_lines():
    """The lines the sources, the wrappers and PERF.md cite."""
    s3_lines = (SCRIPTS / "expert_stream_study.py").read_text().splitlines()
    s4_lines = (SCRIPTS / "fp4_kernel_study.py").read_text().splitlines()
    assert s3_lines[122].startswith("def run_auto(")
    assert s3_lines[147].lstrip().startswith("f = pl.pallas_call(")
    assert s3_lines[154].startswith("def run_all_in_flight(")
    assert s3_lines[184].lstrip().startswith("f = pl.pallas_call(")
    assert s4_lines[104].startswith("def build(")
    assert s4_lines[127].lstrip().startswith("out = pl.pallas_call(")
    for line, name in ((71, "make_kernel"), (43, "decode_arith"), (51, "decode_bits"),
                       (63, "expand_scales")):
        assert s4_lines[line].startswith(f"def {name}(")


def test_sources_are_built_and_dispatch_every_variant_and_tile():
    assert {"expert_stream", "fp4_study"} <= set(build.SOURCES)
    es_src = (CSRC / "expert_stream.cu").read_text()
    fs_src = (CSRC / "fp4_study.cu").read_text()
    for r in es.ROWS:
        for native in ("true", "false"):
            assert f"launch_gemv<{native}, {r}>" in es_src
        assert f"if (rows == {r}) return launch<kVariant, {r}>" in fs_src
    assert "constexpr int kFloor = 0, kBitsNoscale = 1, kBits = 2, kArith = 3;" in fs_src
    assert fs.VARIANTS == ("floor", "bits_noscale", "bits", "arith")
    # every copy of a block issued before the first wait, one barrier an m
    body = es_src[es_src.index("expert_gemv_in_flight_kernel("):]
    assert body.index("bulk_copy_g2s(") < body.index("mbar_wait(")


def test_scale_load_count_reads_each_kernel():
    fake = "".join(
        f"\n\tFunction : _ZN12_GLOBAL__N_118fp4_variant_kernelILi{v}ELi{r}EEEvPK13__nv_bfloat16"
        f"\n /*0010*/ LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;"
        + "\n /*0020*/ LDG.E.U16.CONSTANT R9, desc[UR4][R6.64] ;" * (v + r // 16)
        for v in range(4) for r in fs.ROWS)
    counts = s4.count_scale_loads("Fatbin elf code:" + fake)
    assert counts == {f"{fs.VARIANTS[v]} rows {r}": v + r // 16 for v in range(4)
                      for r in fs.ROWS}
    assert s4.scale_loads_kept(counts)
    assert not s4.scale_loads_kept({**counts, "floor rows 32": 0})


def test_bound_bytes():
    assert s3.NBYTES == 100_663_296
    assert round(s3.NBYTES / s3.HBM_BYTES_PER_S * 1e6, 2) == 30.05
    assert round(s3.NBYTES / s3.READ_CEILING * 1e6, 2) == 32.24
    assert (s4.PACKED_BYTES, s4.SCALE_BYTES, s4.BYTES) == (50_331_648, 6_291_456, 56_623_104)
    assert round(s4.BYTES / s3.HBM_BYTES_PER_S * 1e6, 2) == 16.90
    assert round(s4.BYTES / s3.READ_CEILING * 1e6, 2) == 18.13
