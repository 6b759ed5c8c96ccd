"""K4's launch plan (``ops/cuda/fp8_gemv.py::plan``) and its fixed-order
reduction, on the CPU.

The plan cuts the work of ``csrc/fp8_gemv.cu`` from shapes alone: a block
takes rt tiles of 8 or 16 rows and ks K parts of them (a warp each), K
parts are whole scale blocks. Here a walk of the kernel's index formulas
(block -> row tiles, warp -> K span) covers every (row tile, column) of
each of the seven decode-step shapes exactly once, with the blocks the plan
documents (at least one on each of an H100's 132 SMs but for wkv's 64 and
wq_a's 128 blocks of 16 warps, whose tiles of 8 rows allow no more without
a split of K across blocks, which measured slower; PERF.md). A plain-torch emulation
of the split and of the kernel's fixed-order sums (a block's K parts in
order) matches the JAX package's
``fp8_gemv`` in interpret mode at the JAX kernel tests' atol 2e-5 (as
tests/test_torch_dsv4_ops.py holds the plain version), with power-of-two
and random-mantissa scales at M 1, 2 and 8. The K4 study's ``--cpu`` mode
runs. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py).
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pegainfer_tpu.ops import quant as jquant
from pegainfer_tpu.ops.pallas import fp4_gemm as pfp4
from pegainfer_tpu_torch.ops import quant as tquant
from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda import fp8_gemv as k4
from pegainfer_tpu_torch.studies import k4_study
from pegainfer_tpu_torch.utils.weights import numpy_to_torch

SMS = 132
SOURCE = (build.CSRC_DIR / "fp8_gemv.cu").read_text()
# the plan of each decode-step shape on 132 SMs: (tile rows, rt, ks), blocks
STEP_PLANS = {"wq_a": ((8, 1, 16), 128), "wq_b": ((16, 8, 1), 256), "wkv": ((8, 1, 16), 64),
              "wo_b": ((16, 1, 8), 256), "shared_w1/w3": ((8, 1, 8), 256),
              "shared_w2": ((16, 1, 8), 256), "idx_wq_b": ((16, 2, 4), 256)}


def _walk(p, OUT, IN):
    """(row, column) -> how many warps of the grid cover it, by the
    kernel's formulas: warp w of block b takes tile b * rt + w % rt and K
    part w // rt."""
    cover = np.zeros((p.blocks(OUT) * p.rt * p.tile_rows, IN), np.int32)
    for b in range(p.blocks(OUT)):
        for w in range(p.rt * p.ks):
            k0, k1 = p.span(w // p.rt, IN)
            r0 = (b * p.rt + w % p.rt) * p.tile_rows
            cover[r0:r0 + p.tile_rows, k0:k1] += 1
    return cover[:OUT]


@pytest.mark.parametrize("name,OUT,IN,n", k4_study.STEP_SHAPES)
def test_plan_covers_each_step_shape_once(name, OUT, IN, n):
    p = k4.plan(OUT, IN, 128, SMS)
    assert ((p.tile_rows, p.rt, p.ks), p.blocks(OUT)) == STEP_PLANS[name] and p.unit == 128
    # wkv's 64 tiles of 8 rows and wq_a's 128 take 16 K parts a block, the
    # most; more blocks would need a split of K across blocks
    assert p.blocks(OUT) >= SMS or (name in ("wkv", "wq_a") and p.rt * p.ks == k4.MAX_WARPS)
    assert p.rt * p.ks <= k4.MAX_WARPS
    assert (_walk(p, OUT, IN) == 1).all()
    for kp in range(p.ks):
        k0, k1 = p.span(kp, IN)
        assert k0 % 128 == 0 and k1 % 128 == 0 and k1 > k0  # whole scale blocks


@pytest.mark.parametrize("OUT,IN,ri,sms", [(256, 384, 128, SMS), (512, 400, 400, SMS),
                                           (1000, 512, 128, SMS), (16, 48, 48, SMS),
                                           (256, 1024, 128, 16), (4096, 8192, 128, 4)])
def test_plan_covers_other_shapes_once(OUT, IN, ri, sms):
    """Shapes the kernel takes beyond the step's: a scale block of the full
    dim (no K split), a ragged last row tile, two tiles, fewer SMs."""
    p = k4.plan(OUT, IN, ri, sms)
    assert p.unit == (ri if ri % 64 == 0 else IN) and p.tile_rows in (8, 16)
    assert p.ks <= IN // p.unit and p.rt * p.ks <= k4.MAX_WARPS
    assert (_walk(p, OUT, IN) == 1).all()


def test_plan_constants_and_formulas_are_the_kernels():
    for name, value in (("kMaxRows", k4.MAX_ROWS), ("kMaxWarps", k4.MAX_WARPS)):
        assert re.search(rf"constexpr int {name} = {value};", SOURCE), name
    assert "const int tile = blockIdx.x * rt + warp % rt;" in SOURCE
    assert "const int kp = warp / rt, nu = IN / unit;" in SOURCE
    assert "const int k0 = kp * nu / ks * unit, k1 = (kp + 1) * nu / ks * unit;" in SOURCE
    assert "const int r0 = tile * kTileRows + g, r1 = r0 + 8;" in SOURCE
    # a block's K parts in order
    assert "for (int p = 0; p < ks; ++p) v += red[p * rt + i / kTileRows][i % kTileRows][n];" \
        in SOURCE
    assert "atomicAdd" not in SOURCE and "red.global" not in SOURCE


def _emulate(x, q, s, p):
    """The kernel's split and its sums in plain torch: each warp's K span
    as one f32 product of bf16 values, a block's K parts added in order."""
    w = tquant.dequant_any({"q": q, "s": s}, torch.bfloat16).float()
    xb = x.to(torch.bfloat16).float()
    OUT, IN = q.shape
    rows_a_block = p.rt * p.tile_rows
    y = torch.empty((x.shape[0], OUT))
    for b in range(p.blocks(OUT)):
        rows = slice(b * rows_a_block, min(OUT, (b + 1) * rows_a_block))
        total = torch.zeros((x.shape[0], rows.stop - rows.start))
        for kp in range(p.ks):
            k0, k1 = p.span(kp, IN)
            total = total + xb[:, k0:k1] @ w[rows, k0:k1].T
        y[:, rows] = total
    return y


@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("mantissa", [False, True])
@pytest.mark.parametrize("OUT,IN,sms", [(256, 1024, 16), (512, 1024, 132)])
def test_split_reduction_matches_pallas(OUT, IN, sms, mantissa, M):
    rng = np.random.default_rng(OUT + IN + M + mantissa)
    jc = jquant.quantize_fp8_tensor(rng.standard_normal((OUT, IN)).astype(np.float32) * 0.1)
    s = jc["s"]
    if mantissa:  # any bf16 value of the scales' exponents: the decode rounds
        s = jnp.asarray(np.asarray(s, np.float32) * (1 + rng.random(s.shape)), jnp.bfloat16)
    x = rng.standard_normal((M, IN)).astype(np.float32)
    ref = np.asarray(pfp4.fp8_gemv(jnp.asarray(x), jc["q"], s, interpret=True))
    q, st = numpy_to_torch(np.asarray(jc["q"])), numpy_to_torch(np.asarray(s))
    p = k4.plan(OUT, IN, 128, sms)
    assert p.ks > 1  # the case splits K
    np.testing.assert_allclose(_emulate(torch.from_numpy(x), q, st, p).numpy(), ref,
                               rtol=0, atol=2e-5)
    before = k4.launches
    np.testing.assert_allclose(k4.fp8_gemv(torch.from_numpy(x), q, st).numpy(), ref,
                               rtol=0, atol=2e-5)
    assert k4.launches == before  # a CPU tensor takes the plain version


def test_study_cpu_mode(capsys):
    assert k4_study.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert '"wkv": {"tile_rows": 8, "rt": 1, "ks": 16, "unit": 128, "blocks": 64' in out
    assert abs(k4_study.step_bound_ms() * 1e3 - 261.28) < 0.01


def test_study_variants_and_mutants_apply_to_the_source():
    """Every substitution of the current design's variants and of the
    planted faults finds its text in csrc/fp8_gemv.cu once."""
    variants = k4_study.variant_sources()
    assert set(variants) == set(k4_study.CURRENT)
    mutants = k4_study.variant_sources(mutants=True)
    assert len(mutants) == 4
    for text, _ in list(variants.values()) + list(mutants.values()):
        assert "extern \"C\" int fp8_gemv(" in text
    assert not k4_study.is_parent(SOURCE)


def test_check_cases_cover_the_step_shapes():
    cases = k4_study.check_cases()
    shapes = {(c[1], c[2]) for c in cases}
    assert {(o, i) for _, o, i, _ in k4_study.STEP_SHAPES} <= shapes
    assert {c[3] for c in cases} == {1, 2, 8} and any(c[4] for c in cases)
    assert any(c[5] == 0 or c[6] == 0 for c in cases)  # a full-dim scale block
