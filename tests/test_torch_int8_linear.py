"""The int8 linear kernel (``csrc/int8_linear.cu``, the decode rows of the int8
weight-only linears of Qwen3 and Qwen3.5) on the CPU: its plain version
against the JAX package's ``ops/quant.py::int8_linear``, the group entry
``ops/quant.py::int8_linears`` against weight-by-weight calls, and its
launch plan walked by the kernel's own index formulas.

- The plain version (``ops/cuda/int8_linear.py::int8_linear_plain``, what
  the wrapper runs on CPU tensors) on numpy inputs from a seed, one weight
  and groups of 2 to 4 of different OUT, at M 1, 8, 9, 16, 17 and 64, a
  ragged OUT 1000 and IN 400, bf16 and f32 rows, against the JAX
  ``int8_linear`` (``jax.numpy`` on the CPU, the codes in its [in, out]
  layout). The kernel rounds x to bf16 first, so the f32 rows are values
  that bf16 holds exactly. Limits: an f32 output each row to 1e-5 of its
  max |ref| (the two forms sum the same exact f32 products in another
  order); a bf16 output each row to one bf16 ulp of its max |ref|, the
  most one such f32 sum that straddles a rounding boundary moves an
  element (``int8_linear_study.row_limits``).
- ``quant.int8_linears`` equals ``quant.int8_linear`` weight by weight bit
  for bit on the CPU, as a list and joined; the models' grouped
  projections equal their projections one by one.
- The plan (``ops/cuda/int8_linear.py::plan``) for every launch of a
  Qwen3-4B and a Qwen3.5 decode step (``int8_linear_study.STEP_LAUNCHES``:
  the groups and the single weights) and every K6 dense shape
  (``k6_study.DENSE_SHAPES``) at the decode buckets: the kernel's formulas
  (read from the source: block -> weight and tile, warp -> K part, step ->
  columns, lane -> 16-byte chunk of codes, the block's sums), vectorised in
  numpy, read each (weight, channel, 16-column chunk) once and write each
  y element once; a lane's A fragment and its B columns are the same
  physical columns.
The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.ops import quant as jquant
from pegainfer_tpu_torch.models import qwen3 as tq3
from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda import int8_linear as il
from pegainfer_tpu_torch.studies import int8_linear_study as study
from pegainfer_tpu_torch.studies import k6_study

SOURCE = (build.CSRC_DIR / "int8_linear.cu").read_text()
CONSTS = {n: int(v) for n, v in re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE)}
RUNS = CONSTS["kRuns"]
STEP_K = 64 * RUNS
ROWS = (1, 2, 4, 8, 16, 32, 64)


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _weights(rng, outs, IN):
    """int8 codes [OUT, IN] over -127..127 and positive f32 scales a weight."""
    return ([rng.integers(-127, 128, (o, IN)).astype(np.int8) for o in outs],
            [(rng.random(o) * 1e-2 + 1e-3).astype(np.float32) for o in outs])


_jax_int8_linear = jax.jit(jquant.int8_linear)


def _jax_ref(x, q, s):
    """The JAX package's int8_linear: x [M, in], its codes [in, out]."""
    return _jax_int8_linear(jnp.asarray(x), jnp.asarray(q.T), jnp.asarray(s))


CASES = [(outs, IN) for outs, IN in (((1000,), 400), ((96, 40), 512), ((1000, 64, 48), 400),
                                     ((256, 512, 128, 64), 256))]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("M", [1, 8, 9, 16, 17, 64])
@pytest.mark.parametrize("outs,IN", CASES, ids=lambda v: str(v))
def test_plain_version_is_the_jax_int8_linear(outs, IN, M, dtype):
    rng = np.random.default_rng(sum(outs) + IN + M)
    qs, ss = _weights(rng, outs, IN)
    x = _bf16_exact(rng.standard_normal((M, IN)).astype(np.float32))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    xt = torch.from_numpy(x).to(tdt)
    before = il.launches
    ys = il.int8_linear(xt, [torch.from_numpy(q) for q in qs], [torch.from_numpy(s) for s in ss])
    assert il.launches == before and len(ys) == len(outs)
    for y, q, s in zip(ys, qs, ss):
        ref = _jax_ref(x if dtype == "f32" else jnp.asarray(x, jnp.bfloat16), q, s)
        ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(tdt)
        assert y.dtype == tdt and y.shape == (M, q.shape[0])
        err, share = study.row_err(y, ref)
        assert share <= 1.0, (err, share)


def test_row_limits_are_one_ulp_of_the_row_max_or_1e_5():
    ref = torch.tensor([[1.0, -0.5], [3.0, 0.0], [0.0, 0.0]])
    assert study.row_limits(ref.to(torch.bfloat16)).tolist() == [2.0 ** -7, 2.0 ** -6, 0.0]
    assert torch.allclose(study.row_limits(ref), torch.tensor([1e-5, 3e-5, 0.0]))
    y = ref.clone().to(torch.bfloat16)
    y[0, 1] += 2.0 ** -8  # one ulp of -0.5, half an ulp of the row's max: passes
    assert study.row_err(y, ref.to(torch.bfloat16))[1] <= 1.0
    y[1, 0] = 3.0 + 2.0 ** -5  # two ulps of the row's max: fails
    assert study.row_err(y, ref.to(torch.bfloat16))[1] > 1.0


def test_plain_version_rounds_x_to_bf16_and_casts_once():
    """f32 rows: x rounded to bf16, exact f32 products summed, times s in
    f32, kept f32; a row of zeros gives zeros."""
    rng = np.random.default_rng(3)
    qs, ss = _weights(rng, (32,), 64)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    x[1] = 0.0
    y, = il.int8_linear_plain(torch.from_numpy(x), [torch.from_numpy(qs[0])],
                              [torch.from_numpy(ss[0])])
    want = (_bf16_exact(x).astype(np.float64) @ qs[0].T.astype(np.float64)) * ss[0]
    assert y.dtype == torch.float32 and (y[1] == 0).all()
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [1, 17, 64, 65, 200])
def test_int8_linears_equal_int8_linear_weight_by_weight(M, dtype):
    """On the CPU (and for more than INT8_GEMV_ROWS rows) the group entry is
    the per-weight ``int8_linear``: the same bits, as a list and joined."""
    rng = np.random.default_rng(M)
    ws = [quant.quantize_int8_linear(torch.from_numpy(
        rng.standard_normal((96, o)).astype(np.float32) * 0.05)) for o in (80, 16, 48, 32)]
    x = torch.from_numpy(rng.standard_normal((M, 96)).astype(np.float32)).to(dtype)
    for n in (1, 2, 3, 4):
        one = [quant.int8_linear(x, w) for w in ws[:n]]
        got = quant.int8_linears(x, ws[:n])
        joined = quant.int8_linears(x, ws[:n], joined=True)
        assert all(torch.equal(a, b) for a, b in zip(one, got))
        assert torch.equal(joined, torch.cat(one, dim=-1))


def test_models_grouped_projections_equal_one_by_one():
    """Qwen3's ``_projs`` (wq / wk / wv) on int8 and bf16 weights is its
    ``_proj`` one by one, bit for bit."""
    rng = np.random.default_rng(9)
    bf = {k: torch.from_numpy(rng.standard_normal((64, o)).astype(np.float32) * 0.05)
          for k, o in (("wq", 64), ("wk", 32), ("wv", 32))}
    q8 = {k: quant.quantize_int8_linear(v) for k, v in bf.items()}
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    for lw in (bf, q8):
        got = tq3._projs(lw, ("wq", "wk", "wv"), x, False)
        assert all(torch.equal(a, tq3._proj(lw, k, x, False))
                   for a, k in zip(got, ("wq", "wk", "wv")))


def test_wrapper_refuses_a_device_without_the_kernel():
    q = torch.zeros((16, 32), dtype=torch.int8, device="meta")
    s = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        il.int8_linear(torch.zeros((1, 32), device="meta"), [q], [s])
    with pytest.raises(ValueError, match="bf16 or f32"):
        il.int8_linear_plain(torch.zeros((1, 32), dtype=torch.float16),
                             [torch.zeros((16, 32), dtype=torch.int8)], [torch.zeros(16)])


# ── the plan, walked by the kernel's formulas ─────────────────────────────
FORMULAS = (
    "const int tile = lb * rt + warp % rt, kp = warp / rt;",
    "const int o0 = tile * 16;  // the warp's first channel",
    "const int nsteps = (IN + kStepK - 1) / kStepK;",
    "const int steps = o0 < OUT && nsteps > kp ? (nsteps - kp + ks - 1) / ks : 0;",
    "const int col0 = (j * ks + kp) * kStepK;",
    "const int c = lane + 32 * i, r = c / kPieces, pc = c % kPieces, col = col0 + 16 * pc;",
    "const bool ok = o0 + r < OUT && col < IN;",
    "cp_async16(dst + r * kStepK + 16 * (pc ^ swizzle(r)),",
    "const int col = (st * ks + kp) * kStepK + 64 * u + 16 * t;  // the lane's 16 columns",
    "const int at = 16 * ((4 * u + t) ^ swizzle(g));",
    "const uint4 c0 = ld_shared16(stage + g * kStepK + at);",
    "const uint4 c1 = ld_shared16(stage + (g + 8) * kStepK + at);",
    "const int nb = rt * 16, o_blk = lb * nb;",
    "const int m = e / nb, i = e % nb, o = o_blk + i;",
    "for (int p = 0; p < ks; ++p) v += red[((p * rt + i / 16) * 8 * G + m) * kRs + i % 16];",
    "blocks += (tiles + rt - 1) / rt;",
    "if (i < grp.n && grp.w[i].first_block <= static_cast<int>(blockIdx.x)) {",
)
# the warpgroup form's (past 16 rows: rt = 4, a warpgroup a K part)
FORMULAS_WG = (
    "if (G >= kWgFromGroups && rt == 4 && ks <= 2) {  // a warpgroup a K part",
    "const int tid = threadIdx.x, kp = tid >> 7, wt = tid & 127;",
    "const int o_blk = lb * 64;  // the block's 64 channels",
    "const int steps = o_blk < OUT && nsteps > kp ? (nsteps - kp + ks - 1) / ks : 0;",
    "const int c = wt + 128 * i, r = c >> 3, pc = c & 7, col = col0 + 16 * pc;",
    "const bool ok = o_blk + r < OUT && col < IN;",
    "const int m = e >> 6, i = e & 63, o = o_blk + i;",
    "for (int p = 0; p < ks; ++p) v += red[(p * N + m) * 68 + i];",
    "const int r0 = 16 * warp + g, r1 = r0 + 8;  // the lane's rows of codes",
    "const uint32_t sel = t & 1 ? 0x7632u : 0x5410u;",
)


def test_the_formulas_walked_here_are_the_sources():
    text = " ".join(SOURCE.split())
    for line in FORMULAS + FORMULAS_WG:
        assert " ".join(line.split()) in text, line
    assert f"constexpr int kWgFromGroups = {il.WG_FROM_GROUPS};" in SOURCE
    assert "constexpr int kStepK = 64 * kRuns;" in SOURCE
    assert "return kRuns == 2 ? (row & 1) << 2 : 0;" in SOURCE
    assert (il.STEP_K, il.MAX_WARPS, il.MAX_WEIGHTS) == (
        STEP_K, CONSTS["kMaxWarps"], CONSTS["kMaxW"])


def _swizzle(row):
    return ((row & 1) << 2) if RUNS == 2 else 0


def _blocks_of(p, outs):
    """Each weight's first block and the grid's blocks (the C interface's
    sum), and each block's weight: the last whose first block is at or
    before it (the kernel's loop)."""
    firsts, blocks = [], 0
    for o in outs:
        firsts.append(blocks)
        blocks += -(-(-(-o // 16)) // p.rt)
    w_of = np.zeros(blocks, np.int64)
    for i, f in enumerate(firsts[1:], 1):
        w_of = np.where(f <= np.arange(blocks), i, w_of)
    return firsts, w_of


@functools.lru_cache(maxsize=None)
def _reads_once(rt, ks, outs, IN) -> bool:
    """Whether one launch of (rt, ks) copies each (weight, channel,
    16-column chunk) of the codes exactly once, by the kernel's formulas. A
    copy's channel comes from (block, warp, chunk row) and its columns from
    (K part, step, piece) alone, so the counts are the product of two walks:
    T[channel, part] over (block, warp, row) and C[part, chunk] over (step,
    piece) of the part's steps (a tile past OUT has no steps and no rows)."""
    p = il.Plan(1, rt, ks)
    pieces = STEP_K // 16
    firsts, w_of = _blocks_of(p, outs)
    nsteps = -(-IN // STEP_K)
    kp = np.arange(ks)[:, None, None]
    steps = np.where(nsteps > kp, (nsteps - kp + ks - 1) // ks, 0)
    j = np.arange(nsteps)[None, :, None]
    col = (j * ks + kp) * STEP_K + 16 * np.arange(pieces)[None, None, :]
    ok = (j < steps) & (col < IN)
    kk, cc = np.broadcast_arrays(kp, col)
    C = np.zeros((ks, IN // 16), np.int64)
    np.add.at(C, (kk[ok], cc[ok] // 16), 1)
    warp = np.arange(rt * ks)[None, :, None]
    r = np.arange(16)[None, None, :]
    for w, o in enumerate(outs):
        lb = (np.flatnonzero(w_of == w) - firsts[w])[:, None, None]
        ch = (lb * rt + warp % rt) * 16 + r
        part = np.broadcast_to(warp // rt, ch.shape)
        keep = ch < o
        T = np.zeros((o, ks), np.int64)
        np.add.at(T, (ch[keep], part[keep]), 1)
        if not (T @ C == 1).all():
            return False
    return True


def _writes_once(p, outs, M) -> bool:
    """Whether the epilogue's entries (row e / nb, channel e % nb of each
    block's nb) write each y element of each weight exactly once."""
    firsts, w_of = _blocks_of(p, outs)
    nb = p.rt * 16
    e = np.arange(M * nb)
    for w, o in enumerate(outs):
        lb = (np.flatnonzero(w_of == w) - firsts[w])[:, None]
        oo = lb * nb + e[None, :] % nb
        mm = np.broadcast_to(e[None, :] // nb, oo.shape)
        keep = oo < o
        writes = np.bincount(mm[keep] * o + oo[keep], minlength=M * o)
        if not (writes == 1).all():
            return False
    return True


def _launches():
    out = [(name, tuple(outs), IN) for fam in study.STEP_LAUNCHES.values()
           for name, outs, IN, _ in fam]
    out += [(name, (OUT,), IN) for name, OUT, IN, _ in k6_study.DENSE_SHAPES]
    return out


def _is_wg(p) -> bool:
    """Whether the C interface runs plan p in the warpgroup form."""
    return p.groups >= il.WG_FROM_GROUPS and p.rt == 4 and p.ks <= 2


@functools.lru_cache(maxsize=None)
def _reads_once_wg(ks, outs, IN) -> bool:
    """``_reads_once`` by the warpgroup form's formulas: a block is one
    64-channel tile, thread wt of warpgroup kp copies chunks c = wt + 128i
    (row c / 8, piece c % 8) of each of its part's steps."""
    pieces = 8
    nsteps = -(-IN // STEP_K)
    kp = np.arange(ks)[:, None, None]
    steps = np.where(nsteps > kp, (nsteps - kp + ks - 1) // ks, 0)
    j = np.arange(nsteps)[None, :, None]
    c = np.arange(512)  # a warpgroup's chunks of a step: wt + 128i
    r, pc = c >> 3, c & 7
    # each row's 8 pieces once: the copies of a step are rows x pieces
    assert (np.bincount(r * pieces + pc, minlength=64 * pieces) == 1).all()
    col = (j * ks + kp) * STEP_K + 16 * np.arange(pieces)[None, None, :]
    ok = (j < steps) & (col < IN)
    kk, cc = np.broadcast_arrays(kp, col)
    C = np.zeros((ks, IN // 16), np.int64)
    np.add.at(C, (kk[ok], cc[ok] // 16), 1)
    for o in outs:
        blocks = -(-o // 64)
        ch = (np.arange(blocks)[:, None] * 64 + np.arange(64)[None, :]).ravel()
        ch = ch[ch < o]
        T = np.zeros((o, ks), np.int64)
        T[ch, :] = 1  # every part's warpgroup of the block reads the block's rows
        if not (T @ C == 1).all():
            return False
    return True


def _covered_once(p, outs, IN, M) -> bool:
    reads = (_reads_once_wg(p.ks, tuple(outs), IN) if _is_wg(p)
             else _reads_once(p.rt, p.ks, tuple(outs), IN))
    return reads and _writes_once(p, outs, M)


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("name,outs,IN", _launches(), ids=lambda v: str(v))
def test_plan_reads_each_code_once_and_writes_each_output_once(name, outs, IN, M):
    p = il.plan(outs, IN, M)
    assert p.groups == il.row_groups(M) and 8 * p.groups >= M
    assert p.rt * p.ks <= il.MAX_WARPS and p.ks <= -(-IN // STEP_K)
    assert _covered_once(p, outs, IN, M)


@pytest.mark.parametrize("plan", [il.Plan(1, 1, 1), il.Plan(2, 2, 4), il.Plan(8, 8, 1),
                                  il.Plan(4, 1, 8), il.Plan(1, 4, 2)])
def test_any_plan_of_the_interface_covers_a_ragged_group_once(plan):
    """The formulas hold for every plan the C interface takes, not only
    ``plan``'s, on ragged OUTs (the last tile partly past OUT) and an IN
    that no step divides."""
    M = min(8 * plan.groups, 13)
    assert _covered_once(plan, (1000, 40, 17), 400, M)


def test_a_lanes_a_fragment_and_b_columns_are_the_same_physical_columns():
    """Lane (g, t)'s run u reads, from stage row g and g + 8, the 16-byte
    place where the copy put the piece of columns col0 + 64u + 16t .. +15,
    and its B takes x at those columns: the codes of word k of it fill
    k-step k's k-slots {2t, 2t+1, 2t+8, 2t+9} and the B words 2k, 2k + 1
    are x at the same four columns."""
    pieces = STEP_K // 16
    for g in range(8):
        for t in range(4):
            for u in range(RUNS):
                for row in (g, g + 8):
                    pc = 4 * u + t  # the piece of the lane's columns
                    written = pc ^ _swizzle(row)  # where the copy put it
                    read = (4 * u + t) ^ _swizzle(g)  # where the lane reads
                    assert written == read and 0 <= read < pieces
                # k-step k: codes 4k .. 4k + 3 of the run = A k-slots 2t, 2t+1
                # (p01) and 2t+8, 2t+9 (p23); B words 2k (x cols 4k, 4k+1) and
                # 2k + 1 (x cols 4k + 2, 4k + 3) of the same 16 columns
                for k in range(4):
                    a_cols = [4 * k, 4 * k + 1, 4 * k + 2, 4 * k + 3]
                    b_cols = [2 * (2 * k), 2 * (2 * k) + 1, 2 * (2 * k + 1), 2 * (2 * k + 1) + 1]
                    assert a_cols == b_cols


def test_study_cpu_mode_and_its_text_substitutions():
    """The study's ``--cpu`` (the plans and the plain version against numpy)
    and every variant's and planted fault's text is in the source once."""
    out = study.run_cpu()
    assert out["max_rel_err"] < 1e-6
    assert set(study.variant_sources()) >= {"as-is", "loads-only", "no-mma"}
    assert len(study.variant_sources(mutants=True)) == 4
    assert len(study.check_cases()) == 48
