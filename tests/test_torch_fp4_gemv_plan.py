"""K3 (``csrc/fp4_gemv.cu``, the packed-fp4 expert GEMV of fp4 decode) on
the CPU: its row grouping, its launch plan and index formulas, and its
fixed-order sums, emulated from the source's own constants and formulas.

- The grouping (``common.cuh slot_group``, shared with K6: a slot's warp
  votes over its chunk of 16 ids: the lanes of
  each id, the first lane of each valid id, the slot's j-th first lane)
  gives each chunk's distinct valid experts in order of first appearance,
  each with its rows in order, no place to an invalid id, and nothing to
  the slots past them; a direct numpy reading agrees.
- The plan (``ops/cuda/fp4_gemv.py::plan``) and the kernel's formulas (block
  -> warp tiles and K parts, thread -> rows and runs, the B columns, the
  block's sums, the zero rows) cover each (row, output channel, 32-column
  run) of w1 and w2 and of small shapes exactly once, and write each y
  element once, at M 1, 6, 12 and 20; each mma step pairs A and B on the
  same physical columns.
- A plain-torch emulation of the kernel's sums (a warp's run, 128
  consecutive columns, as one f32 product, added in order, a block's K
  parts in order) matches
  the JAX package's ``moe_fp4_gemv`` in interpret mode at the JAX tests'
  atol 2e-5, at tests/test_torch_dsv4_ops.py's sizes (groups 32 and 256,
  power-of-two and random-mantissa scales, repeated experts).
- The CPU wrapper gives 0 for rows of invalid ids; the K3 study's ``--cpu``
  runs and its variants and planted faults find their text in the source.
The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py).
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.ops import quant as jquant
from pegainfer_tpu.ops.pallas import fp4_gemm as pfp4
from pegainfer_tpu_torch.ops import quant as tquant
from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
from pegainfer_tpu_torch.studies import k3_study
from pegainfer_tpu_torch.utils.weights import numpy_to_torch

SMS = 132
SOURCE = (build.CSRC_DIR / "fp4_gemv.cu").read_text()
COMMON = (build.CSRC_DIR / "common.cuh").read_text()  # the grouping K3 and K6 share
CONSTS = {n: int(v) for n, v in re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE)}
CHUNK = CONSTS["kChunkRows"]
TILES, RUNS = CONSTS["kTiles"], CONSTS["kRuns"]
WARP_CH = 16 * TILES
STEP_K = 4 * 32 * RUNS


def test_wrapper_constants_are_the_kernels():
    assert (k3.CHUNK_ROWS, k3.WARP_CH, k3.STEP_K, k3.MAX_WARPS) == (
        CHUNK, WARP_CH, STEP_K, CONSTS["kMaxWarps"])
    for line in ("constexpr int kWarpCh = 16 * kTiles;", "constexpr int kRows = 2 * kTiles;",
                 "constexpr int kStepK = 4 * 32 * kRuns;"):
        assert line in SOURCE, line


# ── the grouping ─────────────────────────────────────────────────────────
GROUPING_LINES = (
    "const int c0 = slot / kChunk * kChunk, j = slot % kChunk;",
    "const int n = min(kChunk, M - c0);",
    "const int e = lane < n ? idx[c0 + lane] : -1;",
    "const bool valid = lane < n && e >= 0 && e < E;",
    "const unsigned same = __match_any_sync(0xffffffffu, e);",
    "const unsigned firsts = __ballot_sync(0xffffffffu, valid && !(same & ((1u << lane) - 1)));",
    "invalid = __ballot_sync(0xffffffffu, lane < n && !valid);",
    "if (j < __popc(firsts)) {",
    "const int f = nth_bit(firsts, j);",
    "expert = __shfl_sync(0xffffffffu, e, f);",
    "rows = __shfl_sync(0xffffffffu, same, f);",
)


def _nth_bit(mask: int, n: int) -> int:
    for _ in range(n):
        mask &= mask - 1
    return (mask & -mask).bit_length() - 1


def _slot_group(idx: torch.Tensor, E: int, slot: int):
    """``slot_group<kChunkRows>`` in torch, the 32 lanes a vector: (expert
    or -1, the mask of its rows in the chunk, the chunk's invalid mask)."""
    M = idx.numel()
    c0, j = slot // CHUNK * CHUNK, slot % CHUNK
    n = min(CHUNK, M - c0)
    lane = torch.arange(32)
    e = torch.full((32,), -1, dtype=torch.int64)
    e[:n] = idx[c0:c0 + n].long()
    valid = (lane < n) & (e >= 0) & (e < E)
    bit = 2 ** lane
    same = ((e[:, None] == e[None, :]).long() * bit[None, :]).sum(1)  # __match_any_sync
    firsts = int((valid & ((same & (bit - 1)) == 0)).long().mul(bit).sum())
    invalid = int(((lane < n) & ~valid).long().mul(bit).sum())
    if j < bin(firsts).count("1"):
        f = _nth_bit(firsts, j)
        return int(e[f]), int(same[f]), invalid
    return -1, 0, invalid


def _groups_numpy(idx: np.ndarray, E: int):
    """A direct reading: per chunk of 16 rows, the distinct valid ids in
    order of first appearance, each with its rows (absolute), and the rows
    of invalid ids."""
    out = []
    for c0 in range(0, len(idx), CHUNK):
        order, rows, bad = [], {}, []
        for m in range(c0, min(len(idx), c0 + CHUNK)):
            e = int(idx[m])
            if not 0 <= e < E:
                bad.append(m)
                continue
            if e not in rows:
                order.append(e)
                rows[e] = []
            rows[e].append(m)
        out.append(([(e, rows[e]) for e in order], bad))
    return out


def _idx_cases():
    rng = np.random.default_rng(0)
    E = 8
    cases = {"one row": np.array([3]), "all one expert": np.full(12, 5),
             "shared (B = 2)": np.array([0, 1, 2, 3, 4, 5, 6, 0, 7, 1, 2, 2]),
             "invalid": np.array([2, -1, 2, 8, 7, -5, 2, 100]),
             "all invalid": np.array([-1, 8, 9])}
    for M in (6, 12, 16, 17, 20, 40):
        cases[f"random M={M}"] = rng.integers(-1, E + 1, M)
    return E, cases


@pytest.mark.parametrize("name", list(_idx_cases()[1]))
def test_grouping_matches_a_direct_reading(name):
    for line in GROUPING_LINES:
        assert line in COMMON, line
    assert "slot_group<kChunkRows>(idx, M, E, blockIdx.y, lane, expert, rows, invalid);" in SOURCE
    E, cases = _idx_cases()
    idx = cases[name].astype(np.int32)
    want = _groups_numpy(idx, E)
    M = len(idx)
    for c, (groups, bad) in enumerate(want):
        c0 = c * CHUNK
        for j in range(min(CHUNK, M - c0)):
            expert, rows, invalid = _slot_group(torch.from_numpy(idx), E, c0 + j)
            assert invalid == sum(1 << (m - c0) for m in bad)
            if j < len(groups):
                e, members = groups[j]
                assert expert == e and rows == sum(1 << (m - c0) for m in members)
                # the B columns in order: row nth_bit(rows, n) of the chunk
                assert [c0 + _nth_bit(rows, n) for n in range(len(members))] == members
            else:
                assert expert == -1 and rows == 0  # a slot past the chunk's experts exits


# ── the plan and the index formulas ──────────────────────────────────────
WALK_LINES = (
    "const int tile = blockIdx.x * rt + warp % rt;",
    "const int kp = warp / rt, nu = IN / unit;",
    "const int k0 = kp * nu / ks * unit, k1 = (kp + 1) * nu / ks * unit;",
    "const int o0 = tile * kWarpCh;",
    "const size_t o = ebase + min(o0 + g + 8 * h, OUT - 1);",
    "const int steps = o0 < OUT ? (k1 - k0 + kStepK - 1) / kStepK : 0;",
    "for (int st = 0; st < steps; ++st) {",
    "const int base = k0 + st * kStepK;",
    "const int col = base + 32 * t + 128 * u;",
    "const bool in = col < k1;",
    "st.a[u][h] = in ? ld_codes(qr[h] + col / 2) : zero;",
    "if (st + 1 < steps) load(nxt, base + kStepK, j, rem);",
    "const uint4 xw = xv && in ? __ldg(reinterpret_cast<const uint4*>(xr + col) + wi) : zero;",
    "e2m1x8_bf16x2(word(cur.a[u][h], wi), cur.sc[u][h], r[h]);",
    "const uint32_t af[4] = {r[2 * mt][2 * hh], r[2 * mt + 1][2 * hh],",
    "r[2 * mt][2 * hh + 1], r[2 * mt + 1][2 * hh + 1]};",
    "mma_bf16(cr[mt], af, word(xw, 2 * hh), word(xw, 2 * hh + 1));",
    "for (int n0 = 0; n0 < cnt; n0 += 8) {",
    "const bool xv = n0 + g < cnt;",
    "x + static_cast<size_t>(c0 + (xv ? nth_bit(rows, n0 + g) : 0)) * IN;",
    "const int nb = rt * kWarpCh, o_blk = blockIdx.x * nb;",
    "red[(warp * kWarpCh + mt * 16 + g + 8 * (i >> 1)) * 8 + 2 * t + (i & 1)] = c[mt][i];",
    "const int cols = min(8, cnt - n0);",
    "for (int e = threadIdx.x; e < nb * cols; e += blockDim.x) {",
    "const int col = e / nb, i = e % nb, o = o_blk + i;",
    "v += red[((p * rt + i / kWarpCh) * kWarpCh + i % kWarpCh) * 8 + col];",
    "if (o < OUT) y[static_cast<size_t>(row_of[n0 + col]) * OUT + o] = v;",
    "if (blockIdx.y % kChunkRows == 0) {",
    "if (o_blk + i < OUT) yr[o_blk + i] = 0.f;",
    "const dim3 grid((tiles + rt - 1) / rt, M);",
)


def _walk(p, idx, E, OUT, IN):
    """The kernel's work by its formulas: (how many threads read each (row,
    channel, 32-column run) of the routed weights, how many writes reach
    each y element)."""
    M = len(idx)
    runs = IN // 32
    cover = np.zeros((M, OUT, runs), np.int32)
    writes = np.zeros((M, OUT), np.int32)
    g, t = np.arange(8), np.arange(4)
    nb = p.rt * WARP_CH
    for slot in range(M):
        expert, rows, invalid = _slot_group(torch.from_numpy(idx), E, slot)
        c0 = slot // CHUNK * CHUNK
        for bx in range(p.blocks(OUT)):
            o_blk = bx * nb
            chans = np.arange(o_blk, min(OUT, o_blk + nb))
            if slot % CHUNK == 0:
                for r in range(CHUNK):
                    if invalid >> r & 1:
                        writes[c0 + r, chans] += 1
            if expert < 0:
                continue
            members = [c0 + _nth_bit(rows, n) for n in range(bin(rows).count("1"))]
            for n0 in range(0, len(members), 8):  # passes of 8 B columns
                part = members[n0:n0 + 8]
                for warp in range(p.rt * p.ks):
                    tile, kp = bx * p.rt + warp % p.rt, warp // p.rt
                    k0, k1 = p.span(kp, IN)
                    o0 = tile * WARP_CH
                    if o0 >= OUT:
                        continue
                    ch = (o0 + g[:, None] + 8 * np.arange(2 * TILES)[None, :]).ravel()
                    ch = ch[ch < OUT]  # rows past OUT are read and never written
                    for base in range(k0, k1, STEP_K):
                        for u in range(RUNS):
                            col = base + 32 * t + 128 * u
                            col = col[col < k1]
                            cover[np.ix_(part, ch, col // 32)] += 1
                for row in part:  # the block's sums
                    writes[row, chans] += 1
    return cover, writes


def _routed(idx, E):
    return np.array([0 <= e < E for e in idx])


@pytest.mark.parametrize("M,kind", [(1, "distinct"), (6, "distinct"), (12, "shared"),
                                    (12, "repeated"), (20, "repeated"), (20, "invalid")])
@pytest.mark.parametrize("name,OUT,IN,n", k3_study.SHAPES)
def test_plan_covers_the_step_shapes_once(name, OUT, IN, n, M, kind):
    for line in WALK_LINES:
        assert line in SOURCE, line
    E = 64
    idx = k3_study.route(kind, M, E, torch.randperm(E, generator=torch.Generator()
                                                    .manual_seed(M))).numpy()
    p = k3.plan(OUT, IN, 32, M, SMS)
    assert p.rt * p.ks <= k3.MAX_WARPS and IN % p.unit == 0 and p.unit % STEP_K == 0
    if M == 6:  # enough blocks to fill the SMs at a B = 1 step
        assert p.blocks(OUT) * M >= 2 * SMS
    cover, writes = _walk(p, idx, E, OUT, IN)
    routed = _routed(idx, E)
    assert (cover[routed] == 1).all() and (cover[~routed] == 0).all()
    assert (writes == 1).all()


@pytest.mark.parametrize("M", [1, 6, 12, 20])
@pytest.mark.parametrize("OUT,IN,group,sms", [(64, 256, 32, SMS), (96, 1024, 32, SMS),
                                              (1000, 512, 64, 16), (48, 768, 96, 4),
                                              (32, 320, 32, SMS)])
def test_plan_covers_other_shapes_once(OUT, IN, group, sms, M):
    """A ragged last tile (OUT 1000, 48), a group of 96 (a unit of 768), an
    IN that no step divides (320: one K part, its last step half in)."""
    E = 16
    idx = k3_study.route("repeated" if M > 1 else "distinct", M, E, torch.arange(E)).numpy()
    p = k3.plan(OUT, IN, group, M, sms)
    assert p.unit % group == 0 and IN % p.unit == 0 and p.ks <= IN // p.unit
    cover, writes = _walk(p, idx, E, OUT, IN)
    assert (cover == 1).all() and (writes == 1).all()


def test_mma_steps_pair_a_and_b_on_the_same_columns():
    """Thread (g, t), run u, word wi, half hh: A's k-slots {2t, 2t+1} are
    byte 2hh of the run's word wi (codes 8wi + 4hh + {0, 1}), {2t+8, 2t+9}
    byte 2hh + 1 (+ {2, 3}); B's registers are words 2hh and 2hh + 1 of x's
    uint4 wi at the run's column (values 8wi + 4hh + {0, 1}, {2, 3}). Over
    the 4 lanes t, the 8 mma steps of run u take each of the 128 columns
    [128u, 128u + 128) of the step once."""
    for u in range(RUNS):
        seen = []
        for wi in range(4):
            for hh in range(2):
                a_cols, b_cols = [], []
                for t in range(4):
                    col = 32 * t + 128 * u
                    for byte, kslot in ((2 * hh, 2 * t), (2 * hh + 1, 2 * t + 8)):
                        codes = [col + 8 * wi + 2 * byte, col + 8 * wi + 2 * byte + 1]
                        a_cols.append((kslot, codes))
                    for w, kslot in ((2 * hh, 2 * t), (2 * hh + 1, 2 * t + 8)):
                        b_cols.append((kslot, [col + 8 * wi + 2 * w, col + 8 * wi + 2 * w + 1]))
                assert sorted(a_cols) == sorted(b_cols)
                seen += [c for _, cs in a_cols for c in cs]
        assert sorted(seen) == list(range(128 * u, 128 * u + 128))


# ── the fixed-order sums against the JAX package ─────────────────────────


def _emulate(x, q, s, idx, p):
    """The kernel's sums in plain torch: a warp's run (its 4 lanes' 32
    columns, 128 in a row) as one f32 product added to the warp's sums in
    order, a block's K parts added in order; rows of invalid ids 0."""
    E, OUT, _ = q.shape
    IN = x.shape[1]
    xb = x.to(torch.bfloat16).float()
    y = torch.zeros((x.shape[0], OUT))
    for slot in range(x.shape[0]):
        expert, rows, _ = _slot_group(idx, E, slot)
        if expert < 0:
            continue
        c0 = slot // CHUNK * CHUNK
        members = [c0 + _nth_bit(rows, n) for n in range(bin(rows).count("1"))]
        w = tquant.dequant_any({"q": q[expert], "s": s[expert]}, torch.bfloat16).float()
        for bx in range(p.blocks(OUT)):
            total = None
            for kp in range(p.ks):
                k0, k1 = p.span(kp, IN)
                acc = torch.zeros((len(members), p.rt * WARP_CH))
                for base in range(k0, k1, STEP_K):
                    for u in range(RUNS):
                        cols = [c for t in range(4) for c in range(
                            base + 32 * t + 128 * u, base + 32 * t + 128 * u + 32) if c < k1]
                        if not cols:
                            continue
                        o = torch.arange(bx * p.rt * WARP_CH, (bx + 1) * p.rt * WARP_CH)
                        wo = w[o.clamp(max=OUT - 1)][:, cols]
                        acc = acc + xb[members][:, cols] @ wo.T
                total = acc if total is None else total + acc
            lo, hi = bx * p.rt * WARP_CH, min(OUT, (bx + 1) * p.rt * WARP_CH)
            y[members, lo:hi] = total[:, : hi - lo]
    return y


@pytest.mark.parametrize("mantissa", [False, True])
@pytest.mark.parametrize("E,OUT,IN,group", [(4, 64, 256, 32), (4, 256, 512, 32),
                                            (2, 32, 256, 256), (8, 64, 1024, 32)])
def test_emulated_sums_match_pallas(E, OUT, IN, group, mantissa):
    rng = np.random.default_rng(E + OUT + IN + mantissa)
    jc = jquant.quantize_fp4_stack(rng.standard_normal((E, OUT, IN)).astype(np.float32) * 0.1,
                                   group=group)
    s = jc["s"]
    if mantissa:  # any bf16 value of the scales' exponents: the decode rounds
        s = jnp.asarray(np.asarray(s, np.float32) * (1 + rng.random(s.shape)), jnp.bfloat16)
    M = 12
    x = rng.standard_normal((M, IN)).astype(np.float32)
    idx = rng.integers(0, E, M).astype(np.int32)
    idx[7], idx[11] = idx[0], idx[2]  # repeated experts
    ref = np.asarray(pfp4.moe_fp4_gemv(jnp.asarray(x), jc["q"], s, jnp.asarray(idx),
                                       interpret=True))
    q, st = numpy_to_torch(np.asarray(jc["q"])), numpy_to_torch(np.asarray(s))
    p = k3.plan(OUT, IN, group, M, SMS)
    got = _emulate(torch.from_numpy(x), q, st, torch.from_numpy(idx), p)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)
    before = k3.launches
    np.testing.assert_allclose(
        k3.moe_fp4_gemv(torch.from_numpy(x), q, st, torch.from_numpy(idx)).numpy(), ref,
        rtol=0, atol=2e-5)
    assert k3.launches == before  # a CPU tensor takes the plain version


def test_emulated_sums_split_k_match_the_plain_version():
    """A plan of 4 K parts and 2 tiles a block (three blocks at OUT 88, the
    last tile ragged), repeated experts across two chunks of rows and
    invalid ids, against the plain version."""
    rng = np.random.default_rng(5)
    E, OUT, IN, M = 6, 88, 1024, 20
    c = tquant.quantize_fp4_stack(rng.standard_normal((E, OUT, IN)).astype(np.float32) * 0.1)
    x = torch.from_numpy(rng.standard_normal((M, IN)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, E + 1, M).astype(np.int32))
    p = k3.Plan(2, 4, 128)
    assert p.blocks(OUT) == 3
    want = k3.moe_fp4_gemv_plain(x, c["q"], c["s"], idx)
    np.testing.assert_allclose(_emulate(x, c["q"], c["s"], idx, p).numpy(), want.numpy(),
                               rtol=0, atol=2e-5)


def test_plain_version_zeroes_rows_of_invalid_ids():
    rng = np.random.default_rng(3)
    E, OUT, IN = 3, 32, 256
    c = tquant.quantize_fp4_stack(rng.standard_normal((E, OUT, IN)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((5, IN)).astype(np.float32))
    idx = torch.tensor([1, -1, 3, 0, 1], dtype=torch.int32)
    y = k3.moe_fp4_gemv(x, c["q"], c["s"], idx)
    assert (y[[1, 2]] == 0).all() and (y[[0, 3, 4]] != 0).any(dim=1).all()
    w = tquant.dequant_any(c, torch.bfloat16).float()
    xb = x.to(torch.bfloat16).float()
    for m, e in ((0, 1), (3, 0), (4, 1)):
        np.testing.assert_allclose(y[m].numpy(), (w[e] @ xb[m]).numpy(), rtol=0, atol=2e-5)


# ── the study ────────────────────────────────────────────────────────────


def test_study_cpu_mode(capsys):
    assert k3_study.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert '"w1 M=6 distinct": {"rt": 2, "ks": 4, "unit": 128, "blocks": 384' in out
    # the step's bound: 16 w1 / w3 and 8 w2 launches of 6 distinct experts
    per = k3_study.bytes_moved(6, 6, 2048, 4096) / k3_study.READ_CEILING * 1e6
    assert math.isclose(k3_study.step_bound_ms() * 1e3, 24 * per, rel_tol=1e-3)
    assert abs(per - 9.10) < 0.01


def test_study_variants_and_mutants_apply_to_the_source():
    """Every substitution of the current design's variants and of the
    planted faults finds its text in csrc/fp4_gemv.cu once."""
    variants = k3_study.variant_sources()
    assert set(variants) == set(k3_study.CURRENT)
    mutants = k3_study.variant_sources(mutants=True)
    assert len(mutants) == 5
    for text, _ in list(variants.values()) + list(mutants.values()):
        assert 'extern "C" int fp4_gemv(' in text
    assert not k3_study.is_parent(SOURCE)


def test_check_cases_cover_the_card_cases():
    cases = k3_study.check_cases()
    shapes = {(c[1], c[2]) for c in cases}
    assert shapes == {(2048, 4096), (4096, 2048)}
    assert {c[4] for c in cases} == {1, 2, 6, 12, 20, 40}
    assert {c[5] for c in cases} == {"distinct", "repeated", "shared", "invalid"}
    assert {c[3] for c in cases} == {32, 64} and {c[6] for c in cases} == {True, False}
    assert any(c[0].startswith("w3") for c in cases)
    # the routings give what they claim: distinct experts, shared 9 of 12
    for M, kind in ((6, "distinct"), (12, "shared"), (12, "repeated"), (20, "invalid")):
        idx = k3_study.route(kind, M, 64, torch.arange(64)).numpy()
        valid = idx[(idx >= 0) & (idx < 64)]
        assert len(idx) == M and len(set(valid.tolist())) == k3_study.distinct(kind, M)
