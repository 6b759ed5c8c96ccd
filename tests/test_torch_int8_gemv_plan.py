"""K6 (``csrc/int8_gemv.cu``, the int8 expert GEMV of int8 decode with the
chain off) on the CPU: its row grouping, its launch plan and index
formulas, its int8 -> bf16 convert and its fixed-order sums, emulated from
the source's own constants and formulas.

- The grouping (``common.cuh slot_group``, K3's warp votes over a slot's
  chunk of 16 ids) gives each chunk's distinct valid experts in order of
  first appearance, each with its rows in order, no place to an invalid id,
  and nothing to the slots past them; a direct numpy reading agrees.
- The plan (``ops/cuda/int8_gemv.py::plan``) and the kernel's formulas (block
  -> warp tiles and K parts, a K part's steps kp, kp + ks, ..., thread ->
  rows and runs of 16 codes, the B columns, the passes of 8 rows, the
  block's sums, the zero rows) cover
  each (row, output channel, 16-column chunk) of w1 and w2 and of small
  shapes exactly once, and write each y element once, at M 1, 6, 12 and 20;
  each mma step pairs A and B on the same physical columns.
- The convert (``s8x4_to_bf16x2``: a byte permute, two masks, one bf16x2
  subtraction a pair), emulated bit by bit in numpy, gives every int8 value
  exactly in every byte of a word.
- A plain-torch emulation of the kernel's sums (a warp's run, 64
  consecutive columns, as one f32 product, added in order, a block's K
  parts, interleaved by step, in order) matches the JAX package's ``moe_int8_gemv`` in interpret
  mode to 1e-5 of each row's max |y| (the card checks' limit), at the JAX
  kernel tests' sizes and with repeated experts.
- The CPU wrapper gives 0 for rows of invalid ids; the K6 study's ``--cpu``
  runs and its variants and planted faults find their text in the source.
The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.ops.pallas import fp4_gemm as pfp4
from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
from pegainfer_tpu_torch.studies import k6_study

SMS = 132
SOURCE = (build.CSRC_DIR / "int8_gemv.cu").read_text()
COMMON = (build.CSRC_DIR / "common.cuh").read_text()
CONSTS = {n: int(v) for n, v in re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE)}
CHUNK = CONSTS["kChunkRows"]
RUNS = CONSTS["kRuns"]
WARP_CH = CONSTS["kWarpCh"]
STEP_K = 4 * 16 * RUNS
RTOL = 1e-5  # of each row's max |y| (chip_smoke.INT8_GEMV_RTOL)


def test_wrapper_constants_are_the_kernels():
    assert (k6.CHUNK_ROWS, k6.WARP_CH, k6.RUNS, k6.STEP_K, k6.MAX_WARPS) == (
        CHUNK, WARP_CH, RUNS, STEP_K, CONSTS["kMaxWarps"])
    assert "constexpr int kStepK = 4 * 16 * kRuns;" in SOURCE
    assert k6_study.RTOL == RTOL and k6_study.step_k(SOURCE) == STEP_K


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


def _slot_group(idx: np.ndarray, E: int, slot: int):
    """``slot_group<kChunkRows>`` in numpy, the 32 lanes a vector: (expert
    or -1, the mask of its rows in the chunk, the chunk's invalid mask)."""
    M = len(idx)
    c0, j = slot // CHUNK * CHUNK, slot % CHUNK
    n = min(CHUNK, M - c0)
    lane = np.arange(32)
    e = np.full(32, -1, np.int64)
    e[:n] = idx[c0:c0 + n]
    valid = (lane < n) & (e >= 0) & (e < E)
    bit = 1 << lane
    same = ((e[:, None] == e[None, :]) * bit[None, :]).sum(1)  # __match_any_sync
    firsts = int((valid & ((same & (bit - 1)) == 0)).astype(np.int64) @ bit)
    invalid = int(((lane < n) & ~valid).astype(np.int64) @ bit)
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
    rng = np.random.default_rng(1)
    E = 8
    cases = {"one row": np.array([3]), "all one expert": np.full(20, 5),
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
            expert, rows, invalid = _slot_group(idx, E, c0 + j)
            assert invalid == sum(1 << (m - c0) for m in bad)
            if j < len(groups):
                e, members = groups[j]
                assert expert == e and rows == sum(1 << (m - c0) for m in members)
                assert [c0 + _nth_bit(rows, n) for n in range(len(members))] == members
            else:
                assert expert == -1 and rows == 0  # a slot past the chunk's experts exits


# ── the plan and the index formulas ──────────────────────────────────────
WALK_LINES = (
    "const int tile = blockIdx.x * rt + warp % rt;",
    "const int kp = warp / rt;",
    "const int o0 = tile * kWarpCh;",
    "for (int h = 0; h < 2; ++h) qr[h] = q + (ebase + min(o0 + g + 8 * h, OUT - 1)) * IN;",
    "const int nsteps = o0 < OUT ? (IN + kStepK - 1) / kStepK : 0;",
    "const int steps = nsteps > kp ? (nsteps - kp + ks - 1) / ks : 0;",
    "for (int st = 0; st < steps; ++st) {",
    "const int base = (st * ks + kp) * kStepK;",
    "const int col = base + 16 * t + 64 * u;",
    "for (int h = 0; h < 2; ++h) a[u][h] = col < IN ? ld_codes(qr[h] + col) : zero;",
    "if (base + 64 * u >= IN) break;",
    "const bool in = col < IN;",
    "const uint4 xw = xv && in ? __ldg(reinterpret_cast<const uint4*>(xr + col) + xi) : zero;",
    "s8x4_to_bf16x2(word(a[u][0], 2 * xi + hw), af[0], af[2]);",
    "s8x4_to_bf16x2(word(a[u][1], 2 * xi + hw), af[1], af[3]);",
    "mma_bf16(cr, af, word(xw, 2 * hw), word(xw, 2 * hw + 1));",
    "for (int n0 = 0; n0 < cnt; n0 += 8) {",
    "const bool xv = n0 + g < cnt;",
    "x + static_cast<size_t>(c0 + (xv ? nth_bit(rows, n0 + g) : 0)) * IN;",
    "const int nb = rt * kWarpCh, o_blk = blockIdx.x * nb;",
    "red[(warp * kWarpCh + g + 8 * (i >> 1)) * 8 + 2 * t + (i & 1)] = c[i];",
    "const int cols = min(8, cnt - n0);",
    "for (int e = threadIdx.x; e < nb * cols; e += blockDim.x) {",
    "const int col = e / nb, i = e % nb, o = o_blk + i;",
    "v += red[((p * rt + i / kWarpCh) * kWarpCh + i % kWarpCh) * 8 + col];",
    "if (o < OUT) y[static_cast<size_t>(row_of[n0 + col]) * OUT + o] = v;",
    "if (blockIdx.y % kChunkRows == 0) {",
    "if (o_blk + i < OUT) yr[o_blk + i] = 0.f;",
    "const dim3 grid((tiles + rt - 1) / rt, M);",
)


def _part_steps(kp, ks, IN):
    """The steps of K part kp (the kernel's formulas): kp, kp + ks, ..."""
    nsteps = -(-IN // STEP_K)
    steps = (nsteps - kp + ks - 1) // ks if nsteps > kp else 0
    return [st * ks + kp for st in range(steps)]


def _members(idx, E, slot):
    expert, rows, invalid = _slot_group(idx, E, slot)
    c0 = slot // CHUNK * CHUNK
    return expert, [c0 + _nth_bit(rows, n) for n in range(bin(rows).count("1"))], invalid


def _walk(p, idx, E, OUT, IN):
    """The kernel's work by its formulas: (how many threads read each (row,
    channel, 16-column chunk) of the routed weights, how many writes reach
    each y element)."""
    M = len(idx)
    cover = np.zeros((M, OUT, IN // 16), np.int32)
    writes = np.zeros((M, OUT), np.int32)
    g, t = np.arange(8), np.arange(4)
    nb = p.rt * WARP_CH
    for slot in range(M):
        expert, members, invalid = _members(idx, E, slot)
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
            for n0 in range(0, len(members), 8):  # passes of 8 B columns
                part = members[n0:n0 + 8]
                for warp in range(p.rt * p.ks):
                    tile, kp = bx * p.rt + warp % p.rt, warp // p.rt
                    o0 = tile * WARP_CH
                    if o0 >= OUT:
                        continue
                    ch = np.concatenate([o0 + g, o0 + g + 8])
                    ch = ch[ch < OUT]  # rows past OUT are read and never written
                    for step in _part_steps(kp, p.ks, IN):
                        base = step * STEP_K
                        for u in range(RUNS):
                            if base + 64 * u >= IN:
                                break
                            col = base + 16 * t + 64 * u
                            col = col[col < IN]
                            cover[np.ix_(part, ch, col // 16)] += 1
                for row in part:  # the block's sums
                    writes[row, chans] += 1
    return cover, writes


def _routed(idx, E):
    return np.array([0 <= e < E for e in idx])


@pytest.mark.parametrize("M,kind", [(1, "distinct"), (6, "distinct"), (12, "shared"),
                                    (12, "repeated"), (20, "one"), (20, "invalid")])
@pytest.mark.parametrize("name,OUT,IN,n", k6_study.SHAPES)
def test_plan_covers_the_step_shapes_once(name, OUT, IN, n, M, kind):
    for line in WALK_LINES:
        assert line in SOURCE, line
    E = 64
    idx = k6_study.route(kind, M, E, torch.randperm(E, generator=torch.Generator()
                                                    .manual_seed(M))).numpy()
    p = k6.plan(OUT, IN, M, SMS)
    assert p.rt * p.ks <= k6.MAX_WARPS and p.unit == STEP_K
    if M == 6:  # enough blocks to fill the SMs at a B = 1 step
        assert p.blocks(OUT) * M >= 2 * SMS
    cover, writes = _walk(p, idx, E, OUT, IN)
    routed = _routed(idx, E)
    assert (cover[routed] == 1).all() and (cover[~routed] == 0).all()
    assert (writes == 1).all()


@pytest.mark.parametrize("M", [1, 6, 12, 20])
@pytest.mark.parametrize("OUT,IN,sms", [(64, 256, SMS), (96, 1024, SMS), (1000, 512, 16),
                                        (48, 400, 4), (32, 336, SMS), (16, 1040, SMS)])
def test_plan_covers_other_shapes_once(OUT, IN, sms, M):
    """A ragged last tile (OUT 1000, 48), INs that no step divides (400, 336:
    the last step part in, 336's last run half in; 1040: a last step of one
    run of 16 codes on the fourth K part)."""
    E = 16
    idx = k6_study.route("repeated" if M > 1 else "distinct", M, E, torch.arange(E)).numpy()
    p = k6.plan(OUT, IN, M, sms)
    assert p.rt * p.ks <= k6.MAX_WARPS
    cover, writes = _walk(p, idx, E, OUT, IN)
    assert (cover == 1).all() and (writes == 1).all()


@pytest.mark.parametrize("ks,IN", [(1, 4096), (2, 2048), (4, 4096), (8, 4096), (4, 400),
                                   (8, 256), (3, 1040)])
def test_k_parts_take_every_step_once(ks, IN):
    """The K parts of a tile take the row's steps in turn: together every
    step once, each part its steps in order, and a part with none (ks past
    the steps) does no work."""
    parts = [_part_steps(kp, ks, IN) for kp in range(ks)]
    assert sorted(s for steps in parts for s in steps) == list(range(-(-IN // STEP_K)))
    for kp, steps in enumerate(parts):
        assert steps == list(range(kp, -(-IN // STEP_K), ks))


def test_mma_steps_pair_a_and_b_on_the_same_columns():
    """Thread (g, t), run u, x unit xi, half hw: A's k-slots {2t, 2t+1} are
    codes 4wi + {0, 1} of the run's word wi = 2xi + hw, {2t+8, 2t+9} codes
    4wi + {2, 3}; B's registers are words 2hw and 2hw + 1 of x's uint4 xi at
    the run's column (values 8xi + 4hw + {0, 1}, {2, 3}). Over the 4 lanes
    t, the 4 mma steps of run u take each of the 64 columns [64u, 64u + 64)
    of the step once."""
    for u in range(RUNS):
        seen = []
        for xi in range(2):
            for hw in range(2):
                wi = 2 * xi + hw
                a_cols, b_cols = [], []
                for t in range(4):
                    col = 16 * t + 64 * u
                    a_cols += [(2 * t, [col + 4 * wi, col + 4 * wi + 1]),
                               (2 * t + 8, [col + 4 * wi + 2, col + 4 * wi + 3])]
                    for w, kslot in ((2 * hw, 2 * t), (2 * hw + 1, 2 * t + 8)):
                        b_cols.append((kslot, [col + 8 * xi + 2 * w, col + 8 * xi + 2 * w + 1]))
                assert sorted(a_cols) == sorted(b_cols)
                seen += [c for _, cs in a_cols for c in cs]
        assert sorted(seen) == list(range(64 * u, 64 * u + 64))


# ── the convert ──────────────────────────────────────────────────────────


def _prmt(a, b, sel):
    """prmt.b32 with a default-mode selector: result byte i is byte
    (sel >> 4i) & 7 of the 8 bytes {b, a} (a the low 4)."""
    pool = [(a >> (8 * k)) & 0xFF for k in range(4)] + [(b >> (8 * k)) & 0xFF for k in range(4)]
    return sum(pool[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _bf16(bits):
    return np.array([bits << 16], np.uint32).view(np.float32)[0]


def _sub_bf16x2(a, b):
    """sub.rn.bf16x2 where the difference is exact (a small integer)."""
    out = 0
    for half in range(2):
        d = np.float32(_bf16((a >> 16 * half) & 0xFFFF)) - np.float32(_bf16((b >> 16 * half) & 0xFFFF))
        bits = int(np.array([d], np.float32).view(np.uint32)[0])
        assert bits & 0xFFFF == 0  # exact in bf16
        out |= (bits >> 16) << (16 * half)
    return out


def test_convert_is_exact_for_every_int8_value():
    body = SOURCE[SOURCE.index("__device__ __forceinline__ void s8x4_to_bf16x2("):]
    body = body[:body.index("\n}\n")]
    consts = re.findall(r"prmt\(w, (0x[0-9A-F]+)u, (0x[0-9A-F]+)u\)", body)
    masks = re.findall(r"sub_bf16x2\(lo & (0x[0-9A-F]+)u, lo & (0x[0-9A-F]+)u\)", body)
    assert len(consts) == 2 and len(masks) == 1
    (hi_const, sel01), (_, sel23) = [(int(c, 16), int(s, 16)) for c, s in consts]
    keep, sign = (int(m, 16) for m in masks[0])
    assert "p23 = sub_bf16x2(hi & 0xFF7FFF7Fu, hi & 0xFF80FF80u);" in body
    assert 'asm("sub.rn.bf16x2 %0, %1, %2;\\n"' in SOURCE
    for v in range(256):
        code = v - 256 if v > 127 else v
        for pos in range(4):
            w = (v << (8 * pos)) | (0x5A << (8 * ((pos + 1) % 4)))  # a neighbour byte
            pairs = []
            for sel in (sel01, sel23):
                word = _prmt(w, hi_const, sel)
                r = _sub_bf16x2(word & keep, word & sign)
                pairs += [_bf16(r & 0xFFFF), _bf16(r >> 16)]
            assert pairs[pos] == code, (v, pos)


# ── the fixed-order sums against the JAX package ─────────────────────────


def _emulate(x, q, idx, p):
    """The kernel's sums in plain torch: a warp's run (its 4 lanes' 16
    columns, 64 in a row) as one f32 product added to the warp's sums in
    order, its steps kp, kp + ks, ... in order, a block's K parts added in
    order; rows of invalid ids 0."""
    E, OUT, IN = q.shape
    xb = x.to(torch.bfloat16).float()
    y = torch.zeros((x.shape[0], OUT))
    for slot in range(x.shape[0]):
        expert, members, _ = _members(idx.numpy(), E, slot)
        if expert < 0:
            continue
        w = q[expert].float()
        for bx in range(p.blocks(OUT)):
            o = torch.arange(bx * p.rt * WARP_CH, (bx + 1) * p.rt * WARP_CH).clamp(max=OUT - 1)
            total = None
            for kp in range(p.ks):
                acc = torch.zeros((len(members), p.rt * WARP_CH))
                for step in _part_steps(kp, p.ks, IN):
                    for u in range(RUNS):
                        run = step * STEP_K + 64 * u
                        cols = [c for t in range(4) for c in range(run + 16 * t, run + 16 * t + 16)
                                if c < IN]
                        if cols:
                            acc = acc + xb[members][:, cols] @ w[o][:, cols].T
                total = acc if total is None else total + acc
            lo, hi = bx * p.rt * WARP_CH, min(OUT, (bx + 1) * p.rt * WARP_CH)
            y[members, lo:hi] = total[:, : hi - lo]
    return y


def _row_share(got, ref):
    err = np.abs(got - ref).max(axis=1)
    lim = RTOL * np.abs(ref).max(axis=1)
    return float((err / lim).max())


@pytest.mark.parametrize("E,OUT,IN,M", [(4, 64, 256, 6), (4, 256, 512, 12), (2, 32, 256, 3),
                                        (8, 64, 1024, 20)])
def test_emulated_sums_match_pallas(E, OUT, IN, M):
    rng = np.random.default_rng(E + OUT + IN + M)
    q = rng.integers(-127, 128, (E, OUT, IN)).astype(np.int8)
    x = rng.standard_normal((M, IN)).astype(np.float32)
    idx = rng.integers(0, E, M).astype(np.int32)
    idx[M - 1] = idx[0]  # a repeated expert
    ref = np.asarray(pfp4.moe_int8_gemv(jnp.asarray(x), jnp.asarray(q), jnp.asarray(idx),
                                        interpret=True))
    p = k6.plan(OUT, IN, M, SMS)
    got = _emulate(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(idx), p)
    assert _row_share(got.numpy(), ref) <= 1.0
    before = k6.launches
    plain = k6.moe_int8_gemv(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(idx))
    assert k6.launches == before  # a CPU tensor takes the plain version
    assert _row_share(plain.numpy(), ref) <= 1.0


def test_emulated_sums_split_k_match_the_plain_version():
    """A plan of 4 K parts and 2 tiles a block (three blocks at OUT 88, the
    last tile ragged), one expert for 10 rows (two passes), repeated experts
    across two chunks of rows and invalid ids, against the plain version."""
    rng = np.random.default_rng(5)
    E, OUT, IN, M = 6, 88, 1024, 20
    q = torch.from_numpy(rng.integers(-127, 128, (E, OUT, IN)).astype(np.int8))
    x = torch.from_numpy(rng.standard_normal((M, IN)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, E + 1, M).astype(np.int32))
    idx[2:12] = 3
    p = k6.Plan(2, 4, STEP_K)
    assert p.blocks(OUT) == 3
    want = k6.moe_int8_gemv_plain(x, q, idx).numpy()
    got = _emulate(x, q, idx, p).numpy()
    zero = (want == 0).all(axis=1)
    assert zero.any() and (got[zero] == 0).all()
    assert _row_share(got[~zero], want[~zero]) <= 1.0


def test_plain_version_zeroes_rows_of_invalid_ids():
    rng = np.random.default_rng(3)
    E, OUT, IN = 3, 32, 256
    q = torch.from_numpy(rng.integers(-127, 128, (E, OUT, IN)).astype(np.int8))
    x = torch.from_numpy(rng.standard_normal((5, IN)).astype(np.float32))
    idx = torch.tensor([1, -1, 3, 0, 1], dtype=torch.int32)
    y = k6.moe_int8_gemv(x, q, idx)
    assert (y[[1, 2]] == 0).all() and (y[[0, 3, 4]] != 0).any(dim=1).all()
    xb = x.to(torch.bfloat16).double()
    for m, e in ((0, 1), (3, 0), (4, 1)):
        want = (q[e].double() @ xb[m]).numpy()
        assert np.abs(y[m].numpy() - want).max() <= RTOL * np.abs(want).max()


# ── the study ────────────────────────────────────────────────────────────


def test_study_cpu_mode(capsys):
    assert k6_study.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert '"w1 M=6 distinct": {"rt": 2, "ks": 4, "unit": 128, "blocks": 384' in out
    assert '"w1 M=1 distinct": {"rt": 1, "ks": 8, "unit": 128, "blocks": 128' in out
    # the step's bound: 16 w1 / w3 and 8 w2 launches of 6 distinct experts
    per = k6_study.bytes_moved(6, 6, 2048, 4096) / k6_study.READ_CEILING * 1e6
    assert abs(k6_study.step_bound_ms() * 1e3 - 24 * per) < 0.5
    assert abs(per - 16.15) < 0.01
    assert abs(k6_study.bytes_moved(1, 1, 2048, 4096) / k6_study.READ_CEILING * 1e6 - 2.69) < 0.01


def test_study_variants_and_mutants_apply_to_the_source():
    """Every substitution of the current design's variants and of the
    planted faults finds its text in csrc/int8_gemv.cu once; the runs
    variants change the step the study plans with."""
    variants = k6_study.variant_sources()
    assert set(variants) == set(k6_study.CURRENT)
    mutants = k6_study.variant_sources(mutants=True)
    assert len(mutants) == 4
    for text, _ in list(variants.values()) + list(mutants.values()):
        assert 'extern "C" int int8_gemv(' in text and not k6_study.is_parent(text)
    assert k6_study.step_k(variants["runs-1"][0]) == 64
    assert k6_study.step_k(variants["runs-4"][0]) == 256
    assert k6_study.variant_plan(256, 2048, 4096, 6, SMS).unit == 256
    assert "const int base = (s0 + st) * kStepK;" in variants["contiguous-parts"][0]


def test_check_cases_cover_the_card_cases():
    cases = k6_study.check_cases()
    assert {(c[1], c[2]) for c in cases} == {(2048, 4096), (4096, 2048), (1000, 400)}
    assert {c[3] for c in cases} == {1, 2, 6, 12, 16, 20, 40}
    assert {c[4] for c in cases} == {"distinct", "repeated", "shared", "invalid", "one"}
    for M, kind in ((6, "distinct"), (12, "shared"), (12, "repeated"), (20, "invalid"),
                    (20, "one")):
        idx = k6_study.route(kind, M, 64, torch.arange(64)).numpy()
        valid = idx[(idx >= 0) & (idx < 64)]
        assert len(idx) == M and len(set(valid.tolist())) == k6_study.distinct(kind, M)

