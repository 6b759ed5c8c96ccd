"""K9 (``csrc/fp4_chain.cu``, the fused packed-fp4 decode chain) on the CPU:
its row grouping, its work split and its fragments, emulated in numpy and
torch from the source's own constants and index formulas, and the CPU
wrapper against the JAX package.

- The grouping (a thread a row: the row's column among its expert's rows,
  the expert's place among the first rows in order) gives the distinct
  valid experts in order of first appearance, each with its rows in order,
  a second n8 column past 8 rows, and no place to an invalid id.
- The work split (blocks over work items by grid stride, warps over the
  128-wide steps of the contraction by ``kb % kWarps``) covers each
  (item, step) once and each (expert, channel) once, in both phases.
- The kernel's whole function, emulated fragment by fragment (the decode
  of ``csrc/common.cuh``, a thread's run of 32 codes, the A registers of
  its 8 k16 steps, the B registers from x or act by the source's formulas,
  with perm13 act's halves paired by the source's byte-permute selectors),
  gives ``moe_fp4_chain_plain`` row by row, and a pairing with the halves
  swapped does not.
- The CPU wrapper (the plain version) agrees with the JAX package at the
  row sets of the card tests: with the JAX package's reference of the
  chain, three ``moe_fp4_gemv`` calls in interpret mode and the SwiGLU
  (tests/test_pallas_kernels.py), and at 4 rows of repeated experts with
  the Pallas chain kernel itself in interpret mode; rows of invalid ids
  are 0.
Tiny sizes: E 8, I 256, D 512.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.ops.pallas import fp4_gemm as pfp4
from pegainfer_tpu_torch.ops.cuda import fp4_chain as k9
from pegainfer_tpu_torch.ops.moe import swiglu
from pegainfer_tpu_torch.utils.weights import numpy_to_torch
from tests.test_torch_fp4_grouped_plan import _consts, _decode_word, _prmt, _scaled

SOURCE = Path(k9.__file__).resolve().parents[2] / "csrc" / "fp4_chain.cu"
E, I, D, LIMIT = 8, 256, 512, 7.0
ROW_RTOL = 1e-3  # chip_smoke.CHAIN_ROW_RTOL


def _int_consts():
    """The source's ``constexpr int`` constants by name."""
    found = re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE.read_text())
    return {n: int(v) for n, v in found}


def _perm13_selectors():
    """The prmt selectors that pair act's halves into phase 2's B registers
    (b[2s] and b[2s + 1])."""
    text = SOURCE.read_text()
    sel = [re.search(rf"b\[{r}\] = prmt\(word\(l, i\), word\(h, i\), (0x[0-9a-fA-F]+)u\);",
                     text).group(1) for r in (r"2 \* s", r"2 \* s \+ 1")]
    return [int(s, 16) for s in sel]


# ── the grouping ─────────────────────────────────────────────────────────


def _groups(ids, n_experts, max_rows):
    """The kernel's grouping, a thread a row, as its source computes it.
    Returns (experts, rows of each)."""
    M = len(ids)
    valid = [0 <= e < n_experts for e in ids]
    col = [sum(1 for k in range(m) if ids[k] == ids[m]) for m in range(M)]
    first = [valid[m] and col[m] == 0 for m in range(M)]
    experts = [None] * max_rows
    rows = [[None] * max_rows for _ in range(max_rows)]
    for m in range(M):
        if not valid[m]:
            continue
        j, cnt, j_first = 0, 0, 0
        for k in range(max_rows):
            if k < M and ids[k] == ids[m]:
                if cnt == 0:
                    j_first = j
                cnt += 1
            if k < M:
                j += first[k]
        rows[j_first][col[m]] = m
        if col[m] == 0:
            experts[j_first] = (ids[m], cnt)
    n = sum(first)
    return experts[:n], [r[: experts[j][1]] for j, r in enumerate(rows[:n])]


@pytest.mark.parametrize("ids", [
    [3], [5, 1, 7, 0, 2, 6], [4, 2, 6, 4, 2, 6, 1, 3, 1, 5, 0, 7],
    [6] * 16, [0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2, 3, 4, 5, 6, 7],
    [2, -1, 5, 8, 2, 13, -7, 5, 0],
], ids=["M1", "M6-distinct", "M12-repeat", "M16-one-expert", "M16-twice-each", "invalid"])
def test_grouping_orders_experts_by_first_row(ids):
    c = _int_consts()
    experts, rows = _groups(ids, E, c["kMaxRows"])
    valid = [e for e in ids if 0 <= e < E]
    assert [e for e, _ in experts] == list(dict.fromkeys(valid))
    for (e, cnt), r in zip(experts, rows):
        assert r == [m for m, i in enumerate(ids) if i == e] and cnt == len(r)
        # the rows are the B columns: n8 column tile col // 8, a second past 8
        assert max(col // 8 for col in range(cnt)) == (cnt > 8)
    assert sorted(m for r in rows for m in r) == [m for m, e in enumerate(ids) if 0 <= e < E]


# ── the work split ───────────────────────────────────────────────────────


@pytest.mark.parametrize("phase2", [False, True], ids=["phase1", "phase2"])
@pytest.mark.parametrize("n_experts,grid", [(1, 3), (6, 5), (12, 264)])
def test_work_split_covers_each_item_and_step_once(phase2, n_experts, grid):
    c = _int_consts()
    warps, ch, kk = c["kWarps"], c["kCh"], c["kK"]
    item_ch = 2 * ch if phase2 else ch
    OUT, K = (4096, 2048) if phase2 else (2048, 4096)
    tiles, KB = OUT // item_ch, K // kk
    n_items = n_experts * tiles
    seen = np.zeros((n_items, KB), np.int64)
    for b in range(grid):
        mine = (n_items - 1 - b) // grid + 1 if b < n_items else 0
        for warp in range(warps):
            nk = (KB - 1 - warp) // warps + 1 if warp < KB else 0
            for f in range(mine * nk):  # the warp's sequence, as load_step walks it
                w, kb = b + (f // nk) * grid, warp + (f % nk) * warps
                seen[w, kb] += 1
    assert (seen == 1).all()
    channels = sorted((w // tiles, (w % tiles) * item_ch + o) for w in range(n_items)
                      for o in range(item_ch))
    assert channels == [(e, o) for e in range(n_experts) for o in range(OUT)]


# ── the whole function, fragment by fragment ─────────────────────────────


def _stack(gen, out_d, in_d, group, pow2=True):
    """Codes over all byte values and bf16 scales around 1 / (2.93
    sqrt(in_d)): powers of two, or with random mantissas."""
    q = torch.randint(0, 256, (E, out_d, in_d // 2), dtype=torch.uint8, generator=gen)
    e = torch.randint(-1, 2, (E, out_d, in_d // group), generator=gen).float()
    s = torch.exp2(e - round(float(np.log2(2.93 * in_d ** 0.5))))
    if not pow2:
        s = s * (1 + torch.rand(s.shape, generator=gen))
    return {"q": q, "s": s.to(torch.bfloat16)}


def _a_slots(q, s, group, kk):
    """A of one weight matrix ([OUT, K/2] codes, [OUT, K/group] scales) as
    the kernel holds it: [OUT, K / kK steps, 4 threads t, 8 k16 steps, 4
    slots] f64. Thread t's run is bytes kb·kK/2 + 16t .. + 15 under the
    scale of code kb·kK + 32t; word wi's byte j decodes to a bf16 pair,
    byte 2s (low, high code) in k-slots {2t, 2t+1} and byte 2s + 1 in
    {2t+8, 2t+9} of step s."""
    c = _consts()
    out_d, KB = q.shape[0], 2 * q.shape[1] // kk
    words = q.numpy().reshape(out_d, KB, 4, 4, 4).view("<u4")[..., 0]  # [OUT, KB, t, wi]
    cols = (np.arange(KB)[:, None] * kk + 32 * np.arange(4)[None]) // group
    scale = s.float()[:, torch.from_numpy(cols)]  # [OUT, KB, t]
    pairs = _decode_word(words, c)  # [j, OUT, KB, t, wi]
    vals = _scaled(pairs, scale[None, :, :, :, None])  # [j, OUT, KB, t, wi, 2] bf16
    # byte 4wi + j is byte 2s + (j % 2) of step s = 2wi + j // 2
    return vals.permute(1, 2, 3, 4, 0, 5).reshape(out_d, KB, 4, 8, 4).double()


def _halves(words):
    """uint32 words -> their bf16 halves, low first: [..., 2] f64."""
    w = np.asarray(words, np.uint32)
    h = np.stack([w & np.uint32(0xFFFF), w >> np.uint32(16)], -1).astype(np.uint32)
    return torch.from_numpy((h << np.uint32(16)).view(np.float32)).double()


def _b_slots(v, kk, perm13=False, selectors=None):
    """B of rows v ([rows, K] bf16) for each step and thread as the source
    loads it: [rows, K / kK, 4 threads, 8 k16 steps, 4 slots] f64. Natural:
    the 32 values at kb·kK + 32t as 16 words, b[2s] and b[2s + 1]; perm13:
    the 16 values at kb·kK/2 + 16t (lo) and at K/2 beyond (hi), word i of
    each, b[2s] = prmt(lo[s], hi[s], sel0), b[2s + 1] = prmt(lo[s], hi[s],
    sel1)."""
    rows, K = v.shape
    KB = K // kk
    bits = v.contiguous().view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    if not perm13:
        run = bits.reshape(rows, KB, 4, 16, 2)  # k0 + 32t + 2q + e
        words = run[..., 0] | (run[..., 1] << np.uint32(16))  # [rows, KB, t, 16]
    else:
        lo = bits[:, : K // 2].reshape(rows, KB, 4, 8, 2)
        hi = bits[:, K // 2:].reshape(rows, KB, 4, 8, 2)
        lw = lo[..., 0] | (lo[..., 1] << np.uint32(16))
        hw = hi[..., 0] | (hi[..., 1] << np.uint32(16))
        words = np.stack([_prmt(lw, hw, selectors[0]), _prmt(lw, hw, selectors[1])], -1)
        words = words.reshape(rows, KB, 4, 16)
    return _halves(words.reshape(rows, KB, 4, 8, 2)).reshape(rows, KB, 4, 8, 4)


def _emulate(x, w1, w3, w2, idx, limit, perm13, group, selectors=None):
    """The kernel's function from its fragments: phase 1 per distinct
    expert (A of w1 / w3 against the B of x), the clamped SwiGLU, act in
    bf16 at each row's place; phase 2 (A of w2 against the B of act)."""
    c = _int_consts()
    kk = c["kK"]
    selectors = selectors or _perm13_selectors()
    M = x.shape[0]
    experts, rows = _groups(idx.tolist(), E, c["kMaxRows"])
    xb = x.to(torch.bfloat16)
    act = torch.zeros((M, I), dtype=torch.bfloat16)
    y = torch.zeros((M, D), dtype=torch.float64)
    for (e, _), r in zip(experts, rows):
        bx = _b_slots(xb[r], kk)
        g = torch.einsum("okts,nkts->no", _a_slots(w1["q"][e], w1["s"][e], group, kk).flatten(3),
                         bx.flatten(3))
        u = torch.einsum("okts,nkts->no", _a_slots(w3["q"][e], w3["s"][e], group, kk).flatten(3),
                         bx.flatten(3))
        act[r] = swiglu(g.float(), u.float(), limit).to(torch.bfloat16)
    for (e, _), r in zip(experts, rows):
        ba = _b_slots(act[r], kk, perm13, selectors)
        y[r] = torch.einsum("okts,nkts->no", _a_slots(w2["q"][e], w2["s"][e], group, kk).flatten(3),
                            ba.flatten(3))
    return y.float()


def _row_share(y, ref):
    d = (y - ref).abs().amax(dim=1)
    lim = ROW_RTOL * ref.abs().amax(dim=1)
    return torch.where(d > 0, d / lim, torch.zeros_like(d)).max().item()


EMULATED = [  # (ids, group, pow2, limit, perm13)
    ([5, 1, 7, 0, 2, 6], 32, True, LIMIT, False),
    ([5, 1, 7, 0, 2, 6], 32, True, LIMIT, True),
    ([4] * 16, 32, True, LIMIT, True),  # two n8 columns of one expert
    ([2, -1, 5, 8, 2, 0], 64, False, 0.0, True),  # invalid ids, g 64, bf16 scales, no clamp
    ([3, 6, 3, 1, 6, 3, 0, 7, 1], 64, True, LIMIT, False),
]


@pytest.mark.parametrize("ids,group,pow2,limit,perm13", EMULATED)
def test_emulated_kernel_gives_the_plain_chain(ids, group, pow2, limit, perm13):
    gen = torch.Generator().manual_seed(len(ids) + group)
    w1, w3, w2 = _stack(gen, I, D, group, pow2), _stack(gen, I, D, group, pow2), _stack(
        gen, D, I, group, pow2)
    if perm13:
        w1, w3 = k9.permute_w13(w1), k9.permute_w13(w3)
    x = torch.randn((len(ids), D), generator=gen)
    idx = torch.tensor(ids, dtype=torch.int32)
    ref = k9.moe_fp4_chain_plain(x, w1, w3, w2, idx, limit, perm13)
    # exact products summed in another order; act may move by one bf16 ulp
    assert _row_share(_emulate(x, w1, w3, w2, idx, limit, perm13, group), ref) <= 1.0
    if perm13:  # act's halves swapped in the B registers: plausible, and wrong
        sel = _perm13_selectors()
        swapped = [((s & 0xFF) << 8) | (s >> 8) for s in sel]  # hi half first
        bad = _emulate(x, w1, w3, w2, idx, limit, perm13, group, swapped)
        assert _row_share(bad, ref) > 100


# ── the CPU wrapper against the JAX package ──────────────────────────────


def _jax_reference(x, j1, j3, j2, idx, limit):
    """The JAX package's reference of the chain (tests/test_pallas_kernels.py):
    three moe_fp4_gemv calls in interpret mode and the SwiGLU between."""
    def gemv(rows, w):
        return pfp4.moe_fp4_gemv(rows, w["q"], w["s"], jnp.asarray(idx), interpret=True)

    g, u = gemv(jnp.asarray(x), j1), gemv(jnp.asarray(x), j3)
    if limit > 0:
        g, u = jnp.minimum(g, limit), jnp.clip(u, -limit, limit)
    return np.asarray(gemv(jax.nn.sigmoid(g) * g * u, j2))


def _containers(rng, group, pow2):
    """One set of w1, w3, w2 as JAX containers and the port's."""
    def one(out_d, in_d):
        q = rng.integers(0, 256, (E, out_d, in_d // 2), dtype=np.uint8)
        s = np.exp2(rng.integers(-1, 2, (E, out_d, in_d // group)) - 6).astype(np.float32)
        if not pow2:
            s = s * (1 + rng.random(s.shape, dtype=np.float32))
        js = jnp.asarray(s, jnp.bfloat16)
        return {"q": jnp.asarray(q), "s": js}, {"q": torch.from_numpy(q),
                                                 "s": numpy_to_torch(np.asarray(js))}

    return zip(*(one(I, D), one(I, D), one(D, I)))


CARD_ROWS = [  # (ids, group, pow2, limit): the card tests' row sets, at E 8
    ([3], 32, True, LIMIT),
    ([5, 1, 7, 0, 2, 6], 32, True, LIMIT),
    ([4, 2, 6, 1, 3, 0, 4, 2, 6, 1, 3, 0], 32, True, LIMIT),
    ([0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2, 3, 4, 5, 6, 7], 32, True, LIMIT),
    ([6] * 16, 32, True, LIMIT),
    ([5, 1, 7, 0, 2, 6], 32, True, 0.0),
    ([5, 1, 7, 5, 1, 7], 64, True, LIMIT),
    ([5, 1, 7, 0, 2, 6], 32, False, LIMIT),
]


@functools.lru_cache(maxsize=None)
def _card_case(case):
    """Inputs of one row set of CARD_ROWS and the JAX reference, shared by
    both perm13 forms."""
    ids, group, pow2, limit = CARD_ROWS[case]
    rng = np.random.default_rng(len(ids) + group + int(pow2))
    (j1, j3, j2), ws = _containers(rng, group, pow2)
    x = rng.standard_normal((len(ids), D)).astype(np.float32)
    idx = np.asarray(ids, np.int32)
    return x, idx, ws, _jax_reference(x, j1, j3, j2, idx, limit)  # perm13 permutes I only


@pytest.mark.parametrize("perm13", [False, True])
@pytest.mark.parametrize("case", range(len(CARD_ROWS)))
def test_cpu_wrapper_matches_jax_reference(perm13, case):
    x, idx, (t1, t3, t2), ref = _card_case(case)
    if perm13:
        t1, t3 = k9.permute_w13(t1), k9.permute_w13(t3)
    before = k9.launches
    out = k9.moe_fp4_chain(torch.from_numpy(x), t1, t3, t2, torch.from_numpy(idx),
                           CARD_ROWS[case][3], perm13=perm13)
    assert k9.launches == before
    assert _row_share(out, torch.from_numpy(ref.copy())) <= 1.0


def test_cpu_wrapper_matches_pallas_chain_and_zeroes_invalid_rows():
    """The Pallas chain kernel itself at 4 rows of repeated experts, perm13."""
    rng = np.random.default_rng(12)
    (j1, j3, j2), (t1, t3, t2) = _containers(rng, 32, True)
    ids = [4, 2, 4, 2]
    x = rng.standard_normal((len(ids), D)).astype(np.float32)
    idx = np.asarray(ids, np.int32)
    perm = pfp4.perm13_rows(I)
    p1, p3 = ({"q": j["q"][:, perm], "s": j["s"][:, perm]} for j in (j1, j3))
    ref = np.asarray(pfp4.moe_fp4_chain(
        jnp.asarray(x), p1["q"], p1["s"], p3["q"], p3["s"], j2["q"], j2["s"],
        jnp.asarray(idx), limit=LIMIT, interpret=True, perm13=True))
    t1, t3 = k9.permute_w13(t1), k9.permute_w13(t3)
    xt = torch.from_numpy(x)
    out = k9.moe_fp4_chain(xt, t1, t3, t2, torch.from_numpy(idx), LIMIT, perm13=True)
    assert _row_share(out, torch.from_numpy(ref.copy())) <= 1.0
    # ids outside [0, E): those rows are 0, the others as before
    bad = torch.tensor([4, -1, E, 2], dtype=torch.int32)
    out_bad = k9.moe_fp4_chain(xt, t1, t3, t2, bad, LIMIT, perm13=True)
    ok = (bad >= 0) & (bad < E)
    assert not bool(out_bad[~ok].any())
    assert torch.equal(out_bad[ok], out[ok])
