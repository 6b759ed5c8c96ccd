"""K5 (``csrc/fp4_grouped.cu``) on the CPU: its launch plan, its decode and
its fragment mapping, emulated in numpy and torch.

- The plan that K5 shares with K7 (``fp4_grouped.plan``), walked in torch
  as the kernel walks it, gives ``moe_fp4_grouped_plain`` on the routings of
  ``test_torch_int8_grouped_plan.py``, writing each (row, output tile) once.
- The kernel's decode (byte permutes with the constants and selectors read
  from ``csrc/common.cuh``, then one bf16 multiply by the group's scale)
  gives the same bits as ``quant.dequant_any`` for every code byte, at
  power-of-two and at arbitrary bf16 scales.
- Its fragment mapping (a thread's 8 code bytes to the A registers of four
  k16 steps, x's B fragment from the same physical k) gives the contraction
  of ``quant.unpack_fp4`` x ``s`` in natural k order, at groups 16, 32 and
  64 (an odd number of groups a row).
- The wrapper on CPU tensors takes the plain version whatever plan it is
  given, and agrees with the JAX kernel in interpret mode.
Tiny sizes: E <= 16, IN <= 256.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.ops.pallas import fp4_gemm as pfp4
from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
from pegainfer_tpu_torch.utils.weights import numpy_to_torch
from tests.test_torch_int8_grouped_plan import CASES, E, _case

OUT, IN = 192, 128  # OUT: one whole output tile and a half one
# the decode K5 shares with K9
SOURCE = Path(k5.__file__).resolve().parents[2] / "csrc" / "common.cuh"


def _stack(gen, E, out_dim, in_dim, group=32, pow2=True):
    """Random codes over all 256 byte values and bf16 scales around 1/16:
    powers of two (the checkpoint's) or with random mantissas."""
    q = torch.randint(0, 256, (E, out_dim, in_dim // 2), dtype=torch.uint8, generator=gen)
    e = torch.randint(-6, -2, (E, out_dim, in_dim // group), generator=gen).float()
    mant = 1.0 if pow2 else 1.0 + torch.rand(e.shape, generator=gen)
    return q, (torch.exp2(e) * mant).to(torch.bfloat16)


def _walk(x, q, s, p):
    """The kernel's work in torch: for each live item and output tile, the
    owned rows get (x[r] if the row is the item's expert's, else 0) @ the
    decoded weights. Returns (y, writes per (row, output tile))."""
    Mp = x.shape[0]
    n_ot = -(-OUT // k5.OUT_TILE)
    y = torch.full((Mp, OUT), float("nan"))
    writes = torch.zeros((Mp, n_ot), dtype=torch.long)
    xb = x.to(torch.bfloat16).float()
    for e, lo, hi in p.items[: int(p.n_items[0])].tolist():
        rows = torch.arange(lo, hi)
        load, own = p.row_e[rows] == e, p.owner[rows] == e
        xr = torch.where(load[:, None], xb[rows], torch.zeros(()))
        w = quant.dequant_any({"q": q[e], "s": s[e]}, torch.bfloat16).float()
        for ot in range(n_ot):
            o = slice(ot * k5.OUT_TILE, min(OUT, (ot + 1) * k5.OUT_TILE))
            y[rows[own], o] = (xr @ w[o].T)[own]
            writes[rows[own], ot] += 1
    return y, writes


@pytest.mark.parametrize("name", CASES)
def test_plan_walk_reproduces_fp4_plain(name):
    seg, tm = _case(name)
    Mp = seg[0].numel()
    gen = torch.Generator().manual_seed(11 * Mp)
    x = torch.randn((Mp, IN), generator=gen)
    q, s = _stack(gen, E, OUT, IN)
    y, writes = _walk(x, q, s, k5.plan(*seg, tm, E))
    assert bool((writes == 1).all())
    ref = k5.moe_fp4_grouped_plain(x, q, s, *seg, tm=tm)
    # exact f32 products, summed in another order: rows of about 3
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    _, covered = k5._row_experts(*seg, tm)
    assert not bool(y[~covered].any())  # rows of no segment are exactly 0


# ── the kernel's decode and fragment mapping, emulated ──────────────────


def _consts():
    """The kernel's uint32 constants (tables and prmt selectors) by name."""
    found = dict(re.findall(r"\b(k\w+) = (0x[0-9A-Fa-f]+)u", SOURCE.read_text()))
    return {n: int(v, 16) for n, v in found.items()}


def _prmt(a, b, sel):
    """PTX prmt.b32 (default mode) on uint32 arrays: result byte i is byte
    (nibble i of sel) & 7 of (b:a), or its bit 7 replicated where the
    nibble's bit 3 is set."""
    a, b, sel = np.broadcast_arrays(*(np.asarray(v, np.uint64) for v in (a, b, sel)))
    src = np.stack([(v >> np.uint64(8 * i)) & np.uint64(0xFF) for v in (a, b) for i in range(4)])
    out = np.zeros(sel.shape, np.uint64)
    for i in range(4):
        nib = (sel >> np.uint64(4 * i)) & np.uint64(0xF)
        byte = np.take_along_axis(src, (nib & np.uint64(7)).astype(np.int64)[None], 0)[0]
        byte = np.where(nib & np.uint64(8), np.where(byte & np.uint64(0x80), 0xFF, 0), byte)
        out |= byte.astype(np.uint64) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _decode_word(w, c):
    """e2m1x8_bf16x2 before its multiply: uint32 words of 8 codes -> [4, ...]
    bf16 pairs (byte j's low nibble in the low half of pair j)."""
    w = np.asarray(w, np.uint32)
    m = w & np.uint32(0x77777777)
    w4 = (w << np.uint32(4)).astype(np.uint32)
    hi03 = _prmt(c["kHi0"], c["kHi1"], m) | (_prmt(w, w4, c["kSelNeg03"]) & np.uint32(0x80808080))
    hi47 = _prmt(c["kHi0"], c["kHi1"], m >> np.uint32(16)) | (
        _prmt(w, w4, c["kSelNeg47"]) & np.uint32(0x80808080))
    lo03, lo47 = _prmt(c["kLo0"], c["kLo1"], m), _prmt(c["kLo0"], c["kLo1"], m >> np.uint32(16))
    return np.stack([_prmt(lo03, hi03, c["kSelPair01"]), _prmt(lo03, hi03, c["kSelPair23"]),
                     _prmt(lo47, hi47, c["kSelPair01"]), _prmt(lo47, hi47, c["kSelPair23"])])


def _scaled(pairs, scale):
    """mul.rn.bf16x2 by a bf16 scale (f32 [...] broadcast to the pairs):
    the exact product rounded once to bf16. Returns bf16 [..., 2] (low
    half first)."""
    halves = np.stack([pairs & np.uint32(0xFFFF), pairs >> np.uint32(16)], -1)
    f = torch.from_numpy((halves << np.uint32(16)).astype(np.uint32).view(np.float32))
    return (f * torch.as_tensor(scale)[..., None]).to(torch.bfloat16)


def _bits(t):
    return t.contiguous().view(torch.int16)


@pytest.mark.parametrize("pow2", [True, False], ids=["pow2-scales", "bf16-scales"])
def test_decode_gives_dequant_bits(pow2):
    """Every byte of codes at 64 scales: the kernel's weights are
    bf16(f32(code) x scale), bit for bit ``quant.dequant_any``'s."""
    c = _consts()
    gen = torch.Generator().manual_seed(5)
    _, s = _stack(gen, 1, 64, 32, group=32, pow2=pow2)
    s = s.reshape(64)  # one scale a row
    # every byte value in each row, in an order of its own (neighbours in a
    # word differ in their signs)
    q = torch.stack([torch.randperm(256, generator=gen) for _ in range(64)]).to(torch.uint8)
    words = q.numpy().reshape(64, 64, 4).view("<u4")[..., 0]  # [64, 64] little endian
    pairs = _decode_word(words, c)  # [4 bytes of the word, 64, 64]
    got = _scaled(np.moveaxis(pairs, 0, -1), s.float()[:, None, None])  # [64, 64, 4, 2]
    want = quant.dequant_any({"q": q, "s": s[:, None]}, torch.bfloat16)  # [64, 512]
    assert torch.equal(_bits(got.reshape(64, 512)), _bits(want))


def _fragments(q, s, x, group, c):
    """The kernel's contraction of one expert's codes with x rows, slot by
    slot: for each 64-wide group of k, thread t (lanes t, t + 4, ...)
    decodes the 8 bytes at 8t (codes 16t .. 16t + 15) under the scale of
    code 16t; in k16 step st its A registers a0 / a2 (k-slots {2t, 2t+1} /
    {2t+8, 2t+9}) are bytes 2st / 2st + 1, and its B registers b0 / b1 are
    x's bf16 pairs at 16t + 4st / 16t + 4st + 2 (the kernel's bw[2st],
    bw[2st + 1]). Returns (A [OUT, steps, 16] bf16, the physical k of each
    slot [steps, 16], y [rows, OUT] f64 summed slot by slot)."""
    out_dim, in_dim = q.shape[0], 2 * q.shape[1]
    G = in_dim // 64
    A = torch.zeros((out_dim, G, 4, 16), dtype=torch.bfloat16)
    k_of = np.full((G, 4, 16), -1)
    for kg in range(G):
        for t in range(4):
            raw = q[:, kg * 32 + 8 * t: kg * 32 + 8 * t + 8].numpy()  # [OUT, 8]
            words = raw.reshape(out_dim, 2, 4).view("<u4")[..., 0]  # [OUT, 2]
            scale = s[:, (kg * 64 + 16 * t) // group].float()
            pairs = _decode_word(words, c)  # [4, OUT, 2]: pair j of word i is byte 4i + j
            byte_regs = np.concatenate([pairs[:, :, 0].T, pairs[:, :, 1].T], 1)  # [OUT, 8]
            wts = _scaled(byte_regs, scale[:, None])  # [OUT, 8 bytes, 2]
            for st in range(4):
                for half, (b, kx) in enumerate(((2 * st, 16 * t + 4 * st),
                                                (2 * st + 1, 16 * t + 4 * st + 2))):
                    slot = 2 * t + 8 * half
                    A[:, kg, st, slot: slot + 2] = wts[:, b]
                    k_of[kg, st, slot: slot + 2] = kg * 64 + kx + np.arange(2)
    A, k_of = A.reshape(out_dim, -1, 16), k_of.reshape(-1, 16)
    xk = x.double()[:, torch.from_numpy(k_of)]  # [rows, steps, 16]
    y = torch.einsum("rsk,osk->ro", xk, A.double())
    return A, k_of, y


@pytest.mark.parametrize("group,in_dim", [(16, 256), (32, 256), (64, 192)],
                         ids=["g16", "g32", "g64-odd-S"])
def test_fragment_mapping_gives_the_natural_contraction(group, in_dim):
    c = _consts()
    gen = torch.Generator().manual_seed(group)
    out_dim, rows = 16, 5
    q, s = _stack(gen, 1, out_dim, in_dim, group=group, pow2=False)
    q, s = q[0], s[0]
    x = torch.randn((rows, in_dim), generator=gen).to(torch.bfloat16)
    A, k_of, y = _fragments(q, s, x, group, c)
    # each 64-wide group's slots hold each of its k once
    for kg in range(in_dim // 64):
        assert sorted(k_of[4 * kg: 4 * kg + 4].reshape(-1).tolist()) == list(
            range(kg * 64, kg * 64 + 64))
    w = quant.unpack_fp4(q) * s.float().repeat_interleave(group, dim=-1)
    wb = w.to(torch.bfloat16)
    assert torch.equal(_bits(A.reshape(out_dim, -1)),
                       _bits(wb[:, torch.from_numpy(k_of).reshape(-1)]))
    ref = x.double() @ wb.double().T
    torch.testing.assert_close(y, ref, rtol=1e-12, atol=1e-12)


# ── the wrapper on the CPU ───────────────────────────────────────────────


def test_cpu_wrapper_ignores_plan_and_matches_pallas():
    rng = np.random.default_rng(9)
    n_exp, out_dim, in_dim, M, tm = 8, 64, 256, 64, 16
    q = rng.integers(0, 256, (n_exp, out_dim, in_dim // 2), dtype=np.uint8)
    s = np.exp2(rng.integers(-4, 3, (n_exp, out_dim, in_dim // 32))).astype(np.float32)
    x = rng.standard_normal((M, in_dim)).astype(np.float32)
    flat_e = np.sort(rng.choice([0, 1, 1, 1, 3, 7], M)).astype(np.int32)
    js = jnp.asarray(s, jnp.bfloat16)
    jseg = pfp4.tile_segments(jnp.asarray(flat_e), tm, n_exp)
    ref = np.asarray(pfp4.moe_fp4_grouped(jnp.asarray(x), jnp.asarray(q), js, *jseg,
                                          out_tile=32, tm=tm, interpret=True))
    tseg = k5.tile_segments(torch.from_numpy(flat_e), tm, n_exp)
    work = k5.plan(*tseg, tm, n_exp)
    # a plan of the wrong shape too: a CPU tensor never reads it
    bad = k5.Plan(*(t[:1] for t in work))
    before = k5.launches
    ts = numpy_to_torch(np.asarray(js))
    for p in (work, bad, None):
        out = k5.moe_fp4_grouped(torch.from_numpy(x), torch.from_numpy(q), ts, *tseg,
                                 tm=tm, plan=p)
        # the same exact products of bf16 values, summed in another order
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert k5.launches == before
