"""K7's launch plan (``ops/cuda/int8_grouped.py::plan``) on the CPU.

The plan turns the tiles' expert segments into work items (expert, lo, hi)
of at most ROW_CHUNK rows; the kernel runs each item against every tile of
OUT_TILE output channels, loads x[r] only where ``row_e[r]`` is the item's
expert and writes row r only where ``owner[r]`` is. These tests hold the
plan's rows against ``fp4_grouped._row_experts`` (which the plain version
uses) and walk its items in torch as the kernel does: every (row, output
tile) is written exactly once, and the walk gives ``moe_int8_grouped_plain``.
Tiny sizes: E <= 16, IN <= 256.
"""

import numpy as np
import pytest
import torch

from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
from pegainfer_tpu_torch.ops.cuda import int8_grouped as k7

E, OUT, IN = 16, 192, 128  # OUT: one whole output tile and a half one


def _sorted(rng, M, choices):
    return torch.from_numpy(np.sort(rng.choice(choices, M)).astype(np.int32))


def _segments(rng, M, tm, choices):
    e = _sorted(rng, M, choices)
    Mp = -(-M // tm) * tm
    e = torch.cat([e, e[-1:].expand(Mp - M)])  # pad rows carry the last expert
    return k5.tile_segments(e, tm, E), tm


def _hand_built(tm, segs_per_tile):
    """Segments of a tile given as [(expert, lo, hi), ...]; entries past
    n_seg hold expert 0, lo tm, hi 1, as tile_segments leaves them."""
    T = len(segs_per_tile)
    seg_e = torch.zeros((T, tm), dtype=torch.int32)
    seg_lo = torch.full((T, tm), tm, dtype=torch.int32)
    seg_hi = torch.ones((T, tm), dtype=torch.int32)
    n_seg = torch.zeros(T, dtype=torch.int32)
    for t, segs in enumerate(segs_per_tile):
        for i, (e, lo, hi) in enumerate(segs):
            seg_e[t, i], seg_lo[t, i], seg_hi[t, i] = e, lo, hi
        n_seg[t] = len(segs)
    return (seg_e, seg_lo, seg_hi, n_seg), tm


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "spread":  # every expert hit, a few rows each
        return _segments(rng, 200, 64, np.arange(E))
    if name == "skewed":  # most rows on two experts, the rest empty
        return _segments(rng, 300, 128, [0, 3, 3, 3, 3, 3, 7, 12, 15])
    if name == "empty-experts":  # odd experts only, tm = 8
        return _segments(rng, 44, 8, np.arange(1, E, 2))
    if name == "expert-across-tiles":  # one expert's 150 rows span five 32-row tiles
        return _segments(rng, 200, 32, [5] * 15 + [2, 9, 14])
    if name == "one-expert":  # all rows on one expert: several row chunks
        return _segments(rng, 256, 128, [6])
    if name == "uncovered-rows":  # gaps inside, an empty tile, a leading gap
        return _hand_built(16, [[(2, 3, 5), (3, 8, 16)], [], [(3, 0, 4), (9, 10, 12)],
                                [(15, 4, 16)]])
    if name == "no-rows-covered":
        return _hand_built(8, [[], []])
    raise ValueError(name)


CASES = ["spread", "skewed", "empty-experts", "expert-across-tiles", "one-expert",
         "uncovered-rows", "no-rows-covered"]


def _walk(x, q, p):
    """The kernel's work in torch: for each live item and output tile, the
    owned rows get (x[r] if the row is the item's expert's, else 0) @ codes.
    Returns (y, writes per (row, output tile))."""
    Mp = x.shape[0]
    n_ot = -(-OUT // k7.OUT_TILE)
    y = torch.full((Mp, OUT), float("nan"))
    writes = torch.zeros((Mp, n_ot), dtype=torch.long)
    xb = x.to(torch.bfloat16).float()
    for e, lo, hi in p.items[: int(p.n_items[0])].tolist():
        rows = torch.arange(lo, hi)
        load, own = p.row_e[rows] == e, p.owner[rows] == e
        xr = torch.where(load[:, None], xb[rows], torch.zeros(()))
        for ot in range(n_ot):
            o = slice(ot * k7.OUT_TILE, min(OUT, (ot + 1) * k7.OUT_TILE))
            y[rows[own], o] = (xr @ q[e, o].float().T)[own]
            writes[rows[own], ot] += 1
    return y, writes


@pytest.mark.parametrize("name", CASES)
def test_plan_rows_agree_with_row_experts(name):
    seg, tm = _case(name)
    p = k7.plan(*seg, tm, E)
    row_e, covered = k5._row_experts(*seg, tm)
    assert all(t.dtype == torch.int32 for t in p)
    assert torch.equal(p.row_e, torch.where(covered, row_e, -1).int())
    # a covered row is owned by its own expert; owners never decrease for
    # sorted rows, so each expert owns one range
    assert torch.equal(p.owner[covered], p.row_e[covered])
    assert bool((p.owner[1:] >= p.owner[:-1]).all())


@pytest.mark.parametrize("name", CASES)
def test_plan_items_cover_each_row_once(name):
    seg, tm = _case(name)
    Mp = seg[0].numel()
    p = k7.plan(*seg, tm, E)
    n = int(p.n_items[0])
    slots = E * -(-Mp // k7.ROW_CHUNK)
    assert p.items.shape == (slots, 3)
    # the kernel's grid holds the items of sorted rows: E + ceil(Mp / ROW_CHUNK)
    assert 1 <= n <= E + -(-Mp // k7.ROW_CHUNK)
    items = p.items[:n]
    assert bool((items[:, 2] > items[:, 1]).all())
    assert bool((items[:, 2] - items[:, 1] <= k7.ROW_CHUNK).all())
    assert bool((items[1:, 0] >= items[:-1, 0]).all())  # experts in order
    assert not bool(p.items[n:].any())
    x = torch.randn((Mp, IN), generator=torch.Generator().manual_seed(Mp))
    q = torch.randint(-127, 128, (E, OUT, IN), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(Mp + 1))
    _, writes = _walk(x, q, p)
    assert bool((writes == 1).all())


@pytest.mark.parametrize("name", CASES)
def test_plan_walk_reproduces_plain(name):
    seg, tm = _case(name)
    Mp = seg[0].numel()
    gen = torch.Generator().manual_seed(7 * Mp)
    x = torch.randn((Mp, IN), generator=gen)
    q = torch.randint(-127, 128, (E, OUT, IN), dtype=torch.int8, generator=gen)
    y, _ = _walk(x, q, k7.plan(*seg, tm, E))
    ref = k7.moe_int8_grouped_plain(x, q, *seg, tm=tm)
    # exact f32 products, summed in another order: rows of about 1e3
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-3)
    _, covered = k5._row_experts(*seg, tm)
    assert not bool(y[~covered].any())  # rows of no segment are exactly 0


def test_plan_skips_invalid_segments():
    """Segments past n_seg, empty ones (lo >= hi) and experts outside
    [0, E) cover no row."""
    seg, tm = _hand_built(8, [[(4, 0, 3), (E, 3, 6), (5, 6, 6)]])
    seg[0][0, 3], seg[1][0, 3], seg[2][0, 3] = 7, 6, 8  # past n_seg = 3
    p = k7.plan(*seg, tm, E)
    assert p.row_e.tolist() == [4, 4, 4, -1, -1, -1, -1, -1]
    assert p.owner.tolist() == [4] * 8
    assert p.items[: int(p.n_items[0])].tolist() == [[4, 0, 8]]


def test_plan_splits_a_long_expert_into_row_chunks():
    tm, T = 128, 3
    e = torch.cat([torch.full((10,), 1), torch.full((300,), 4), torch.full((74,), 11)])
    p = k7.plan(*k5.tile_segments(e.int(), tm, E), tm, E)
    C = k7.ROW_CHUNK
    want = [[1, 0, 10]] + [[4, 10 + C * i, min(310, 10 + C * (i + 1))] for i in range(5)]
    want += [[11, 310, 374], [11, 374, 384]]
    assert T * tm == 384
    assert p.items[: int(p.n_items[0])].tolist() == want
