"""The split planner of the paged-decode kernel K1 (``ops/cuda/paged_decode.py::
plan_splits``), on the CPU: the kernel splits each row's context across
blocks, and the wrapper picks the split from shapes alone. Across a grid of
batch sizes, kv heads, table widths, page sizes and SM counts: the splits
cover pages 0..P-1 once each and in order, there are never more splits than
pages, and there is one split once the B x Hkv blocks alone fill the card.
"""

import pytest

from pegainfer_tpu_torch.ops.cuda import paged_decode as pd

WIDTHS = (0, 1, 2, 3, 17, 18, 64, 127, 256, 640)  # table widths P, in pages
PAGE_SIZES = (1, 16, 64, 128)


def split_pages(P, S, pps):
    """The page ranges [(first, end), ...] of the S splits, as
    csrc/paged_decode.cu computes them from (S, pps)."""
    return [(s * pps, min((s + 1) * pps, P)) for s in range(S)]


@pytest.mark.parametrize("sm_count", [132, 114, 8])
@pytest.mark.parametrize("B,Hkv", [(1, 8), (2, 8), (3, 8), (1, 1), (5, 2), (16, 8), (64, 8),
                                   (1, 40)])
def test_plan_splits_covers_every_page_once(B, Hkv, sm_count):
    for P in WIDTHS:
        for ps in PAGE_SIZES:
            S, pps = pd.plan_splits(B, Hkv, P, ps, sm_count)
            assert 1 <= S <= max(P, 1) and S <= pd.MAX_SPLITS and pps >= 1
            ranges = split_pages(P, S, pps)
            pages = [p for lo, hi in ranges for p in range(lo, hi)]
            assert pages == list(range(P))  # each page once, in order
            if P:
                assert all(lo < hi for lo, hi in ranges)  # no split is empty of pages
            if B * Hkv >= sm_count:
                assert S == 1


@pytest.mark.parametrize("sm_count", [132, 114])
def test_plan_splits_aims_at_two_blocks_an_sm(sm_count):
    """Splits raise the grid toward BLOCKS_PER_SM blocks an SM, as far as
    the pages and the least split size allow: between half and all of the
    splits aimed at."""
    for B, Hkv in ((1, 8), (2, 8), (4, 4)):
        for P in (18, 64, 256):
            S, _ = pd.plan_splits(B, Hkv, P, 64, sm_count)
            aim = min(P, -(-pd.BLOCKS_PER_SM * sm_count // (B * Hkv)))
            assert aim / 2 <= S <= aim
    # small pages: a split holds at least MIN_SPLIT_TOKENS tokens
    S, pps = pd.plan_splits(1, 8, 72, 16, sm_count)
    assert pps * 16 >= pd.MIN_SPLIT_TOKENS


def test_plan_splits_at_the_main_path_shape():
    """Qwen3-4B at B = 1 and a context of 1,152 (18 pages of 64) on an
    H100's 132 SMs: one page a split, 144 blocks where the first design had
    8."""
    assert pd.plan_splits(1, 8, 18, 64, 132) == (18, 1)
    assert pd.plan_splits(64, 8, 20, 64, 132) == (1, 20)
