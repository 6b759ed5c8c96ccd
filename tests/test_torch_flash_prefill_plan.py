"""K2's launch plan (ops/cuda/flash_prefill.py::plan) and tile rule on the CPU.

The kernel (csrc/flash_prefill.cu) takes its tile sizes and grid from
``plan`` and walks the key tiles that ``key_tiles`` below counts, skipping
the mask on the first ``unmasked`` of them (its n_tiles and n_full). These
tests hold that rule against the causal and kv_valid mask element by
element, so a tile the kernel skips or leaves unmasked never holds a (row,
key) pair whose validity it would get wrong.
"""

import numpy as np
import pytest

from pegainfer_tpu_torch.ops.cuda import flash_prefill as fp


def key_tiles(p, qt, T, S, kv_valid, q_offset):
    """(tiles, unmasked) of query tile ``qt``, as the kernel computes them:
    key tiles [0, tiles) reach the causal diagonal of the tile's last row
    below T and min(kv_valid, S); the first ``unmasked`` lie wholly at or
    below its first row's position and below min(kv_valid, S)."""
    kv_lim = min(kv_valid, S)
    q_lo = q_offset + qt * p.bq
    q_hi = q_offset + min((qt + 1) * p.bq, T) - 1
    kv_hi = min(kv_lim, q_hi + 1)
    tiles = -(-kv_hi // p.bk) if kv_hi > 0 else 0
    unmasked = max(0, min((q_lo + 1) // p.bk, kv_lim // p.bk))
    return tiles, unmasked


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("hd", fp.HEAD_DIMS)
def test_plan_packs_a_block_of_rows(G, hd):
    for T in (1, 31, 32, 1000, 1024, 4097):
        p = fp.plan(T, G, hd)
        assert p.bq * G == fp.ROWS
        assert p.bk == (64 if hd == 256 else 128)
        assert (p.q_tiles - 1) * p.bq < T <= p.q_tiles * p.bq


def _valid(T, S, kv_valid, q_offset, rows, keys):
    """valid[t, key] for query rows ``rows`` (t < T) and ``keys``."""
    pos = q_offset + rows[:, None]
    k = keys[None, :]
    return (k <= pos) & (k < min(kv_valid, S))


# (T, S, kv_valid, q_offset, G, hd): whole prompts, ragged T, chunks whose
# kv_valid ends inside them, keys past kv_valid, one row, a long prompt
CASES = [
    (1024, 1024, 1024, 0, 4, 128),
    (1000, 1000, 1000, 0, 4, 128),
    (37, 37, 30, 0, 4, 128),
    (256, 768, 768, 512, 4, 128),
    (256, 1280, 1000, 768, 4, 128),
    (1, 700, 700, 699, 4, 128),
    (300, 300, 300, 0, 8, 256),
    (200, 712, 650, 512, 8, 256),
    (777, 777, 777, 0, 1, 128),
    (130, 130, 130, 0, 64, 64),
    (4096, 4096, 4096, 0, 4, 128),
    (64, 32768, 32768, 32704, 4, 128),
]


@pytest.mark.parametrize("T,S,kv_valid,q_offset,G,hd", CASES)
def test_key_tiles_cover_every_valid_key_and_mask_every_crossing_tile(
        T, S, kv_valid, q_offset, G, hd):
    p = fp.plan(T, G, hd)
    keys = np.arange(-(-S // p.bk) * p.bk)  # a tile past S holds zero-filled keys
    for qt in range(p.q_tiles):
        rows = np.arange(qt * p.bq, min((qt + 1) * p.bq, T))
        valid = _valid(T, S, kv_valid, q_offset, rows, keys)
        tiles, unmasked = key_tiles(p, qt, T, S, kv_valid, q_offset)
        # no valid key lies past the tiles walked, and the last one walked
        # holds one
        assert not valid[:, tiles * p.bk:].any()
        if tiles:
            assert valid[:, (tiles - 1) * p.bk:tiles * p.bk].any()
        # unmasked tiles are valid for every row; the next tile walked is not
        assert unmasked <= tiles
        assert valid[:, :unmasked * p.bk].all()
        if unmasked < tiles:
            assert not valid[:, unmasked * p.bk:(unmasked + 1) * p.bk].all()


@pytest.mark.parametrize("T,G,hd", [(1024, 4, 128), (4096, 4, 128), (1024, 8, 256),
                                    (1000, 2, 64)])
def test_grid_runs_the_longest_query_tiles_first(T, G, hd):
    """Block b works on query tile q_tiles - 1 - b // Hkv: in launch order
    the key tiles a block walks never grow, so the last wave holds the
    shortest causal rows."""
    p = fp.plan(T, G, hd)
    order = [key_tiles(p, p.q_tiles - 1 - b, T, T, T, 0)[0] for b in range(p.q_tiles)]
    assert order == sorted(order, reverse=True)
    assert order[0] == -(-T // p.bk) and order[-1] == 1


def test_main_path_work():
    """The Qwen3-4B 1,024-token prefill (Hq 32, Hkv 8, hd 128): 32 query
    tiles of 32 positions for each of 8 kv heads, 256 blocks walking 1,152
    key tiles of 128 keys, 256 of them masked (one a block)."""
    p = fp.plan(1024, 4, 128)
    assert (p.bq, p.bk, p.q_tiles) == (32, 128, 32)
    per_head = [key_tiles(p, qt, 1024, 1024, 1024, 0) for qt in range(p.q_tiles)]
    assert 8 * sum(t for t, _ in per_head) == 1152
    assert all(t - u == 1 for t, u in per_head)
