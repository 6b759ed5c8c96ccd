"""The port's refcounted page pool and page prefix cache against the JAX
package's (``pegainfer_tpu/engine/kv.py``), step for step.

One seeded sequence of request starts (cache ``match``, ``alloc``, cache
``insert``), releases (``free``) and evictions (``alloc`` on shortage through
the cache's hook) runs through both; after every step the refcounts, the
free lists, the cached chains and every result must be equal. Exact
(integers only).
"""

import numpy as np
import pytest

from pegainfer_tpu.engine import kv as jkv
from pegainfer_tpu_torch.engine import kv as tkv

PS = 4


def _state(pool, cache):
    return (list(pool._free), dict(pool._refs), pool.allocated, pool.available,
            dict(cache._pages), dict(cache._lru), cache.hits, cache.misses,
            cache.evictable())


def _call(f, *args):
    """A call's result, or the type and text of what it raised."""
    try:
        return ("ok", f(*args))
    except (RuntimeError, ValueError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_prefix_cache_replay_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pools = [jkv.PagePool(40), tkv.PagePool(40)]
    caches = [jkv.PrefixCache(pools[0], PS), tkv.PrefixCache(pools[1], PS)]
    # prompts share prefixes drawn from a few families, so matches hit
    families = [rng.integers(2, 50, 48).tolist() for _ in range(3)]
    live = {}  # request -> (pages per side)
    evicted = hits = 0
    for step in range(120):
        op = rng.integers(0, 10)
        if op < 6 or not live:  # start a request: match, alloc the rest, insert
            fam = families[rng.integers(0, len(families))]
            n = int(rng.integers(1, 40))
            prompt = fam[:n] + rng.integers(2, 50, int(rng.integers(0, 9))).tolist()
            need = -(-len(prompt) // PS)
            got = []
            for pool, cache in zip(pools, caches):
                n_tok, pages = cache.match(prompt)
                res = _call(pool.alloc, need - len(pages))
                if res[0] == "ok":
                    pages = list(pages) + res[1]
                    cache.insert(prompt, pages[: len(prompt) // PS])
                else:
                    pool.free(pages)  # the request is refused
                got.append((n_tok, res[0], pages if res[0] == "ok" else None))
            assert got[0] == got[1], (step, got)
            hits += got[0][0] > 0
            if got[0][1] == "ok":
                live[step] = (got[0][2], got[1][2])
        elif op < 9:  # release a live request
            rid = list(live)[int(rng.integers(0, len(live)))]
            for pool, pages in zip(pools, live.pop(rid)):
                pool.free(pages)
        else:  # a large alloc: the cache's hook evicts until it fits or is empty
            n = int(rng.integers(1, 12))
            before = caches[0].evictable()
            res = [_call(pool.alloc, n) for pool in pools]
            assert res[0] == res[1], (step, res)
            evicted += caches[0].evictable() < before
            if res[0][0] == "ok":
                for pool, r in zip(pools, res):
                    pool.free(r[1])
        assert _state(pools[0], caches[0]) == _state(pools[1], caches[1]), step
    assert hits > 0 and evicted > 0  # the sequence took both paths
    for pool, cache, side in zip(pools, caches, (0, 1)):
        for pages in live.values():
            pool.free(pages[side])
        cache.clear()
    assert _state(pools[0], caches[0]) == _state(pools[1], caches[1])
    assert not caches[1]._pages and pools[1].allocated == 0


def test_match_keeps_the_last_token_and_takes_references():
    pool = tkv.PagePool(16)
    cache = tkv.PrefixCache(pool, PS)
    prompt = list(range(10, 26))  # 16 tokens: 4 full pages
    pages = pool.alloc(4)
    cache.insert(prompt, pages)
    assert [pool._refs[p] for p in pages] == [2, 2, 2, 2]
    # capped at (T - 1) // ps pages: the last token always re-runs
    assert cache.match(prompt) == (12, pages[:3])
    assert cache.match(prompt + [99]) == (16, pages)
    assert cache.match([1] + prompt) == (0, [])
    assert (cache.hits, cache.misses) == (2, 1)
    pool.free(pages)  # the request lets go; the cache and the two matches hold them
    assert [pool._refs[p] for p in pages] == [3, 3, 3, 2]
    with pytest.raises(ValueError):
        pool.free([tkv.PagePool.NULL_PAGE])
