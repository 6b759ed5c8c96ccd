"""The Qwen3.5 hybrid's prefix cache and its engine with the JAX engine's
chunk and cache options, on the CPU.

- The port's ``PrefixCache`` with state snapshots (``match_hybrid``,
  ``insert_snapshot``, the snapshot LRU) against the JAX package's
  ``engine/kv.py`` over the same sequences: exact (integers and the
  snapshots' identities).
- The port's engine (``HybridExecutor`` and its scheduler, stepped by hand
  as tests/test_torch_chunked_engine.py steps Qwen3's) against the JAX
  engine (``JaxExecutor`` on ``q35.make_runtime``'s grouped runtime) with
  ``prefill_chunk=16``, ``prefill_chunk_mixed=8`` and the cache on, on the
  tiny f32 period-2 weights of tests/test_torch_qwen35_engine.py, page 4:
  equal greedy tokens, finish reasons and counts (greedy streams do not
  depend on how pieces interleave, so the JAX engine runs on its thread).
- The fine tail's snapshot positions, the cache on against off, and the
  snapshot bytes that come off the pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.engine import kv as jkv
from pegainfer_tpu.engine.jax_executor import JaxExecutor
from pegainfer_tpu.engine.scheduler import start_scheduler as j_start_scheduler
from pegainfer_tpu.models import qwen35 as jq
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine import kv as tkv
from pegainfer_tpu_torch.engine.hybrid_executor import HybridExecutor
from pegainfer_tpu_torch.engine.scheduler import Scheduler
from pegainfer_tpu_torch.engine.torch_executor import plan_piece, small_piece
from pegainfer_tpu_torch.models import qwen35 as tq
from pegainfer_tpu_torch.models import qwen35_engine as tengine

PS = 4
SLOTS = 3
OPTS = dict(prefill_chunk=16, prefill_chunk_mixed=8, enable_prefix_cache=True)
WAIT_S = 300
MAX_STEPS = 3000
# one token a dispatch, each read before the next: these tests step the
# scheduler by hand between tokens (decode blocks are
# tests/test_torch_decode_blocks*.py's)
ONE_TOKEN = dict(decode_block=1, decode_block_max=1, decode_pipeline_depth=1)


def _cfg_kw():
    """The period-2 shape of tests/test_qwen35_parity.py, untied head."""
    return dict(hidden_size=64, intermediate_size=128, num_hidden_layers=4,
                num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                vocab_size=128, rms_norm_eps=1e-6, rope_theta=1e6,
                partial_rotary_factor=0.25,
                layer_types=("linear_attention", "full_attention") * 2,
                linear_num_key_heads=2, linear_num_value_heads=4,
                linear_key_head_dim=16, linear_value_head_dim=16,
                linear_conv_kernel_dim=4, tie_word_embeddings=False,
                eos_token_id=7, stop_token_ids=(7,), max_position_embeddings=1024)


# ── the prefix cache with snapshots ──────────────────────────────────────


def _caches(num_pages=40, max_snapshots=tkv.DEFAULT_MAX_SNAPSHOTS):
    pools = [jkv.PagePool(num_pages), tkv.PagePool(num_pages)]
    caches = [jkv.PrefixCache(pools[0], PS, max_snapshots=max_snapshots),
              tkv.PrefixCache(pools[1], PS, max_snapshots=max_snapshots)]
    return pools, caches


def _state(pool, cache):
    return (list(pool._free), dict(pool._refs), dict(cache._pages), dict(cache._lru),
            list(cache._snaps.items()), cache.hits, cache.misses)


def test_snapshot_cases_match_jax():
    """tests/test_prefix_cache.py's hybrid cases through both caches: no
    match without a snapshot (a plain match still hits), the deepest
    snapshot wins, the cap of (T - 1) // ps pages, refused positions, the
    LRU cap of 2 refreshed by a match; ``clear`` empties the snapshots."""
    assert tkv.DEFAULT_MAX_SNAPSHOTS == jkv.DEFAULT_MAX_SNAPSHOTS == 8
    for max_snaps in (8, 2):
        pools, caches = _caches(max_snapshots=max_snaps)
        toks = list(range(40))
        steps = [("insert", toks[:20]), ("match_hybrid", toks[:20] + [77]),
                 ("match", toks[:20] + [77]), ("snap", 8), ("match_hybrid", toks[:20] + [77]),
                 ("snap", 16), ("match_hybrid", toks[:20] + [77]), ("match_hybrid", toks[:20]),
                 ("snap", 7), ("snap", 44), ("snap", 0), ("insert", toks), ("snap", 24),
                 ("match_hybrid", toks[:17] + [99]), ("snap", 32), ("match_hybrid", toks),
                 ("match_hybrid", [5] + toks)]
        for i, (op, arg) in enumerate(steps):
            got = []
            for pool, cache in zip(pools, caches):
                if op == "insert":
                    pages = pool.alloc(len(arg) // PS)
                    cache.insert(arg, pages)
                    pool.free(pages)
                    got.append(None)
                elif op == "snap":
                    cache.insert_snapshot(toks, arg, f"at{arg}")
                    got.append(None)
                else:
                    res = getattr(cache, op)(arg)
                    pool.free(res[1])
                    got.append(res)
            assert got[0] == got[1], (max_snaps, i, op, got)
            assert _state(pools[0], caches[0]) == _state(pools[1], caches[1]), (max_snaps, i)
        snaps = sorted(pos for pos, _ in caches[1]._snaps.values())
        assert snaps == ([8, 16, 24, 32] if max_snaps == 8 else [16, 32])
        for pool, cache in zip(pools, caches):
            cache.clear()
            assert not cache._snaps and pool.allocated == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshot_replay_matches_jax(seed):
    """A seeded sequence of prompt starts (``match_hybrid``, alloc, insert,
    snapshots at the deepest interior page boundary and the aligned end),
    releases and evicting allocs through both caches at a snapshot cap of
    3: equal results, pools, chains and snapshot LRUs after every step."""
    rng = np.random.default_rng(seed)
    pools, caches = _caches(num_pages=48, max_snapshots=3)
    families = [rng.integers(2, 50, 48).tolist() for _ in range(3)]
    live, hits = {}, 0
    for step in range(150):
        op = rng.integers(0, 10)
        if op < 6 or not live:
            fam = families[rng.integers(0, len(families))]
            prompt = fam[:int(rng.integers(1, 40))] + rng.integers(
                2, 50, int(rng.integers(0, 9))).tolist()
            T, need = len(prompt), -(-len(prompt) // PS)
            got = []
            for pool, cache in zip(pools, caches):
                n_tok, pages, snap = cache.match_hybrid(prompt)
                try:
                    pages = list(pages) + pool.alloc(need - len(pages))
                except RuntimeError as e:
                    pool.free(pages)
                    got.append((n_tok, snap, str(e)))
                    continue
                cache.insert(prompt, pages[: T // PS])
                inner = (T - 1) // PS * PS
                for pos in (inner, T) if inner < T else (T,):
                    cache.insert_snapshot(prompt, pos, (step, pos))
                got.append((n_tok, snap, pages))
            assert got[0] == got[1], (step, got)
            hits += got[0][0] > 0
            if isinstance(got[0][2], list):
                live[step] = [got[0][2], got[1][2]]
        elif op < 9:
            rid = list(live)[int(rng.integers(0, len(live)))]
            for pool, pages in zip(pools, live.pop(rid)):
                pool.free(pages)
        else:
            n = int(rng.integers(1, 14))
            res = []
            for pool in pools:
                try:
                    res.append(pool.alloc(n))
                except RuntimeError as e:
                    res.append(str(e))
            assert res[0] == res[1], step
            if isinstance(res[0], list):
                for pool, pages in zip(pools, res):
                    pool.free(pages)
        assert _state(pools[0], caches[0]) == _state(pools[1], caches[1]), step
    assert hits > 0 and len(caches[1]._snaps) == 3


# ── the engine against the JAX engine ────────────────────────────────────


@pytest.fixture(scope="module")
def weights():
    jparams = jq.init_random_params(jq.Qwen35Config(**_cfg_kw()), seed=17,
                                    dtype=jnp.float32, scale=0.2)
    return jparams, tq.params_from_jax(jax.tree.map(np.asarray, jparams))


def _submit(mod, handle, req):
    prompt, max_tokens, ignore_eos = req
    ch = mod.TokenChannel()
    handle.submit(mod.GenerateRequest(prompt_tokens=list(prompt), max_tokens=max_tokens,
                                      params=mod.SamplingParams(ignore_eos=ignore_eos),
                                      channel=ch))
    return ch


def _events(mod, ch):
    toks = []
    while True:
        ev = ch.get(timeout=WAIT_S)
        assert ev is not None, "engine produced no event in time"
        if isinstance(ev, mod.Token):
            toks.append(ev.id)
        elif mod.is_terminal(ev):
            assert isinstance(ev, mod.Finished), ev
            return toks, ev.finish_reason.value, ev.completion_tokens


def _jax_run(jparams, waves, num_pages=128, **opts):
    """Each wave through the JAX engine, finished before the next starts."""
    rt = jq.make_runtime(jq.Qwen35Config(**_cfg_kw()), jparams, num_pages=num_pages,
                         page_size=PS, max_slots=SLOTS, kv_dtype=jnp.float32,
                         use_pallas=False, flat_decode=False, prefill_mode="grouped")
    ex = JaxExecutor(rt, jc.EngineLoadOptions(precompile=False, decode_block=1,
                                              max_batch_size=SLOTS, **{**OPTS, **opts}))
    handle = j_start_scheduler(ex)
    out = []
    try:
        for first, later in waves:
            chans = [_submit(jc, handle, r) for r in first + later]
            out += [_events(jc, ch) for ch in chans]
    finally:
        handle.shutdown()
    return out, ex


class SteppedEngine:
    """The port's hybrid executor and scheduler on the CPU, stepped by hand."""

    def __init__(self, tparams, num_pages=128, **opts):
        cfg = tq.Qwen35Config(**_cfg_kw())
        state = tq.make_state(cfg, num_pages, PS, SLOTS, kv_dtype=torch.float32)
        self.ex = HybridExecutor(cfg, tparams, state, tc.EngineLoadOptions(
            max_batch_size=SLOTS, **{**OPTS, **ONE_TOKEN, **opts}))
        self.handle = tc.EngineHandle()
        self.sched = Scheduler(self.ex, self.handle)

    def step(self) -> bool:
        reqs, _ = self.handle._drain()
        for r in reqs:
            self.sched._ingest(r)
        return self.sched.step()

    def run_until(self, cond):
        for _ in range(MAX_STEPS):
            if cond():
                return
            assert self.step(), "scheduler idle before the condition held"
        raise AssertionError("condition not reached")

    def run_to_idle(self):
        for _ in range(MAX_STEPS):
            if not self.step():
                return
        raise AssertionError("scheduler never went idle")

    def waves(self, waves):
        out = []
        for first, later in waves:
            chans = [_submit(tc, self.handle, r) for r in first]
            if later:  # once every stream of the wave has decoded a token
                n = len(first)
                self.run_until(lambda: len(self.sched.active) == n and all(
                    st.generated_count >= 2 for st in self.sched.active))
                chans += [_submit(tc, self.handle, r) for r in later]
            self.run_to_idle()
            out += [_events(tc, ch) for ch in chans]
        return out


def _prompts(seed, *lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(8, 128, n).tolist() for n in lens]


def _record(ex):
    """Log each snapshot taken (prompt length, position) and each hybrid
    lookup's cached tokens."""
    rec = {"snaps": [], "matches": []}
    insert, match = ex.prefix_cache.insert_snapshot, ex.prefix_cache.match_hybrid

    def logged_insert(tokens, pos, snap):
        rec["snaps"].append((len(tokens), pos))
        insert(tokens, pos, snap)

    def logged_match(tokens):
        res = match(tokens)
        rec["matches"].append(res[0])
        return res

    ex.prefix_cache.insert_snapshot, ex.prefix_cache.match_hybrid = logged_insert, logged_match
    return rec


def test_engine_streams_match_jax_engine(weights):
    """Two streams decode while an 80-token prompt arrives (fused pieces of
    8, snapshots at 64 and 80); the prompt again (a hit at 64, one piece);
    the prompt extended by 12 (a hit at 80); then under decode load the
    prompt's first 70 tokens (a hit at 64): every stream equals the JAX
    engine's, and both caches end with the same snapshot positions."""
    jparams, tparams = weights
    s1, s2, s3, long_p, ext = _prompts(42, 6, 9, 7, 80, 12)
    waves = [
        ([(s1, 20, True), (s2, 16, True)], [(long_p, 6, True)]),
        ([(long_p, 5, True)], []),
        ([(long_p + ext, 5, True)], []),
        ([(s3, 14, True)], [(long_p[:70], 4, True)]),
    ]
    want, jex = _jax_run(jparams, waves)
    port = SteppedEngine(tparams)
    rec = _record(port.ex)
    got = port.waves(waves)
    assert got == want
    ex = port.ex
    assert ex.mixed_pieces >= 4 and ex.chunk_pieces > ex.mixed_pieces
    # lookups: s1, s2, the cold prompt, its repeat, the extension, s3, the cut
    assert rec["matches"] == [0, 0, 0, 64, 80, 0, 64] and ex.prefix_cache.hits == 3
    # (prompt length, position): the cold run's deepest interior boundary and
    # its end, the repeat's end, the extension's end (the cut one is unaligned)
    assert rec["snaps"] == [(80, 64), (80, 80), (80, 80), (92, 92)]
    assert sorted(p for p, _ in ex.prefix_cache._snaps.values()) == \
        sorted(p for p, _ in jex.prefix_cache._snaps.values())
    assert ex.free_slots() == SLOTS
    assert ex.acct.pool.allocated == len(ex.prefix_cache._pages)  # only the cache holds pages


def test_mixed_pieces_carry_the_streams_slots(weights):
    """In a fused piece the decode rows carry their requests' slots (a
    padding row the dead one) and the prefilling request's slot is not
    among them."""
    _, tparams = weights
    port = SteppedEngine(tparams)
    seen = []
    mixed = port.ex._mixed_model

    def logged(item, items, chunk_tokens, start, valid, table, dec):
        slots = port.ex._slots_of(items, dec[0].shape[0]).tolist()
        seen.append((port.ex._slot(item.request_id), slots))
        return mixed(item, items, chunk_tokens, start, valid, table, dec)

    port.ex._mixed_model = logged
    s1, s2, long_p = _prompts(3, 6, 9, 40)
    port.waves([([(s1, 12, True), (s2, 12, True)], [(long_p, 3, True)])])
    assert seen and all(own not in slots[:2] and slots[2:] == [SLOTS] * (len(slots) - 2)
                        for own, slots in seen)
    assert {own for own, _ in seen} == {2} and all(sorted(s[:2]) == [0, 1] for _, s in seen)


@pytest.mark.parametrize("ps", [4, 16, 64])
def test_fine_tail_plan_walk(ps):
    """With the fine tail, every schedule covers [start, T) in rising
    page-aligned steps of at most the piece size, and ends with one piece
    from the boundary at or above T - small (of at most ``small`` tokens)."""
    rng = np.random.default_rng(ps)
    for _ in range(300):
        chunk = ps * int(rng.integers(2, 48))
        mixed = min(chunk, ps * int(rng.integers(1, 12)))
        small = small_piece(chunk, ps)
        T = int(rng.integers(1, 6000))
        start = ps * int(rng.integers(0, (T - 1) // ps + 1))
        flips = [bool(b) for b in rng.integers(0, 2, 4096)]
        ends, a = [], start
        while a < T:
            a = plan_piece(T, a, chunk, mixed, small, flips[len(ends)], small < chunk, ps)
            ends.append(a)
        starts = [start] + ends[:-1]
        assert ends[-1] == T and all(e % ps == 0 for e in ends[:-1])
        assert all(0 < b - a <= max(chunk, small) for a, b in zip(starts, ends))
        if small < chunk and T - start > small:
            b = -(-(T - small) // ps) * ps
            assert starts[-1] == b and T - b <= small and b in ends


def test_fine_tail_snapshot_positions():
    """tests/test_prefix_cache.py's JAX case on the port: a 900-token
    prompt at ``prefill_chunk=512`` runs as pieces ending at 512, 644 and
    900, keeps snapshots at 644 (ceil((900 - 256) / 4) x 4) and 900, and
    the same prompt again hits at 644 and streams the same tokens."""
    cfg = tq.Qwen35Config(**_cfg_kw())
    params = tq.init_random_params(cfg, seed=5, dtype=torch.float32, scale=0.2)
    port = SteppedEngine(params, num_pages=256, prefill_chunk=512)
    ends = []
    chunk = port.ex._chunk_model

    def logged(item, chunk_tokens, start, valid, table):
        ends.append(start + valid)
        return chunk(item, chunk_tokens, start, valid, table)

    port.ex._chunk_model = logged
    prompt = np.random.default_rng(23).integers(2, 128, 900).tolist()
    (first,) = port.waves([([(prompt, 3, True)], [])])
    assert ends == [512, 644, 900]
    assert sorted(p for p, _ in port.ex.prefix_cache._snaps.values()) == [644, 900]
    hits = port.ex.prefix_cache.hits
    (again,) = port.waves([([(prompt, 3, True)], [])])
    assert again == first and port.ex.prefix_cache.hits == hits + 1 and ends[-1] == 900


def test_fine_tail_matches_jax_engine(weights):
    """At ``prefill_chunk=264`` the small piece (256) is below the chunk, so
    both engines end a 300-token prompt with the fine tail (pieces ending
    at 44 and 300, snapshots at both); the prompt again and extended by 20
    hit at 44 and 300 (a pool of 255 pages keeps the prompt's 75 cached
    beside a request's 80). Equal streams and snapshot positions."""
    jparams, tparams = weights
    prompt, ext = _prompts(9, 300, 20)
    waves = [([(prompt, 4, True)], []), ([(prompt, 4, True)], []),
             ([(prompt + ext, 4, True)], [])]
    want, jex = _jax_run(jparams, waves, num_pages=256, prefill_chunk=264)
    port = SteppedEngine(tparams, num_pages=256, prefill_chunk=264)
    rec = _record(port.ex)
    assert port.waves(waves) == want
    assert rec["matches"] == [0, 44, 300]
    assert rec["snaps"] == [(300, 44), (300, 300), (300, 300), (320, 320)]
    assert sorted(p for p, _ in port.ex.prefix_cache._snaps.values()) == \
        sorted(p for p, _ in jex.prefix_cache._snaps.values()) == [44, 300, 320]


def test_cache_on_matches_cache_off(weights):
    """tests/test_prefix_cache.py's differential stream on the port: ten
    prompts cut from three bases, with tails, one at a time: the same
    greedy tokens with the cache on and off, and the cache hit."""
    _, tparams = weights
    rng = np.random.default_rng(17)
    bases = [rng.integers(8, 128, int(rng.integers(20, 60))).tolist() for _ in range(3)]
    prompts = []
    for _ in range(10):
        b = bases[rng.integers(0, len(bases))]
        prompts.append(b[:int(rng.integers(8, len(b) + 1))]
                       + rng.integers(8, 128, int(rng.integers(0, 8))).tolist())
    waves = [([(p, 3 + i % 4, True)], []) for i, p in enumerate(prompts)]
    on = SteppedEngine(tparams)
    assert on.waves(waves) == SteppedEngine(tparams, enable_prefix_cache=False).waves(waves)
    assert on.ex.prefix_cache.hits > 0


def test_snapshot_bytes_come_off_the_pool(monkeypatch):
    """``compute_num_pages`` at ``bench_config()`` with 60 GB free: the
    cache on takes DEFAULT_MAX_SNAPSHOTS slot states (8 x 53.48 MB) more
    off the pool than the cache off, as the JAX engine's sizing does."""
    free = 60 * 10 ** 9
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 80 * 10 ** 9))
    cfg = tq.bench_config()
    dev = torch.device("cuda")
    per_page, slot = tq.kv_bytes_per_page(cfg, 64), tq.slot_bytes(cfg)
    off = tengine.compute_num_pages(cfg, 64, 0.5, 2, dev)
    on = tengine.compute_num_pages(cfg, 64, 0.5, 2, dev, prefix_cache=True)
    assert off == int((free - 3 * slot) * 0.5) // per_page
    assert on == int((free - 11 * slot) * 0.5) // per_page
    assert 8 * slot == 427_819_008 and off - on == 204  # 8 x 53.48 MB at half a page of 1 MiB
