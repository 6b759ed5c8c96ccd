"""The port's engine with chunked prefill, the prefix cache and the fused
mixed step against the JAX engine, on the CPU.

Both engines take the same options (``prefill_chunk=16``,
``prefill_chunk_mixed=8``, the cache on) and the same tiny weights (2
layers, hidden 64, page 4, f32). Greedy streams do not depend on how the
pieces interleave, so the JAX engine runs on its own thread and the port's
scheduler is driven by ``Scheduler.step()`` calls: a prompt is submitted
exactly when the streams before it have decoded a token. Each test asserts
that the port took the path it is about (fused pieces ran, the cache hit).
The executor-level test holds one fused piece's non-greedy decode rows and
their logprobs against the JAX executor's at atol 1e-4 (as
``tests/test_torch_engine.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.engine import executor as jx
from pegainfer_tpu.engine.jax_executor import JaxExecutor
from pegainfer_tpu.engine.scheduler import start_scheduler as j_start_scheduler
from pegainfer_tpu.models import qwen3 as jq3
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine import executor as tx
from pegainfer_tpu_torch.engine.kv import PrefixCache
from pegainfer_tpu_torch.engine.scheduler import Scheduler
from pegainfer_tpu_torch.engine.torch_executor import TorchExecutor
from pegainfer_tpu_torch.models import qwen3 as tq3
from pegainfer_tpu_torch.models import qwen3_engine as tengine

PS = 4
OPTS = dict(prefill_chunk=16, prefill_chunk_mixed=8, enable_prefix_cache=True)
WAIT_S = 300
MAX_STEPS = 2000
# one token a dispatch, each read before the next: these tests step the
# scheduler by hand between tokens (decode blocks are
# tests/test_torch_decode_blocks*.py's)
ONE_TOKEN = dict(decode_block=1, decode_block_max=1, decode_pipeline_depth=1)


def _cfg_kw(stop=(1,)):
    return dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                vocab_size=128, rms_norm_eps=1e-6, rope_theta=1e6,
                tie_word_embeddings=True, eos_token_id=1, stop_token_ids=stop,
                max_position_embeddings=1024)


@pytest.fixture(scope="module")
def weights():
    jparams = jq3.init_random_params(jq3.Qwen3Config(**_cfg_kw()), seed=3,
                                     dtype=jnp.float32, scale=0.2)
    return jparams, tq3.params_from_jax(jax.tree.map(np.asarray, jparams))


# A request: (prompt, max_tokens, ignore_eos). A wave: requests submitted at
# once, then (on the port, once every stream has decoded a token) requests
# arriving under decode load.


def _jax_run(jparams, waves, num_pages=128, stop=(1,)):
    """Each wave's requests through the JAX engine, the wave finished before
    the next starts. Returns [(tokens, finish reason, completion count)]."""
    rt = jq3.make_runtime(jq3.Qwen3Config(**_cfg_kw(stop)), jparams, num_pages=num_pages,
                          page_size=PS, kv_dtype=jnp.float32, use_pallas=False)
    handle = j_start_scheduler(JaxExecutor(rt, jc.EngineLoadOptions(**OPTS)))
    out = []
    try:
        for first, later in waves:
            chans = [_submit(jc, handle, r) for r in first + later]
            out += [_events(jc, ch) for ch in chans]
    finally:
        handle.shutdown()
    return out


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


class SteppedEngine:
    """The port's executor and scheduler on the CPU, stepped by hand."""

    def __init__(self, tparams, num_pages=128, stop=(1,), **opts):
        cfg = tq3.Qwen3Config(**_cfg_kw(stop))
        self.ex = TorchExecutor(cfg, tparams,
                                tq3.make_kv_pages(cfg, num_pages, PS, dtype=torch.float32),
                                tc.EngineLoadOptions(**{**OPTS, **ONE_TOKEN, **opts}))
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
    return [rng.integers(2, 128, n).tolist() for n in lens]


def _waves():
    s1, s2, s3, long_p, p41 = _prompts(42, 6, 9, 7, 80, 41)
    return [
        # a long prompt arriving while two streams decode: fused pieces
        ([(s1, 24, True), (s2, 20, True)], [(long_p, 8, True)]),
        # the same prompt again: 19 cached pages, 4 tokens re-run
        ([(long_p, 6, True)], []),
        ([(p41, 5, True)], []),
        # under decode load: p41 fully cached (re-runs its last token) and a
        # short prompt inside its cached prefix (through the stepper too)
        ([(s3, 16, True)], [(p41, 5, True), (p41[:13], 4, True)]),
    ]


@pytest.fixture(scope="module")
def jax_waves(weights):
    return _jax_run(weights[0], _waves())


def test_engine_streams_match_jax_engine(weights, jax_waves):
    port = SteppedEngine(weights[1])
    got = port.waves(_waves())
    assert got == jax_waves
    ex = port.ex
    assert ex.mixed_pieces >= 2 and ex.chunk_pieces > ex.mixed_pieces
    assert ex.prefix_cache.hits >= 3 and ex.prefills >= 3
    assert ex.acct.pool.allocated == len(ex.prefix_cache._pages)  # only the cache holds pages


def test_time_sliced_interleave_matches_jax_engine(weights, jax_waves, monkeypatch):
    """PEGAINFER_MIXED_FUSED=0: pieces alternate with decode steps."""
    monkeypatch.setenv("PEGAINFER_MIXED_FUSED", "0")
    port = SteppedEngine(weights[1])
    got = port.waves(_waves()[:1])
    assert got == jax_waves[:3]
    assert port.ex.mixed_pieces == 0 and port.ex.chunk_pieces >= 5
    assert port.ex.decode_steps >= port.ex.chunk_pieces


def test_eos_in_the_middle_of_a_prefill(weights):
    """A stream that stops on EOS while a long prompt's fused pieces run:
    its rows in the piece already dispatched are dropped, the prefill goes
    on without decode rows, and both streams equal the JAX engine's."""
    jparams, tparams = weights
    short, long_p = _prompts(1, 6, 120)
    solo = SteppedEngine(tparams).waves([([(short, 24, True)], [])])[0][0]
    # the first token not seen before, a few tokens in, is the stream's EOS
    # (held against the JAX engine below)
    idx = next(i for i in range(3, len(solo)) if solo[i] not in solo[:i])
    stop = (1, solo[idx])
    waves = [([(short, 24, False)], [(long_p, 4, True)])]
    want = _jax_run(jparams, waves, stop=stop)
    port = SteppedEngine(tparams, stop=stop)
    got = port.waves(waves)
    assert got == want
    assert got[0] == (solo[:idx], "stop", idx + 1)
    assert 0 < port.ex.mixed_pieces < port.ex.chunk_pieces  # stopped mid-prefill


def test_a_pool_filled_by_the_cache_still_admits(weights):
    """23 usable pages; three 30-token prompts leave 21 of them held by the
    cache alone. The fourth request needs 9: admission counts the
    evictable pages and the pool's shortage hook evicts on alloc."""
    jparams, tparams = weights
    waves = [([(p, 4, True)], []) for p in _prompts(7, 30, 30, 30, 30)]
    want = _jax_run(jparams, waves, num_pages=24)
    port = SteppedEngine(tparams, num_pages=24)
    got = port.waves(waves[:3])
    pool, cache = port.ex.acct.pool, port.ex.prefix_cache
    assert pool.available == 2 and cache.evictable() == 21
    got += port.waves(waves[3:])
    assert got == want
    assert len(cache._pages) < 21 + 7  # entries were evicted to admit the last


def test_mixed_piece_sampling_and_logprobs_match_jax_executor(weights):
    """Both executors: two decode streams (temperature / top-k with
    logprobs 2, top-p with 3) ride three fused pieces of a 40-token prompt
    with the same random draws. Pieces 2 and 3 get stale host tokens, as
    the scheduler's one-piece-late apply leaves them: the executors feed
    the previous piece's sampled tokens themselves."""
    jparams, tparams = weights
    rt = jq3.make_runtime(jq3.Qwen3Config(**_cfg_kw()), jparams, num_pages=64, page_size=PS,
                          kv_dtype=jnp.float32, use_pallas=False)
    jex = JaxExecutor(rt, jc.EngineLoadOptions(**OPTS))
    port = SteppedEngine(tparams, num_pages=64)
    tex = port.ex
    rng = np.random.default_rng(9)
    prompts = _prompts(9, 5, 11, 40)
    sampling = [dict(temperature=0.9, top_k=6), dict(temperature=1.1, top_p=0.8)]
    logprobs = [2, 3]

    def prefill(mod, xmod, ex, rid, prompt):
        item = xmod.PrefillStepItem(request_id=rid, prompt_tokens=prompt,
                                    params=mod.SamplingParams(), random_val=0.5)
        return ex.execute_prefill(xmod.PrefillPlan([item])).requests[0].first_token

    firsts = [prefill(jc, jx, jex, i, p) for i, p in enumerate(prompts[:2])]
    assert firsts == [prefill(tc, tx, tex, i, p) for i, p in enumerate(prompts[:2])]

    def items(mod, xmod):
        return [xmod.DecodeStepItem(request_id=i, token_id=firsts[i],
                                    params=mod.SamplingParams(**sampling[i]),
                                    logprobs=logprobs[i], random_val=0.0)
                for i in range(2)]

    gens = [ex.prefill_stepper(xmod.PrefillStepItem(
        request_id=2, prompt_tokens=prompts[2], params=mod.SamplingParams()))
        for ex, mod, xmod in ((jex, jc, jx), (tex, tc, tx))]
    for piece in range(3):
        rand = [rng.uniform(size=2).tolist()]
        rows = []
        for ex, gen, mod, xmod in ((jex, gens[0], jc, jx), (tex, gens[1], tc, tx)):
            ex.decode_active = True
            ex.mixed_items, ex.mixed_rand = items(mod, xmod), rand
            assert next(gen) == 8 * (piece + 1)
            rows.append(ex.resolve_pending_multi(ex.mixed_pending))
            ex.mixed_pending = None
        (jrows, trows) = rows
        assert [(r, t) for r, t, _ in trows] == [(r, t) for r, t, _ in jrows]
        for (_, _, jl), (_, _, tl) in zip(jrows, trows):
            assert tl[0].logprob == pytest.approx(jl[0].logprob, abs=1e-4)
            assert [i for i, _ in tl[0].top_logprobs] == [i for i, _ in jl[0].top_logprobs]
            np.testing.assert_allclose([v for _, v in tl[0].top_logprobs],
                                       [v for _, v in jl[0].top_logprobs], rtol=0, atol=1e-4)
    assert tex.mixed_pieces == 3


def test_start_engine_from_params_builds_the_cache(weights):
    _, tparams = weights
    cfg = tq3.Qwen3Config(**_cfg_kw())
    handle = tengine.start_engine_from_params(
        cfg, tparams, tc.EngineLoadOptions(max_num_pages=8, prefill_chunk=100,
                                           enable_prefix_cache=True), device="cpu")
    try:
        ex = handle._scheduler.executor
        assert isinstance(ex.prefix_cache, PrefixCache) and ex.prefix_cache.pool is ex.acct.pool
        # aligned down to the engine's page of 64; the mixed size capped by it
        assert (ex.prefill_chunk, ex.prefill_chunk_mixed) == (64, 64)
    finally:
        handle.shutdown()
    with pytest.raises(ValueError, match="prefill_chunk"):
        tengine.start_engine_from_params(
            cfg, tparams, tc.EngineLoadOptions(max_num_pages=8, enable_prefix_cache=True,
                                               prefill_chunk=None), device="cpu")
