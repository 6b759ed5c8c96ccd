"""The port's decode blocks and pipelined decode (``decode_block``,
``decode_block_max``, ``decode_pipeline_depth``) for Qwen3, on the CPU.

The engine-level cases are tests/test_pipelined_decode.py's, on its config
(2 layers, hidden 64, vocab 128, page 4, f32, seed 7, 128 pages, batch 8):
the port's executor and the JAX executor, each under its own scheduler
stepped by hand with the same options (here the JAX defaults; the deep
profile ``decode_block_max=4, decode_pipeline_depth=4`` is
tests/test_torch_decode_blocks_deep.py's, on these cases), take the same
requests at the same points, so their streams must be equal, sampled ones
too (the same engine seed, the same draws in the same order). An arrival
during the pipeline is submitted after the second block's dispatch on both
sides. The port runs with its graph options on, so its blocks go through
``DecodeGraphs.run_block``'s buffers (the CPU runs ``decode_block`` on
them).

The executor-level cases hold one block of 4 against four one-token
blocks (tokens equal, logprobs within 1e-5, pools equal past the null
page) and a pipelined pair (the second block dispatched on the first's
tokens on the device before the first is read) against two blocks read in
turn.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.engine import scheduler as jsched
from pegainfer_tpu.engine.jax_executor import JaxExecutor
from pegainfer_tpu.models import qwen3 as jq3
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine import executor as tx
from pegainfer_tpu_torch.engine import scheduler as tsched
from pegainfer_tpu_torch.engine.torch_executor import TorchExecutor
from pegainfer_tpu_torch.models import qwen3 as tq3

PS = 4
NUM_PAGES = 128
MAX_STEPS = 500
LP_ATOL = 1e-5
PROFILES = {"defaults": {}, "deep": dict(decode_block_max=4, decode_pipeline_depth=4)}


def _cfg_kw():
    return dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                vocab_size=128, rms_norm_eps=1e-6, rope_theta=1e6,
                tie_word_embeddings=True, eos_token_id=1, stop_token_ids=(1,),
                max_position_embeddings=512)


@pytest.fixture(scope="module")
def weights():
    jparams = jq3.init_random_params(jq3.Qwen3Config(**_cfg_kw()), seed=7, dtype=jnp.float32)
    return jparams, tq3.params_from_jax(jax.tree.map(np.asarray, jparams))


class Side:
    """One engine's executor and scheduler, stepped by hand: requests are
    submitted to its handle, and ``run`` steps until the scheduler is idle
    and nothing waits in the handle."""

    def __init__(self, mod, sched_mod, ex):
        self.mod, self.ex = mod, ex
        self.handle = mod.EngineHandle()
        self.sched = sched_mod.Scheduler(ex, self.handle, seed=42)
        self.dispatches = 0
        self.on_dispatch = None  # called with the dispatch count after each block
        dispatch = ex.execute_decode_async

        def counted(*a, **kw):
            out = dispatch(*a, **kw)
            self.dispatches += 1
            if self.on_dispatch is not None:
                self.on_dispatch(self.dispatches)
            return out

        ex.execute_decode_async = counted

    def submit(self, prompt, max_tokens, ignore_eos=True, **sampling):
        ch = self.mod.TokenChannel()
        self.handle.submit(self.mod.GenerateRequest(
            prompt_tokens=list(prompt), max_tokens=max_tokens,
            params=self.mod.SamplingParams(ignore_eos=ignore_eos, **sampling), channel=ch))
        return ch

    def step(self) -> bool:
        reqs, _ = self.handle._drain()
        for r in reqs:
            self.sched._ingest(r)
        return self.sched.step()

    def run(self, until=None):
        for _ in range(MAX_STEPS):
            if until is not None and until():
                return
            if not self.step() and self.handle._submit_q.empty():
                return
        raise AssertionError("the scheduler never went idle")

    def collect(self, ch):
        toks, fin = [], None
        while fin is None:
            ev = ch.get(timeout=1)
            assert ev is not None, "the stream did not end"
            if isinstance(ev, self.mod.Token):
                toks.append(ev.id)
            elif self.mod.is_terminal(ev):
                assert isinstance(ev, self.mod.Finished), ev
                fin = ev.finish_reason.value
        return toks, fin

    def serve(self, requests):
        chans = [self.submit(*r[:2], **(r[2] if len(r) > 2 else {})) for r in requests]
        self.run()
        return [self.collect(ch) for ch in chans]

    def set_stop(self, ids):
        if isinstance(self.ex, TorchExecutor):
            self.ex._stop_ids = frozenset(ids)
        else:
            self.ex.rt.stop_token_ids = frozenset(ids)


def _sides(weights, profile):
    jparams, tparams = weights
    opts = dict(max_batch_size=8, **PROFILES[profile])
    rt = jq3.make_runtime(jq3.Qwen3Config(**_cfg_kw()), jparams, num_pages=NUM_PAGES,
                          page_size=PS, kv_dtype=jnp.float32, use_pallas=False)
    jside = Side(jc, jsched, JaxExecutor(rt, jc.EngineLoadOptions(precompile=False, **opts)))
    cfg = tq3.Qwen3Config(**_cfg_kw())
    tex = TorchExecutor(cfg, tparams, tq3.make_kv_pages(cfg, NUM_PAGES, PS, dtype=torch.float32),
                        tc.EngineLoadOptions(**opts))
    tex.precompile()
    return jside, Side(tc, tsched, tex)


@pytest.fixture(scope="module")
def sides(weights):
    """(JAX side, port side) under the defaults, shared by the cases in
    order: both take the same sequence of requests, so their schedulers'
    random streams stay in step."""
    return "defaults", _sides(weights, "defaults")


SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)


def case_single(s):
    runs = [s.serve([([5, 9, 13], 12)]) for _ in range(2)]
    assert runs[0] == runs[1] and len(runs[0][0][0]) == 12 and runs[0][0][1] == "length"
    return runs


def case_arrival(s):
    chans = [s.submit([3 + i, 40 + i], 16) for i in range(4)]
    late, k0 = [], s.dispatches
    # after the second block's dispatch
    s.on_dispatch = lambda k: late.append(s.submit([99], 8)) if k == k0 + 2 else None
    s.run()
    s.on_dispatch = None
    out = [s.collect(ch) for ch in chans + late]
    assert all(len(t) == 16 and f == "length" for t, f in out[:4]) and len(out[4][0]) == 8
    solo = s.serve([([3, 40], 16)])
    assert solo[0] == out[0]
    return out + solo


def case_sampled(s):
    out = s.serve([([7, 8, 9], 10, SAMPLED)])
    assert len(out[0][0]) == 10 and out[0][1] == "length"
    return out


def case_kv_pressure(s):
    out = s.serve([([2 + i, 30 + i, 60 + i], 20) for i in range(12)])
    assert all(len(t) == 20 and f == "length" for t, f in out)
    return out


def case_page_reuse(s):
    a, keeper = s.submit([11, 12, 13], 4), s.submit([21], 24)
    s.run(until=lambda: a._done.is_set())
    b = s.submit([31, 32], 16)  # may land on a's freed pages
    s.run()
    out = [s.collect(ch) for ch in (a, b, keeper)]
    solo = s.serve([([31, 32], 16)])
    assert len(out[0][0]) == 4 and out[1] == solo[0]
    return out + solo


def case_mixed(s):
    out = s.serve([([5, 40], 8), ([6, 40], 8, dict(temperature=0.9, top_k=30)), ([7, 40], 8)])
    assert all(len(t) == 8 for t, _ in out)
    assert s.serve([([5, 40], 8)])[0] == out[0]
    return out


def case_eos_in_window(s):
    # this prompt's greedy stream turns to a new token at its 13th: that
    # token is its stop token, inside the first steady block, with the next
    # block in flight
    prompt = [8, 12, 49]
    out = s.serve([(prompt, 30)])
    ref = out[0][0]
    stop = next(t for i, t in enumerate(ref[6:], 6) if t not in ref[:i])
    s.set_stop({1, stop})
    try:
        eos = s.serve([(prompt, 30, dict(ignore_eos=False))])
    finally:
        s.set_stop({1})
    assert eos[0][1] == "stop" and eos[0][0] == ref[:ref.index(stop)]
    return out + eos


def case_length_boundary(s):
    before = getattr(s.ex, "decode_steps", None)
    out = s.serve([([7, 11], 17)])
    assert len(out[0][0]) == 17 and out[0][1] == "length"
    if before is not None:  # the port: computed = emitted, nothing past the budget
        assert s.ex.decode_steps - before == 16
    return out


CASES = [case_single, case_arrival, case_sampled, case_kv_pressure, case_page_reuse,
         case_mixed, case_eos_in_window, case_length_boundary]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_streams_match_the_jax_engine(sides, case):
    profile, (jside, tside) = sides
    want = case(jside)
    got = case(tside)
    assert got == want
    assert tside.dispatches == jside.dispatches  # the same blocks
    if profile == "defaults":
        assert tside.ex.decode_blocks < tside.ex.decode_steps


def test_block_options_have_the_jax_defaults_and_clamps(caplog):
    j, t = jc.EngineLoadOptions(), tc.EngineLoadOptions()
    assert (t.decode_block, t.decode_block_max, t.decode_pipeline_depth) == (4, 16, 2)
    assert (t.decode_block, t.decode_block_max, t.decode_pipeline_depth) == (
        j.decode_block, j.decode_block_max, j.decode_pipeline_depth)
    with caplog.at_level("WARNING"):
        got = tc.block_options(tc.EngineLoadOptions(decode_block=8, decode_block_max=4,
                                                    decode_pipeline_depth=0))
    assert got == (8, 8, 1) and "clamped up" in caplog.text
    assert tc.block_options(tc.EngineLoadOptions(decode_block=0)) == (1, 16, 2)


# ── the executor level ───────────────────────────────────────────────────


ITEMS = [  # (prompt, sampling, logprobs)
    ([5, 9, 13], {}, 0), ([7, 8, 9, 10, 11], SAMPLED, 3), ([21, 22], {}, 2)]


def _executor(tparams, graphs=True):
    cfg = tq3.Qwen3Config(**_cfg_kw())
    return TorchExecutor(cfg, tparams, tq3.make_kv_pages(cfg, 32, PS, dtype=torch.float32),
                         tc.EngineLoadOptions(max_batch_size=8, enable_cuda_graph=graphs))


def _prefilled(tparams, graphs=True):
    ex = _executor(tparams, graphs)
    res = ex.execute_prefill(tx.PrefillPlan([
        tx.PrefillStepItem(request_id=i, prompt_tokens=p, params=tc.SamplingParams(**sp),
                           logprobs=lp, random_val=0.25)
        for i, (p, sp, lp) in enumerate(ITEMS)])).requests
    return ex, [r.first_token for r in res]


def _items(toks, rands=None):
    return [tx.DecodeStepItem(request_id=i, token_id=t, params=tc.SamplingParams(**sp),
                              logprobs=lp, random_val=0.0 if rands is None else rands[i])
            for i, ((_, sp, lp), t) in enumerate(zip(ITEMS, toks))]


def _same_cache(a, b):
    """Each request's pages hold the same rows in both executors (their
    page ids may differ: a block takes its pages at once)."""
    for rid in range(len(ITEMS)):
        pa, pb = a.acct.state(rid).pages, b.acct.state(rid).pages
        assert len(pa) == len(pb) and a.acct.state(rid).length == b.acct.state(rid).length
        assert torch.equal(a.kv_pages[:, :, pa], b.kv_pages[:, :, pb])


def _rows_equal(a, b):
    """Tokens equal, logprobs (chosen and top values) within LP_ATOL, top
    ids equal."""
    assert [(rid, t) for rid, t, _ in a] == [(rid, t) for rid, t, _ in b]
    for (_, _, la), (_, _, lb) in zip(a, b):
        assert (la is None) == (lb is None)
        for x, y in zip(la or (), lb or ()):
            assert abs(x.logprob - y.logprob) <= LP_ATOL
            assert [i for i, _ in x.top_logprobs] == [i for i, _ in y.top_logprobs]
            np.testing.assert_allclose([v for _, v in x.top_logprobs],
                                       [v for _, v in y.top_logprobs], rtol=0, atol=LP_ATOL)


@pytest.mark.parametrize("graphs", [True, False], ids=["graph-buffers", "eager"])
def test_a_block_of_four_equals_four_one_token_blocks(weights, graphs):
    rand = np.random.default_rng(3).uniform(size=(4, len(ITEMS))).astype(np.float32)
    block, first = _prefilled(weights[1], graphs)
    got = block.resolve_pending_multi(block.execute_decode_async(
        _items(first), n_tokens=4, rand_matrix=rand.tolist()))
    steps, toks = _prefilled(weights[1], graphs)
    rows = [(i, [], []) for i in range(len(ITEMS))]
    for s in range(4):
        res = steps.resolve_pending_multi(steps.execute_decode_async(
            _items(toks), rand_matrix=rand[s:s + 1].tolist()))
        for (rid, t, lp), row in zip(res, rows):
            row[1].extend(t)
            row[2].extend(lp or [])
        toks = [t[-1] for _, t, _ in res]
    want = [(rid, t, lp or None) for rid, t, lp in rows]
    _rows_equal(got, want)
    assert [lp is None for _, _, lp in got] == [lp == 0 for _, _, lp in ITEMS]
    assert (block.decode_steps, block.decode_blocks) == (4, 1)
    assert (steps.decode_steps, steps.decode_blocks) == (4, 4)
    assert (block._graphs is not None) == graphs
    if graphs:  # the block's buffers, keyed (B, P, N, greedy, lp_k)
        assert set(block._graphs.blocks) == {(4, 8, 4, False, 4)}
    _same_cache(block, steps)


def test_a_pipelined_pair_equals_two_blocks_read_in_turn(weights):
    """Block 2 dispatched on block 1's tokens on the device before block 1
    is read (its host token ids stale), against block 2 dispatched on the
    tokens read from block 1."""
    rand = np.random.default_rng(4).uniform(size=(8, len(ITEMS))).astype(np.float32)
    pipe, first = _prefilled(weights[1])
    p1 = pipe.execute_decode_async(_items(first), n_tokens=4, rand_matrix=rand[:4].tolist())
    p2 = pipe.execute_decode_async(_items([0] * len(ITEMS)), tokens_dev=p1.tokens_dev,
                                   n_tokens=4, rand_matrix=rand[4:].tolist())
    got = [pipe.resolve_pending_multi(p) for p in (p1, p2)]
    turn, first = _prefilled(weights[1])
    r1 = turn.resolve_pending_multi(turn.execute_decode_async(
        _items(first), n_tokens=4, rand_matrix=rand[:4].tolist()))
    r2 = turn.resolve_pending_multi(turn.execute_decode_async(
        _items([t[-1] for _, t, _ in r1]), n_tokens=4, rand_matrix=rand[4:].tolist()))
    _rows_equal(got[0], r1)
    _rows_equal(got[1], r2)
    _same_cache(pipe, turn)


def test_execute_decode_is_a_one_token_block(weights):
    """``execute_decode`` without logprobs: one block of one token (the
    first step's draw from each item's ``random_val``), read at once; with
    a logprobs row the one-token step that keeps its logits."""
    a, first = _prefilled(weights[1])
    rands = [0.3, 0.6, 0.9]
    plain = [dataclasses.replace(it, logprobs=0) for it in _items(first, rands)]
    res = a.execute_decode(tx.DecodePlan(plain)).requests
    b, _ = _prefilled(weights[1])
    want = b.resolve_pending_multi(b.execute_decode_async(plain))
    assert [(r.request_id, [r.token]) for r in res] == [(rid, t) for rid, t, _ in want]
    assert a.decode_blocks == 1 and set(a._graphs.blocks) == set()  # the one-token graph
    res = a.execute_decode(tx.DecodePlan(_items([r.token for r in res], rands))).requests
    assert [r.logprob is None for r in res] == [lp == 0 for _, _, lp in ITEMS]
    assert (a.decode_steps, a.decode_blocks) == (2, 2)
