"""Decode blocks of the two families with state slots, the Qwen3.5 hybrid
(``engine/hybrid_executor.py``) and DeepSeek-V4
(``engine/slot_executor.py``), on the CPU, through their graph buffers
(``DecodeGraphs.run_block``; nothing is captured on the CPU).

- One block of 4 equals four one-token blocks: tokens equal (greedy and
  sampled rows, the same draws), logprobs within 1e-5, and every live
  slot's rows (and the hybrid's pages) equal afterwards; a pipelined pair
  (the second block dispatched on the first's tokens on the device before
  the first is read) equals two blocks read in turn.
- The hybrid engine under the defaults (blocks of 4, steady blocks of 16,
  depth 2) gives the JAX engine's greedy streams under its defaults
  (DeepSeek-V4's engine under the defaults is held against the JAX
  engine's in tests/test_torch_dsv4.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.engine.jax_executor import JaxExecutor
from pegainfer_tpu.engine.scheduler import start_scheduler as j_start_scheduler
from pegainfer_tpu.models import qwen35 as jq
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine import executor as tx
from pegainfer_tpu_torch.engine.hybrid_executor import HybridExecutor
from pegainfer_tpu_torch.engine.slot_executor import SlotExecutor
from pegainfer_tpu_torch.models import dsv4 as tdsv4
from pegainfer_tpu_torch.models import dsv4_engine
from pegainfer_tpu_torch.models import qwen35 as tq
from pegainfer_tpu_torch.models import qwen35_engine
from tests.test_torch_decode_graphs_slots import DSV4_TINY, Q35_TINY, _drain

PS = 4
NUM_PAGES = 64
SLOTS = 3
MAX_LEN = 64
WAIT_S = 300
LP_ATOL = 1e-5
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
ITEMS = [  # (prompt, sampling, logprobs)
    ([5, 9, 13], {}, 0), ([7, 8, 9, 10, 11], SAMPLED, 3), ([21, 22, 23, 24], {}, 2)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_decode_graphs_slots.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hybrid(params):
    cfg = tq.Qwen35Config(**Q35_TINY)
    state = tq.make_state(cfg, NUM_PAGES, PS, SLOTS, kv_dtype=torch.float32)
    return HybridExecutor(cfg, params, state, tc.EngineLoadOptions(max_batch_size=SLOTS))


def _dsv4(params):
    cfg = tdsv4.DSv4Config(**{**DSV4_TINY, "dim": 32, "moe_inter_dim": 16})
    state = tdsv4.make_state(cfg, SLOTS, dsv4_engine.max_blocks_for(cfg, MAX_LEN))
    return SlotExecutor(cfg, params, state, SLOTS, MAX_LEN,
                        tc.EngineLoadOptions(max_batch_size=SLOTS, enable_prefix_cache=False))


@pytest.fixture(scope="module")
def makers():
    """family -> a function making a fresh executor on the family's tiny
    weights (the same weights each time)."""
    q35 = tq.init_random_params(tq.Qwen35Config(**Q35_TINY), seed=3, dtype=torch.float32)
    cfg = tdsv4.DSv4Config(**{**DSV4_TINY, "dim": 32, "moe_inter_dim": 16})
    d4 = tdsv4.init_random_params(cfg, seed=0, dtype=torch.float32, scale=0.08)
    fp4 = tdsv4.quantize_params_resident(d4)
    int8 = tdsv4.quantize_params_resident(d4, experts="int8")
    return {"qwen35": lambda: _hybrid(q35), "dsv4-fp4": lambda: _dsv4(fp4),
            "dsv4-int8": lambda: _dsv4(int8)}


def _prefilled(make):
    ex = make()
    res = ex.execute_prefill(tx.PrefillPlan([
        tx.PrefillStepItem(request_id=i, prompt_tokens=p, params=tc.SamplingParams(**sp),
                           logprobs=lp, random_val=0.25)
        for i, (p, sp, lp) in enumerate(ITEMS)])).requests
    return ex, [r.first_token for r in res]


def _items(toks):
    return [tx.DecodeStepItem(request_id=i, token_id=t, params=tc.SamplingParams(**sp),
                              logprobs=lp)
            for i, ((_, sp, lp), t) in enumerate(zip(ITEMS, toks))]


def _rows_equal(a, b):
    assert [(rid, t) for rid, t, _ in a] == [(rid, t) for rid, t, _ in b]
    for (_, _, la), (_, _, lb) in zip(a, b):
        assert (la is None) == (lb is None)
        for x, y in zip(la or (), lb or ()):
            assert abs(x.logprob - y.logprob) <= LP_ATOL
            assert [i for i, _ in x.top_logprobs] == [i for i, _ in y.top_logprobs]
            np.testing.assert_allclose([v for _, v in x.top_logprobs],
                                       [v for _, v in y.top_logprobs], rtol=0, atol=LP_ATOL)


def _same_state(a, b):
    """Every live slot's rows equal (the dead slot apart), and the hybrid's
    pages of each request."""
    for rid in range(len(ITEMS)):
        sa, sb = a._slot(rid), b._slot(rid)
        if isinstance(a, HybridExecutor):
            for key in ("rec", "conv"):
                assert torch.equal(a.state[key][:, :, sa], b.state[key][:, :, sb]), key
            pa, pb = a.acct.state(rid).pages, b.acct.state(rid).pages
            assert torch.equal(a.state["kv"][:, :, pa], b.state["kv"][:, :, pb])
        else:
            for la, lb in zip(a.state["layers"], b.state["layers"]):
                for key in la:
                    assert torch.equal(la[key][sa], lb[key][sb]), key


FAMILIES = ["qwen35", "dsv4-fp4", "dsv4-int8"]


@pytest.mark.parametrize("family", FAMILIES)
def test_a_block_of_four_equals_four_one_token_blocks(makers, family):
    rand = np.random.default_rng(3).uniform(size=(4, len(ITEMS))).astype(np.float32)
    block, first = _prefilled(makers[family])
    got = block.resolve_pending_multi(block.execute_decode_async(
        _items(first), n_tokens=4, rand_matrix=rand.tolist()))
    steps, toks = _prefilled(makers[family])
    rows = [(i, [], []) for i in range(len(ITEMS))]
    for s in range(4):
        res = steps.resolve_pending_multi(steps.execute_decode_async(
            _items(toks), rand_matrix=rand[s:s + 1].tolist()))
        for (_, t, lp), row in zip(res, rows):
            row[1].extend(t)
            row[2].extend(lp or [])
        toks = [t[-1] for _, t, _ in res]
    _rows_equal(got, [(rid, t, lp or None) for rid, t, lp in rows])
    P = 8 if family == "qwen35" else 0
    assert set(block._graphs.blocks) == {(4, P, 4, False, 4)}
    assert (block.decode_steps, block.decode_blocks, steps.decode_blocks) == (4, 1, 4)
    _same_state(block, steps)


@pytest.mark.parametrize("family", FAMILIES)
def test_a_pipelined_pair_equals_two_blocks_read_in_turn(makers, family):
    rand = np.random.default_rng(4).uniform(size=(8, len(ITEMS))).astype(np.float32)
    pipe, first = _prefilled(makers[family])
    p1 = pipe.execute_decode_async(_items(first), n_tokens=4, rand_matrix=rand[:4].tolist())
    p2 = pipe.execute_decode_async(_items([0] * len(ITEMS)), tokens_dev=p1.tokens_dev,
                                   n_tokens=4, rand_matrix=rand[4:].tolist())
    got = [pipe.resolve_pending_multi(p) for p in (p1, p2)]
    turn, first = _prefilled(makers[family])
    r1 = turn.resolve_pending_multi(turn.execute_decode_async(
        _items(first), n_tokens=4, rand_matrix=rand[:4].tolist()))
    r2 = turn.resolve_pending_multi(turn.execute_decode_async(
        _items([t[-1] for _, t, _ in r1]), n_tokens=4, rand_matrix=rand[4:].tolist()))
    _rows_equal(got[0], r1)
    _rows_equal(got[1], r2)
    _same_state(pipe, turn)


def test_hybrid_greedy_streams_under_the_defaults_match_jax():
    """Two prompts of 24 tokens each on two slots (a steady block of 16,
    then blocks of 4 and 1 toward the LENGTH limit), both engines under
    their defaults."""
    jparams = jq.init_random_params(jq.Qwen35Config(**Q35_TINY), seed=11, dtype=jnp.float32,
                                    scale=0.2)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(8, 128, n).tolist() for n in (13, 16)]

    def submit(mod, handle):
        chans = []
        for p in prompts:
            ch = mod.TokenChannel()
            handle.submit(mod.GenerateRequest(prompt_tokens=p, max_tokens=24,
                                              params=mod.SamplingParams(ignore_eos=True),
                                              channel=ch))
            chans.append(ch)
        return _drain(mod, chans, WAIT_S)

    rt = jq.make_runtime(jq.Qwen35Config(**Q35_TINY), jparams, num_pages=NUM_PAGES,
                         page_size=PS, max_slots=2, kv_dtype=jnp.float32, use_pallas=False,
                         flat_decode=False, prefill_mode="grouped")
    jhandle = j_start_scheduler(JaxExecutor(rt, jc.EngineLoadOptions(precompile=False,
                                                                     max_batch_size=2)))
    try:
        want = submit(jc, jhandle)
    finally:
        jhandle.shutdown()
    handle = qwen35_engine.start_engine_from_params(
        tq.Qwen35Config(**Q35_TINY), tq.params_from_jax(jax.tree.map(np.asarray, jparams)),
        tc.EngineLoadOptions(max_num_pages=NUM_PAGES, max_batch_size=2), device="cpu")
    ex = handle._scheduler.executor
    try:
        got = submit(tc, handle)
    finally:
        handle.shutdown()
    assert got == want and [len(t) for t in got] == [24, 24]
    assert (ex.decode_block, ex.decode_block_max, ex.decode_pipeline_depth) == (4, 16, 2)
    assert any(k[2] == 16 for k in ex._graphs.blocks)  # a steady block of 16 ran
