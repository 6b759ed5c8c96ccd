"""The graphed decode step of the two families with state slots, the
Qwen3.5 hybrid (``engine/hybrid_executor.py``) and DeepSeek-V4
(``engine/slot_executor.py``), on the CPU.

On the CPU nothing is captured: the executors fill the static buffers that
``engine/decode_graphs.py`` replays a graph over on the card and call the
forward on them, so these tests hold the buffer logic (the families'
inputs, the slots, the padding rows on the dead slot, the resume through
the B = 1 buffers) against the JAX engine and against the eager step. The
JAX engine's streams and the weights are made once a module.

- The hybrid (tiny, period 4, page 4, f32 and int8): four requests make
  the decode batch go 4 -> 3 -> 2 -> 1 and the table width cross 8 -> 16;
  the graphed engine gives the JAX engine's greedy streams and the eager
  engine's, and every live slot's recurrent and conv rows and every live
  page equal the eager engine's afterwards.
- DeepSeek-V4 (tiny, widths at which the fused chains K8 / K9 run, fp4
  resident and int8 experts, chain on and off): the same traffic on four
  slots, the graphed engine's streams and live slot rows equal the eager
  engine's.
- Padding rows are written afresh on the dead slot at every step, and a
  new set of buffers starts as padding rows on the dead slot (the warm-up
  of a capture must not write a live slot), for both families.
- A slot-cache resume through the B = 1 buffers gives the eager resume's
  first token and slot rows, and the cached logits do not change in later
  steps.
- The hybrid engine start prepares the JAX ladder; DeepSeek-V4's prepares
  nothing before its first decode step.
- Either option False keeps the eager step, in both families.
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
from pegainfer_tpu_torch.engine import decode_graphs as dg
from pegainfer_tpu_torch.engine.executor import (DecodePlan, DecodeStepItem, PrefillPlan,
                                                  PrefillStepItem)
from pegainfer_tpu_torch.engine.hybrid_executor import HybridExecutor
from pegainfer_tpu_torch.engine.kv import PagePool
from pegainfer_tpu_torch.engine.scheduler import Scheduler
from pegainfer_tpu_torch.engine.slot_executor import SlotExecutor
from pegainfer_tpu_torch.models import dsv4 as tdsv4
from pegainfer_tpu_torch.models import dsv4_engine
from pegainfer_tpu_torch.models import qwen35 as tq
from pegainfer_tpu_torch.models import qwen35_engine
from pegainfer_tpu_torch.ops.cuda import fp4_chain as k9
from pegainfer_tpu_torch.ops.cuda import int8_chain as k8

PS = 4
NUM_PAGES = 64
SLOTS = 4
MAX_LEN = 64
WAIT_S = 300
MAX_STEPS = 500
# (prompt length, max tokens): decode rows 4, 4, 4, then 3 (bucket 4), 2, 1;
# the last request's table passes 8 pages at its third decode step
REQUESTS = ((5, 4), (9, 6), (14, 12), (30, 16))

Q35_TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=4,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16, vocab_size=128,
                rms_norm_eps=1e-6, rope_theta=1e6, partial_rotary_factor=0.25,
                layer_types=("linear_attention",) * 3 + ("full_attention",),
                linear_num_key_heads=2, linear_num_value_heads=4, linear_key_head_dim=8,
                linear_value_head_dim=8, linear_conv_kernel_dim=4, tie_word_embeddings=True,
                eos_token_id=1, stop_token_ids=(1,), max_position_embeddings=256)
# dim and moe_inter_dim 256: the widths at which the fused chains' gates
# (int8_chain_supported, fp4_chain_supported) take the decode rows
DSV4_TINY = dict(vocab_size=128, dim=256, moe_inter_dim=256, n_layers=3,
                 num_attention_heads=4, head_dim=16, q_lora_rank=16, qk_rope_head_dim=8,
                 o_groups=2, o_lora_rank=8, sliding_window=8, n_routed_experts=8,
                 n_shared_experts=1, n_activated_experts=2, n_hash_layers=1,
                 routed_scaling_factor=1.5, swiglu_limit=7.0, rms_norm_eps=1e-6,
                 index_n_heads=2, index_head_dim=8, index_topk=4, max_position_embeddings=4096,
                 rope_theta=10000.0, compress_rope_theta=10000.0, compress_ratios=(0, 8, 4),
                 yarn_original_seq_len=256, yarn_factor=4.0)


def _prompts(seed=21):
    rng = np.random.default_rng(seed)
    return [rng.integers(8, 128, n).tolist() for n, _ in REQUESTS]


def _drain(mod, chans, timeout):
    out = []
    for ch in chans:
        toks = []
        while True:
            ev = ch.get(timeout=timeout)
            assert ev is not None, "the stream did not end"
            if isinstance(ev, mod.Token):
                toks.append(ev.id)
            elif mod.is_terminal(ev):
                assert isinstance(ev, mod.Finished), ev
                break
        out.append(toks)
    return out


def _submit(mod, handle, prompts):
    chans = []
    for p, (_, m) in zip(prompts, REQUESTS):
        ch = mod.TokenChannel()
        handle.submit(mod.GenerateRequest(prompt_tokens=p, max_tokens=m,
                                          params=mod.SamplingParams(ignore_eos=True),
                                          channel=ch))
        chans.append(ch)
    return chans


# ── module fixtures: the tiny weights, the JAX engine's streams ──────────


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the tiny models' steps are
    thousands of small torch ops, which intra-op threads slow down (about
    10x here, and far more when test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _copy(tree):
    return jax.tree.map(lambda a: a, tree)


@pytest.fixture(scope="module")
def q35_models():
    """{"f32": JAX params, "int8": JAX int8 params} of one tiny hybrid."""
    jcfg = jq.Qwen35Config(**Q35_TINY)
    jparams = jq.init_random_params(jcfg, seed=11, dtype=jnp.float32, scale=0.2)
    return {"f32": jparams, "int8": jq.quantize_params_int8(_copy(jparams))}


@pytest.fixture(scope="module")
def q35_jax_streams(q35_models):
    """The JAX engine's greedy streams of REQUESTS, submitted at once."""
    out = {}
    for mode, params in q35_models.items():
        rt = jq.make_runtime(jq.Qwen35Config(**Q35_TINY), params, num_pages=NUM_PAGES,
                             page_size=PS, max_slots=SLOTS, kv_dtype=jnp.float32,
                             use_pallas=False, flat_decode=False, prefill_mode="grouped")
        handle = j_start_scheduler(JaxExecutor(rt, jc.EngineLoadOptions(
            precompile=False, enable_prefix_cache=False, prefill_chunk=4096, decode_block=1,
            max_batch_size=SLOTS)))
        try:
            out[mode] = _drain(jc, _submit(jc, handle, _prompts()), WAIT_S)
        finally:
            handle.shutdown()
    return out


@pytest.fixture(scope="module")
def dsv4_models():
    """{"fp4": resident params, "int8": int8-expert params} of one tiny
    DeepSeek-V4."""
    cfg = tdsv4.DSv4Config(**DSV4_TINY)
    params = tdsv4.init_random_params(cfg, seed=0, dtype=torch.float32, scale=0.08)
    return {"fp4": tdsv4.quantize_params_resident(params),
            "int8": tdsv4.quantize_params_resident(params, experts="int8")}


# ── the executors stepped by hand ────────────────────────────────────────


# one token a dispatch (the one-token graphs' buffers take every step;
# decode blocks are tests/test_torch_decode_blocks*.py's)
ONE_TOKEN = dict(decode_block=1, decode_block_max=1, decode_pipeline_depth=1)


class Stepped:
    """An executor and its scheduler, stepped by hand, every request
    submitted before the first step; the decode steps' (rows, padded
    arrays) are recorded."""

    def __init__(self, ex):
        self.ex = ex
        self.steps = []
        host = ex._decode_host

        def logged(items, *extra):
            arrays, states = host(items, *extra)
            self.steps.append((len(items), [a.copy() for a in arrays]))
            return arrays, states

        ex._decode_host = logged
        self.handle = tc.EngineHandle()
        self.sched = Scheduler(ex, self.handle)

    def run(self, prompts):
        chans = _submit(tc, self.handle, prompts)
        reqs, _ = self.handle._drain()
        for r in reqs:
            self.sched._ingest(r)
        for _ in range(MAX_STEPS):
            if not self.sched.step():
                break
        return _drain(tc, chans, 1)


def _hybrid(jparams, mode, **opts):
    cfg = tq.Qwen35Config(**Q35_TINY)
    params = tq.params_from_jax(jax.tree.map(np.asarray, jparams))
    if mode == "int8":
        params = tq.quantize_params_int8(params)
    state = tq.make_state(cfg, NUM_PAGES, PS, SLOTS, kv_dtype=torch.float32)
    ex = HybridExecutor(cfg, params, state, tc.EngineLoadOptions(max_batch_size=SLOTS,
                                                                 **ONE_TOKEN, **opts))
    ex.precompile()
    return Stepped(ex)


def _dsv4(params, moe_chain, slots=SLOTS, **opts):
    cfg = tdsv4.DSv4Config(**DSV4_TINY)
    state = tdsv4.make_state(cfg, slots, dsv4_engine.max_blocks_for(cfg, MAX_LEN))
    return SlotExecutor(cfg, params, state, slots, MAX_LEN,
                        tc.EngineLoadOptions(max_batch_size=slots, **ONE_TOKEN, **opts),
                        moe_chain)


def _check_batches(steps, table: bool):
    """The batch went 4 -> 1 through 3 rows in bucket 4 (and, with a table,
    its width crossed 8 -> 16); every padding row was on the dead slot."""
    rows = [n for n, _ in steps]
    assert rows == sorted(rows, reverse=True) and {4, 3, 2, 1} <= set(rows)
    for n, arrays in steps:
        assert (arrays[-1][n:] == SLOTS).all() and (arrays[0][n:] == 0).all()
        assert len(set(arrays[-1][:n].tolist())) == n and (arrays[-1][:n] < SLOTS).all()
    if table:
        assert {(4, 8), (4, 16), (2, 16), (1, 16)} <= {a[2].shape for _, a in steps}


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_hybrid_graphed_engine_matches_jax_and_the_eager_engine(mode, q35_models,
                                                                 q35_jax_streams):
    graphed = _hybrid(q35_models["f32"], mode)
    eager = _hybrid(q35_models["f32"], mode, enable_cuda_graph=False)
    out_g, out_e = graphed.run(_prompts()), eager.run(_prompts())
    assert out_g == q35_jax_streams[mode] and out_e == q35_jax_streams[mode]
    assert [len(t) for t in out_g] == [m for _, m in REQUESTS]
    assert graphed.ex._graphs is not None and eager.ex._graphs is None
    assert graphed.ex._graphs.family == dg.hybrid(SLOTS)
    _check_batches(graphed.steps, table=True)
    assert [n for n, _ in graphed.steps] == [n for n, _ in eager.steps]
    shapes = {a[2].shape for _, a in graphed.steps}
    assert set(graphed.ex._graphs.steps) == {(1, 8), (2, 8), (4, 8)} | shapes
    sg, se = graphed.ex.state, eager.ex.state
    for key in ("rec", "conv"):  # every live slot's rows (the dead one, SLOTS, apart)
        assert torch.equal(sg[key][:, :, :SLOTS], se[key][:, :, :SLOTS]), key
    assert torch.equal(sg["kv"][:, :, 1:], se["kv"][:, :, 1:])  # past the null page


def _live_rows_equal(state_a, state_b, slots=SLOTS):
    return all(torch.equal(a[key][:slots], b[key][:slots])
               for a, b in zip(state_a["layers"], state_b["layers"]) for key in a)


@pytest.mark.parametrize("experts,moe_chain", [("fp4", False), ("fp4", True), ("int8", None),
                                               ("int8", False)],
                         ids=["fp4-chain-off", "fp4-chain-on", "int8-chain-on",
                              "int8-chain-off"])
def test_dsv4_graphed_engine_matches_the_eager_engine(experts, moe_chain, dsv4_models):
    params = dsv4_models[experts]
    lw = params["layers"][0]
    # at these widths a decode batch of up to 4 rows takes the chain
    gate = k8.int8_chain_supported if experts == "int8" else k9.fp4_chain_supported
    assert gate(lw["experts_w1"], lw["experts_w2"], SLOTS * DSV4_TINY["n_activated_experts"])
    graphed = Stepped(_dsv4(params, moe_chain))
    eager = Stepped(_dsv4(params, moe_chain, enable_cuda_graph=False))
    out_g, out_e = graphed.run(_prompts(3)), eager.run(_prompts(3))
    assert out_g == out_e and [len(t) for t in out_g] == [m for _, m in REQUESTS]
    assert graphed.ex._graphs.family == dg.dsv4(SLOTS) and eager.ex._graphs is None
    _check_batches(graphed.steps, table=False)
    assert set(graphed.ex._graphs.steps) == {(4, 0), (2, 0), (1, 0)}
    assert _live_rows_equal(graphed.ex.state, eager.ex.state)


@pytest.mark.parametrize("family", ["qwen35", "dsv4"])
def test_padding_rows_are_written_afresh_on_the_dead_slot(family):
    """New buffers start as padding rows on the dead slot (what a capture's
    warm-up runs over); a batch of 4 rows, then 3 in the same bucket: the
    fourth row is padding on the dead slot again, not the last step's
    row."""
    dead = 7
    fam = dg.hybrid(dead) if family == "qwen35" else dg.dsv4(dead)
    seen = []

    def step(*inputs):
        seen.append([t.clone() for t in inputs])
        return torch.zeros(inputs[0].shape[0], 5)

    graphs = dg.DecodeGraphs(step, torch.device("cpu"), (1, 2, 4), 2, fam)
    st = graphs.prepare(4, 8 if fam.table else 0)
    fresh = dict(zip(fam.args, st.inputs))
    assert fresh["slots"].tolist() == [dead] * 4 and fresh["tokens"].tolist() == [0] * 4
    if fam.table:
        assert (fresh["table"] == PagePool.NULL_PAGE).all()

    def batch(n, base):
        cols = {"tokens": np.array([3, 4, 5, 6][:n] + [0] * (4 - n), np.int32),
                "positions": np.array([base + i for i in range(n)] + [0] * (4 - n), np.int32),
                "seq_lens": np.array([base + 1 + i for i in range(n)] + [0] * (4 - n), np.int32),
                "slots": np.array([2, 0, 3, 1][:n] + [dead] * (4 - n), np.int32),
                "table": np.array([list(range(1 + 8 * i, 9 + 8 * i)) for i in range(n)]
                                  + [[PagePool.NULL_PAGE] * 8] * (4 - n), np.int32)}
        return [cols[a] for a in fam.args]

    graphs.run(*batch(4, 10))
    less = batch(3, 11)
    graphs.run(*less)
    assert list(graphs.steps) == [(4, 8 if fam.table else 0)]  # one set of buffers, reused
    for got, want in zip(seen[1], less):
        assert np.array_equal(got.numpy(), want)
    assert dict(zip(fam.args, seen[1]))["slots"].tolist() == [2, 0, 3, dead]
    off, n = dg.offsets(fam, 4, 8 if fam.table else 0)
    assert st.flat.numel() == n and all(o % dg.ALIGN == 0 for o in off.values())


def test_dsv4_resume_through_the_buffers_matches_the_eager_resume(dsv4_models):
    """P prefilled fresh (its snapshot cached), then P + 5 on another
    request: resumed from the snapshot through 5 steps of the B = 1 buffers,
    with the eager resume's first token and slot rows; the extended
    prompt's cached logits stay as they were through later decode steps."""
    rng = np.random.default_rng(8)
    P = rng.integers(8, 128, 24).tolist()
    ext = P + rng.integers(8, 128, 5).tolist()
    sp = tc.SamplingParams()
    runs = {}
    for graphs in (True, False):
        ex = _dsv4(dsv4_models["fp4"], None, slots=2, enable_cuda_graph=graphs)
        calls = []
        resume = tdsv4.prefill_resume
        tdsv4.prefill_resume = lambda *a, **k: calls.append(1) or resume(*a, **k)
        try:
            ex.execute_prefill(PrefillPlan([PrefillStepItem(0, P, sp)]))
            ex.release_request(0)
            first = ex.execute_prefill(PrefillPlan([PrefillStepItem(1, ext, sp)]))
            tok = first.requests[0].first_token
            _, _, cached = ex.slot_prefix_cache.match(ext)
            kept = cached.clone()
            rows = ex.slot_export(ex._slot(1))
            for _ in range(3):
                tok = ex.execute_decode(DecodePlan([DecodeStepItem(1, tok, sp)])).requests[0].token
        finally:
            tdsv4.prefill_resume = resume
        assert ex.resume_steps == 5 and ex.prefills == 1
        assert len(calls) == (0 if graphs else 1)  # graphed: no eager resume
        assert torch.equal(ex.slot_prefix_cache.match(ext)[2], kept)
        runs[graphs] = (first.requests[0].first_token, rows, kept)
    (tg, rows_g, lg), (te, rows_e, le) = runs[True], runs[False]
    assert tg == te and torch.equal(lg, le)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(rows_g["layers"], rows_e["layers"])
               for k in a)


def _start(family, **opts):
    if family == "qwen35":
        cfg = tq.Qwen35Config(**Q35_TINY)
        return qwen35_engine.start_engine_from_params(
            cfg, tq.init_random_params(cfg, seed=0, dtype=torch.float32),
            tc.EngineLoadOptions(max_num_pages=16, max_batch_size=2, **opts), device="cpu")
    cfg = tdsv4.DSv4Config(**{**DSV4_TINY, "dim": 32, "moe_inter_dim": 16})
    params = tdsv4.quantize_params_resident(
        tdsv4.init_random_params(cfg, seed=0, dtype=torch.float32, scale=0.08))
    return dsv4_engine.start_engine_from_params(
        cfg, params, tc.EngineLoadOptions(max_model_len=MAX_LEN, max_batch_size=2, **opts),
        device="cpu")


def _serve_one(handle, n=4):
    ch = tc.TokenChannel()
    handle.submit(tc.GenerateRequest(prompt_tokens=[9, 10, 11, 12, 13], max_tokens=n,
                                     params=tc.SamplingParams(ignore_eos=True), channel=ch))
    return _drain(tc, [ch], WAIT_S)[0]


@pytest.mark.parametrize("family", ["qwen35", "dsv4"])
def test_engine_start_prepares_the_ladder_or_nothing(family):
    """With the defaults, the hybrid engine prepares every batch bucket up
    to ``bucket_batch(max_batch)`` at width 8 before the scheduler starts
    (the JAX engine's ``precompile``); DeepSeek-V4's prepares nothing (the
    JAX DSv4 engine compiles at first use) until a decode step needs its
    bucket. Either way the decode steps go through the buffers."""
    handle = _start(family)
    ex = handle._scheduler.executor
    try:
        at_start = set(ex._graphs.steps)
        model = ex._decode_model
        ex._decode_model = lambda *a: pytest.fail("the eager step ran")
        toks = _serve_one(handle)
    finally:
        handle.shutdown()
    ex._decode_model = model
    assert ex._graphs.buckets == (1, 2) and len(toks) == 4 and ex.decode_steps == 3
    if family == "qwen35":
        assert at_start == {(1, 8), (2, 8)} == set(ex._graphs.steps)
    else:
        assert at_start == set() and set(ex._graphs.steps) == {(1, 0)}
    assert ex.graph_captures == 0  # nothing to capture on the CPU


@pytest.mark.parametrize("opts", [dict(precompile=True, enable_cuda_graph=False),
                                  dict(precompile=False, enable_cuda_graph=True)],
                         ids=["graph-off", "precompile-off"])
@pytest.mark.parametrize("family", ["qwen35", "dsv4"])
def test_either_option_off_keeps_the_eager_step(family, opts):
    """Each engine with one of the two options off serves a request to its
    end through its eager step (its ``_decode_model`` hook runs every
    step), with no buffers."""
    handle = _start(family, **opts)
    ex = handle._scheduler.executor
    calls = []
    model = ex._decode_model
    ex._decode_model = lambda *a: calls.append(1) or model(*a)
    try:
        toks = _serve_one(handle)
    finally:
        handle.shutdown()
    assert ex._graphs is None and len(toks) == 4 and len(calls) == ex.decode_steps == 3
