"""The port's graphed decode step (``precompile`` / ``enable_cuda_graph``,
``engine/decode_graphs.py``) and its power-of-two table widths, on the CPU.

On the CPU nothing is captured: the executor fills the same static
buffers it replays a graph over on the card and calls the forward on them,
so these tests hold the buffer logic (widths, padding rows, reuse) against
the JAX package and against the eager step. Tiny Qwen3 (2 layers, hidden
64, page 4, f32), the JAX engine and executor with the XLA attention path;
the JAX engine's streams are computed once a module.

- The two options exist with the JAX defaults.
- ``bucket_pow2`` and the table cap are the JAX executor's, over a sweep
  and on executors built alike.
- Four requests of different lengths make the decode batch go 4 -> 2 -> 1
  (through a batch of 3 in bucket 4) and the table width cross 8 -> 16:
  the engine with the options on gives the JAX engine's greedy streams and
  the streams of a port engine with ``enable_cuda_graph=False``; the pools
  of the two port runs are equal past the null page (a padding row that
  wrote a live page would show there), in bf16-free f32 and in int8.
- Padding rows are written afresh when a batch shrinks inside its bucket.
- Either option False keeps the eager step. The hybrid's and DeepSeek-V4's
  graphed steps are tests/test_torch_decode_graphs_slots.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.engine import jax_executor as jxe
from pegainfer_tpu.engine.scheduler import start_scheduler as j_start_scheduler
from pegainfer_tpu.models import qwen3 as jq3
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine import torch_executor as tex
from pegainfer_tpu_torch.engine.decode_graphs import DecodeGraphs, layout
from pegainfer_tpu_torch.engine.kv import PagePool
from pegainfer_tpu_torch.engine.scheduler import Scheduler
from pegainfer_tpu_torch.models import qwen3 as tq3
from pegainfer_tpu_torch.models import qwen3_engine as tengine

PS = 4
NUM_PAGES = 64
MAX_BATCH = 4
WAIT_S = 300
MAX_STEPS = 500
# (prompt length, max tokens): decode rows 4, 4, 4, then 3 (bucket 4), 2, 1;
# the last request's table passes 8 pages at its third decode step
REQUESTS = ((5, 4), (9, 6), (14, 12), (30, 16))


def _cfg_kw():
    return dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                vocab_size=128, rms_norm_eps=1e-6, rope_theta=1e6,
                tie_word_embeddings=True, eos_token_id=1, stop_token_ids=(1,),
                max_position_embeddings=256)


def _prompts():
    rng = np.random.default_rng(21)
    return [rng.integers(8, 128, n).tolist() for n, _ in REQUESTS]


@pytest.fixture(scope="module")
def models():
    """(JAX params, JAX int8 params) of one tiny Qwen3."""
    jcfg = jq3.Qwen3Config(**_cfg_kw())
    jparams = jq3.init_random_params(jcfg, seed=5, dtype=jnp.float32)
    j8 = jq3.quantize_params_int8(jax.tree.map(lambda a: a, jparams))
    return jparams, j8


def _jax_streams(params):
    """The JAX engine's greedy streams of REQUESTS, submitted at once."""
    rt = jq3.make_runtime(jq3.Qwen3Config(**_cfg_kw()), params, num_pages=NUM_PAGES,
                          page_size=PS, kv_dtype=jnp.float32, use_pallas=False)
    handle = j_start_scheduler(jxe.JaxExecutor(rt, jc.EngineLoadOptions(
        precompile=False, max_batch_size=MAX_BATCH, prefill_chunk=4096)))
    try:
        chans = []
        for p, (_, m) in zip(_prompts(), REQUESTS):
            ch = jc.TokenChannel()
            handle.submit(jc.GenerateRequest(prompt_tokens=p, max_tokens=m,
                                             params=jc.SamplingParams(ignore_eos=True),
                                             channel=ch))
            chans.append(ch)
        out = []
        for ch in chans:
            toks = []
            while True:
                ev = ch.get(timeout=WAIT_S)
                assert ev is not None, "engine produced no event in time"
                if isinstance(ev, jc.Token):
                    toks.append(ev.id)
                elif jc.is_terminal(ev):
                    assert isinstance(ev, jc.Finished), ev
                    break
            out.append(toks)
        return out
    finally:
        handle.shutdown()


@pytest.fixture(scope="module")
def jax_streams(models):
    return {"f32": _jax_streams(models[0]), "int8": _jax_streams(models[1])}


class Stepped:
    """The port's executor (started as ``start_engine_from_params`` starts
    it: ``precompile`` first) and scheduler, stepped by hand, every request
    submitted before the first step; the decode steps' (rows, B, P) are
    recorded. It decodes one token a dispatch, each read before the next
    (``decode_block``, ``decode_block_max`` and ``decode_pipeline_depth``
    1), so each step goes through the one-token graph's buffers; blocks are
    tests/test_torch_decode_blocks*.py's."""

    def __init__(self, jparams, **opts):
        cfg = tq3.Qwen3Config(**_cfg_kw())
        params = tq3.params_from_jax(jax.tree.map(np.asarray, jparams))
        if opts.get("quantize") == "int8":
            params = tq3.quantize_params_int8(params)
        self.ex = tex.TorchExecutor(
            cfg, params, tq3.make_kv_pages(cfg, NUM_PAGES, PS, dtype=torch.float32),
            tc.EngineLoadOptions(max_batch_size=MAX_BATCH, decode_block=1, decode_block_max=1,
                                 decode_pipeline_depth=1, **opts))
        self.ex.precompile()
        self.shapes = []
        host = self.ex._decode_host

        def logged(items, *extra):
            arrays, states = host(items, *extra)
            self.shapes.append((len(items),) + arrays[2].shape)
            return arrays, states

        self.ex._decode_host = logged
        self.handle = tc.EngineHandle()
        self.sched = Scheduler(self.ex, self.handle)

    def run(self):
        chans = []
        for p, (_, m) in zip(_prompts(), REQUESTS):
            ch = tc.TokenChannel()
            self.handle.submit(tc.GenerateRequest(prompt_tokens=p, max_tokens=m,
                                                  params=tc.SamplingParams(ignore_eos=True),
                                                  channel=ch))
            chans.append(ch)
        reqs, _ = self.handle._drain()
        for r in reqs:
            self.sched._ingest(r)
        for _ in range(MAX_STEPS):
            if not self.sched.step():
                break
        out = []
        for ch in chans:
            toks = []
            while True:
                ev = ch.get(timeout=1)
                assert ev is not None, "the stream did not end"
                if isinstance(ev, tc.Token):
                    toks.append(ev.id)
                elif tc.is_terminal(ev):
                    assert isinstance(ev, tc.Finished), ev
                    break
            out.append(toks)
        return out


def test_graph_options_have_the_jax_defaults():
    j, t = jc.EngineLoadOptions(), tc.EngineLoadOptions()
    assert (t.precompile, t.enable_cuda_graph) == (j.precompile, j.enable_cuda_graph)
    assert t.precompile is True and t.enable_cuda_graph is True


@pytest.mark.parametrize("hi", [8, 16, 64, 1024, 4096])
def test_bucket_pow2_is_the_jax_one(hi):
    for n in range(0, 600):
        assert tex.bucket_pow2(n, 8, hi) == jxe.bucket_pow2(n, 8, hi), n


@pytest.mark.parametrize("num_pages,max_len,chunk", [
    (16, 256, 16), (64, 256, 64), (128, 1024, 2048), (1000, 1024, 64), (40, 4096, 128)])
def test_table_cap_is_the_jax_executors(num_pages, max_len, chunk):
    """Both executors built on one pool size, model length and chunk."""
    kw = {**_cfg_kw(), "max_position_embeddings": max_len}
    jcfg, tcfg = jq3.Qwen3Config(**kw), tq3.Qwen3Config(**kw)
    jparams = jq3.init_random_params(jcfg, seed=1, dtype=jnp.float32)
    rt = jq3.make_runtime(jcfg, jparams, num_pages=num_pages, page_size=PS,
                          kv_dtype=jnp.float32, use_pallas=False)
    jex = jxe.JaxExecutor(rt, jc.EngineLoadOptions(precompile=False, prefill_chunk=chunk))
    ex = tex.TorchExecutor(tcfg, tq3.params_from_jax(jax.tree.map(np.asarray, jparams)),
                           tq3.make_kv_pages(tcfg, num_pages, PS, dtype=torch.float32),
                           tc.EngineLoadOptions(prefill_chunk=chunk))
    assert ex.max_request_pages() == jex.max_request_pages()
    assert ex._table_cap == jex._table_cap
    # no chunk: no chunk of slack
    assert tex.table_cap(ex.max_request_pages(), 0, PS) == tex.bucket_pow2(
        ex.max_request_pages(), 8, 1 << 30)


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_graphed_engine_matches_jax_and_the_eager_engine(mode, models, jax_streams):
    opts = dict(quantize="int8") if mode == "int8" else {}
    graphed = Stepped(models[0], **opts)
    eager = Stepped(models[0], enable_cuda_graph=False, **opts)
    out_g, out_e = graphed.run(), eager.run()
    assert out_g == jax_streams[mode] and out_e == jax_streams[mode]
    assert [len(t) for t in out_g] == [m for _, m in REQUESTS]
    # the path: the buffers' step took every decode step, the batch went
    # 4 -> 2 -> 1 through 3 rows in bucket 4, the width crossed 8 -> 16
    assert graphed.ex._graphs is not None and eager.ex._graphs is None
    assert graphed.shapes == eager.shapes
    rows = [r for r, _, _ in graphed.shapes]
    assert rows == sorted(rows, reverse=True) and {4, 3, 2, 1} <= set(rows)
    assert {(4, 8), (4, 16), (2, 16), (1, 16)} <= {(B, P) for _, B, P in graphed.shapes}
    assert set(graphed.ex._graphs.steps) == {(1, 8), (2, 8), (4, 8)} | {
        (B, P) for _, B, P in graphed.shapes}
    assert graphed.ex.graph_captures == 0  # nothing to capture on the CPU
    # every live page alike: the padding rows wrote the null page only
    assert torch.equal(graphed.ex.kv_pages[:, :, 1:], eager.ex.kv_pages[:, :, 1:])


def test_padding_rows_are_written_afresh():
    """A batch of 4 rows, then 3 in the same bucket: the fourth row of the
    static buffers is padding again (token 0, position 0, seq_len 0, null
    pages), not the last step's row."""
    seen = []

    def step(tokens, positions, tables, seq_lens):
        seen.append([t.clone() for t in (tokens, positions, tables, seq_lens)])
        return torch.zeros(tokens.shape[0], 5)

    graphs = DecodeGraphs(step, torch.device("cpu"), (1, 2, 4), 2)
    full = (np.array([3, 4, 5, 6], np.int32), np.array([10, 11, 12, 13], np.int32),
            np.arange(1, 33, dtype=np.int32).reshape(4, 8), np.array([11, 12, 13, 14], np.int32))
    graphs.run(*full)
    less = (np.array([3, 4, 5, 0], np.int32), np.array([11, 12, 13, 0], np.int32),
            np.array([list(range(1, 9))] * 3 + [[PagePool.NULL_PAGE] * 8], np.int32),
            np.array([12, 13, 14, 0], np.int32))
    graphs.run(*less)
    assert list(graphs.steps) == [(4, 8)]  # one set of buffers, reused
    for got, want in zip(seen[1], less):
        assert np.array_equal(got.numpy(), want)
    assert seen[1][2][3].tolist() == [PagePool.NULL_PAGE] * 8
    pos, lens, tab, n = layout(4, 8)
    assert graphs.steps[(4, 8)].flat.numel() == n and tab % 16 == 0 and pos % 16 == 0


@pytest.mark.parametrize("opts", [dict(precompile=True, enable_cuda_graph=False),
                                  dict(precompile=False, enable_cuda_graph=True)])
def test_either_option_off_keeps_the_eager_step(opts, models):
    cfg = tq3.Qwen3Config(**_cfg_kw())
    params = tq3.params_from_jax(jax.tree.map(np.asarray, models[0]))
    handle = tengine.start_engine_from_params(
        cfg, params, tc.EngineLoadOptions(max_num_pages=NUM_PAGES, **opts), device="cpu")
    ex = handle._scheduler.executor
    calls = []
    model = ex._decode_model
    ex._decode_model = lambda *a: calls.append(1) or model(*a)
    try:
        ch = tc.TokenChannel()
        handle.submit(tc.GenerateRequest(prompt_tokens=[9, 10, 11], max_tokens=4,
                                         params=tc.SamplingParams(ignore_eos=True), channel=ch))
        toks = []
        while True:
            ev = ch.get(timeout=WAIT_S)
            assert ev is not None
            if isinstance(ev, tc.Token):
                toks.append(ev.id)
            elif tc.is_terminal(ev):
                break
    finally:
        handle.shutdown()
    assert ex._graphs is None and len(toks) == 4 and len(calls) == ex.decode_steps == 3


def test_engine_start_prepares_the_jax_ladder(models):
    """``start_engine_from_params`` with the defaults: the buffers of every
    batch bucket up to ``bucket_batch(max_batch)`` at width 8 before the
    scheduler starts (the JAX executor's ``precompile``)."""
    cfg = tq3.Qwen3Config(**_cfg_kw())
    params = tq3.params_from_jax(jax.tree.map(np.asarray, models[0]))
    handle = tengine.start_engine_from_params(
        cfg, params, tc.EngineLoadOptions(max_num_pages=NUM_PAGES, max_batch_size=3),
        device="cpu")
    try:
        ex = handle._scheduler.executor
        assert set(ex._graphs.steps) == {(1, 8), (2, 8), (4, 8)}
        assert ex._graphs.buckets == (1, 2, 4)
    finally:
        handle.shutdown()
