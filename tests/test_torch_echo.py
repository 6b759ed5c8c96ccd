"""Echo and prompt logprobs in the port against the JAX package, on the CPU.

- Each executor (``TorchExecutor`` for Qwen3, ``HybridExecutor`` for the
  Qwen3.5 hybrid, ``SlotExecutor`` for DeepSeek-V4) and the JAX
  ``JaxExecutor`` on the same weights prefill the same echo request with
  ``logprobs=2``: its prompt logprobs (None, then each token's given the
  tokens before it), its first token and that token's logprob, at rtol
  1e-4 and atol 1e-5 (``tests/test_chunked_prefill.py``'s tolerance:
  log-softmax of f32 logits summed in another order). Qwen3 and the
  hybrid run whole (``prefill_chunk`` above the prompt), chunked (pieces
  of 16 from page 4, the cache on; the hybrid's fine tail) and in the
  stepper's pieces of 8 under decode load, where no piece takes the decode
  rows offered to it (none is fused); DSv4 prefills whole, as its JAX
  executor does.
- The caches are skipped exactly where the JAX executor skips them: a
  prompt cached by an earlier request is matched for an echo request
  without logprobs and not for one with them (Qwen3's pages, the hybrid's
  snapshots; hits and misses equal the JAX cache's); DSv4's slot cache
  resumes an extension of a cached prompt but not an echo one with
  logprobs, whose snapshot goes in with its last logits.
- Through the engines: ``PromptTokens`` comes first, before any token, with
  the prompt's ids; its logprobs are all None without ``logprobs``.

Weights: Qwen3 as ``tests/test_chunked_prefill.py``'s echo test (2 layers,
hidden 64, seed 3, f32), the hybrid as ``tests/test_torch_qwen35_engine.py``
(period 2, seed 11), DSv4 as ``tests/test_torch_dsv4_cache.py``
(``tests/test_pd_handoff.py``'s config, resident fp8 / fp4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.engine import executor as jx
from pegainfer_tpu.engine.jax_executor import JaxExecutor
from pegainfer_tpu.models import qwen3 as jq3
from pegainfer_tpu.models import qwen35 as jq
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine import executor as tx
from pegainfer_tpu_torch.engine.hybrid_executor import HybridExecutor
from pegainfer_tpu_torch.engine.torch_executor import TorchExecutor
from pegainfer_tpu_torch.models import qwen3 as tq3
from pegainfer_tpu_torch.models import qwen35 as tq
from pegainfer_tpu_torch.models import qwen35_engine as tqengine
from pegainfer_tpu_torch.models import qwen3_engine as t3engine

from test_torch_dsv4_cache import dsv4_models, jax_on, port_executor

PS = 4
PAGES = 64
RTOL, ATOL = 1e-4, 1e-5
WAIT_S = 300
WHOLE = dict(prefill_chunk=4096, enable_prefix_cache=False)
CHUNKED = dict(prefill_chunk=16, prefill_chunk_mixed=8, enable_prefix_cache=True)


def _q3_kw():
    return dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                vocab_size=128, rms_norm_eps=1e-6, rope_theta=1e6,
                tie_word_embeddings=True, eos_token_id=1, stop_token_ids=(1,),
                max_position_embeddings=1024)


def _q35_kw():
    return dict(hidden_size=64, intermediate_size=128, num_hidden_layers=4,
                num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                vocab_size=128, rms_norm_eps=1e-6, rope_theta=1e6,
                partial_rotary_factor=0.25,
                layer_types=("linear_attention", "full_attention") * 2,
                linear_num_key_heads=2, linear_num_value_heads=4,
                linear_key_head_dim=16, linear_value_head_dim=16,
                linear_conv_kernel_dim=4, tie_word_embeddings=False,
                eos_token_id=7, stop_token_ids=(7,), max_position_embeddings=256)


def _executors(family, opts):
    """A JAX executor and the port's on the same f32 weights and options."""
    if family == "qwen3":
        jcfg, tcfg = jq3.Qwen3Config(**_q3_kw()), tq3.Qwen3Config(**_q3_kw())
        jparams = jq3.init_random_params(jcfg, seed=3, dtype=jnp.float32)
        rt = jq3.make_runtime(jcfg, jparams, num_pages=PAGES, page_size=PS,
                              kv_dtype=jnp.float32, use_pallas=False)
        jex = JaxExecutor(rt, jc.EngineLoadOptions(**opts))
        tparams = tq3.params_from_jax(jax.tree.map(np.asarray, jparams))
        tex = TorchExecutor(tcfg, tparams,
                            tq3.make_kv_pages(tcfg, PAGES, PS, dtype=torch.float32),
                            tc.EngineLoadOptions(**opts))
        return jex, tex
    jcfg, tcfg = jq.Qwen35Config(**_q35_kw()), tq.Qwen35Config(**_q35_kw())
    jparams = jq.init_random_params(jcfg, seed=11, dtype=jnp.float32, scale=0.2)
    rt = jq.make_runtime(jcfg, jparams, num_pages=PAGES, page_size=PS, max_slots=2,
                         kv_dtype=jnp.float32, use_pallas=False, flat_decode=False,
                         prefill_mode="grouped")
    jex = JaxExecutor(rt, jc.EngineLoadOptions(precompile=False, max_batch_size=2,
                                               decode_block=1, **opts))
    tparams = tq.params_from_jax(jax.tree.map(np.asarray, jparams))
    tex = HybridExecutor(tcfg, tparams, tq.make_state(tcfg, PAGES, PS, 2,
                                                      kv_dtype=torch.float32),
                         tc.EngineLoadOptions(max_batch_size=2, **opts))
    return jex, tex


def _mods(ex):
    return jx if isinstance(ex, JaxExecutor) else tx


def _prefill(ex, rid, prompt, echo=True, logprobs=2):
    m = _mods(ex)
    item = m.PrefillStepItem(request_id=rid, prompt_tokens=list(prompt),
                             params=m.SamplingParams(ignore_eos=True), logprobs=logprobs,
                             echo=echo)
    res = ex.execute_prefill(m.PrefillPlan(requests=[item], echo=echo)).requests[0]
    ex.release_request(rid)
    return res


def _step_under_decode_load(ex, rid, prompt):
    """An echo request with logprobs through ``prefill_stepper`` as the
    scheduler drives it while streams decode (``decode_active``, decode rows
    offered before every piece): no piece takes the rows (none is fused);
    the scheduler then decodes apart. Returns (result, pieces)."""
    m = _mods(ex)
    item = m.PrefillStepItem(request_id=rid, prompt_tokens=list(prompt),
                             params=m.SamplingParams(ignore_eos=True), logprobs=2, echo=True)
    assert ex.supports_chunked_prefill(item)
    gen, offered, pieces = ex.prefill_stepper(item), ["decode rows"], 0
    while True:
        ex.decode_active, ex.mixed_items = True, offered
        pieces += 1
        try:
            next(gen)
        except StopIteration as done:
            res = done.value
            break
        finally:
            assert ex.mixed_items is offered and getattr(ex, "mixed_pending", None) is None
    ex.decode_active, ex.mixed_items = False, None
    ex.release_request(rid)
    return res, pieces


def _assert_same(got, want, T):
    """Two prefill results of one echo request with logprobs."""
    assert len(got.prompt_logprobs) == len(want.prompt_logprobs) == T
    assert got.prompt_logprobs[0] is None and want.prompt_logprobs[0] is None
    np.testing.assert_allclose([t.logprob for t in got.prompt_logprobs[1:]],
                               [t.logprob for t in want.prompt_logprobs[1:]],
                               rtol=RTOL, atol=ATOL)
    assert got.first_token == want.first_token
    np.testing.assert_allclose(got.first_token_logprob.logprob,
                               want.first_token_logprob.logprob, rtol=RTOL, atol=ATOL)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(8, 127, n).tolist()


@pytest.mark.parametrize("mode", ["whole", "chunked", "under_decode_load"])
@pytest.mark.parametrize("family", ["qwen3", "qwen35"])
def test_prompt_logprobs_match_jax(family, mode):
    """A 53-token echo request with logprobs: whole, in pieces of 16 (the
    port's stepper ran, each piece with all its logits), or in the mixed
    pieces of 8 that decode load asks for, never fused with the rows
    offered."""
    jex, tex = _executors(family, WHOLE if mode == "whole" else CHUNKED)
    prompt = _prompt(9, 53)
    if mode == "under_decode_load":
        (want, jpieces), (got, pieces) = (_step_under_decode_load(ex, 1, prompt)
                                          for ex in (jex, tex))
        assert pieces == jpieces == 6
    else:
        want, got = _prefill(jex, 1, prompt), _prefill(tex, 1, prompt)
    _assert_same(got, want, len(prompt))
    want_counts = {"whole": (0, 1), "chunked": (4, 0), "under_decode_load": (6, 0)}[mode]
    assert (tex.chunk_pieces, tex.prefills) == want_counts and tex.mixed_pieces == 0


@pytest.mark.parametrize("family", ["qwen3", "qwen35"])
def test_echo_skips_the_prefix_cache_as_jax_does(family):
    """P cached by a plain request; P again as an echo request with
    logprobs (no lookup: every prompt row's logits are needed) and as one
    without (a hit): the caches' hits and misses equal the JAX cache's, and
    the echo request's logprobs the JAX ones."""
    jex, tex = _executors(family, CHUNKED)
    prompt = _prompt(10, 40)
    counts = []
    for ex in (jex, tex):
        first = _prefill(ex, 1, prompt, echo=False, logprobs=0)
        with_lps = _prefill(ex, 2, prompt)
        hits_after_echo = ex.prefix_cache.hits
        no_lps = _prefill(ex, 3, prompt, logprobs=0)
        counts.append((hits_after_echo, ex.prefix_cache.hits, ex.prefix_cache.misses))
        assert no_lps.prompt_logprobs is None
        assert no_lps.first_token == with_lps.first_token == first.first_token
        if ex is jex:
            want = with_lps
    _assert_same(with_lps, want, len(prompt))
    assert counts[0] == counts[1] and counts[1][0] == 0 and counts[1][1] == 1


def test_dsv4_prompt_logprobs_match_jax():
    """DSv4 (whole, with all its logits) against the JAX executor, both with
    the slot cache on and cold."""
    jex, tex = jax_on(cache=True), port_executor(cache=True)
    prompt = _prompt(11, 24)
    want = _prefill(jex, 1, prompt)
    got = _prefill(tex, 1, prompt)
    _assert_same(got, want, len(prompt))
    assert tex.prefills == 1


def test_dsv4_echo_skips_the_slot_cache_resume_as_jax_does():
    """P served with logprobs (its snapshot kept with its logits); P + 4
    tokens as an echo request with logprobs: no lookup, a fresh prefill
    (no resume steps), its snapshot inserted with its last logits; P + 4
    again as a plain request: the identical prompt skips its forward. Hits,
    misses and the inserted logits as the JAX executor's."""
    _, tcfg, _, _ = dsv4_models("fp4")
    jex, tex = jax_on(cache=True), port_executor(cache=True)
    prompt = _prompt(12, 24)
    longer = prompt + _prompt(13, 4)
    out = []
    for ex in (jex, tex):
        _prefill(ex, 1, prompt, echo=False, logprobs=1)
        echoed = _prefill(ex, 2, longer)
        after_echo = (ex.slot_prefix_cache.hits, ex.slot_prefix_cache.misses)
        again = _prefill(ex, 3, longer, echo=False, logprobs=1)
        _, logits = ex.slot_prefix_cache._entries[tuple(longer)]
        out.append((echoed, again, after_echo, np.asarray(logits)))
    (jecho, jagain, jcounts, jlogits), (techo, tagain, tcounts, tlogits) = out
    _assert_same(techo, jecho, len(longer))
    assert tcounts == jcounts == (0, 1) and tex.resume_steps == 0 and tex.prefills == 2
    assert tagain.first_token == jagain.first_token == techo.first_token
    assert tlogits.shape == (tcfg.vocab_size,)
    np.testing.assert_allclose(tlogits, jlogits, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("logprobs", [0, 1])
@pytest.mark.parametrize("family", ["qwen3", "qwen35"])
def test_engine_sends_prompt_tokens_first(family, logprobs):
    """Through ``start_engine_from_params`` (chunks of 64 on the port's page
    of 64, so the 150-token prompt runs as pieces): after ``Scheduled``,
    ``PromptTokens`` with the prompt's ids comes before any token; its
    logprobs are None for the first and, with ``logprobs``, numbers after
    (all None without); then the tokens and ``Finished``."""
    if family == "qwen3":
        cfg, engine = tq3.Qwen3Config(**_q3_kw()), t3engine
        params = tq3.init_random_params(cfg, seed=0, dtype=torch.float32)
        opts = {}
    else:
        cfg, engine = tq.Qwen35Config(**_q35_kw()), tqengine
        params = tq.init_random_params(cfg, seed=0, dtype=torch.float32)
        opts = dict(max_batch_size=2)
    handle = engine.start_engine_from_params(
        cfg, params, tc.EngineLoadOptions(max_num_pages=16, prefill_chunk=64, **opts),
        device="cpu")
    prompt = _prompt(14, 150)
    try:
        ch = tc.TokenChannel()
        handle.submit(tc.GenerateRequest(prompt_tokens=prompt, max_tokens=3, echo=True,
                                         logprobs=logprobs, channel=ch,
                                         params=tc.SamplingParams(ignore_eos=True)))
        events = []
        while not events or not tc.is_terminal(events[-1]):
            events.append(ch.get(timeout=WAIT_S))
            assert events[-1] is not None, "engine produced no event in time"
        ex = handle._scheduler.executor
    finally:
        handle.shutdown()
    kinds = [type(ev).__name__ for ev in events]
    assert kinds == ["Scheduled", "PromptTokens", "Token", "Token", "Token", "Finished"]
    pt = events[1]
    assert pt.ids == prompt and len(pt.logprobs) == len(prompt) and pt.logprobs[0] is None
    if logprobs:
        assert all(isinstance(t.logprob, float) and t.logprob <= 0 for t in pt.logprobs[1:])
    else:
        assert all(t is None for t in pt.logprobs)
    assert ex.chunk_pieces == 3
