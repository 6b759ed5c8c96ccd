"""The port's engine (TorchExecutor + its scheduler, on the CPU) against the
JAX engine (JaxExecutor with the XLA attention path) on the same tiny
weights, plus the port's import and device rules."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.engine.jax_executor import JaxExecutor
from pegainfer_tpu.engine.scheduler import start_scheduler as j_start_scheduler
from pegainfer_tpu.models import qwen3 as jq3
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine.torch_executor import TorchExecutor
from pegainfer_tpu_torch.models import qwen3 as tq3
from pegainfer_tpu_torch.models import qwen3_engine as tengine
from pegainfer_tpu_torch.utils.device import resolve_device

PORT = pathlib.Path(__file__).resolve().parents[1] / "pegainfer_tpu_torch"
EOS = 7
WAIT_S = 300


def _cfg_kw():
    return dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                vocab_size=128, rms_norm_eps=1e-6, rope_theta=1e6,
                tie_word_embeddings=False, eos_token_id=EOS, stop_token_ids=(EOS,),
                max_position_embeddings=256)


def _collect(mod, handle, prompts, max_tokens):
    """Submit all prompts at once, greedy; return each stream's token ids
    and terminal event."""
    chans = []
    for p in prompts:
        ch = mod.TokenChannel()
        handle.submit(mod.GenerateRequest(prompt_tokens=p, max_tokens=max_tokens,
                                          params=mod.SamplingParams(), channel=ch))
        chans.append(ch)
    out = []
    for ch in chans:
        toks, fin = [], None
        while fin is None:
            ev = ch.get(timeout=WAIT_S)
            assert ev is not None, "engine produced no event in time"
            if isinstance(ev, mod.Token):
                toks.append(ev.id)
            elif mod.is_terminal(ev):
                fin = ev
        out.append((toks, fin))
    return out


def test_engine_greedy_streams_match_jax_engine():
    jcfg, tcfg = jq3.Qwen3Config(**_cfg_kw()), tq3.Qwen3Config(**_cfg_kw())
    jparams = jq3.init_random_params(jcfg, seed=11, dtype=jnp.float32, scale=0.2)
    tparams = tq3.params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(8, 128, n).tolist() for n in (6, 23, 13)]

    rt = jq3.make_runtime(jcfg, jparams, num_pages=128, page_size=4,
                          kv_dtype=jnp.float32, use_pallas=False)
    jhandle = j_start_scheduler(JaxExecutor(rt))
    try:
        ref = _collect(jc, jhandle, prompts, max_tokens=10)
    finally:
        jhandle.shutdown()

    thandle = tengine.start_engine_from_params(
        tcfg, tparams, tc.EngineLoadOptions(max_num_pages=32), device="cpu")
    try:
        out = _collect(tc, thandle, prompts, max_tokens=10)
        ex = thandle._scheduler.executor
        assert isinstance(ex, TorchExecutor) and ex.prefills == 3 and ex.decode_steps > 0
    finally:
        thandle.shutdown()

    for (rt_toks, rfin), (ot_toks, ofin) in zip(ref, out):
        assert isinstance(rfin, jc.Finished) and isinstance(ofin, tc.Finished)
        assert ot_toks == rt_toks
        assert ofin.finish_reason.value == rfin.finish_reason.value
        assert ofin.completion_tokens == rfin.completion_tokens
    assert sum(len(t) for t, _ in out) > len(out)  # more than first tokens


def test_executor_sampling_and_logprobs_match_jax_executor():
    """Both executors driven step by step with the same plans: greedy,
    temperature, top-k and top-p rows with the same random_val draws give
    the same tokens, and requested logprobs agree (atol 1e-4)."""
    from pegainfer_tpu.engine import executor as jx
    from pegainfer_tpu_torch.engine import executor as tx

    jcfg, tcfg = jq3.Qwen3Config(**_cfg_kw()), tq3.Qwen3Config(**_cfg_kw())
    jparams = jq3.init_random_params(jcfg, seed=12, dtype=jnp.float32, scale=0.2)
    tparams = tq3.params_from_jax(jax.tree.map(np.asarray, jparams))
    rt = jq3.make_runtime(jcfg, jparams, num_pages=64, page_size=4,
                          kv_dtype=jnp.float32, use_pallas=False)
    jex = JaxExecutor(rt)
    tex = TorchExecutor(tcfg, tparams, tq3.make_kv_pages(tcfg, 16, 64, dtype=torch.float32))
    rng = np.random.default_rng(6)
    sampling = [dict(), dict(temperature=0.8), dict(temperature=1.0, top_k=5),
                dict(temperature=1.2, top_p=0.7)]
    logprobs = [0, 2, 0, 3]
    prompts = [rng.integers(8, 128, n).tolist() for n in (5, 9, 12, 7)]

    def prefill_items(mod, xmod, rands):
        return [xmod.PrefillStepItem(request_id=i, prompt_tokens=p,
                                     params=mod.SamplingParams(**sp), logprobs=lp,
                                     random_val=r)
                for i, (p, sp, lp, r) in enumerate(zip(prompts, sampling, logprobs, rands))]

    def compare(jres, tres):
        """Each side: [(token, TokenLogprob | None)] per request."""
        assert [t for t, _ in tres] == [t for t, _ in jres]
        for (_, jl), (_, tl) in zip(jres, tres):
            assert (jl is None) == (tl is None)
            if jl is not None:
                assert tl.logprob == pytest.approx(jl.logprob, abs=1e-4)
                assert [i for i, _ in tl.top_logprobs] == [i for i, _ in jl.top_logprobs]
                np.testing.assert_allclose([v for _, v in tl.top_logprobs],
                                           [v for _, v in jl.top_logprobs],
                                           rtol=0, atol=1e-4)

    rands = rng.uniform(size=4).tolist()
    jp = jex.execute_prefill(jx.PrefillPlan(prefill_items(jc, jx, rands))).requests
    tp = tex.execute_prefill(tx.PrefillPlan(prefill_items(tc, tx, rands))).requests
    compare([(r.first_token, r.first_token_logprob) for r in jp],
            [(r.first_token, r.first_token_logprob) for r in tp])
    toks = [r.first_token for r in jp]
    for _ in range(5):
        rands = rng.uniform(size=4).tolist()

        def decode_items(mod, xmod):
            return [xmod.DecodeStepItem(request_id=i, token_id=t,
                                        params=mod.SamplingParams(**sp), logprobs=lp,
                                        random_val=r)
                    for i, (t, sp, lp, r) in enumerate(zip(toks, sampling, logprobs, rands))]

        jd = jex.execute_decode(jx.DecodePlan(decode_items(jc, jx))).requests
        td = tex.execute_decode(tx.DecodePlan(decode_items(tc, tx))).requests
        compare([(r.token, r.logprob) for r in jd], [(r.token, r.logprob) for r in td])
        toks = [r.token for r in jd]
    assert tex.decode_steps == 5 and tex.prefills == 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_matches_jax(seed):
    """The port's copy of the full-lifetime admission rule decides as the
    JAX package's does."""
    from types import SimpleNamespace as NS

    from pegainfer_tpu.engine import kv as jkv
    from pegainfer_tpu_torch.engine import kv as tkv

    rng = np.random.default_rng(seed)
    active = [NS(prompt_len=int(rng.integers(1, 300)), max_tokens=int(rng.integers(1, 200)),
                 generated_count=int(rng.integers(0, 50))) for _ in range(4)]
    deferred = [NS(prompt_len=int(rng.integers(1, 900)), max_tokens=int(rng.integers(1, 400)))
                for _ in range(12)]
    for avail in (0, 10, 40, 200):
        args = (deferred, active, 16, avail, 48)
        j, t = jkv.admit_deferred_requests(*args), tkv.admit_deferred_requests(*args)
        assert (t.pending, t.deferred, t.rejected) == (j.pending, j.deferred, j.rejected)


def test_engine_rejects_a_request_larger_than_the_pool():
    tcfg = tq3.Qwen3Config(**_cfg_kw())
    params = tq3.init_random_params(tcfg, seed=0, dtype=torch.float32)
    handle = tengine.start_engine_from_params(
        tcfg, params, tc.EngineLoadOptions(max_num_pages=3), device="cpu")
    try:
        (toks, fin), = _collect(tc, handle, [list(range(8, 140))], max_tokens=4)
    finally:
        handle.shutdown()
    assert toks == [] and isinstance(fin, tc.Rejected)


def test_echo_request_ends_in_error_not_silently():
    """Echo is not ported yet: the request gets an Error event naming it,
    and the engine keeps serving the next request."""
    tcfg = tq3.Qwen3Config(**_cfg_kw())
    params = tq3.init_random_params(tcfg, seed=0, dtype=torch.float32)
    handle = tengine.start_engine_from_params(
        tcfg, params, tc.EngineLoadOptions(max_num_pages=16), device="cpu")
    try:
        ch = tc.TokenChannel()
        handle.submit(tc.GenerateRequest(prompt_tokens=[9, 10, 11], max_tokens=3,
                                         echo=True, channel=ch))
        ev = ch.get(timeout=WAIT_S)
        while ev is not None and not tc.is_terminal(ev):
            ev = ch.get(timeout=WAIT_S)
        (toks, fin), = _collect(tc, handle, [[9, 10, 11]], max_tokens=3)
    finally:
        handle.shutdown()
    assert isinstance(ev, tc.Error) and "NotImplementedError" in ev.message
    assert isinstance(fin, tc.Finished) and len(toks) == 3


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "pegainfer_tpu"), f"{f}: imports {name}"


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    """Called without ``device`` on a machine without CUDA, an entry point
    raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = tq3.Qwen3Config(**_cfg_kw())
    params = tq3.init_random_params(tcfg, seed=0, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.start_engine_from_params(tcfg, params, tc.EngineLoadOptions(max_num_pages=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.start_engine("/nonexistent/model")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("option", [dict(quantize="int8"), dict(enable_prefix_cache=True),
                                    dict(prefill_chunk=256), dict(decode_block=4)])
def test_unsupported_options_raise(option):
    tcfg = tq3.Qwen3Config(**_cfg_kw())
    params = tq3.init_random_params(tcfg, seed=0, dtype=torch.float32)
    kv = tq3.make_kv_pages(tcfg, 8, 4, dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        TorchExecutor(tcfg, params, kv, tc.EngineLoadOptions(**option))
