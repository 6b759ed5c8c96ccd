"""The port's Qwen3.5 engine (HybridExecutor + its scheduler, on the CPU)
against the JAX engine (JaxExecutor on ``q35.make_runtime``'s grouped
runtime) on the same tiny f32 weights; checkpoint loading; the chunk and
cache options it serves and the options it refuses."""

import json

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
from pegainfer_tpu_torch.engine.hybrid_executor import HybridExecutor
from pegainfer_tpu_torch.models import qwen35 as tq
from pegainfer_tpu_torch.models import qwen35_engine as tengine

WAIT_S = 300


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
                eos_token_id=7, stop_token_ids=(7,), max_position_embeddings=256)


def _collect(mod, handle, prompts, max_tokens, ignore_eos=False):
    """Submit all prompts at once, greedy; return each stream's token ids
    and terminal event."""
    chans = []
    for p in prompts:
        ch = mod.TokenChannel()
        handle.submit(mod.GenerateRequest(
            prompt_tokens=p, max_tokens=max_tokens,
            params=mod.SamplingParams(ignore_eos=ignore_eos), channel=ch))
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


def _record_slot_events(ex):
    """Log the executor's prefills (request, slot) and releases in order."""
    events = []
    prefill, release = ex._prefill_model, ex.release_request

    def logged_prefill(item, tokens, table):
        out = prefill(item, tokens, table)
        events.append(("prefill", item.request_id, ex._slots[item.request_id]))
        return out

    def logged_release(request_id):
        events.append(("release", request_id, ex._slots.get(request_id)))
        release(request_id)

    ex._prefill_model, ex.release_request = logged_prefill, logged_release
    return events


def test_engine_greedy_streams_match_jax_engine():
    """Three prompts on two state slots: every greedy stream equals the JAX
    engine's (EOS included), and the third request is prefilled only after
    one of the first two released its slot, into a slot they freed."""
    kw = _cfg_kw()
    jcfg, tcfg = jq.Qwen35Config(**kw), tq.Qwen35Config(**kw)
    jparams = jq.init_random_params(jcfg, seed=11, dtype=jnp.float32, scale=0.2)
    tparams = tq.params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(4)
    # prompt lengths in one JAX prefill bucket (13..16) keep its compiles few
    prompts = [rng.integers(8, 128, n).tolist() for n in (13, 16, 14)]
    max_tokens = [12, 6, 9]

    rt = jq.make_runtime(jcfg, jparams, num_pages=64, page_size=4, max_slots=2,
                         kv_dtype=jnp.float32, use_pallas=False, flat_decode=False,
                         prefill_mode="grouped")
    jhandle = j_start_scheduler(JaxExecutor(rt, jc.EngineLoadOptions(
        precompile=False, enable_prefix_cache=False, prefill_chunk=4096, decode_block=1,
        max_batch_size=2)))
    try:
        ref = [_collect(jc, jhandle, [p], m)[0] for p, m in zip(prompts, max_tokens)]
        ref_all = _collect(jc, jhandle, prompts, 10)
    finally:
        jhandle.shutdown()

    thandle = tengine.start_engine_from_params(
        tcfg, tparams, tc.EngineLoadOptions(max_batch_size=2, max_num_pages=64), device="cpu")
    ex = thandle._scheduler.executor
    assert isinstance(ex, HybridExecutor) and ex.free_slots() == 2
    try:
        out = [_collect(tc, thandle, [p], m)[0] for p, m in zip(prompts, max_tokens)]
        events = _record_slot_events(ex)
        out_all = _collect(tc, thandle, prompts, 10)
        assert ex.free_slots() == 2 and ex.prefills == 6 and ex.decode_steps > 0
    finally:
        thandle.shutdown()

    for (rtoks, rfin), (otoks, ofin) in zip(ref + ref_all, out + out_all):
        assert isinstance(rfin, jc.Finished) and isinstance(ofin, tc.Finished)
        assert otoks == rtoks
        assert ofin.finish_reason.value == rfin.finish_reason.value
        assert ofin.completion_tokens == rfin.completion_tokens
    assert sum(len(t) for t, _ in out_all) > 3 * len(out_all)
    rids = sorted({rid for kind, rid, _ in events if kind == "prefill"})
    third = next(i for i, e in enumerate(events) if e[:2] == ("prefill", rids[2]))
    freed = [e[2] for e in events[:third] if e[0] == "release" and e[1] in rids[:2]]
    assert freed and events[third][2] in freed


def _write_checkpoint(tmp_path):
    """A tiny HF Qwen3NextForCausalLM checkpoint (config.json,
    generation_config.json, model.safetensors), as tests/
    test_model_path_load.py writes one. Returns its state dict."""
    transformers = pytest.importorskip("transformers")
    from safetensors import numpy as st_numpy

    hf = transformers.Qwen3NextConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=32, rms_norm_eps=1e-6,
        rope_theta=1e6, partial_rotary_factor=0.25, tie_word_embeddings=False,
        max_position_embeddings=512, layer_types=["linear_attention", "full_attention"] * 2,
        linear_num_key_heads=2, linear_num_value_heads=4, linear_key_head_dim=16,
        linear_value_head_dim=16, linear_conv_kernel_dim=4, num_experts=0, eos_token_id=0,
        attn_implementation="eager")
    torch.manual_seed(1)
    model = transformers.Qwen3NextForCausalLM(hf).eval()
    cfg = hf.to_dict()
    cfg["architectures"] = [type(model).__name__]
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    (tmp_path / "generation_config.json").write_text(json.dumps({"eos_token_id": 0}))
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    st_numpy.save_file(sd, str(tmp_path / "model.safetensors"))
    return sd


def test_start_engine_serves_a_checkpoint(tmp_path):
    """``start_engine(path)`` reads the config (as the JAX
    ``from_model_path`` does) and the safetensors in bf16, and streams the
    tokens of ``start_engine_from_params`` on the same state dict."""
    sd = _write_checkpoint(tmp_path)
    path = str(tmp_path)
    assert tengine.probe_model(path) and not tengine.probe_model(str(tmp_path / "none"))
    cfg = tq.Qwen35Config.from_model_path(path)
    jcfg = jq.Qwen35Config.from_model_path(path)
    assert cfg == tq.Qwen35Config(**{f: getattr(jcfg, f)
                                     for f in tq.Qwen35Config.__dataclass_fields__})
    opts = tc.EngineLoadOptions(max_batch_size=2, max_num_pages=16)
    prompt = np.random.default_rng(5).integers(2, 256, 12).tolist()

    handle = tengine.start_engine(path, opts, device="cpu")
    try:
        params = handle._scheduler.executor.params
        assert params["lin"]["wq"].dtype == torch.bfloat16
        assert params["lin"]["A_log"].dtype == torch.float32
        (disk, fin), = _collect(tc, handle, [prompt], 8, ignore_eos=True)
    finally:
        handle.shutdown()
    mem = tengine.start_engine_from_params(
        cfg, tq.params_from_state_dict(cfg, sd, dtype=torch.bfloat16), opts, device="cpu")
    try:
        (ref, _), = _collect(tc, mem, [prompt], 8, ignore_eos=True)
    finally:
        mem.shutdown()
    assert isinstance(fin, tc.Finished) and len(disk) == 8 and disk == ref


@pytest.mark.parametrize("option", [
    dict(prefill_chunk=64, enable_prefix_cache=False), dict(enable_prefix_cache=True),
    dict(enable_prefix_cache=True, prefill_chunk=64)])
def test_chunk_and_cache_options_serve(option):
    """The options the engine refused before its chunked prefill and hybrid
    cache were ported now start it and finish a request through the
    chunked path (a 100-token prompt in pieces of 64). The cache without a
    chunk size keeps the port's rule (ValueError: it continues a cached
    prefix through the chunked path) and serves with the default chunk,
    the JAX engine's 2,048."""
    tcfg = tq.Qwen35Config(**_cfg_kw())
    params = tq.init_random_params(tcfg, seed=0, dtype=torch.float32)
    if "prefill_chunk" not in option:
        with pytest.raises(ValueError, match="prefill_chunk"):
            tengine.start_engine_from_params(tcfg, params, tc.EngineLoadOptions(
                max_num_pages=8, max_batch_size=2, prefill_chunk=None, **option),
                device="cpu")
        assert tc.EngineLoadOptions().prefill_chunk == 2048
    opts = tc.EngineLoadOptions(max_num_pages=16, max_batch_size=2, **option)
    handle = tengine.start_engine_from_params(tcfg, params, opts, device="cpu")
    try:
        ex = handle._scheduler.executor
        assert ex._hybrid_cache == opts.enable_prefix_cache
        prompt = np.random.default_rng(3).integers(8, 128, 100).tolist()
        (toks, fin), = _collect(tc, handle, [prompt], 4, ignore_eos=True)
        assert ex.chunk_pieces == (2 if opts.prefill_chunk == 64 else 0)
        assert ex.free_slots() == 2
    finally:
        handle.shutdown()
    assert isinstance(fin, tc.Finished) and len(toks) == 4


@pytest.mark.parametrize("option", [dict(quantize="int8-experts"), dict(decode_block=2)])
def test_refused_options_raise(option):
    """int8 experts raise, naming Qwen3.5; ``decode_block=2``, refused
    before decode blocks were ported, serves the JAX engine's greedy
    streams under the same option."""
    tcfg = tq.Qwen35Config(**_cfg_kw())
    if "decode_block" in option:
        jcfg = jq.Qwen35Config(**_cfg_kw())
        jparams = jq.init_random_params(jcfg, seed=11, dtype=jnp.float32, scale=0.2)
        prompts = [np.random.default_rng(4).integers(8, 128, n).tolist() for n in (13, 16)]
        rt = jq.make_runtime(jcfg, jparams, num_pages=64, page_size=4, max_slots=2,
                             kv_dtype=jnp.float32, use_pallas=False, flat_decode=False,
                             prefill_mode="grouped")
        jhandle = j_start_scheduler(JaxExecutor(rt, jc.EngineLoadOptions(
            precompile=False, enable_prefix_cache=False, prefill_chunk=4096,
            max_batch_size=2, **option)))
        try:
            ref = _collect(jc, jhandle, prompts, 9)
        finally:
            jhandle.shutdown()
        thandle = tengine.start_engine_from_params(
            tcfg, tq.params_from_jax(jax.tree.map(np.asarray, jparams)),
            tc.EngineLoadOptions(max_batch_size=2, max_num_pages=64, **option), device="cpu")
        ex = thandle._scheduler.executor
        try:
            out = _collect(tc, thandle, prompts, 9)
        finally:
            thandle.shutdown()
        assert [t for t, _ in out] == [t for t, _ in ref]
        assert ex.decode_block == 2 and ex.decode_blocks < ex.decode_steps
        return
    params = tq.init_random_params(tcfg, seed=0, dtype=torch.float32)
    opts = tc.EngineLoadOptions(max_num_pages=8, max_batch_size=2, **option)
    with pytest.raises(NotImplementedError, match="Qwen3.5"):
        tengine.start_engine_from_params(tcfg, params, opts, device="cpu")
    state = tq.make_state(tcfg, 8, 4, 2, kv_dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        HybridExecutor(tcfg, params, state, opts)


def test_echo_request_ends_in_error_and_frees_its_slot():
    """An echo request with logprobs is served (no Error): ``PromptTokens``
    with the prompt's logprobs comes before its tokens, its slot is freed
    when it ends, and the engine serves the next request with both slots
    free after."""
    tcfg = tq.Qwen35Config(**_cfg_kw())
    params = tq.init_random_params(tcfg, seed=0, dtype=torch.float32)
    handle = tengine.start_engine_from_params(
        tcfg, params, tc.EngineLoadOptions(max_num_pages=16, max_batch_size=2), device="cpu")
    try:
        ch = tc.TokenChannel()
        handle.submit(tc.GenerateRequest(prompt_tokens=[9, 10, 11], max_tokens=3,
                                         echo=True, logprobs=1, channel=ch,
                                         params=tc.SamplingParams(ignore_eos=True)))
        events = [ch.get(timeout=WAIT_S)]
        while events[-1] is not None and not tc.is_terminal(events[-1]):
            events.append(ch.get(timeout=WAIT_S))
        (toks, fin), = _collect(tc, handle, [[9, 10, 11]], 3, ignore_eos=True)
        assert handle._scheduler.executor.free_slots() == 2
    finally:
        handle.shutdown()
    kinds = [type(ev).__name__ for ev in events]
    assert kinds == ["Scheduled", "PromptTokens", "Token", "Token", "Token", "Finished"]
    assert events[1].ids == [9, 10, 11] and events[1].logprobs[0] is None
    assert all(t.logprob <= 0 for t in events[1].logprobs[1:])
    assert [ev.id for ev in events if isinstance(ev, tc.Token)] == toks
    assert isinstance(fin, tc.Finished) and len(toks) == 3


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    """Without ``device``, on a machine without CUDA, the entry points raise
    rather than running on the CPU; ``device="cpu"`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = tq.Qwen35Config(**_cfg_kw())
    params = tq.init_random_params(tcfg, seed=0, dtype=torch.float32)
    opts = tc.EngineLoadOptions(max_num_pages=8, max_batch_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.start_engine_from_params(tcfg, params, opts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.start_engine("/nonexistent/model")
    with pytest.raises(ValueError, match="max_num_pages"):
        tengine.compute_num_pages(tcfg, 64, 0.5, 2, torch.device("cpu"))
    handle = tengine.start_engine_from_params(tcfg, params, opts, device="cpu")
    handle.shutdown()


def test_slot_state_bytes():
    """One slot's state at the JAX ``bench_config`` (24 GDN layers of 32
    heads x 128 x 128 f32 plus a 4 x 8,192 window): 53.5 MB; a KV page of 64
    tokens over its 8 full layers, 1 MiB in bf16."""
    cfg = tq.bench_config()
    jcfg = jq.bench_config()
    assert cfg == tq.Qwen35Config(**{f: getattr(jcfg, f)
                                     for f in tq.Qwen35Config.__dataclass_fields__})
    assert tq.slot_bytes(cfg) == 24 * (32 * 128 * 128 + 4 * 8192) * 4
    state = tq.make_state(tq.Qwen35Config(**_cfg_kw()), 4, 4, 3)
    small = tq.Qwen35Config(**_cfg_kw())
    assert (state["rec"][:, :, 0].numel() + state["conv"][:, :, 0].numel()) * 4 == \
        tq.slot_bytes(small)
    assert state["rec"].shape[2] == 4  # 3 slots + the dead one
    assert tq.kv_bytes_per_page(cfg, 64) == jq.kv_bytes_per_page(jcfg, 64) == 1 << 20
