"""The PyTorch port's DeepSeek-V4 model and engine against the JAX package,
on the CPU.

Params come from the JAX package's ``init_random_params(dtype=float32)``
made resident by its ``quantize_params_resident`` (fp8 linears, packed-fp4
experts) and carried over by ``params_from_jax``. On the CPU the port's
kernel wrappers run their plain versions, whose numerics (bf16 x, exact
bf16 weights, f32 sums) are those of the JAX package's XLA path. The
models run in f32, but the routed experts round their inputs to bf16 as
the kernels do: an f32 difference of 1e-7 from another summation order can
move one input across a bf16 rounding boundary, one bf16 ulp (2^-8
relative) of that element, and the next layers carry it on. Hence atol
2e-2 on logits of magnitude about 3, and 1e-2 on the slot caches (about 1
at the seed's widths), where an error of the port would be of order 1.

Configs: tests/test_dsv4_model.py's tiny one (dense, non-overlap and
overlap + indexer layers, hash and score gates) and
tests/test_pallas_kernels.py's dim-256 one.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.engine.jax_executor import JaxExecutor
from pegainfer_tpu.engine.scheduler import start_scheduler as j_start_scheduler
from pegainfer_tpu.models import dsv4 as jdsv4
from pegainfer_tpu.models import dsv4_engine as jengine
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine import executor as tx
from pegainfer_tpu_torch.engine.scheduler import Scheduler
from pegainfer_tpu_torch.engine.slot_executor import SlotExecutor
from pegainfer_tpu_torch.models import dsv4 as tdsv4
from pegainfer_tpu_torch.models import dsv4_engine as tengine

LOGIT_TOL = dict(rtol=0, atol=2e-2)
CACHE_TOL = dict(rtol=0, atol=1e-2)
WAIT_S = 300

TINY = dict(vocab_size=128, dim=32, moe_inter_dim=16, n_layers=3, num_attention_heads=4,
            head_dim=16, q_lora_rank=16, qk_rope_head_dim=8, o_groups=2, o_lora_rank=8,
            sliding_window=8, n_routed_experts=8, n_shared_experts=1, n_activated_experts=2,
            n_hash_layers=1, routed_scaling_factor=1.5, swiglu_limit=7.0, rms_norm_eps=1e-6,
            index_n_heads=2, index_head_dim=8, index_topk=4, max_position_embeddings=4096,
            rope_theta=10000.0, compress_rope_theta=10000.0, compress_ratios=(0, 8, 4),
            yarn_original_seq_len=256, yarn_factor=4.0)
WIDE = dict(vocab_size=128, dim=256, moe_inter_dim=256, n_layers=2, num_attention_heads=8,
            head_dim=32, q_lora_rank=32, qk_rope_head_dim=16, o_groups=8, o_lora_rank=8,
            sliding_window=8, n_routed_experts=8, n_shared_experts=1, n_activated_experts=2,
            n_hash_layers=1, routed_scaling_factor=1.5, swiglu_limit=7.0, rms_norm_eps=1e-6,
            index_n_heads=8, index_head_dim=32, index_topk=4, max_position_embeddings=4096,
            rope_theta=1e4, compress_rope_theta=1e4, compress_ratios=(0, 4),
            yarn_original_seq_len=256, yarn_factor=4.0)
CONFIGS = {"tiny": (TINY, 0, 0.08), "wide": (WIDE, 9, 0.08)}


def _models(name):
    kw, seed, scale = CONFIGS[name]
    jcfg, tcfg = jdsv4.DSv4Config(**kw), tdsv4.DSv4Config(**kw)
    jparams = jdsv4.quantize_params_resident(
        jdsv4.init_random_params(jcfg, seed=seed, dtype=jnp.float32, scale=scale))
    tparams = tdsv4.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    return _models(request.param)


def _i32(*xs):
    return jnp.asarray(xs, jnp.int32), torch.tensor(xs, dtype=torch.int32)


def test_port_init_and_quantization_equal_jax_params():
    jcfg, tcfg, jparams, tparams = _models("tiny")
    mine = tdsv4.quantize_params_resident(tdsv4.init_random_params(tcfg, seed=0,
                                                                   dtype=torch.float32,
                                                                   scale=0.08))
    flat_j = jax.tree_util.tree_flatten_with_path(tparams)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == torch.float8_e4m3fn:
            a, b = a.view(torch.uint8), b.view(torch.uint8)
        assert torch.equal(a, b), path


def test_prefill_logits_and_caches_match_jax(models):
    jcfg, tcfg, jparams, tparams = models
    toks = np.random.default_rng(0).integers(2, jcfg.vocab_size, 16).astype(np.int32)
    jl, jcaches = jdsv4.prefill(jcfg, jparams, jnp.asarray(toks))
    tl, tcaches = tdsv4.prefill(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    last, _ = tdsv4.prefill(tcfg, tparams, torch.from_numpy(toks), last_only=True)
    np.testing.assert_allclose(last.numpy(), np.asarray(jl)[-1:], **LOGIT_TOL)
    for jcache, tcache in zip(jcaches, tcaches):
        for key in ("kv", "ckv", "ick"):
            if jcache[key] is None:
                assert tcache[key] is None
            else:
                np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                           **CACHE_TOL)


@pytest.mark.parametrize("T_pre", [12, 13])
def test_seeded_slot_and_decode_steps_match_jax(models, T_pre):
    """Prefill into slot 1 (slot caches after _seed_state), then two decode
    steps at batch 2 with a dead-slot row, against the JAX package."""
    jcfg, tcfg, jparams, tparams = models
    toks = np.random.default_rng(T_pre).integers(2, jcfg.vocab_size, T_pre + 2)
    jstate = jdsv4.make_state(jcfg, max_slots=2, max_blocks=8)
    tstate = tdsv4.make_state(tcfg, max_slots=2, max_blocks=8)
    jl, jstate = jdsv4.prefill(jcfg, jparams, jnp.asarray(toks[:T_pre], jnp.int32),
                               state=jstate, slot=jnp.int32(1))
    tl, tstate = tdsv4.prefill(tcfg, tparams, torch.tensor(toks[:T_pre], dtype=torch.int32),
                               state=tstate, slot=1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for jls, tls in zip(jstate["layers"], tstate["layers"]):
        assert sorted(jls) == sorted(tls)
        for key in jls:
            np.testing.assert_allclose(tls[key].numpy(), np.asarray(jls[key]), **CACHE_TOL)
    for step in range(2):
        pos = T_pre + step
        (jt, tt), (jp, tp), (js, ts) = _i32(int(toks[pos]), 0), _i32(pos, 0), _i32(1, 2)
        jstate, jlog = jdsv4.decode(jcfg, jparams, jstate, jt, jp, js)
        tlog = tdsv4.decode(tcfg, tparams, tstate, tt, tp, ts)
        np.testing.assert_allclose(tlog[0].numpy(), np.asarray(jlog)[0], **LOGIT_TOL)
    for jls, tls in zip(jstate["layers"], tstate["layers"]):
        for key in jls:  # the live slot; the dead slot holds garbage
            np.testing.assert_allclose(tls[key][1].numpy(), np.asarray(jls[key])[1],
                                       **CACHE_TOL)


def test_model_routes_through_the_kernel_wrappers(monkeypatch):
    """The routed experts take K5 from 8 tokens on and K3 below, and with
    ``plain_kernels`` the plain versions; on the CPU the wrappers add no
    launches."""
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
    from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5

    _, tcfg, _, tparams = _models("tiny")
    calls = []

    def logged(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    for mod, name in ((k3, "moe_fp4_gemv"), (k5, "moe_fp4_grouped"),
                      (k3, "moe_fp4_gemv_plain"), (k5, "moe_fp4_grouped_plain")):
        monkeypatch.setattr(mod, name, logged(name, getattr(mod, name)))
    toks = torch.arange(2, 12, dtype=torch.int32)
    state = tdsv4.make_state(tcfg, 1, 8)
    tdsv4.prefill(tcfg, tparams, toks, state=state, slot=0)
    # the wrapper, then (a CPU tensor) its plain version, per projection
    assert calls == ["moe_fp4_grouped", "moe_fp4_grouped_plain"] * 3 * tcfg.n_layers
    calls.clear()
    tdsv4.decode(tcfg, tparams, state, *(torch.tensor([x], dtype=torch.int32)
                                         for x in (5, 10, 0)), plain_kernels=True)
    assert calls == ["moe_fp4_gemv_plain"] * 3 * tcfg.n_layers
    assert k3.launches == 0 and k5.launches == 0


# ── the engine ───────────────────────────────────────────────────────────


def _collect(mod, handle, prompts, max_tokens):
    chans = []
    for p in prompts:
        ch = mod.TokenChannel()
        handle.submit(mod.GenerateRequest(prompt_tokens=p, max_tokens=max_tokens,
                                          params=mod.SamplingParams(ignore_eos=True),
                                          channel=ch))
        chans.append(ch)
    out = []
    for ch in chans:
        toks, fin, sched = [], None, None
        while fin is None:
            ev = ch.get(timeout=WAIT_S)
            assert ev is not None, "engine produced no event in time"
            if isinstance(ev, mod.Token):
                toks.append(ev.id)
            elif isinstance(ev, mod.Scheduled):
                sched = ev.scheduled_at_unix_s
            elif mod.is_terminal(ev):
                fin = ev
        out.append((toks, fin, sched))
    return out


def test_engine_greedy_streams_match_jax_engine():
    """Three requests on two slots: the third waits for a slot in both
    engines, and every greedy stream is the same."""
    jcfg, tcfg, jparams, tparams = _models("tiny")
    rng = np.random.default_rng(4)
    # prompt lengths in one JAX prefill bucket (9..16) keep its compiles few
    prompts = [rng.integers(2, 128, n).tolist() for n in (9, 15, 12)]
    rt = jengine.make_runtime(jcfg, jparams, max_model_len=64, max_slots=2)
    jhandle = j_start_scheduler(JaxExecutor(rt, jc.EngineLoadOptions(precompile=False)))
    try:
        ref = _collect(jc, jhandle, prompts, max_tokens=8)
    finally:
        jhandle.shutdown()

    thandle = tengine.start_engine_from_params(
        tcfg, tparams, tc.EngineLoadOptions(max_batch_size=2, max_model_len=64),
        device="cpu")
    ex = thandle._scheduler.executor
    events = _record_slot_events(ex)
    try:
        out = _collect(tc, thandle, prompts, max_tokens=8)
        assert isinstance(ex, SlotExecutor) and ex.prefills == 3
        assert ex.free_slots() == 2
    finally:
        thandle.shutdown()

    for (rtoks, rfin, _), (otoks, ofin, _) in zip(ref, out):
        assert isinstance(rfin, jc.Finished) and isinstance(ofin, tc.Finished)
        assert len(otoks) == ofin.completion_tokens == 8
        assert otoks == rtoks
    # the third request was prefilled only after one of the first two ended
    assert events.index(("prefill", 2)) > events.index(("release", 0))


def _record_slot_events(ex):
    """Wrap an executor's prefill and release to log their order."""
    events = []
    prefill_one, release = ex._prefill_one, ex.release_request

    def logged_prefill(item):
        events.append(("prefill", item.request_id))
        return prefill_one(item)

    def logged_release(request_id):
        events.append(("release", request_id))
        release(request_id)

    ex._prefill_one, ex.release_request = logged_prefill, logged_release
    return events


class _SlotStub:
    """A page-rich executor with a fixed number of state slots."""

    def __init__(self, slots):
        self.slots = slots
        self.prefilled = []

    def page_size(self):
        return 1

    def available_pages(self):
        return 1 << 20

    def max_request_pages(self):
        return 1 << 20

    def free_slots(self):
        return self.slots

    def is_stop_token(self, token_id):
        return False

    def release_request(self, request_id):
        pass

    def execute_prefill(self, plan):
        self.prefilled += [it.request_id for it in plan.requests]
        return tx.PrefillResult(requests=[
            tx.PrefillRequestResult(request_id=it.request_id, first_token=3)
            for it in plan.requests])


@pytest.mark.parametrize("slots", [0, 1, 2])
def test_scheduler_defers_what_exceeds_free_slots(slots):
    handle = tc.EngineHandle()
    ex = _SlotStub(slots)
    sched = Scheduler(ex, handle)
    for _ in range(3):
        sched._ingest(tc.GenerateRequest(prompt_tokens=[5, 6, 7], max_tokens=1,
                                         channel=tc.TokenChannel()))
    sched.step()
    assert ex.prefilled == list(range(slots))
    assert [r.request_id for r in sched.deferred] == list(range(slots, 3))


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, tparams = _models("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.start_engine_from_params(tcfg, tparams, tc.EngineLoadOptions())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.start_engine("/nonexistent/model")
    with pytest.raises(NotImplementedError, match="checkpoint loader"):
        tengine.start_engine("/nonexistent/model", device="cpu")


@pytest.mark.parametrize("option", [dict(quantize="bf16"), dict(enable_prefix_cache=True),
                                    dict(prefill_chunk=256), dict(decode_block=4)])
def test_unsupported_options_raise(option):
    _, tcfg, _, tparams = _models("tiny")
    with pytest.raises(NotImplementedError):
        tengine.start_engine_from_params(tcfg, tparams, tc.EngineLoadOptions(**option),
                                         device="cpu")


def test_unported_expert_formats_raise():
    _, tcfg, _, _ = _models("tiny")
    plain = tdsv4.init_random_params(tcfg, seed=1, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="packed-fp4 or int8"):
        tdsv4.prefill(tcfg, plain, torch.arange(2, 12, dtype=torch.int32))


def test_echo_request_ends_in_error_not_silently():
    _, tcfg, _, tparams = _models("tiny")
    handle = tengine.start_engine_from_params(
        tcfg, tparams, tc.EngineLoadOptions(max_model_len=64), device="cpu")
    try:
        ch = tc.TokenChannel()
        handle.submit(tc.GenerateRequest(prompt_tokens=[9, 10, 11], max_tokens=3,
                                         echo=True, channel=ch))
        ev = ch.get(timeout=WAIT_S)
        while ev is not None and not tc.is_terminal(ev):
            ev = ch.get(timeout=WAIT_S)
        (toks, fin, _), = _collect(tc, handle, [[9, 10, 11, 12]], max_tokens=3)
    finally:
        handle.shutdown()
    assert isinstance(ev, tc.Error) and "NotImplementedError" in ev.message
    assert isinstance(fin, tc.Finished) and len(toks) == 3
    assert handle._scheduler.executor.free_slots() == 2


def test_port_imports_no_ml_dtypes():
    """The card's machine has no ml_dtypes: the port encodes E2M1 itself
    and takes fp8 from torch."""
    import ast
    import pathlib

    port = pathlib.Path(__file__).resolve().parents[1] / "pegainfer_tpu_torch"
    for f in sorted(port.rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "ml_dtypes" for n in names), f
