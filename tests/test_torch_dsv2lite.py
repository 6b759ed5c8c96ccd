"""The PyTorch port's DeepSeek-V2-Lite (``pegainfer_tpu_torch/models/
dsv2lite.py``) against the JAX package and HF transformers, on the CPU.

The weights are tests/test_dsv2lite.py's ``hf_tiny`` (2 layers, the first
dense, 8 experts top-2 + 2 shared, kv_lora_rank 32, f32), carried into the
JAX tree by its ``params_from_state_dict`` and into the port by
``params_from_jax``. Both packages then compute in f32 with the same
products, only summed in another order (f32 rounding, about 1e-7 of a
value), so logits of magnitude about 1 are held to 1e-4, and HF's to the
JAX test's 2e-3. Greedy streams must be equal. Where both run in bf16 (the
MoE forms in bf16, the checkpoint's engines) the tolerances are stated at
each test.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.engine import executor as jx
from pegainfer_tpu.engine.jax_executor import JaxExecutor
from pegainfer_tpu.engine.scheduler import start_scheduler as j_start_scheduler
from pegainfer_tpu.models import dsv2lite as jv2
from pegainfer_tpu.server import main as jmain
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine import decode_graphs as dg
from pegainfer_tpu_torch.engine import executor as tx
from pegainfer_tpu_torch.engine import pd as tpd
from pegainfer_tpu_torch.engine.slot_executor import SlotExecutor
from pegainfer_tpu_torch.models import dsv2lite as tv2
from pegainfer_tpu_torch.server import main as tmain
from tests.test_dsv2lite import hf_tiny, jx_cfg_from_hf

LOGIT_TOL = dict(rtol=0, atol=1e-4)  # f32 against f32, another summation order
HF_TOL = dict(rtol=0, atol=2e-3)  # tests/test_dsv2lite.py's
WAIT_S = 300
MAX_LEN = 64
# the JAX functions jitted once (an unjitted call dispatches op by op)
j_prefill = jax.jit(jv2.prefill, static_argnums=0, static_argnames="return_all_logits")
j_decode = jax.jit(jv2.decode, static_argnums=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (the JAX compiles run beside torch's pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(HF config, HF model, JAX config, JAX f32 params, port config, port
    params, the HF state dict as numpy)."""
    hf, model = hf_tiny()
    jcfg = jx_cfg_from_hf(hf)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    jparams = jv2.params_from_state_dict(jcfg, sd, dtype=jnp.float32)
    tcfg = tv2.DSv2LiteConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    tparams = tv2.params_from_jax(jax.tree.map(np.asarray, jparams))
    return hf, model, jcfg, jparams, tcfg, tparams, sd


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(2, 128, n).tolist()


def _collect(mod, handle, prompts, max_tokens):
    """Greedy streams of ``prompts``, submitted at once."""
    def drain(ch):
        toks = []
        while True:
            ev = ch.get(timeout=WAIT_S)
            assert ev is not None, "engine produced no event in time"
            if isinstance(ev, mod.Token):
                toks.append(ev.id)
            elif mod.is_terminal(ev):
                assert isinstance(ev, mod.Finished), ev
                return toks

    chans = []
    for p in prompts:
        ch = mod.TokenChannel()
        handle.submit(mod.GenerateRequest(prompt_tokens=p, max_tokens=max_tokens,
                                          params=mod.SamplingParams(ignore_eos=True),
                                          channel=ch))
        chans.append(ch)
    return [drain(ch) for ch in chans]


# ── configuration and parameters ────────────────────────────────────────


def _config_cases(hf):
    base = {**hf.to_dict(), "architectures": ["DeepseekV2ForCausalLM"]}
    return {"hf": base, "eos_list": {**base, "eos_token_id": [5, 6]},
            "rope_scaling": {**base, "rope_scaling": {"type": "yarn", "factor": 40}},
            "q_lora": {**base, "q_lora_rank": 64},
            "not_v2": {**base, "model_type": "deepseek_v3"}}


@pytest.mark.parametrize("case", ["hf", "eos_list", "rope_scaling", "q_lora", "not_v2"])
def test_config_and_probe_match_jax(tiny, case, tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(_config_cases(tiny[0])[case]))
    path = str(tmp_path)
    assert tv2.probe_model(path) == jv2.probe_model(path)
    assert not tv2.probe_model(str(tmp_path / "missing"))
    try:
        want = jv2.DSv2LiteConfig.from_model_path(path)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tv2.DSv2LiteConfig.from_model_path(path)
        assert str(got.value) == str(e)
        return
    got = tv2.DSv2LiteConfig.from_model_path(path)
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == {
        f: getattr(want, f) for f in want.__dataclass_fields__}
    assert got.qk_head_dim == want.qk_head_dim
    assert tmain.detect_model_type(path) == jmain.detect_model_type(path) == "dsv2lite"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_random_params_draws_as_jax(tiny, dtype):
    jcfg, tcfg = tiny[2], tiny[4]
    want = tv2.params_from_jax(jax.tree.map(np.asarray, jv2.init_random_params(
        jcfg, seed=3, dtype=getattr(jnp, dtype), scale=0.1)))
    got = tv2.init_random_params(tcfg, seed=3, dtype=getattr(torch, dtype), scale=0.1)
    flat_w, flat_g = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (want, got))
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert g.dtype == w.dtype and torch.equal(g, w), path
    assert tv2.params_bytes(got) == sum(w.numel() * w.element_size() for _, w in flat_w)


def test_init_random_device_is_seeded_and_shaped(tiny):
    tcfg, tparams = tiny[4], tiny[5]
    a, b = (tv2.init_random_device(tcfg, torch.Generator().manual_seed(5), "cpu")
            for _ in range(2))
    flat_a, flat_t = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (a, tparams))
    assert [p for p, _ in flat_a] == [p for p, _ in flat_t]
    for (path, x), (_, t) in zip(flat_a, flat_t):
        assert x.dtype == torch.bfloat16 and x.shape == t.shape, path
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    # projections keep about the RMS of their input
    w = a["moe"]["experts_w2"].float()
    assert abs(w.std().item() * w.shape[-1] ** 0.5 - 1) < 0.1


# ── the forward ─────────────────────────────────────────────────────────


def test_f32_rows_split_exactly_into_three_bf16_parts():
    """``split_bf16`` (the card's f32-by-bf16 products): the parts add up to
    x exactly over a wide range of magnitudes, and their three products
    with bf16 weights (each exact in f32; here in f32 on the CPU) summed
    give the f32 product to f32 rounding."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 7, 256), generator=g) * torch.exp2(torch.randint(
        -40, 40, (4, 7, 1), generator=g).float())
    parts = tv2.split_bf16(x)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    assert torch.equal(sum(p.double() for p in parts), x.double())
    w = torch.randn((4, 256, 9), generator=g).to(torch.bfloat16)
    three = sum(torch.bmm(p.float(), w.float()) for p in parts)
    want = torch.bmm(x.double(), w.double())
    scale = torch.bmm(x.abs().double(), w.abs().double())
    assert ((three.double() - want).abs() <= 1e-6 * scale).all()


@pytest.mark.parametrize("T", [5, 12])
def test_prefill_logits_and_rows_match_jax_and_hf(tiny, T):
    """Every row's logits against the JAX ``prefill`` and HF; the slot's
    latent rows against the JAX state's. At T 5 the port's routed experts
    take the gathered form (the JAX call at T 5 the dense one), at 12 both
    the grouped form."""
    _, model, jcfg, jparams, tcfg, tparams, _ = tiny
    toks = np.asarray(_prompt(3, T), np.int32)
    jstate, jlast, jall = j_prefill(jcfg, jparams, jv2.make_state(jcfg, 2, 32),
                                      jnp.asarray(toks), jnp.int32(T), jnp.int32(1),
                                      return_all_logits=True)
    tstate = tv2.make_state(tcfg, 2, 32)
    last, every = tv2.prefill(tcfg, tparams, torch.from_numpy(toks), tstate, 1,
                              return_all_logits=True)
    np.testing.assert_allclose(every.numpy(), np.asarray(jall), **LOGIT_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **LOGIT_TOL)
    only, none = tv2.prefill(tcfg, tparams, torch.from_numpy(toks))  # the head on one row
    assert none is None
    np.testing.assert_allclose(only.numpy(), last.numpy(), rtol=0, atol=1e-6)
    with torch.no_grad():
        want = model(torch.from_numpy(toks)[None].long()).logits[0].numpy()
    np.testing.assert_allclose(every.numpy(), want, **HF_TOL)
    for key in ("ckv", "kr"):
        np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]), rtol=0,
                                   atol=1e-5)
        assert not tstate[key][:, 0].any() and not tstate[key][:, 1, T:].any()


def test_decode_logits_match_jax_step_by_step(tiny):
    """Two prompts in slots 1 and 0 (11 and 7 tokens), then three steps of a
    batch of three: both at their own positions and a padding row on the
    dead slot (2) at position 0; the live rows' logits and slot rows against
    the JAX ``decode``."""
    _, _, jcfg, jparams, tcfg, tparams, _ = tiny
    prompts = {1: _prompt(4, 11), 0: _prompt(5, 7)}
    jstate, tstate = jv2.make_state(jcfg, 2, 32), tv2.make_state(tcfg, 2, 32)
    nxt = {}
    for slot, p in prompts.items():
        jstate, jlast, _ = j_prefill(jcfg, jparams, jstate, jnp.asarray(p, jnp.int32),
                                       jnp.int32(len(p)), jnp.int32(slot))
        tv2.prefill(tcfg, tparams, torch.tensor(p, dtype=torch.int32), tstate, slot)
        nxt[slot] = int(np.argmax(np.asarray(jlast)))
    for step in range(3):
        toks = [nxt[1], nxt[0], 0]
        pos = [len(prompts[1]) + step, len(prompts[0]) + step, 0]
        slots = [1, 0, 2]
        jstate, jlog = j_decode(jcfg, jparams, jstate, *(jnp.asarray(v, jnp.int32)
                                                           for v in (toks, pos, slots)))
        tlog = tv2.decode(tcfg, tparams, tstate, *(torch.tensor(v, dtype=torch.int32)
                                                   for v in (toks, pos, slots)))
        np.testing.assert_allclose(tlog[:2].numpy(), np.asarray(jlog)[:2], **LOGIT_TOL)
        nxt = {1: int(np.argmax(np.asarray(jlog)[0])), 0: int(np.argmax(np.asarray(jlog)[1]))}
    for key in ("ckv", "kr"):  # the live slots; the dead slot holds padding rows
        np.testing.assert_allclose(tstate[key][:, :2].numpy(), np.asarray(jstate[key])[:, :2],
                                   rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def bf16_layer(tiny):
    """The tiny config's MoE layer in bf16 (the JAX init drawn in bf16, on
    both sides) and bf16 rows h [16, D]."""
    jcfg, tcfg = tiny[2], tiny[4]
    jp = jv2.init_random_params(jcfg, seed=8, dtype=jnp.bfloat16, scale=0.2)
    jmw = jax.tree.map(lambda a: a[0], jp["moe"])
    tmw = tv2.params_from_jax(jax.tree.map(np.asarray, jmw))
    h = np.random.default_rng(8).standard_normal((16, jcfg.hidden_size)).astype(np.float32)
    jh = jnp.asarray(h).astype(jnp.bfloat16)
    th = torch.from_numpy(h).to(torch.bfloat16)
    return jcfg, tcfg, jmw, tmw, jh, th


@pytest.mark.parametrize("form,T", [("dense", 2), ("gathered", 1), ("gathered", 2),
                                    ("gathered", 7), ("grouped", 16)])
def test_moe_forms_match_jax_in_bf16(bf16_layer, form, T):
    """The routing equals the JAX one (ids exactly); then each routed form
    against the JAX form it stands for, on bf16 weights and rows:
    ``_moe_dense`` and the gathered decode form against the JAX
    ``_moe_dense`` (f32 products of bf16 values, only the sums' order
    differs: 1e-5 of the largest output), the grouped form against the JAX
    ``_moe_grouped`` (the activation rounded to bf16 on both sides: an f32
    sum-order difference can move one act element across a rounding
    boundary, one bf16 ulp (2^-8) of it times its w2 weights, so 1e-2 of the
    largest output)."""
    jcfg, tcfg, jmw, tmw, jh, th = bf16_layer
    jidx, jwts = jv2._route(jcfg, jmw["gate_w"], jh[:T])
    tidx, twts = tv2._route(tcfg, tmw["gate_w"], th[:T])
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(twts.numpy(), np.asarray(jwts), rtol=1e-6, atol=0)
    ref = jv2._moe_grouped if form == "grouped" else jv2._moe_dense
    want = np.asarray(ref(jcfg, jmw, jh[:T], jidx, jwts))
    got = getattr(tv2, f"_moe_{form}")(tcfg, tmw, th[:T], tidx, twts).numpy()
    tol = (1e-2 if form == "grouped" else 1e-5) * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # the form the model takes at T rows
    with torch.no_grad():
        shared = tv2._silu_mlp(th[:T], tmw["shared_gate"], tmw["shared_up"], tmw["shared_down"])
        taken = "grouped" if T >= tv2.PREFILL_MOE_TOKENS else "gathered"
        routed = getattr(tv2, f"_moe_{taken}")(tcfg, tmw, th[:T], tidx, twts)
        assert torch.equal(tv2._moe(tcfg, tmw, th[:T]), shared + routed)


# ── the engine ──────────────────────────────────────────────────────────


def _port_engine(tcfg, tparams, **kw):
    return tv2.start_engine_from_params(
        tcfg, tparams, tc.EngineLoadOptions(max_batch_size=2, max_model_len=MAX_LEN, **kw),
        device="cpu")


@pytest.fixture(scope="module")
def jax_streams(tiny):
    """The JAX engine's greedy streams under its defaults: one request
    alone, then two at once."""
    _, _, jcfg, jparams, _, _, _ = tiny
    rt = jv2.make_runtime(jcfg, jparams, max_model_len=MAX_LEN, max_slots=2)
    handle = j_start_scheduler(JaxExecutor(rt, jc.EngineLoadOptions(precompile=False,
                                                                    max_batch_size=2)))
    try:
        one = _collect(jc, handle, [_prompt(5, 9)], 8)
        two = _collect(jc, handle, [_prompt(6, 10), _prompt(7, 13)], 12)
        return one, two
    finally:
        handle.shutdown()


@pytest.mark.parametrize("case", ["one", "two"])
def test_engine_greedy_ids_match_jax_engine_and_hf(tiny, jax_streams, case):
    """Under the defaults (decode blocks of 4, steady blocks of 16, depth 2,
    through the graph buffers): one request (also against HF ``generate``,
    as the JAX test), and two at once on the two slots."""
    _, model, _, _, tcfg, tparams, _ = tiny
    handle = _port_engine(tcfg, tparams)
    ex = handle._scheduler.executor
    try:
        if case == "one":
            got = _collect(tc, handle, [_prompt(5, 9)], 8)
        else:
            got = _collect(tc, handle, [_prompt(6, 10), _prompt(7, 13)], 12)
    finally:
        handle.shutdown()
    assert got == jax_streams[0 if case == "one" else 1]
    assert isinstance(ex, SlotExecutor) and ex.prefills == len(got)
    assert ex._graphs.family == dg.dsv2lite(2) and ex.slot_prefix_cache is None
    assert (ex.decode_block, ex.decode_block_max, ex.decode_pipeline_depth) == (4, 16, 2)
    if case == "one":
        prompt = _prompt(5, 9)
        with torch.no_grad():
            out = model.generate(torch.tensor(prompt)[None], max_new_tokens=8, do_sample=False,
                                 eos_token_id=None, pad_token_id=0)
        assert got[0] == out[0, len(prompt):].tolist()
    else:
        assert any(B == 2 for B, *_ in ex._graphs.blocks)


def _executor(tcfg, tparams, **kw):
    opts = tc.EngineLoadOptions(max_batch_size=2, **kw)
    return SlotExecutor(tcfg, tparams, tv2.make_state(tcfg, 2, MAX_LEN), 2, MAX_LEN, opts,
                        model=tv2.slot_model(tcfg, tparams))


def _item(m, rid, prompt, **kw):
    return m.PrefillStepItem(request_id=rid, prompt_tokens=list(prompt),
                             params=m.SamplingParams(ignore_eos=True), **kw)


def _decode_n(ex, m, rid, first, n):
    toks = [first]
    for _ in range(n):
        toks.append(ex.execute_decode(m.DecodePlan(requests=[m.DecodeStepItem(
            request_id=rid, token_id=toks[-1], params=m.SamplingParams(ignore_eos=True))]))
            .requests[0].token)
    return toks


def test_a_block_of_four_equals_four_one_token_blocks(tiny):
    """Two requests on the two slots: one block of 4 against four one-token
    blocks; tokens equal, and both slots' rows."""
    tcfg, tparams = tiny[4], tiny[5]
    runs = []
    for blocks in ([4], [1, 1, 1, 1]):
        ex = _executor(tcfg, tparams)
        res = ex.execute_prefill(tx.PrefillPlan([_item(tx, i, _prompt(9 + i, 6 + i))
                                                 for i in range(2)])).requests
        toks, rows = [r.first_token for r in res], [[], []]
        for n in blocks:
            out = ex.resolve_pending_multi(ex.execute_decode_async(
                [tx.DecodeStepItem(request_id=i, token_id=t,
                                   params=tc.SamplingParams(ignore_eos=True))
                 for i, t in enumerate(toks)], n_tokens=n))
            for i, (_, t, _) in enumerate(out):
                rows[i] += t
            toks = [t[-1] for _, t, _ in out]
        runs.append((rows, ex))
    (got, a), (want, b) = runs
    assert got == want and [len(r) for r in got] == [4, 4]
    assert set(a._graphs.blocks) == {(2, 0, 4, True, 0)} and a.decode_blocks == 1
    for key in ("ckv", "kr"):
        assert torch.equal(a.state[key][:, :2], b.state[key][:, :2])


def test_echo_prompt_logprobs_match_jax(tiny):
    """An echo request with logprobs, prefilled whole with every row's
    logits, against ``JaxExecutor`` (1e-4, as the logits)."""
    _, _, jcfg, jparams, tcfg, tparams, _ = tiny
    prompt = _prompt(11, 20)
    rt = jv2.make_runtime(jcfg, jparams, max_model_len=MAX_LEN, max_slots=2)
    jres = JaxExecutor(rt, jc.EngineLoadOptions(precompile=False)).execute_prefill(
        jx.PrefillPlan(requests=[_item(jx, 1, prompt, logprobs=2, echo=True)],
                       echo=True)).requests[0]
    ex = _executor(tcfg, tparams)
    tres = ex.execute_prefill(tx.PrefillPlan(
        requests=[_item(tx, 1, prompt, logprobs=2, echo=True)], echo=True)).requests[0]
    assert tres.first_token == jres.first_token and ex.prefills == 1
    assert tres.prompt_logprobs[0] is None and jres.prompt_logprobs[0] is None
    np.testing.assert_allclose([t.logprob for t in tres.prompt_logprobs[1:]],
                               [t.logprob for t in jres.prompt_logprobs[1:]], **LOGIT_TOL)
    np.testing.assert_allclose(tres.first_token_logprob.logprob,
                               jres.first_token_logprob.logprob, **LOGIT_TOL)


def test_pd_handoff_between_two_port_executors(tiny):
    """Prefill and export on A, import on B (after B gave its slot 0 to a
    throwaway request): B's stream equals a single executor's own run and
    the JAX executor's; the payload is the slot's rows on the host."""
    _, _, jcfg, jparams, tcfg, tparams, _ = tiny
    prompt, n = _prompt(12, 14), 6
    single = _executor(tcfg, tparams)
    first = single.execute_prefill(tx.PrefillPlan([_item(tx, 1, prompt)])).requests[0]
    own = _decode_n(single, tx, 1, first.first_token, n)
    a, b = _executor(tcfg, tparams), _executor(tcfg, tparams)
    b.execute_prefill(tx.PrefillPlan([_item(tx, 999, [3, 4, 5])]))
    payload = tpd.prefill_and_export(a, _item(tx, 7, prompt))
    assert payload.kv_rows is None and a.free_slots() == 2
    assert all(v.device.type == "cpu" for v in payload.state_snap.values())
    assert sum(v.numel() * v.element_size() for v in payload.state_snap.values()) == \
        a.snapshot_bytes
    tpd.import_request(b, payload)
    assert b._slots[7] == 1
    moved = _decode_n(b, tx, 7, payload.first_token, n)
    rt = jv2.make_runtime(jcfg, jparams, max_model_len=MAX_LEN, max_slots=2)
    jex = JaxExecutor(rt, jc.EngineLoadOptions(precompile=False, enable_prefix_cache=False))
    jres = jex.execute_prefill(jx.PrefillPlan([_item(jx, 1, prompt)])).requests[0]
    assert moved == own == _decode_n(jex, jx, 1, jres.first_token, n)
    # without the rows the stream is another
    c, d = _executor(tcfg, tparams), _executor(tcfg, tparams)
    broken = tpd.prefill_and_export(c, _item(tx, 7, prompt))
    broken.state_snap = {k: torch.zeros_like(v) for k, v in broken.state_snap.items()}
    tpd.import_request(d, broken)
    assert _decode_n(d, tx, 7, broken.first_token, n) != moved


def test_non_pow2_max_model_len(tiny):
    """max_model_len 50 and a 40-token prompt (the JAX executor pads it to
    64 and clamps its cache write): the port's ids equal the JAX engine's."""
    _, _, jcfg, jparams, tcfg, tparams, _ = tiny
    prompt = _prompt(13, 40)
    rt = jv2.make_runtime(jcfg, jparams, max_model_len=50, max_slots=2)
    jh = j_start_scheduler(JaxExecutor(rt, jc.EngineLoadOptions(precompile=False,
                                                                max_batch_size=2)))
    try:
        want = _collect(jc, jh, [prompt], 5)
    finally:
        jh.shutdown()
    th = tv2.start_engine_from_params(tcfg, tparams, tc.EngineLoadOptions(
        max_batch_size=2, max_model_len=50), device="cpu")
    try:
        got = _collect(tc, th, [prompt], 5)
    finally:
        th.shutdown()
    assert got == want and len(got[0]) == 5


# ── the checkpoint ──────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def checkpoint(tiny, tmp_path_factory):
    """The tiny HF model written as a checkpoint (config.json and a
    safetensors file in f32, as the JAX test writes it)."""
    from safetensors import numpy as st_numpy

    hf, _, _, _, _, _, sd = tiny
    path = tmp_path_factory.mktemp("dsv2lite")
    (path / "config.json").write_text(json.dumps(
        {**hf.to_dict(), "architectures": ["DeepseekV2ForCausalLM"]}))
    st_numpy.save_file(sd, str(path / "model.safetensors"))
    return str(path)


def test_checkpoint_tree_equals_jax_bit_for_bit(tiny, checkpoint):
    """``load_params`` (streamed, cast to bf16) against ``params_from_jax``
    of the JAX ``params_from_state_dict`` in bf16."""
    jcfg, tcfg, sd = tiny[2], tiny[4], tiny[6]
    want = tv2.params_from_jax(jax.tree.map(np.asarray, jv2.params_from_state_dict(jcfg, sd)))
    got = tv2.load_params(tcfg, checkpoint, device="cpu")
    flat_w, flat_g = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (want, got))
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert g.dtype == w.dtype == torch.bfloat16 and torch.equal(
            g.view(torch.int16), w.view(torch.int16)), path


def test_start_engine_from_path_ids_match_jax(checkpoint):
    """``start_engine(path)`` against the JAX ``start_engine(path,
    ep_size=1)`` (both bf16), one request and then two at once; and the
    CLI's ``build_engine`` builds the same engine."""
    prompts = [[_prompt(14, 6)], [_prompt(15, 9), _prompt(16, 12)]]
    jh = jv2.start_engine(checkpoint, jc.EngineLoadOptions(
        precompile=False, max_batch_size=2, max_model_len=MAX_LEN), ep_size=1)
    try:
        want = [_collect(jc, jh, p, 6) for p in prompts]
    finally:
        jh.shutdown()
    th = tv2.start_engine(checkpoint, tc.EngineLoadOptions(max_batch_size=2,
                                                           max_model_len=MAX_LEN),
                          device="cpu")
    try:
        got = [_collect(tc, th, p, 6) for p in prompts]
    finally:
        th.shutdown()
    assert got == want
    args = tmain.parse_args(["--model-path", checkpoint, "--max-batch-size", "2"])
    handle = tmain.build_engine(args, device="cpu")
    try:
        ex = handle._scheduler.executor
        assert isinstance(ex, SlotExecutor) and ex.model.family == "DeepSeek-V2-Lite"
        assert ex.state["ckv"].shape[2] == tv2.DEFAULT_MAX_MODEL_LEN
        assert _collect(tc, handle, prompts[0], 6) == want[0]
    finally:
        handle.shutdown()


# ── refusals ────────────────────────────────────────────────────────────


@pytest.mark.parametrize("route", ["ep_size", "quantize", "quantize_path", "cli_tp",
                                   "cli_quantize", "no_card", "no_card_path"])
def test_refusals(tiny, checkpoint, route, monkeypatch):
    tcfg, tparams = tiny[4], tiny[5]
    if route == "ep_size":
        with pytest.raises(NotImplementedError, match="ep_size=2"):
            tv2.start_engine(checkpoint, device="cpu", ep_size=2)
    elif route == "quantize":
        with pytest.raises(NotImplementedError, match="DeepSeek-V2-Lite.*int8"):
            tv2.start_engine_from_params(tcfg, tparams, tc.EngineLoadOptions(quantize="int8"),
                                         device="cpu")
    elif route == "quantize_path":
        with pytest.raises(NotImplementedError, match="quantize='bf16'"):
            tv2.start_engine(checkpoint, tc.EngineLoadOptions(quantize="bf16"), device="cpu")
    elif route in ("cli_tp", "cli_quantize"):
        flag = ["--tp-size", "2"] if route == "cli_tp" else ["--quantize", "int8"]
        with pytest.raises(NotImplementedError):
            tmain.build_engine(tmain.parse_args(["--model-path", checkpoint, *flag]),
                               device="cpu")
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            if route == "no_card":
                tv2.start_engine_from_params(tcfg, tparams)
            else:
                tv2.start_engine(checkpoint)
