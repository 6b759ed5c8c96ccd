"""The port's DeepSeek-V4 int8-experts mode and fused decode chains against
the JAX package, on the CPU.

Params come from the JAX package's ``init_random_params(dtype=float32)``
made resident by its ``quantize_params_resident`` (``experts="int8"`` or
packed fp4) and carried over by ``params_from_jax``. The JAX side runs its
kernel paths (``RunModes(fp4_kernel="interpret")``: the int8 grouped GEMM,
the int8 and fp4 chains, the int8 GEMVs, in Pallas interpret mode); its
chain switch is ``PEGAINFER_DSV4_CHAIN``. The port runs the same routes
through its kernel wrappers, which take their plain versions for CPU
tensors; its chain switch is the ``moe_chain`` argument. Logits at the
tolerance of tests/test_torch_dsv4.py (atol 2e-2; bf16 roundings of the
routed experts' inputs carry f32 sum-order differences on).

Config: tests/test_torch_dsv4.py's ``WIDE`` (dim 256, 8 experts of width
256), whose shapes pass both chain gates; the engine test uses its ``TINY``
one (three requests on two slots), which takes the int8 GEMVs.
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
from pegainfer_tpu.ops import quant as jquant
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.models import dsv4 as tdsv4
from pegainfer_tpu_torch.models import dsv4_engine as tengine
from pegainfer_tpu_torch.ops.cuda import fp4_chain as k9
from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
from pegainfer_tpu_torch.ops.cuda import int8_chain as k8
from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
from pegainfer_tpu_torch.ops.cuda import int8_grouped as k7

from test_torch_dsv4 import LOGIT_TOL, TINY, WIDE, _collect

KERNELS = jdsv4.RunModes(fp4_kernel="interpret")
PROMPT = [3, 17, 42, 9, 88, 12, 7, 55, 2, 91]  # T = 10: the grouped GEMMs


def _params(kw, experts, seed=9):
    jcfg, tcfg = jdsv4.DSv4Config(**kw), tdsv4.DSv4Config(**kw)
    jparams = jdsv4.quantize_params_resident(
        jdsv4.init_random_params(jcfg, seed=seed, dtype=jnp.float32, scale=0.08),
        experts=experts)
    return jcfg, tcfg, jparams, tdsv4.params_from_jax(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def int8_models():
    return _params(WIDE, "int8")


def test_port_quantize_params_resident_int8_equals_jax():
    _, tcfg, _, tparams = _params(TINY, "int8", seed=0)
    mine = tdsv4.quantize_params_resident(
        tdsv4.init_random_params(tcfg, seed=0, dtype=torch.float32, scale=0.08), experts="int8")
    for lw_t, lw_m in zip(tparams["layers"], mine["layers"]):
        for k in tdsv4.FP4_KEYS:
            assert lw_m[k]["q"].dtype == torch.int8
            assert torch.equal(lw_m[k]["q"], lw_t[k]["q"]) and torch.equal(lw_m[k]["s"],
                                                                           lw_t[k]["s"])
    with pytest.raises(ValueError, match="experts"):
        tdsv4.quantize_params_resident(tdsv4.init_random_params(tcfg), experts="bf16")


def test_int8_prefill_logits_match_jax_grouped_kernel(int8_models):
    jcfg, tcfg, jparams, tparams = int8_models
    toks = np.asarray(PROMPT, np.int32)
    jl, _ = jdsv4.prefill(jcfg, jparams, jnp.asarray(toks), modes=KERNELS)
    tl, _ = tdsv4.prefill(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def _decode_both(jcfg, tcfg, jparams, tparams, moe_chain):
    """Prefill 5 tokens into slot 1 (T < 8: the decode-shaped MoE, chain
    included), then one decode step at batch 2 with a dead-slot row, with
    the kernels; returns (port logits, JAX logits) of the live row."""
    toks = np.asarray(PROMPT[:5], np.int32)
    jstate = jdsv4.make_state(jcfg, max_slots=2, max_blocks=8)
    tstate = tdsv4.make_state(tcfg, max_slots=2, max_blocks=8)
    _, jstate = jdsv4.prefill(jcfg, jparams, jnp.asarray(toks), state=jstate,
                              slot=jnp.int32(1))
    tdsv4.prefill(tcfg, tparams, torch.from_numpy(toks), state=tstate, slot=1,
                  moe_chain=moe_chain)
    step = ([7, 0], [5, 0], [1, 2])
    jargs = [jnp.asarray(a, jnp.int32) for a in step]
    targs = [torch.tensor(a, dtype=torch.int32) for a in step]
    _, jlog = jdsv4.decode(jcfg, jparams, jstate, *jargs, modes=KERNELS)
    tlog = tdsv4.decode(tcfg, tparams, tstate, *targs, moe_chain=moe_chain)
    return tlog[0].numpy(), np.asarray(jlog)[0]


@pytest.mark.parametrize("moe_chain,env", [(None, None), (True, "1"), (False, "0")])
def test_int8_decode_logits_match_jax_chain_on_and_off(int8_models, monkeypatch, moe_chain,
                                                       env):
    """The chain is the int8 default (None) and runs on request (True); off
    (False) it is three GEMVs, on both sides."""
    if env is None:
        monkeypatch.delenv("PEGAINFER_DSV4_CHAIN", raising=False)
    else:
        monkeypatch.setenv("PEGAINFER_DSV4_CHAIN", env)
    tl, jl = _decode_both(*int8_models, moe_chain=moe_chain)
    np.testing.assert_allclose(tl, jl, **LOGIT_TOL)


def test_fp4_chain_decode_logits_match_jax(monkeypatch):
    monkeypatch.setenv("PEGAINFER_DSV4_CHAIN", "1")
    jcfg, tcfg, jparams, tparams = _params(WIDE, "fp4")
    assert k9.fp4_chain_supported(tparams["layers"][1]["experts_w1"],
                                  tparams["layers"][1]["experts_w2"], jcfg.n_activated_experts)
    tl, jl = _decode_both(jcfg, tcfg, jparams, tparams, moe_chain=True)
    np.testing.assert_allclose(tl, jl, **LOGIT_TOL)


def test_model_routes_int8_and_chains_through_the_kernel_wrappers(int8_models, monkeypatch):
    """int8 prefill takes K7, int8 decode K8 by default and K6 with the
    chain off, fp4 decode K9 with the chain on and K3 by default, and
    ``plain_kernels`` the plain versions; on the CPU no launch is counted."""
    _, tcfg, _, tparams = int8_models
    calls = []

    def logged(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    for mod, name in ((k6, "moe_int8_gemv"), (k7, "moe_int8_grouped"), (k8, "moe_int8_chain"),
                      (k9, "moe_fp4_chain"), (k3, "moe_fp4_gemv"), (k5, "moe_fp4_grouped"),
                      (k6, "moe_int8_gemv_plain"), (k7, "moe_int8_grouped_plain"),
                      (k8, "moe_int8_chain_plain"), (k9, "moe_fp4_chain_plain"),
                      (k3, "moe_fp4_gemv_plain")):
        monkeypatch.setattr(mod, name, logged(name, getattr(mod, name)))
    L = tcfg.n_layers
    state = tdsv4.make_state(tcfg, 1, 8)
    tdsv4.prefill(tcfg, tparams, torch.tensor(PROMPT, dtype=torch.int32), state=state, slot=0)
    assert calls == ["moe_int8_grouped", "moe_int8_grouped_plain"] * 3 * L
    step = [torch.tensor([x], dtype=torch.int32) for x in (5, len(PROMPT), 0)]

    def decode_calls(params, **kw):
        calls.clear()
        tdsv4.decode(tcfg, params, state, *step, **kw)
        return list(calls)

    # a chain's plain version is three plain GEMVs
    chain8 = ["moe_int8_chain_plain"] + ["moe_int8_gemv_plain"] * 3
    chain4 = ["moe_fp4_chain_plain"] + ["moe_fp4_gemv_plain"] * 3
    assert decode_calls(tparams) == (["moe_int8_chain"] + chain8) * L
    assert decode_calls(tparams, plain_kernels=True) == chain8 * L
    assert decode_calls(tparams, moe_chain=False) == (
        ["moe_int8_gemv", "moe_int8_gemv_plain"] * 3 * L)
    assert decode_calls(tparams, moe_chain=False, plain_kernels=True) == (
        ["moe_int8_gemv_plain"] * 3 * L)
    fp4 = _params(WIDE, "fp4")[3]
    assert decode_calls(fp4) == ["moe_fp4_gemv", "moe_fp4_gemv_plain"] * 3 * L
    assert decode_calls(fp4, moe_chain=True) == (["moe_fp4_chain"] + chain4) * L
    assert decode_calls(fp4, moe_chain=True, plain_kernels=True) == chain4 * L
    assert k6.launches == k7.launches == k8.launches == k9.launches == 0


def test_requantize_experts_in_place_matches_jax_load_step():
    """fp4 params -> int8 in place, as dsv4_engine.py:208-212 does at load;
    int8 stacks pass unchanged."""
    _, _, jparams, tparams = _params(TINY, "fp4", seed=0)
    tdsv4.requantize_experts_int8(tparams)
    for jlw, tlw in zip(jparams["layers"], tparams["layers"]):
        for k in tdsv4.FP4_KEYS:
            ref = jquant.quantize_int8_stack(np.asarray(jquant.dequant_any(jlw[k], jnp.float32)))
            np.testing.assert_array_equal(tlw[k]["q"].numpy(), np.asarray(ref["q"]))
            np.testing.assert_array_equal(tlw[k]["s"].numpy(), np.asarray(ref["s"]))
    q_before = tparams["layers"][0]["experts_w1"]["q"]
    tdsv4.requantize_experts_int8(tparams)
    assert tparams["layers"][0]["experts_w1"]["q"] is q_before


def test_int8_engine_greedy_streams_match_jax_engine():
    """quantize="int8-experts" on fp4 params: the port's engine requantizes
    at start and streams the JAX engine's tokens (the JAX engine served the
    same fp4 params requantized as its loader does)."""
    jcfg, tcfg, jparams, tparams = _params(TINY, "fp4", seed=0)
    for lw in jparams["layers"]:
        for k in jdsv4.FP4_KEYS:
            lw[k] = jquant.quantize_int8_stack(np.asarray(jquant.dequant_any(lw[k], jnp.float32)))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, 128, n).tolist() for n in (9, 15, 12)]
    rt = jengine.make_runtime(jcfg, jparams, max_model_len=64, max_slots=2)
    jhandle = j_start_scheduler(JaxExecutor(rt, jc.EngineLoadOptions(precompile=False)))
    try:
        ref = _collect(jc, jhandle, prompts, max_tokens=6)
    finally:
        jhandle.shutdown()

    thandle = tengine.start_engine_from_params(
        tcfg, tparams, tc.EngineLoadOptions(max_batch_size=2, max_model_len=64,
                                            quantize="int8-experts"), device="cpu")
    try:
        out = _collect(tc, thandle, prompts, max_tokens=6)
        assert thandle._scheduler.executor.prefills == 3
    finally:
        thandle.shutdown()
    assert all(tparams["layers"][0][k]["q"].dtype == torch.int8 for k in tdsv4.FP4_KEYS)
    for (rtoks, rfin, _), (otoks, ofin, _) in zip(ref, out):
        assert isinstance(rfin, jc.Finished) and isinstance(ofin, tc.Finished)
        assert len(otoks) == ofin.completion_tokens == 6
        assert otoks == rtoks
