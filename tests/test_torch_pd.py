"""PD handoff (``engine/pd.py``) in the port against the JAX package, on
the CPU.

For Qwen3 (paged KV; the receiver's pool churned so the pages land on
other ids), the Qwen3.5 hybrid (pages and the slot's recurrent and conv
rows) and DeepSeek-V4 (no pages: the slot's rows are the whole payload), as
tests/test_pd_handoff.py runs them, with its configs, seeds and prompts:
a request prefilled on executor A moves to executor B and decodes there.
The port's handed-off greedy stream equals the JAX handed-off stream and
the port's own single-executor stream; the payload lives on the host in
CPU tensors and A keeps nothing. The negative controls drop the payload's
state rows, which must change the first decode logprob (hybrid, DSv4);
an executor with no hooks raises.

The hybrid runs at tests/test_prefix_cache.py's ``_tiny_qwen35`` shapes
(one GDN and one full-attention layer) with weights from the JAX package's
``init_random_params`` (no transformers import). DSv4 reuses
tests/test_torch_dsv4_cache.py's resident weights and JAX executor (its
cache off here). One JAX executor plays A and then B in each JAX handoff,
with a throwaway request on the pages and slot A freed, so the import
lands on others.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.engine import executor as jx
from pegainfer_tpu.engine import pd as jpd
from pegainfer_tpu.engine.jax_executor import JaxExecutor
from pegainfer_tpu.models import qwen3 as jq3
from pegainfer_tpu.models import qwen35 as jq35
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine import executor as tx
from pegainfer_tpu_torch.engine import pd as tpd
from pegainfer_tpu_torch.engine.hybrid_executor import HybridExecutor
from pegainfer_tpu_torch.engine.torch_executor import TorchExecutor
from pegainfer_tpu_torch.models import qwen3 as tq3
from pegainfer_tpu_torch.models import qwen35 as tq35

from test_torch_dsv4_cache import jax_on, port_executor

# tests/test_pd_handoff.py's Qwen3 config (seed 41)
QWEN3 = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16, vocab_size=128,
             rms_norm_eps=1e-6, rope_theta=1e6, tie_word_embeddings=True, eos_token_id=1,
             stop_token_ids=(1,), max_position_embeddings=512)
# tests/test_prefix_cache.py::_tiny_qwen35's shapes
QWEN35 = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=32, rms_norm_eps=1e-6,
              rope_theta=1e6, partial_rotary_factor=0.25,
              layer_types=("linear_attention", "full_attention"), linear_num_key_heads=2,
              linear_num_value_heads=4, linear_key_head_dim=16, linear_value_head_dim=16,
              linear_conv_kernel_dim=4, tie_word_embeddings=True, eos_token_id=255,
              stop_token_ids=(255,), max_position_embeddings=2048)
NUM_PAGES, PAGE = 32, 4


def _qwen3():
    jparams = jq3.init_random_params(jq3.Qwen3Config(**QWEN3), seed=41, dtype=jnp.float32)
    tparams = tq3.params_from_jax(jax.tree.map(np.asarray, jparams))

    def jax_make():
        rt = jq3.make_runtime(jq3.Qwen3Config(**QWEN3), jparams, num_pages=NUM_PAGES,
                              page_size=PAGE, kv_dtype=jnp.float32)
        return JaxExecutor(rt, jc.EngineLoadOptions(enable_prefix_cache=False))

    def port_make():
        cfg = tq3.Qwen3Config(**QWEN3)
        return TorchExecutor(cfg, tparams, tq3.make_kv_pages(cfg, NUM_PAGES, PAGE,
                                                             dtype=torch.float32),
                             tc.EngineLoadOptions(enable_prefix_cache=False))

    return jax_make, port_make


def _qwen35():
    jparams = jq35.init_random_params(jq35.Qwen35Config(**QWEN35), seed=5, dtype=jnp.float32,
                                      scale=0.2)
    tparams = tq35.params_from_jax(jax.tree.map(np.asarray, jparams))

    def jax_make():
        rt = jq35.make_runtime(jq35.Qwen35Config(**QWEN35), jparams, num_pages=NUM_PAGES,
                               page_size=PAGE, max_slots=4, kv_dtype=jnp.float32,
                               use_pallas=False)
        return JaxExecutor(rt, jc.EngineLoadOptions(enable_prefix_cache=False))

    def port_make():
        cfg = tq35.Qwen35Config(**QWEN35)
        state = tq35.make_state(cfg, NUM_PAGES, PAGE, 4, kv_dtype=torch.float32)
        return HybridExecutor(cfg, tparams, state, tc.EngineLoadOptions(enable_prefix_cache=False))

    return jax_make, port_make


def _mods(ex):
    return jx if isinstance(ex, JaxExecutor) else tx


def _item(ex, rid, prompt):
    m = _mods(ex)
    return m.PrefillStepItem(request_id=rid, prompt_tokens=list(prompt),
                             params=m.SamplingParams(ignore_eos=True))


def _decode(ex, rid, token, logprobs=0):
    m = _mods(ex)
    res = ex.execute_decode(m.DecodePlan(requests=[m.DecodeStepItem(
        request_id=rid, token_id=token, params=m.SamplingParams(ignore_eos=True),
        logprobs=logprobs)]))
    return res.requests[0]


def decode_n(ex, rid, first, n):
    toks = [first]
    for _ in range(n):
        toks.append(_decode(ex, rid, toks[-1]).token)
    return toks


def run_single(ex, prompt, n, rid=1):
    m = _mods(ex)
    res = ex.execute_prefill(m.PrefillPlan(requests=[_item(ex, rid, prompt)]))
    return decode_n(ex, rid, res.requests[0].first_token, n)


def churn(ex):
    """Prefill a throwaway request on ``ex``: with pages released, the next
    request gets other page ids; with a state slot kept, another slot."""
    m = _mods(ex)
    ex.execute_prefill(m.PrefillPlan(requests=[_item(ex, 999, [3, 4, 5])]))


def handoff(ex_a, ex_b, prompt, rid=7, drop_state=False):
    """Prefill on A, ship, import on B; the payload."""
    pd = jpd if isinstance(ex_a, JaxExecutor) else tpd
    payload = pd.prefill_and_export(ex_a, _item(ex_a, rid, prompt))
    assert payload.prompt_len == len(prompt)
    assert ex_a.acct.get(rid) is None or not ex_a.acct.get(rid).pages  # A let go
    if drop_state:
        payload.state_snap = None
    pd.import_request(ex_b, payload)
    return payload


def host_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in host_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in host_tensors(v)]
    return [tree]


def assert_on_host(payload):
    for t in host_tensors([payload.kv_rows, payload.state_snap]):
        assert t is None or (isinstance(t, torch.Tensor) and t.device.type == "cpu")


def jax_handoff(jex, prompt, n):
    """The JAX handoff's stream, one JAX executor playing A and then B: it
    exports the request (freeing its pages and slot), takes them again for
    a throwaway request, and imports the payload onto others. (Each JAX
    executor compiles its programs anew.)"""
    payload = jpd.prefill_and_export(jex, _item(jex, 7, prompt))
    churn(jex)
    jpd.import_request(jex, payload)
    return decode_n(jex, 7, payload.first_token, n)


def first_logprob(ex_a, ex_b, prompt, drop_state):
    payload = handoff(ex_a, ex_b, prompt, rid=9, drop_state=drop_state)
    return _decode(ex_b, 9, payload.first_token, logprobs=1).logprob.logprob


@pytest.mark.parametrize("family", ["qwen3", "qwen35"])
def test_paged_handoff_matches_jax(family):
    """Qwen3 (seed 2, 19 tokens, 8 steps) and the hybrid (seed 4, 23
    tokens): A's pages land on other ids in B (and the hybrid's rows on
    another slot); the streams equal, and the first decode logprob after
    the handoff equals the single run's exactly."""
    jax_make, port_make = _qwen3() if family == "qwen3" else _qwen35()
    seed, n, vocab = (2, 19, 127) if family == "qwen3" else (4, 23, 255)
    prompt = np.random.default_rng(seed).integers(2, vocab, n).tolist()

    jax_moved = jax_handoff(jax_make(), prompt, 8)

    alone = port_make()
    single = run_single(alone, prompt, 8)
    t_a, t_b = port_make(), port_make()
    churn(t_b)
    payload = handoff(t_a, t_b, prompt)
    assert_on_host(payload)
    pages = -(-len(prompt) // PAGE)
    assert payload.kv_rows.shape[2] == pages
    assert t_b.acct.get(7).pages[:pages] != alone.acct.get(1).pages[:pages]  # other ids
    if family == "qwen35":
        assert payload.state_snap is not None and t_b._slots[7] != 0  # another slot
        assert t_a.free_slots() == 4
    moved = decode_n(t_b, 7, payload.first_token, 8)
    assert moved == single == jax_moved

    single_ex = port_make()
    res = single_ex.execute_prefill(tx.PrefillPlan(requests=[_item(single_ex, 9, prompt)]))
    lp_single = _decode(single_ex, 9, res.requests[0].first_token, logprobs=1).logprob.logprob
    assert first_logprob(port_make(), port_make(), prompt, False) == lp_single
    if family == "qwen35":  # the negative control: the state rows carry the prompt
        lp_broken = first_logprob(port_make(), port_make(), prompt, True)
        assert abs(lp_single - lp_broken) > 1e-6


@pytest.mark.parametrize("family", ["qwen3", "qwen35"])
def test_model_page_hooks_match_jax(family):
    """``export_pages`` / ``import_pages`` of each paged model equal the
    JAX ones: the same pages gathered from a seeded pool, and scattered
    into another pool at other ids (exact: a copy moves no bit)."""
    rng = np.random.default_rng(41)
    shape = (2, 2, NUM_PAGES, 2, PAGE, 16)
    src, dst = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    out_ids, in_ids = [5, 2, 17, 9], [30, 0, 11, 3]
    if family == "qwen3":
        j_rows = jq3.export_pages(jnp.asarray(src), jnp.asarray(out_ids))
        j_dst = jq3.import_pages(jnp.asarray(dst), j_rows, in_ids)
        t_src, t_dst = torch.from_numpy(src), torch.from_numpy(dst.copy())
        t_rows = tq3.export_pages(t_src, out_ids)
        tq3.import_pages(t_dst, t_rows, in_ids)
    else:
        j_rows = jq35.export_pages({"kv": jnp.asarray(src)}, jnp.asarray(out_ids))
        j_dst = jq35.import_pages({"kv": jnp.asarray(dst)}, j_rows, in_ids)["kv"]
        t_src, t_dst = torch.from_numpy(src), torch.from_numpy(dst.copy())
        t_rows = tq35.export_pages({"kv": t_src}, out_ids)
        tq35.import_pages({"kv": t_dst}, t_rows, in_ids)
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(t_dst.numpy(), np.asarray(j_dst))
    t_rows.zero_()  # a copy, not a view of the pool
    np.testing.assert_array_equal(t_src.numpy(), src)


def test_dsv4_slot_handoff_matches_jax():
    """DSv4 (seed 6, 21 tokens, 6 steps): no pages, the slot's rows are the
    payload; the import lands on B's second slot. Streams equal; dropping
    the rows changes the first decode logprob."""
    prompt = np.random.default_rng(6).integers(2, 127, 21).tolist()
    jex = jax_on(False)
    jax_moved = jax_handoff(jex, prompt, 6)
    assert jex._slots[7] == 1
    for rid in (7, 999):  # the executor serves tests/test_torch_dsv4_cache.py too
        jex.release_request(rid)

    single = run_single(port_executor(False), prompt, 6)
    t_a, t_b = port_executor(False), port_executor(False)
    churn(t_b)
    payload = handoff(t_a, t_b, prompt)
    assert payload.kv_rows is None and payload.state_snap is not None
    assert_on_host(payload)
    assert t_b._slots[7] == 1 and t_a.free_slots() == 2
    moved = decode_n(t_b, 7, payload.first_token, 6)
    assert moved == single == jax_moved

    lp_ok = first_logprob(port_executor(False), port_executor(False), prompt, False)
    lp_broken = first_logprob(port_executor(False), port_executor(False), prompt, True)
    assert abs(lp_ok - lp_broken) > 1e-6


def test_handoff_payload_and_refusals():
    """An executor with no hooks raises as the JAX one does; a payload with
    pages needs ``import_pages``, one with state rows ``slot_import``; a
    request already present is refused; the payload's bytes are the
    pages' and the rows'."""
    class NoHooks:
        pass

    with pytest.raises(ValueError, match="no PD support"):
        tpd.prefill_and_export(NoHooks(), None)
    _, port_make = _qwen35()
    prompt = list(range(3, 24))
    a = port_make()
    payload = tpd.prefill_and_export(a, _item(a, 7, prompt))
    cfg = tq35.Qwen35Config(**QWEN35)
    assert payload.kv_rows.numel() * 4 == 6 * tq35.kv_bytes_per_page(cfg, PAGE, torch.float32)
    assert sum(t.numel() * 4 for t in host_tensors(payload.state_snap)) == tq35.slot_bytes(cfg)
    with pytest.raises(ValueError, match="import_pages"):
        tpd.import_request(port_executor(False), payload)
    _, qwen3_make = _qwen3()
    with pytest.raises(ValueError, match="slot_import"):
        tpd.import_request(qwen3_make(), payload)
    b = port_make()
    tpd.import_request(b, payload)
    with pytest.raises(ValueError, match="already present"):
        tpd.import_request(b, payload)
