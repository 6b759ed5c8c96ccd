"""DeepSeek-V4's slot prefix cache in the port against the JAX package, on
the CPU.

- The port's ``SlotPrefixCache`` against the JAX one, case for case
  (tests/test_prefix_cache.py's ``test_slot_prefix_cache_match_insert_evict``).
- The port's ``SlotExecutor`` against the JAX ``JaxExecutor`` on the DSv4
  runtime, both with the cache on, through tests/test_prefix_cache.py's
  three cases and seeds: a prompt extending a cached one (resumed through
  decode steps, seed 9), an identical prompt after a request that asked
  for logprobs (the forward skipped, seed 10), and a suffix past the
  threshold (a fresh prefill, seed 11). Greedy streams, hits and misses
  equal; the entries' prompt-end logits within ``LOGIT_TOL``; the port's
  snapshots equal the JAX snapshots leaf for leaf (the JAX segments
  ungrouped) within ``CACHE_TOL``.
- The model's ``slot_export`` / ``slot_import`` / ``prefill_resume`` /
  ``snapshot_bytes``, and a resume in the int8-experts mode with the
  chain on against the JAX executor's on the same int8 experts.

Weights: tests/test_pd_handoff.py's DSv4 config and seed, made resident
(fp8 linears, packed-fp4 experts) by the JAX ``quantize_params_resident``
as tests/test_torch_dsv4.py does. One JAX executor serves every case of a
module (a new one compiles its programs again); a case starts it on zeroed
slot state and a new cache, or none for a cold run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.engine import executor as jx
from pegainfer_tpu.engine import kv as jkv
from pegainfer_tpu.engine.jax_executor import JaxExecutor
from pegainfer_tpu.models import dsv4 as jdsv4
from pegainfer_tpu.models import dsv4_engine as jengine
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.engine import executor as tx
from pegainfer_tpu_torch.engine import kv as tkv
from pegainfer_tpu_torch.engine.slot_executor import SlotExecutor
from pegainfer_tpu_torch.models import dsv4 as tdsv4
from pegainfer_tpu_torch.models import dsv4_engine as tengine

from test_torch_dsv4 import CACHE_TOL, LOGIT_TOL, WIDE

# tests/test_pd_handoff.py::_make_dsv4's config (seed 11, scale 0.08)
PD_DSV4 = dict(vocab_size=128, dim=32, moe_inter_dim=16, n_layers=2, num_attention_heads=8,
               head_dim=16, q_lora_rank=16, qk_rope_head_dim=8, o_groups=8, o_lora_rank=4,
               sliding_window=8, n_routed_experts=8, n_shared_experts=1,
               n_activated_experts=2, n_hash_layers=1, routed_scaling_factor=1.5,
               swiglu_limit=7.0, rms_norm_eps=1e-6, index_n_heads=8, index_head_dim=16,
               index_topk=4, max_position_embeddings=4096, rope_theta=1e4,
               compress_rope_theta=1e4, compress_ratios=(0, 4), yarn_original_seq_len=256,
               yarn_factor=4.0)
MAX_MODEL_LEN, SLOTS = 64, 2


@functools.lru_cache(maxsize=None)
def dsv4_models(experts):
    """(jcfg, tcfg, JAX params, port params): tests/test_pd_handoff.py's
    DSv4 weights made resident; with ``experts="int8"`` the experts are
    int8 and the config is tests/test_torch_dsv4.py's ``WIDE`` (its shapes
    pass the int8 chain's gate)."""
    kw, seed = (PD_DSV4, 11) if experts == "fp4" else (WIDE, 9)
    jcfg, tcfg = jdsv4.DSv4Config(**kw), tdsv4.DSv4Config(**kw)
    jparams = jdsv4.quantize_params_resident(
        jdsv4.init_random_params(jcfg, seed=seed, dtype=jnp.float32, scale=0.08),
        experts=experts)
    return jcfg, tcfg, jparams, tdsv4.params_from_jax(jax.tree.map(np.asarray, jparams))


@functools.lru_cache(maxsize=None)
def jax_executor(experts):
    """One JAX executor a weight set, cache on (its XLA path)."""
    jcfg, _, jparams, _ = dsv4_models(experts)
    rt = jengine.make_runtime(jcfg, jparams, max_model_len=MAX_MODEL_LEN, max_slots=SLOTS,
                              state_dtype=jnp.float32)
    return JaxExecutor(rt, jc.EngineLoadOptions(enable_prefix_cache=True, precompile=False))


def jax_on(cache: bool, experts="fp4"):
    """The module's JAX executor on zeroed slot state (a new executor's) and
    a new slot cache (or none)."""
    ex = jax_executor(experts)
    ex.state = jax.tree.map(jnp.zeros_like, ex.state)
    ex.slot_prefix_cache = jkv.SlotPrefixCache(max_entries=4) if cache else None
    return ex


def port_executor(cache: bool, experts="fp4", moe_chain=None):
    _, tcfg, _, tparams = dsv4_models(experts)
    state = tdsv4.make_state(tcfg, SLOTS, tengine.max_blocks_for(tcfg, MAX_MODEL_LEN),
                             dtype=torch.float32)
    return SlotExecutor(tcfg, tparams, state, SLOTS, MAX_MODEL_LEN,
                        tc.EngineLoadOptions(enable_prefix_cache=cache), moe_chain=moe_chain)


def _mods(ex):
    return jx if isinstance(ex, JaxExecutor) else tx


def prefill(ex, rid, prompt, logprobs=0):
    m = _mods(ex)
    item = m.PrefillStepItem(request_id=rid, prompt_tokens=list(prompt),
                             params=m.SamplingParams(ignore_eos=True), logprobs=logprobs)
    return ex.execute_prefill(m.PrefillPlan(requests=[item])).requests[0]


def decode_n(ex, rid, first_token, n):
    """``n`` greedy decode steps from ``first_token``; the stream."""
    m = _mods(ex)
    params = m.SamplingParams(ignore_eos=True)
    toks = [first_token]
    for _ in range(n):
        res = ex.execute_decode(m.DecodePlan(requests=[
            m.DecodeStepItem(request_id=rid, token_id=toks[-1], params=params)]))
        toks.append(res.requests[0].token)
    return toks


def serve(ex, rid, prompt, n, logprobs=0):
    """Prefill, ``n`` decode steps, release: the stream."""
    out = decode_n(ex, rid, prefill(ex, rid, prompt, logprobs).first_token, n)
    ex.release_request(rid)
    return out


def entry(ex, prompt):
    """The cache's (snapshot layers, logits) for ``prompt`` as numpy, the
    JAX snapshot's segments ungrouped into layers."""
    snap, logits = ex.slot_prefix_cache._entries[tuple(prompt)]
    if isinstance(ex, JaxExecutor):
        layers = jdsv4.ungroup_state(dsv4_models("fp4")[0], snap)["layers"]
    else:
        layers = snap["layers"]
    return ([{k: np.asarray(v) for k, v in ls.items()} for ls in layers],
            None if logits is None else np.asarray(logits))


def assert_entries_match(jex, tex, prompt):
    """Equal logits, and snapshots equal leaf for leaf. The compressed rows
    are compared up to the prompt's blocks: the JAX prefill pads a prompt
    to its length bucket and writes the padding's blocks past them, rows
    that are not state (decode writes a block before it reads it)."""
    (jsnap, jlog), (tsnap, tlog) = entry(jex, prompt), entry(tex, prompt)
    assert (jlog is None) == (tlog is None)
    if jlog is not None:
        np.testing.assert_allclose(tlog, jlog, **LOGIT_TOL)
    ratios = dsv4_models("fp4")[1].compress_ratios
    assert len(jsnap) == len(tsnap) == len(ratios)
    for jls, tls, ratio in zip(jsnap, tsnap, ratios):
        assert sorted(jls) == sorted(tls)
        for key in jls:
            n = len(prompt) // ratio if key in ("ckv", "ick") else None
            np.testing.assert_allclose(tls[key][:n], jls[key][:n], **CACHE_TOL)


# ── the cache alone ──────────────────────────────────────────────────────


def test_slot_prefix_cache_match_insert_evict_matches_jax():
    """tests/test_prefix_cache.py's case, step for step through both
    caches: equal answers and equal counters."""
    caches = [jkv.SlotPrefixCache(max_entries=2), tkv.SlotPrefixCache(max_entries=2)]

    def both(op, *args, **kw):
        got = [getattr(c, op)(*args, **kw) for c in caches]
        assert got[0] == got[1]
        assert (caches[0].hits, caches[0].misses) == (caches[1].hits, caches[1].misses)
        assert list(caches[0]._entries) == list(caches[1]._entries)
        return got[1]

    assert both("match", [1, 2, 3]) is None
    both("insert", [1, 2], snap="s12", logits=None)
    assert both("match", [1, 2, 9]) == (2, "s12", None)  # an extension hit
    assert both("match", [1, 2]) is None  # identical, no logits: no forward left
    both("insert", [1, 2], snap="s12b", logits="L")  # the logits upgrade the entry
    assert both("match", [1, 2]) == (2, "s12b", "L")
    both("insert", [1, 2, 9], snap="s129", logits=None)
    assert both("match", [1, 2, 9, 4])[0] == 3  # the longest prefix wins
    both("insert", [1, 2], snap="s12c", logits=None)  # a re-insert keeps the logits
    assert both("match", [1, 2]) == (2, "s12c", "L")
    both("insert", [7, 7, 7], snap="s777", logits=None)  # LRU eviction at the cap
    assert both("match", [1, 2, 9, 4])[0] == 2  # [1, 2, 9] was the oldest
    assert both("match", [1, 2])[0] == 2
    assert both("match", [7, 7, 7, 1])[0] == 3
    both("insert", [], snap="s")  # an empty prompt is not kept
    both("clear")
    assert both("match", [1, 2]) is None
    assert (caches[1].hits, caches[1].misses) == (7, 3)


# ── the executors ────────────────────────────────────────────────────────


def test_extension_resume_matches_jax():
    """A prompt extending a cached one by 4 tokens is resumed through 4
    decode steps in both executors and streams the cold run's tokens."""
    rng = np.random.default_rng(9)
    base = rng.integers(2, 127, 24).tolist()
    full = base + rng.integers(2, 127, 4).tolist()
    streams, warm = {}, {}
    for name, make in (("jax", jax_on), ("port", port_executor)):
        streams[name, "cold"] = serve(make(False), 1, full, 6)
        ex = make(True)
        serve(ex, 2, base, 1)
        streams[name, "warm"] = serve(ex, 3, full, 6)
        assert (ex.slot_prefix_cache.hits, ex.slot_prefix_cache.misses) == (1, 1)
        warm[name] = ex
    assert streams["port", "warm"] == streams["port", "cold"] == streams["jax", "warm"]
    assert streams["jax", "warm"] == streams["jax", "cold"]
    assert warm["port"].prefills == 1 and warm["port"].resume_steps == 4
    for prompt in (base, full):
        assert_entries_match(warm["jax"], warm["port"], prompt)


def test_identical_prompt_skips_forward_matches_jax():
    """A request with logprobs stores the prompt-end logits; the same
    prompt again (greedy) runs no forward and streams the same tokens."""
    rng = np.random.default_rng(10)
    prompt = rng.integers(2, 127, 20).tolist()
    out, ex = {}, {}
    for name, make in (("jax", jax_on), ("port", port_executor)):
        e = make(True)
        out[name] = (serve(e, 1, prompt, 5, logprobs=1), serve(e, 2, prompt, 5))
        assert (e.slot_prefix_cache.hits, e.slot_prefix_cache.misses) == (1, 1)
        ex[name] = e
    assert out["port"][0] == out["port"][1] == out["jax"][1] == out["jax"][0]
    assert ex["port"].prefills == 1 and ex["port"].resume_steps == 0
    assert_entries_match(ex["jax"], ex["port"], prompt)


def test_long_suffix_falls_back_to_prefill_matches_jax():
    """A 40-token suffix (past max(32, 48 // 16)) is matched, then served
    by a fresh prefill, which caches its own prompt."""
    rng = np.random.default_rng(11)
    base = rng.integers(2, 127, 8).tolist()
    full = base + rng.integers(2, 127, 40).tolist()
    first, ex = {}, {}
    for name, make in (("jax", jax_on), ("port", port_executor)):
        e = ex[name] = make(True)
        serve(e, 1, base, 1)
        first[name] = prefill(e, 2, full).first_token
        e.release_request(2)
        assert (e.slot_prefix_cache.hits, e.slot_prefix_cache.misses) == (1, 1)
        assert list(e.slot_prefix_cache._entries) == [tuple(base), tuple(full)]
    assert ex["port"].prefills == 2 and ex["port"].resume_steps == 0
    assert_entries_match(ex["jax"], ex["port"], full)
    cold = port_executor(False)
    assert first["port"] == first["jax"] == prefill(cold, 1, full).first_token


def test_int8_chain_resume_matches_jax():
    """The int8-experts mode with the chain on (the port's K8 route, its
    plain version on the CPU) against the JAX executor on the same int8
    experts: a resumed extension's first token, counters and prompt-end
    logits equal the JAX executor's (no decode steps after it: the resume
    is itself decode steps, and each JAX program costs a compile)."""
    rng = np.random.default_rng(9)
    base = rng.integers(2, 127, 12).tolist()
    full = base + rng.integers(2, 127, 3).tolist()
    out, ex = {}, {}
    for name, e in (("jax", lambda: jax_on(True, "int8")),
                    ("port", lambda: port_executor(True, "int8", moe_chain=True))):
        e = ex[name] = e()
        serve(e, 1, base, 0)
        out[name] = serve(e, 2, full, 0)
        assert (e.slot_prefix_cache.hits, e.slot_prefix_cache.misses) == (1, 1)
    assert out["port"] == out["jax"]
    assert ex["port"].resume_steps == 3
    _, jlog = ex["jax"].slot_prefix_cache._entries[tuple(full)]
    _, tlog = ex["port"].slot_prefix_cache._entries[tuple(full)]
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)


# ── the model's hooks ────────────────────────────────────────────────────


def test_resume_from_an_imported_snapshot_equals_decode_steps():
    """``slot_export`` is a copy (later steps do not change it);
    ``slot_import`` into another slot and ``prefill_resume`` give the
    logits of the same decode steps on the original slot, exactly;
    ``snapshot_bytes`` is the sum of one slot's rows."""
    _, tcfg, _, tparams = dsv4_models("fp4")
    toks = torch.tensor(np.random.default_rng(3).integers(2, 127, 26), dtype=torch.int32)
    state = tdsv4.make_state(tcfg, SLOTS, tengine.max_blocks_for(tcfg, MAX_MODEL_LEN))
    tdsv4.prefill(tcfg, tparams, toks[:20], state=state, slot=0)
    snap = tdsv4.slot_export(state, 0)
    kept = {k: v.clone() for k, v in snap["layers"][1].items()}
    direct = None
    for i in range(20, 26):
        direct = tdsv4.decode(tcfg, tparams, state, toks[i:i + 1], torch.tensor([i]),
                              torch.tensor([0]))[0]
    for k, v in snap["layers"][1].items():
        assert torch.equal(v, kept[k])
    assert not torch.equal(state["layers"][1]["kv"][0], snap["layers"][1]["kv"])
    tdsv4.slot_import(state, snap, 1)
    resumed = tdsv4.prefill_resume(tcfg, tparams, state, toks[20:], 20, 1)
    assert torch.equal(resumed, direct)
    for ls in state["layers"]:
        for cache in ls.values():
            assert torch.equal(cache[1], cache[0])
    assert tdsv4.snapshot_bytes(state) == sum(
        v.numel() * v.element_size() for ls in snap["layers"] for v in ls.values())
    with pytest.raises(ValueError, match="at least one token"):
        tdsv4.prefill_resume(tcfg, tparams, state, toks[:0], 26, 1)


def test_snapshot_bytes_at_the_smoke_shapes():
    """One slot's rows of DeepSeek-V4-Flash's first 8 layers at
    max_model_len 2,048, reckoned from ``make_state``'s shapes without
    making them: the 6,413,056 B a snapshot or a DSv4 handoff moves."""
    cfg = tdsv4.DSv4Config(
        vocab_size=129280, dim=4096, moe_inter_dim=2048, n_layers=8, num_attention_heads=64,
        head_dim=512, q_lora_rank=1024, qk_rope_head_dim=64, o_groups=8, o_lora_rank=1024,
        sliding_window=128, n_routed_experts=256, n_shared_experts=1, n_activated_experts=6,
        n_hash_layers=3, routed_scaling_factor=1.5, swiglu_limit=7.0, rms_norm_eps=1e-6,
        index_n_heads=64, index_head_dim=128, index_topk=512,
        max_position_embeddings=1048576, rope_theta=10000.0, compress_rope_theta=10000.0,
        compress_ratios=(0, 0, 4, 128, 4, 128, 4, 128), yarn_original_seq_len=65536,
        yarn_factor=16.0)
    state = tdsv4.make_state(cfg, 2, tengine.max_blocks_for(cfg, 2048),
                             dtype=torch.bfloat16, device="meta")
    assert tdsv4.snapshot_bytes(state) == 6_413_056
