"""The port's Qwen3.5 hybrid (GDN ops, model) against the JAX package's, on
the CPU.

Tiny f32 configs: the JAX parity test's (hidden 64, 4 layers of period 2,
hd 32; tests/test_qwen35_parity.py) and a period-4 one (tests/
test_q35_mixed_fused.py's shape, untied head). Weights come from the JAX
``init_random_params`` through ``params_from_jax``. The port is held to
atol 1e-4 of the JAX package (the same math summed in another order by
another framework, as tests/test_torch_qwen3.py holds Qwen3); the GDN ops
on unit-scale inputs to atol 1e-5. Each JAX function is jitted once per
module.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pegainfer_tpu.models import qwen35 as jq
from pegainfer_tpu.ops import gdn as jgdn
from pegainfer_tpu.ops import norm as jnorm
from pegainfer_tpu_torch.models import qwen35 as tq
from pegainfer_tpu_torch.ops import gdn as tgdn
from pegainfer_tpu_torch.ops import norm as tnorm

PS = 4
NUM_PAGES = 48
MAX_SLOTS = 4
T_PAD = 16  # the JAX prefill's one compiled length (its GDN chunk 16)
ATOL = 1e-4
OP_ATOL = 1e-5

CONFIGS = {
    "period2": dict(hidden_size=64, intermediate_size=128, num_hidden_layers=4,
                    num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                    vocab_size=256, rms_norm_eps=1e-6, rope_theta=1e6,
                    partial_rotary_factor=0.25,
                    layer_types=("linear_attention", "full_attention") * 2,
                    linear_num_key_heads=2, linear_num_value_heads=4,
                    linear_key_head_dim=16, linear_value_head_dim=16,
                    linear_conv_kernel_dim=4, tie_word_embeddings=True,
                    eos_token_id=1, stop_token_ids=(1,), max_position_embeddings=512),
    "period4": dict(hidden_size=128, intermediate_size=256, num_hidden_layers=8,
                    num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                    vocab_size=256, rms_norm_eps=1e-6, rope_theta=1e6,
                    partial_rotary_factor=0.25,
                    layer_types=("linear_attention",) * 3 + ("full_attention",),
                    linear_num_key_heads=2, linear_num_value_heads=4,
                    linear_key_head_dim=16, linear_value_head_dim=16,
                    linear_conv_kernel_dim=4, tie_word_embeddings=False,
                    eos_token_id=0, stop_token_ids=(0,), max_position_embeddings=512),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    kw = CONFIGS[request.param]
    jcfg, tcfg = jq.Qwen35Config(**kw), tq.Qwen35Config(**kw)
    jparams = jq.init_random_params(jcfg, seed=5, dtype=jnp.float32, scale=0.1)
    tparams = tq.params_from_jax(jax.tree.map(np.asarray, jparams))
    jit = {
        "prefill": jax.jit(lambda s, t, sl, pt, slot: jq.prefill(
            jcfg, jparams, s, t, sl, pt, slot, return_all_logits=True,
            gdn_chunk_size=16, mode="grouped")),
        "decode": jax.jit(lambda s, t, p, pt, sl, slots: jq.decode(
            jcfg, jparams, s, t, p, pt, sl, slots)),
    }
    return jcfg, tcfg, tparams, jit


def _rng_t(rng, *shape, scale=1.0):
    return rng.standard_normal(shape).astype(np.float32) * scale


# ── ops ──────────────────────────────────────────────────────────────────


def test_rms_norm_zero_centered_matches_jax():
    """f32 and bf16 inputs: the scale is 1 + w, multiplied in f32 before the
    cast (exact at f32 to 1e-6; at bf16 to one bf16 ulp of the output)."""
    rng = np.random.default_rng(0)
    x, w = _rng_t(rng, 5, 3, 32), _rng_t(rng, 32, scale=0.3)
    got = tnorm.rms_norm_zero_centered(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    ref = jnorm.rms_norm_zero_centered(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    got16 = tnorm.rms_norm_zero_centered(torch.from_numpy(x).bfloat16(),
                                         torch.from_numpy(w).bfloat16(), 1e-6)
    ref16 = jnorm.rms_norm_zero_centered(jnp.asarray(x, jnp.bfloat16),
                                         jnp.asarray(w, jnp.bfloat16), 1e-6)
    ref16 = np.asarray(ref16.astype(jnp.float32))
    np.testing.assert_allclose(got16.float().numpy(), ref16, rtol=2 ** -7, atol=0)
    # the Qwen3 form is another function: with the init's weights (1) the
    # zero-centered one is twice it
    ones = torch.ones(32)
    np.testing.assert_allclose(
        tnorm.rms_norm_zero_centered(torch.from_numpy(x), ones, 1e-6).numpy(),
        2 * tnorm.rms_norm(torch.from_numpy(x), ones, 1e-6).numpy(), rtol=1e-6)


def test_gdn_step_matches_jax():
    """One batched recurrence step (B 3, H 4, dk 16, dv 8): output and state
    within 1e-5."""
    rng = np.random.default_rng(1)
    B, H, dk, dv = 3, 4, 16, 8
    q, k = _rng_t(rng, B, H, dk), _rng_t(rng, B, H, dk)
    v = _rng_t(rng, B, H, dv)
    g = -np.abs(_rng_t(rng, B, H))
    beta = rng.uniform(size=(B, H)).astype(np.float32)
    state = _rng_t(rng, B, H, dk, dv, scale=0.5)
    args = (q, k, v, g, beta, state)
    out, s = tgdn.gdn_step(*(torch.from_numpy(a) for a in args))
    jout, js = jgdn.gdn_step(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=OP_ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=OP_ATOL)


@pytest.mark.parametrize("T", [2, 13])
def test_causal_conv1d_matches_jax(T):
    """The prefill conv of a whole prompt against the JAX conv on the prompt
    padded to 16 rows with ``seq_len`` T: y on the prompt's rows and the
    state (the last K = 4 inputs, zero-padded on the left when T < K)."""
    rng = np.random.default_rng(T)
    C, K = 24, 4
    x, w = _rng_t(rng, T, C), _rng_t(rng, C, K, scale=0.5)
    xp = np.zeros((16, C), np.float32)
    xp[:T] = x
    y, state = tgdn.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w))
    jy, jstate = jax.jit(jgdn.causal_conv1d)(jnp.asarray(xp), jnp.asarray(w), jnp.int32(T))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy)[:T], rtol=0, atol=OP_ATOL)
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    assert state.shape == (K, C)
    if T < K:
        assert not state[: K - T].any() and torch.equal(state[K - T:], torch.from_numpy(x))


def test_causal_conv1d_step_matches_jax():
    """The decode conv: y and the window with the oldest input dropped."""
    rng = np.random.default_rng(2)
    B, C, K = 3, 24, 4
    x, w, state = _rng_t(rng, B, C), _rng_t(rng, C, K, scale=0.5), _rng_t(rng, B, K, C)
    y, s = tgdn.causal_conv1d_step(*(torch.from_numpy(a) for a in (x, w, state)))
    jy, js = jgdn.causal_conv1d_step(*(jnp.asarray(a) for a in (x, w, state)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=OP_ATOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(s[:, :-1].numpy(), state[:, 1:])


@pytest.fixture(scope="module")
def jax_gdn_chunk16():
    return jax.jit(lambda q, k, v, g, b, s: jgdn.gdn_chunk(q, k, v, g, b, s, chunk=16))


@pytest.mark.parametrize("decay", ["mild", "steep"])
@pytest.mark.parametrize("chunk", [16, tgdn.CHUNK])
def test_gdn_chunk_matches_jax(jax_gdn_chunk16, chunk, decay):
    """The port's chunkwise rule on an unpadded T of 150 (a multiple of
    neither chunk) from a nonzero state, at chunk 16 and at the port's chunk,
    against the JAX ``gdn_chunk`` at 16 on the input padded to 160 with
    g = β = 0: outputs and final state within 1e-5. With a steep decay
    (g about -4 a row) ``exp(g_cum)`` underflows to 0 inside a 64-row chunk
    and the results still agree and stay finite."""
    rng = np.random.default_rng(3)
    T, Tp, H, dk, dv = 150, 160, 4, 16, 8
    q, k, v = _rng_t(rng, T, H, dk), _rng_t(rng, T, H, dk), _rng_t(rng, T, H, dv)
    g = -np.abs(_rng_t(rng, T, H, scale=0.3 if decay == "mild" else 4.0))
    beta = rng.uniform(size=(T, H)).astype(np.float32)
    s0 = _rng_t(rng, H, dk, dv, scale=0.5)
    padded = [np.concatenate([a, np.zeros((Tp - T,) + a.shape[1:], np.float32)])
              for a in (q, k, v, g, beta)]
    jout, js = jax_gdn_chunk16(*(jnp.asarray(a) for a in padded), jnp.asarray(s0))
    out, s = tgdn.gdn_chunk(*(torch.from_numpy(a) for a in (q, k, v, g, beta, s0)),
                            chunk=chunk)
    assert out.shape == (T, H, dv) and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(jout)[:T], rtol=0, atol=OP_ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=OP_ATOL)


# ── parameters ───────────────────────────────────────────────────────────


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_random_params_matches_jax(name):
    jcfg, tcfg = jq.Qwen35Config(**CONFIGS[name]), tq.Qwen35Config(**CONFIGS[name])
    jp = jax.tree.map(np.asarray, jq.init_random_params(jcfg, seed=3, dtype=jnp.float32))
    tp = tq.init_random_params(tcfg, seed=3, dtype=torch.float32)
    for key in ("embed", "final_ln", "lm_head"):
        np.testing.assert_array_equal(tp[key].numpy(), jp[key], err_msg=key)
    for grp in ("lin", "full"):
        assert sorted(tp[grp]) == sorted(jp[grp])
        for key, v in jp[grp].items():
            np.testing.assert_array_equal(tp[grp][key].numpy(), v, err_msg=f"{grp}.{key}")


def test_bf16_params_keep_the_gdn_vectors_f32():
    """bf16 weights keep ``dt_bias``, ``A_log`` and ``conv_w`` in f32 (the
    JAX tree's dtypes); ``params_bytes`` counts a tied head once."""
    tcfg = tq.Qwen35Config(**CONFIGS["period4"])
    tp = tq.init_random_params(tcfg, seed=0)
    for key in tq.F32_KEYS:
        assert tp["lin"][key].dtype == torch.float32
    assert tp["lin"]["wq"].dtype == tp["full"]["wo"].dtype == torch.bfloat16
    untied = tq.params_bytes(tp)
    tp["lm_head"] = tp["embed"].T
    assert untied - tq.params_bytes(tp) == tp["embed"].numel() * 2


# ── prefill ──────────────────────────────────────────────────────────────


def _jax_prefill(jcfg, jit, prompt, pages, slot, state=None):
    T = len(prompt)
    toks = np.zeros(T_PAD, np.int32)
    toks[:T] = prompt
    table = np.zeros(T_PAD // PS, np.int32)
    table[: len(pages)] = pages
    if state is None:
        state = jq.make_state(jcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=jnp.float32)
    return jit["prefill"](state, jnp.asarray(toks), jnp.int32(T), jnp.asarray(table),
                          jnp.int32(slot))


def _pool_rows(pool, pages, T):
    """[G, Hkv, pages, 2, ps, hd] -> the first T token rows of ``pages``:
    [G, Hkv, 2, T, hd]."""
    x = np.asarray(pool)[:, :, pages].transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(*x.shape[:3], -1, x.shape[-1])[:, :, :, :T]


@pytest.mark.parametrize("chunk", [16, tgdn.CHUNK])
def test_prefill_matches_jax(model, chunk):
    """An 11-token prompt into slot 1: last and all logits, the pool rows it
    wrote and the slot's recurrent and conv rows within 1e-4 of the JAX
    prefill; the same prompt into a slot left dirty by another prompt gives
    the same logits and rows (a prefill writes its slot whole)."""
    jcfg, tcfg, tparams, jit = model
    prompt = np.random.default_rng(1).integers(0, 256, 11).tolist()
    pages = [1, 2, 3]
    jstate, jlast, jall = _jax_prefill(jcfg, jit, prompt, pages, slot=1)
    tstate = tq.make_state(tcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=torch.float32)
    toks = torch.tensor(prompt, dtype=torch.int32)
    table = torch.tensor(pages, dtype=torch.int32)
    tlast, tall = tq.prefill(tcfg, tparams, tstate, toks, table, 1,
                             return_all_logits=True, gdn_chunk_size=chunk)
    np.testing.assert_allclose(tall.numpy(), np.asarray(jall)[:11], rtol=0, atol=ATOL)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_pool_rows(tstate["kv"], pages, 11),
                               _pool_rows(jstate["kv"], pages, 11), rtol=0, atol=ATOL)
    for key in ("rec", "conv"):
        np.testing.assert_allclose(tstate[key][:, :, 1].numpy(),
                                   np.asarray(jstate[key])[:, :, 1], rtol=0, atol=ATOL)
        assert not tstate[key][:, :, [0, 2, 3, 4]].any(), f"{key}: another slot was written"

    # the prompt into slot 2 of a clean state, and into slot 2 of this state
    # after another prompt left it dirty: equal logits and rows
    clean = tq.make_state(tcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=torch.float32)
    clast, none = tq.prefill(tcfg, tparams, clean, toks, table, 2, gdn_chunk_size=chunk)
    assert none is None
    np.testing.assert_allclose(clast.numpy(), np.asarray(jlast), rtol=0, atol=ATOL)
    other = np.random.default_rng(9).integers(0, 256, 7).tolist()
    tq.prefill(tcfg, tparams, tstate, torch.tensor(other, dtype=torch.int32),
               torch.tensor([4, 5], dtype=torch.int32), 2, gdn_chunk_size=chunk)
    assert tstate["rec"][:, :, 2].any() and tstate["conv"][:, :, 2].any()
    dlast, _ = tq.prefill(tcfg, tparams, tstate, toks, torch.tensor([6, 7, 8], dtype=torch.int32),
                          2, gdn_chunk_size=chunk)
    torch.testing.assert_close(dlast, clast, rtol=0, atol=0)
    for key in ("rec", "conv"):
        torch.testing.assert_close(tstate[key][:, :, 2], clean[key][:, :, 2], rtol=0, atol=0)


# ── decode ───────────────────────────────────────────────────────────────


def test_batched_decode_matches_jax(model):
    """Three requests of ragged lengths prefilled into slots 2, 0 and 1,
    then 6 batched decode steps padded to B = 4 with a dead row (seq_len 0,
    null page, the dead slot): live rows' logits and the live slots'
    recurrent and conv rows within 1e-4 of ``q35.decode``, equal greedy
    tokens, and the unused slot 3 never written."""
    jcfg, tcfg, tparams, jit = model
    rng = np.random.default_rng(2)
    lens, slots_of = [5, 14, 9], [2, 0, 1]
    prompts = [rng.integers(0, 256, n).tolist() for n in lens]
    P = 8  # table width: prompt + 6 tokens
    tables = np.zeros((4, P), np.int32)
    jstate = jq.make_state(jcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=jnp.float32)
    tstate = tq.make_state(tcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=torch.float32)
    toks = []
    for b, (prompt, slot) in enumerate(zip(prompts, slots_of)):
        tables[b] = np.arange(1 + b * P, 1 + (b + 1) * P)
        n = -(-len(prompt) // PS)
        jstate, jlast, _ = _jax_prefill(jcfg, jit, prompt, tables[b, :n], slot, jstate)
        tlast, _ = tq.prefill(tcfg, tparams, tstate, torch.tensor(prompt, dtype=torch.int32),
                              torch.from_numpy(tables[b, :n]), slot)
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=0, atol=ATOL)
        toks.append(int(np.argmax(np.asarray(jlast))))
    slots = np.array(slots_of + [MAX_SLOTS], np.int32)
    live = np.arange(4) < 3
    positions = np.array(lens + [0], np.int32)
    for _ in range(6):
        tokens = np.array(toks + [0], np.int32)
        seq_lens = np.where(live, positions + 1, 0).astype(np.int32)
        jstate, jlogits = jit["decode"](jstate, jnp.asarray(tokens), jnp.asarray(positions),
                                        jnp.asarray(tables), jnp.asarray(seq_lens),
                                        jnp.asarray(slots))
        tlogits = tq.decode(tcfg, tparams, tstate, *(torch.from_numpy(a) for a in
                                                     (tokens, positions, tables, seq_lens,
                                                      slots)))
        jl = np.asarray(jlogits)[:3]
        np.testing.assert_allclose(tlogits.numpy()[:3], jl, rtol=0, atol=ATOL)
        toks = [int(t) for t in np.argmax(jl, axis=-1)]
        assert toks == np.argmax(tlogits.numpy()[:3], axis=-1).tolist()
        positions = np.where(live, positions + 1, 0).astype(np.int32)
    for key in ("rec", "conv"):
        np.testing.assert_allclose(tstate[key][:, :, :3].numpy(),
                                   np.asarray(jstate[key])[:, :, :3], rtol=0, atol=ATOL)
        assert not tstate[key][:, :, 3].any(), f"{key}: the unused slot was written"


# ── HF checkpoint layout ─────────────────────────────────────────────────


def test_params_from_state_dict_matches_jax_and_hf():
    """On an HF ``Qwen3NextForCausalLM`` state dict (the JAX parity test's
    tiny model): the port's tree equals the JAX ``params_from_state_dict``'s
    at f32, and its prefill logits match HF's within the JAX parity test's
    5e-3."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Qwen3NextConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=32, rms_norm_eps=1e-6,
        rope_theta=1e6, partial_rotary_factor=0.25, tie_word_embeddings=True,
        max_position_embeddings=512, layer_types=["linear_attention", "full_attention"] * 2,
        linear_num_key_heads=2, linear_num_value_heads=4, linear_key_head_dim=16,
        linear_value_head_dim=16, linear_conv_kernel_dim=4, num_experts=0,
        attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.Qwen3NextForCausalLM(hf_cfg).eval()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    jcfg, tcfg = jq.Qwen35Config.from_hf(hf_cfg), tq.Qwen35Config.from_hf(hf_cfg)
    assert tcfg == tq.Qwen35Config(**{f: getattr(jcfg, f)
                                      for f in tq.Qwen35Config.__dataclass_fields__})
    jp = jax.tree.map(np.asarray, jq.params_from_state_dict(jcfg, sd, dtype=jnp.float32))
    tp = tq.params_from_state_dict(tcfg, sd, dtype=torch.float32)
    for key in ("embed", "final_ln", "lm_head"):
        np.testing.assert_array_equal(tp[key].numpy(), jp[key], err_msg=key)
    for grp in ("lin", "full"):
        assert sorted(tp[grp]) == sorted(jp[grp])
        for key, v in jp[grp].items():
            assert tp[grp][key].dtype == torch.float32
            np.testing.assert_array_equal(tp[grp][key].numpy(), v, err_msg=f"{grp}.{key}")

    prompt = np.random.default_rng(1).integers(0, 255, 11).tolist()
    with torch.no_grad():
        ref = hf(torch.tensor([prompt])).logits[0].float().numpy()
    state = tq.make_state(tcfg, 8, PS, 1, kv_dtype=torch.float32)
    _, tall = tq.prefill(tcfg, tp, state, torch.tensor(prompt, dtype=torch.int32),
                         torch.arange(1, 4, dtype=torch.int32), 0, return_all_logits=True)
    np.testing.assert_allclose(tall.numpy(), ref, rtol=0, atol=5e-3)
