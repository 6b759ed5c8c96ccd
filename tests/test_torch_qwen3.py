"""The port's Qwen3 forward against the JAX package's, on the CPU.

A tiny config (the shape of tests/test_qwen3_parity.py's fixture, untied
head) with weights from the JAX ``init_random_params``, carried over by
``params_from_jax``. At f32 the two agree within atol 1e-4: the same math,
summed in another order by another framework.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pegainfer_tpu.models import qwen3 as jq3
from pegainfer_tpu_torch.models import qwen3 as tq3

PS = 4
NUM_PAGES = 64
ATOL = 1e-4


def _cfgs():
    kw = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=3,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              vocab_size=256, rms_norm_eps=1e-6, rope_theta=1e6,
              tie_word_embeddings=False, max_position_embeddings=512)
    return jq3.Qwen3Config(**kw), tq3.Qwen3Config(**kw)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jparams = jq3.init_random_params(jcfg, seed=5, dtype=jnp.float32, scale=0.1)
    tparams = tq3.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def test_init_random_params_matches_jax():
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jq3.init_random_params(jcfg, seed=3, dtype=jnp.float32))
    tp = tq3.init_random_params(tcfg, seed=3, dtype=torch.float32)
    np.testing.assert_array_equal(tp["embed"].numpy(), jp["embed"])
    np.testing.assert_array_equal(tp["lm_head"].numpy(), jp["lm_head"])
    for k, v in jp["layers"].items():
        np.testing.assert_array_equal(tp["layers"][k].numpy(), v, err_msg=k)


def _prefill_both(jcfg, jparams, tcfg, tparams, jkv, tkv, prompt, pages):
    T = len(prompt)
    n = -(-T // PS)
    table = np.asarray(pages[:n], np.int32)
    toks = np.zeros(n * PS, np.int32)
    toks[:T] = prompt
    jkv, jlast, jall = jq3.prefill(jcfg, jparams, jkv, jnp.asarray(toks), jnp.int32(T),
                                   jnp.asarray(table), return_all_logits=True)
    tlast, tall = tq3.prefill(tcfg, tparams, tkv, torch.tensor(prompt, dtype=torch.int32),
                              torch.from_numpy(table), return_all_logits=True)
    return jkv, (np.asarray(jlast), np.asarray(jall)[:T]), (tlast.numpy(), tall.numpy())


def test_prefill_logits_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    prompt = np.random.default_rng(1).integers(0, 256, 11).tolist()
    jkv = jq3.make_kv_pages(jcfg, NUM_PAGES, PS, dtype=jnp.float32)
    tkv = tq3.make_kv_pages(tcfg, NUM_PAGES, PS, dtype=torch.float32)
    pages = list(range(1, 4))
    jkv, (jlast, jall), (tlast, tall) = _prefill_both(jcfg, jparams, tcfg, tparams, jkv,
                                                      tkv, prompt, pages)
    np.testing.assert_allclose(tall, jall, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tlast, jlast, rtol=0, atol=ATOL)
    # the pool pages compare one to one (same layout), up to the prompt's
    # last token (JAX also writes its padding rows)
    def rows(pool):  # [L, Hkv, n, 2, ps, hd] -> [L, Hkv, 2, n*ps, hd]
        x = np.asarray(pool)[:, :, pages].transpose(0, 1, 3, 2, 4, 5)
        return x.reshape(*x.shape[:3], -1, x.shape[-1])[:, :, :, : len(prompt)]

    np.testing.assert_allclose(rows(tkv.numpy()), rows(jkv), rtol=0, atol=ATOL)
    last_only, none = tq3.prefill(tcfg, tparams, tkv, torch.tensor(prompt, dtype=torch.int32),
                                  torch.tensor(pages, dtype=torch.int32))
    assert none is None
    np.testing.assert_allclose(last_only.numpy(), jlast, rtol=0, atol=ATOL)


def test_batched_decode_matches_jax(models):
    """Three requests of ragged lengths prefilled into one pool, then 8
    batched decode steps (padded to B = 4 with a dead row): logits within
    atol 1e-4 of ``q3.decode`` and equal greedy tokens."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(2)
    lens = [5, 14, 9]
    prompts = [rng.integers(0, 256, n).tolist() for n in lens]
    P = 8  # page-table width: room for prompt + 8 tokens
    jkv = jq3.make_kv_pages(jcfg, NUM_PAGES, PS, dtype=jnp.float32)
    tkv = tq3.make_kv_pages(tcfg, NUM_PAGES, PS, dtype=torch.float32)
    tables = np.zeros((4, P), np.int32)
    nxt = 1
    toks = []
    for b, prompt in enumerate(prompts):
        tables[b] = np.arange(nxt, nxt + P)
        nxt += P
        jkv, (jlast, _), (tlast, _) = _prefill_both(jcfg, jparams, tcfg, tparams, jkv,
                                                    tkv, prompt, tables[b])
        np.testing.assert_allclose(tlast, jlast, rtol=0, atol=ATOL)
        toks.append(int(np.argmax(jlast)))
        assert int(np.argmax(tlast)) == toks[-1]
    positions = np.array(lens + [0], np.int32)
    jdecode = jax.jit(lambda kv, t, p, pt, sl: jq3.decode(jcfg, jparams, kv, t, p, pt, sl))
    for _ in range(8):
        tokens = np.array(toks + [0], np.int32)
        seq_lens = np.where(np.arange(4) < 3, positions + 1, 0).astype(np.int32)
        pos = np.where(np.arange(4) < 3, positions, 0).astype(np.int32)
        jkv, jlogits = jdecode(jkv, jnp.asarray(tokens), jnp.asarray(pos),
                               jnp.asarray(tables), jnp.asarray(seq_lens))
        tlogits = tq3.decode(tcfg, tparams, tkv, torch.from_numpy(tokens),
                             torch.from_numpy(pos), torch.from_numpy(tables),
                             torch.from_numpy(seq_lens))
        jl, tl = np.asarray(jlogits)[:3], tlogits.numpy()[:3]
        np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
        toks = [int(t) for t in np.argmax(jl, -1)]
        assert [int(t) for t in np.argmax(tl, -1)] == toks
        positions[:3] += 1
