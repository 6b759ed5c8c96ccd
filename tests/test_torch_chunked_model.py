"""The port's chunk continuation and fused mixed step against the JAX
package's, on the CPU.

``prefill_chunk`` against the JAX ``prefill_chunk`` (write-ahead chunk and
its flush), piece by piece after a cached prefix; the port's pieces against
its own whole ``prefill``; ``mixed_chunk`` against the JAX
``mixed_chunk_wa`` and both flushes on ``tests/test_mixed_fused.py``'s
fixture. The config is 2 layers, hidden 64, page 4, f32, weights from the
JAX ``init_random_params`` carried over by ``params_from_jax``. Tolerance:
atol 1e-4 on logits and on the pool rows written, as in
``tests/test_torch_qwen3.py`` (the same math summed in another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pegainfer_tpu.models import qwen3 as jq3
from pegainfer_tpu_torch.models import qwen3 as tq3

PS = 4
NUM_PAGES = 32
ATOL = 1e-4


def _cfgs():
    kw = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              vocab_size=128, rms_norm_eps=1e-6, rope_theta=1e6,
              tie_word_embeddings=True, eos_token_id=1, stop_token_ids=(1,),
              max_position_embeddings=1024)
    return jq3.Qwen3Config(**kw), tq3.Qwen3Config(**kw)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jparams = jq3.init_random_params(jcfg, seed=5, dtype=jnp.float32, scale=0.2)
    tparams = tq3.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _rows(pool, pages, n_tokens):
    """A request's k/v rows by position: [L, Hkv, 2, n_tokens, hd]."""
    x = np.asarray(pool)[:, :, pages].transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(*x.shape[:3], -1, x.shape[-1])[:, :, :, :n_tokens]


def _table(pages, width=8):
    t = np.zeros(width, np.int32)
    t[: len(pages)] = pages
    return t


def _jax_prefix(jcfg, jparams, jkv, prompt, n, table):
    """The JAX whole prefill of ``prompt[:n]`` (n a multiple of PS)."""
    jkv, _, _ = jq3.prefill(jcfg, jparams, jkv, jnp.asarray(prompt[:n], jnp.int32),
                            jnp.int32(n), jnp.asarray(table[: n // PS]))
    return jkv


# (start, valid) pieces after a cached prefix of PREFIX tokens; the last
# piece is short (the JAX chunk pads it to a whole page)
PREFIX = 12
PIECES = ((12, 8), (20, 9))


def test_prefill_chunk_matches_jax(models):
    """Pieces after a cached prefix (the first starts at the page boundary
    after it): each piece's last logits and every row written."""
    jcfg, jparams, tcfg, tparams = models
    prompt = np.random.default_rng(1).integers(2, 128, 29).astype(np.int32)
    pages = [3, 9, 4, 11, 5, 6, 2, 8]
    table = _table(pages)
    jkv = _jax_prefix(jcfg, jparams, jq3.make_kv_pages(jcfg, NUM_PAGES, PS, dtype=jnp.float32),
                      prompt, PREFIX, table)
    tkv = torch.from_numpy(np.array(jkv))  # the cached prefix, shared as-is
    for start, valid in PIECES:
        Tc = -(-valid // PS) * PS
        toks = np.zeros(Tc, np.int32)
        toks[:valid] = prompt[start:start + valid]
        jkv, jlast = jq3.prefill_chunk(jcfg, jparams, jkv, jnp.asarray(toks),
                                       jnp.int32(start), jnp.int32(valid),
                                       jnp.asarray(table))
        tlast = tq3.prefill_chunk(tcfg, tparams, tkv, torch.from_numpy(toks), start, valid,
                                  torch.from_numpy(table))
        assert tlast.shape == (tcfg.vocab_size,) and tlast.dtype == torch.float32
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=0, atol=ATOL)
        end = start + valid
        np.testing.assert_allclose(_rows(tkv.numpy(), pages, end), _rows(jkv, pages, end),
                                   rtol=0, atol=ATOL)
    # pages of no request stay untouched (only valid rows are written)
    others = sorted(set(range(NUM_PAGES)) - set(pages))
    assert not tkv[:, :, others].any()


@pytest.mark.parametrize("cuts", [(16,), (8, 20), (4, 12, 24)])
def test_prefill_chunk_pieces_match_whole_prefill(models, cuts):
    """The port's pieces (first from position 0) against its own whole
    prefill: the last logits and the pool."""
    _, _, tcfg, tparams = models
    T = 29
    prompt = torch.from_numpy(np.random.default_rng(2).integers(2, 128, T).astype(np.int32))
    pages = torch.arange(1, 9, dtype=torch.int32)
    whole = tq3.make_kv_pages(tcfg, NUM_PAGES, PS, dtype=torch.float32)
    want, _ = tq3.prefill(tcfg, tparams, whole, prompt, pages)
    kv = tq3.make_kv_pages(tcfg, NUM_PAGES, PS, dtype=torch.float32)
    bounds = (0,) + cuts + (T,)
    for start, end in zip(bounds, bounds[1:]):
        got = tq3.prefill_chunk(tcfg, tparams, kv, prompt[start:], start, end - start, pages)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(kv.numpy(), whole.numpy(), rtol=0, atol=ATOL)


def _mixed_fixture(jcfg):
    """``tests/test_mixed_fused.py:37-80``'s fixture: two decode rows with
    9 and 13 tokens of KV (pages 1-3 / 4-7), the prefilling request's
    second chunk (start 8, pages 10-11), a previous chunk pend on pages 8-9
    and a previous decode pend."""
    ps = 4
    rng = np.random.default_rng(0)
    dec_lens = [9, 13]
    dec_tables = np.full((2, 8), 0, np.int32)
    dec_tables[0, :3] = [1, 2, 3]
    dec_tables[1, :4] = [4, 5, 6, 7]
    pre_table = np.full(8, 0, np.int32)
    pre_table[:4] = [8, 9, 10, 11]
    pool = jq3.make_kv_pages(jcfg, 32, ps, dtype=jnp.float32)
    fill = jnp.asarray(rng.standard_normal(np.asarray(pool[:, :, 1:12]).shape)
                       .astype(np.float32))
    pool = pool.at[:, :, 1:12].set(fill)
    chunk_toks = rng.integers(2, 128, 8).astype(np.int32)
    dec_toks = rng.integers(2, 128, 2).astype(np.int32)
    cpend0 = jq3.make_chunk_pend(jcfg, 2, ps, jnp.float32)
    cpend0 = {"rows": jnp.asarray(rng.standard_normal(np.asarray(cpend0["rows"]).shape)
                                  .astype(np.float32)),
              "pages": jnp.asarray([8, 9], jnp.int32)}
    dpend0 = jq3.make_pend(jcfg, 2, jnp.float32)
    dpend0 = {"rows": jnp.asarray(rng.standard_normal(np.asarray(dpend0["rows"]).shape)
                                  .astype(np.float32)),
              "page_ids": jnp.asarray([3, 7], jnp.int32),
              "slots": jnp.asarray([0, 0], jnp.int32)}
    dec = dict(toks=dec_toks, pos=np.asarray([n - 1 for n in dec_lens], np.int32),
               tables=dec_tables, seq_lens=np.asarray(dec_lens, np.int32))
    return pool, cpend0, dpend0, chunk_toks, pre_table, dec


@pytest.mark.parametrize("valid", [8, 5])
def test_mixed_chunk_matches_jax(models, valid):
    """The fused step against the JAX ``mixed_chunk_wa`` and its flushes:
    the chunk's last logits, the decode logits and the whole pool. The
    port has no pends: it starts from the pool with the previous pends
    landed, as the JAX step's first act lands them."""
    jcfg, jparams, tcfg, tparams = models
    pool, cpend0, dpend0, chunk_toks, pre_table, dec = _mixed_fixture(jcfg)
    chunk_toks = chunk_toks.copy()
    chunk_toks[valid:] = 0
    start = 8
    j = [jnp.asarray(dec[k]) for k in ("toks", "pos", "tables", "seq_lens")]
    kv, cpend, dpend, jlast, jdec = jq3.mixed_chunk_wa(
        jcfg, jparams, pool, cpend0, dpend0, jnp.asarray(chunk_toks), jnp.int32(start),
        jnp.int32(valid), jnp.asarray(pre_table), *j)
    kv = jq3.flush_chunk_pend(kv, cpend)
    kv = jq3.flush_pend(kv, dpend, jnp.ones((2,), bool))

    landed = jq3.flush_pend(jq3.flush_chunk_pend(pool, cpend0), dpend0, jnp.ones((2,), bool))
    tkv = torch.from_numpy(np.array(landed))
    t = [torch.from_numpy(dec[k]) for k in ("toks", "pos", "tables", "seq_lens")]
    tlast, tdec = tq3.mixed_chunk(tcfg, tparams, tkv, torch.from_numpy(chunk_toks), start,
                                  valid, torch.from_numpy(pre_table), *t)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), rtol=0, atol=ATOL)
    want = np.asarray(kv).copy()
    if valid < 8:  # the JAX chunk also writes its padding rows; the port does not
        end = start + valid
        got_rows = _rows(tkv.numpy(), [8, 9, 10, 11], end)
        np.testing.assert_allclose(got_rows, _rows(want, [8, 9, 10, 11], end), rtol=0,
                                   atol=ATOL)
        want[:, :, 10:12] = tkv.numpy()[:, :, 10:12]  # padding region compared above
    np.testing.assert_allclose(tkv.numpy(), want, rtol=0, atol=ATOL)


def test_mixed_chunk_matches_chunk_then_decode(models):
    """The port's fused step against its own ``prefill_chunk`` and
    ``decode`` run apart on a copy of the pool (the chip's check, here on
    the plain versions)."""
    jcfg, _, tcfg, tparams = models
    pool, cpend0, dpend0, chunk_toks, pre_table, dec = _mixed_fixture(jcfg)
    landed = np.array(jq3.flush_pend(jq3.flush_chunk_pend(pool, cpend0), dpend0,
                                     jnp.ones((2,), bool)))
    t = [torch.from_numpy(dec[k]) for k in ("toks", "pos", "tables", "seq_lens")]
    fused = torch.from_numpy(landed.copy())
    last_f, dec_f = tq3.mixed_chunk(tcfg, tparams, fused, torch.from_numpy(chunk_toks), 8, 8,
                                    torch.from_numpy(pre_table), *t)
    apart = torch.from_numpy(landed.copy())
    last_a = tq3.prefill_chunk(tcfg, tparams, apart, torch.from_numpy(chunk_toks), 8, 8,
                               torch.from_numpy(pre_table))
    dec_a = tq3.decode(tcfg, tparams, apart, *t)
    np.testing.assert_allclose(last_f.numpy(), last_a.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(dec_f.numpy(), dec_a.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(fused.numpy(), apart.numpy(), rtol=0, atol=ATOL)
