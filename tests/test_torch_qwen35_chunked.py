"""The port's Qwen3.5 chunked prefill, fused mixed step and slot snapshots
against the JAX package's, on the CPU.

The tiny f32 period-2 config of tests/test_torch_qwen35_engine.py (hidden
64, 4 layers, hd 32), page size 4, weights from the JAX
``init_random_params``. The JAX side runs its write-ahead forms
(``prefill_chunk_wa`` and ``mixed_chunk_wa``, ``mode="grouped"``,
``gdn_chunk_size=16``, ``use_pallas=False``) followed by their flushes, each
jitted once a module, on pieces padded to 8 rows; the port runs its pieces
unpadded with its GDN chunk of 64. Tolerance: ATOL = 1e-4 on logits, pool
rows and state rows, as tests/test_torch_qwen35.py holds the whole prefill
(the same math summed in another order by another framework); the conv
ops, which only add products in one order, to 1e-5 (y) and exactly (state).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.models import qwen35 as jq
from pegainfer_tpu.ops import gdn as jgdn
from pegainfer_tpu_torch.models import qwen35 as tq
from pegainfer_tpu_torch.ops import gdn as tgdn

PS = 4
TC = 8  # the JAX pieces' padded length (a page multiple)
NUM_PAGES = 32
MAX_SLOTS = 3
ATOL = 1e-4
OP_ATOL = 1e-5


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


@pytest.fixture(scope="module")
def model():
    kw = _cfg_kw()
    jcfg, tcfg = jq.Qwen35Config(**kw), tq.Qwen35Config(**kw)
    jparams = jq.init_random_params(jcfg, seed=13, dtype=jnp.float32, scale=0.2)
    tparams = tq.params_from_jax(jax.tree.map(np.asarray, jparams))

    def chunk(s, t, sp, va, pt, slot):
        cp = jq.make_chunk_pend(jcfg, TC // PS, PS, MAX_SLOTS, jnp.float32)
        s, cp, last = jq.prefill_chunk_wa(jcfg, jparams, s, cp, t, sp, va, pt, slot,
                                          gdn_chunk_size=16, use_pallas=False, mode="grouped")
        return jq.flush_chunk_pend(s, cp), last

    def mixed(s, t, sp, va, pt, slot, dt, dp, dtabs, dsl, dslots):
        B = dt.shape[0]
        cp = jq.make_chunk_pend(jcfg, TC // PS, PS, MAX_SLOTS, jnp.float32)
        dpend = jq.make_pend(jcfg, B, MAX_SLOTS, jnp.float32)
        s, cp, dpend, last, dlog = jq.mixed_chunk_wa(
            jcfg, jparams, s, cp, dpend, t, sp, va, pt, slot, dt, dp, dtabs, dsl, dslots,
            gdn_chunk_size=16, use_pallas=False, mode="grouped")
        s = jq.flush_chunk_pend(s, cp)
        return jq.flush_pend(s, dpend, dsl > 0), last, dlog

    jit = {
        "chunk": jax.jit(chunk),
        "mixed": jax.jit(mixed),
        "prefill": jax.jit(lambda s, t, sl, pt, slot: jq.prefill(
            jcfg, jparams, s, t, sl, pt, slot, gdn_chunk_size=16, mode="grouped")[:2]),
        "decode": jax.jit(lambda s, t, p, pt, sl, slots: jq.decode(
            jcfg, jparams, s, t, p, pt, sl, slots)),
    }
    return jcfg, tcfg, tparams, jit


def _rng_t(rng, *shape, scale=1.0):
    return rng.standard_normal(shape).astype(np.float32) * scale


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


def _pool_rows(pool, pages, T):
    """[G, Hkv, pages, 2, ps, hd] -> the first T token rows of ``pages``:
    [G, Hkv, 2, T, hd]."""
    x = np.asarray(pool)[:, :, pages].transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(*x.shape[:3], -1, x.shape[-1])[:, :, :, :T]


def _assert_slot(tstate, jstate, slot):
    for key in ("rec", "conv"):
        np.testing.assert_allclose(tstate[key][:, :, slot].numpy(),
                                   np.asarray(jstate[key])[:, :, slot], rtol=0, atol=ATOL,
                                   err_msg=f"{key} of slot {slot}")


# ── the conv continuation ────────────────────────────────────────────────


@pytest.mark.parametrize("valid", [5, 12])
def test_causal_conv1d_cont_matches_jax(valid):
    """A 12-row chunk from a nonzero previous window, its state taken at
    ``valid`` < Tc (a padded last piece) and at valid = Tc."""
    rng = np.random.default_rng(valid)
    Tc, C, K = 12, 24, 4
    x, w, prev = _rng_t(rng, Tc, C), _rng_t(rng, C, K, scale=0.5), _rng_t(rng, K, C)
    y, state = tgdn.causal_conv1d_cont(*(torch.from_numpy(a) for a in (x, w, prev)), valid)
    jy, jstate = jax.jit(jgdn.causal_conv1d_cont, static_argnums=3)(
        *(jnp.asarray(a) for a in (x, w, prev)), valid)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=OP_ATOL)
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    assert state.shape == (K, C)
    # the last K inputs before row `valid`, oldest first
    want = np.concatenate([prev, x])[valid:valid + K]
    np.testing.assert_array_equal(state.numpy(), want)


def test_causal_conv1d_cont_chained_is_the_whole_conv():
    """Pieces of 5, 8 and 3 rows, the first from a zero window, each from
    the last one's state: the outputs of ``causal_conv1d`` over the 16 rows
    (to 1e-5: torch's vectorised silu rounds a row apart from its scalar
    tail) and its final state exactly, and the JAX whole conv's."""
    rng = np.random.default_rng(7)
    T, C, K = 16, 24, 4
    x, w = _rng_t(rng, T, C), _rng_t(rng, C, K, scale=0.5)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    state = torch.zeros((K, C))
    ys = []
    for a, b in ((0, 5), (5, 13), (13, 16)):
        y, state = tgdn.causal_conv1d_cont(xt[a:b], wt, state, b - a)
        ys.append(y)
    whole, whole_state = tgdn.causal_conv1d(xt, wt)
    np.testing.assert_allclose(torch.cat(ys).numpy(), whole.numpy(), rtol=0, atol=OP_ATOL)
    assert torch.equal(state, whole_state)
    jy, jstate = jgdn.causal_conv1d(jnp.asarray(x), jnp.asarray(w), T)
    np.testing.assert_allclose(whole.numpy(), np.asarray(jy), rtol=0, atol=OP_ATOL)
    np.testing.assert_array_equal(whole_state.numpy(), np.asarray(jstate))


# ── chunked prefill ──────────────────────────────────────────────────────

PROMPT_T = 27  # pieces of 8 at 0, 8, 16 and a last piece of 3 at 24
PAGES = list(range(1, 8))  # 7 pages hold 27 tokens


def _port_chain(tcfg, tparams, tstate, prompt, pages, slot, ends):
    """The prompt through ``prefill_chunk`` pieces ending at ``ends``;
    returns each piece's last logits."""
    toks, table = _i32(prompt), _i32(pages)
    out, start = [], 0
    for end in ends:
        out.append(tq.prefill_chunk(tcfg, tparams, tstate, toks[start:end], start,
                                    end - start, table, slot))
        start = end
    return out


def _jax_chain(jcfg, jit, prompt, pages, slot, jstate=None):
    """The JAX chain on pieces of TC padded rows; its tables cover each
    piece's padded pages (the null page past the request's)."""
    if jstate is None:
        jstate = jq.make_state(jcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=jnp.float32)
    n = -(-len(prompt) // TC) * TC
    toks = np.zeros(n, np.int32)
    toks[:len(prompt)] = prompt
    table = np.zeros(n // PS, np.int32)
    table[:len(pages)] = pages
    out = []
    for start in range(0, len(prompt), TC):
        valid = min(TC, len(prompt) - start)
        jstate, last = jit["chunk"](jstate, jnp.asarray(toks[start:start + TC]),
                                    jnp.int32(start), jnp.int32(valid), jnp.asarray(table),
                                    jnp.int32(slot))
        out.append(np.asarray(last))
    return jstate, out


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(8, 128, n).tolist()


def test_prefill_chunk_chain_matches_jax(model):
    """27 tokens into slot 1 in pieces of 8, 8, 8, 3: each piece's last
    logits, the pool rows written and the slot's recurrent and conv rows
    against the JAX chain; no other slot is written."""
    jcfg, tcfg, tparams, jit = model
    prompt = _prompt(1, PROMPT_T)
    jstate, jlast = _jax_chain(jcfg, jit, prompt, PAGES, 1)
    tstate = tq.make_state(tcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=torch.float32)
    tlast = _port_chain(tcfg, tparams, tstate, prompt, PAGES, 1, [8, 16, 24, 27])
    for t, j in zip(tlast, jlast):
        assert t.shape == (tcfg.vocab_size,)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(_pool_rows(tstate["kv"], PAGES, PROMPT_T),
                               _pool_rows(jstate["kv"], PAGES, PROMPT_T), rtol=0, atol=ATOL)
    _assert_slot(tstate, jstate, 1)
    for key in ("rec", "conv"):
        assert not tstate[key][:, :, [0, 2, 3]].any(), f"{key}: another slot was written"


def test_prefill_chunk_chain_matches_whole_prefill(model):
    """The chain in pieces of 8 and in uneven pieces (12, 4, 11) against one
    whole ``prefill``: last logits, pool rows, slot rows."""
    _, tcfg, tparams, _ = model
    prompt = _prompt(2, PROMPT_T)
    whole = tq.make_state(tcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=torch.float32)
    wlast, _ = tq.prefill(tcfg, tparams, whole, _i32(prompt), _i32(PAGES), 0)
    for ends in ([8, 16, 24, 27], [12, 16, 27]):
        tstate = tq.make_state(tcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=torch.float32)
        last = _port_chain(tcfg, tparams, tstate, prompt, PAGES, 0, ends)[-1]
        np.testing.assert_allclose(last.numpy(), wlast.numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(_pool_rows(tstate["kv"], PAGES, PROMPT_T),
                                   _pool_rows(whole["kv"], PAGES, PROMPT_T), rtol=0, atol=ATOL)
        for key in ("rec", "conv"):
            np.testing.assert_allclose(tstate[key][:, :, 0].numpy(), whole[key][:, :, 0].numpy(),
                                       rtol=0, atol=ATOL)


def test_first_piece_ignores_a_dirty_recycled_slot(model):
    """A slot left full by another request (slots are recycled LIFO) gives
    the prompt's first piece nothing: the chain into it equals the chain
    into a clean slot bit for bit, rows and logits."""
    _, tcfg, tparams, _ = model
    prompt = _prompt(3, PROMPT_T)
    clean = tq.make_state(tcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=torch.float32)
    want = _port_chain(tcfg, tparams, clean, prompt, PAGES, 2, [8, 16, 24, 27])
    dirty = tq.make_state(tcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=torch.float32)
    _port_chain(tcfg, tparams, dirty, _prompt(4, 19), [8, 9, 10, 11, 12], 2, [8, 16, 19])
    assert dirty["rec"][:, :, 2].any() and dirty["conv"][:, :, 2].any()
    got = _port_chain(tcfg, tparams, dirty, prompt, PAGES, 2, [8, 16, 24, 27])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for key in ("rec", "conv"):
        assert torch.equal(dirty[key][:, :, 2], clean[key][:, :, 2])


# ── the fused mixed step ─────────────────────────────────────────────────

A_LEN = 10  # stream A: prefilled into slot 0 on pages 9-11, one decode step deep


def _mixed_setup(jcfg, tcfg, tparams, jit):
    """Both packages, each with its own forms: A prefilled into slot 0 and
    decoded one token; C's first piece of 8 into slot 1 (pages 1-2 of its
    table [1, ..., 5]). Returns the two states, C's prompt and the fused
    step's decode inputs (B 2: A's row and a padding row on the dead slot)."""
    a_prompt, c_prompt = _prompt(5, A_LEN), _prompt(6, 19)
    a_pages, c_pages = [9, 10, 11], [1, 2, 3, 4, 5]
    jstate = jq.make_state(jcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=jnp.float32)
    toks = np.zeros(16, np.int32)
    toks[:A_LEN] = a_prompt
    jstate, jlast = jit["prefill"](jstate, jnp.asarray(toks), jnp.int32(A_LEN),
                                   jnp.asarray(a_pages + [0], jnp.int32), jnp.int32(0))
    tstate = tq.make_state(tcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=torch.float32)
    tlast, _ = tq.prefill(tcfg, tparams, tstate, _i32(a_prompt), _i32(a_pages), 0)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=0, atol=ATOL)
    tok = int(np.argmax(np.asarray(jlast)))
    tables = np.zeros((2, 4), np.int32)
    tables[0, :3] = a_pages
    step = [np.array(v, np.int32) for v in ([tok, 0], [A_LEN, 0], tables,
                                             [A_LEN + 1, 0], [0, MAX_SLOTS])]
    jstate, jdec = jit["decode"](jstate, *(jnp.asarray(a) for a in step))
    tdec = tq.decode(tcfg, tparams, tstate, *(torch.from_numpy(a) for a in step))
    np.testing.assert_allclose(tdec[0].numpy(), np.asarray(jdec)[0], rtol=0, atol=ATOL)
    jstate, _ = _jax_chain(jcfg, jit, c_prompt[:8], c_pages[:2], 1, jstate)
    _port_chain(tcfg, tparams, tstate, c_prompt, c_pages, 1, [8])
    dec = [np.array(v, np.int32) for v in (
        [int(np.argmax(np.asarray(jdec)[0])), 0], [A_LEN + 1, 0], tables, [A_LEN + 2, 0],
        [0, MAX_SLOTS])]
    return jstate, tstate, c_prompt, c_pages, dec


def test_mixed_chunk_matches_jax(model):
    """C's second piece (8 rows at 8) fused with A's decode row and a
    padding row: the chunk's last logits, A's logits, the pool rows of both
    requests and both slots' rows against ``mixed_chunk_wa`` + its flushes."""
    jcfg, tcfg, tparams, jit = model
    jstate, tstate, c_prompt, c_pages, dec = _mixed_setup(jcfg, tcfg, tparams, jit)
    jstate, jlast, jdlog = jit["mixed"](
        jstate, jnp.asarray(c_prompt[8:16], jnp.int32), jnp.int32(8), jnp.int32(8),
        jnp.asarray(c_pages + [0], jnp.int32), jnp.int32(1), *(jnp.asarray(a) for a in dec))
    tlast, tdlog = tq.mixed_chunk(tcfg, tparams, tstate, _i32(c_prompt[8:16]), 8, 8,
                                  _i32(c_pages), 1, *(torch.from_numpy(a) for a in dec))
    assert tdlog.shape == (2, tcfg.vocab_size)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tdlog[0].numpy(), np.asarray(jdlog)[0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(_pool_rows(tstate["kv"], c_pages, 16),
                               _pool_rows(jstate["kv"], c_pages, 16), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_pool_rows(tstate["kv"], [9, 10, 11], A_LEN + 2),
                               _pool_rows(jstate["kv"], [9, 10, 11], A_LEN + 2), rtol=0,
                               atol=ATOL)
    _assert_slot(tstate, jstate, 0)
    _assert_slot(tstate, jstate, 1)
    assert not tstate["rec"][:, :, 2].any()


def test_mixed_chunk_matches_the_piece_and_the_step_apart(model):
    """The same fused step against ``prefill_chunk`` + ``decode`` on a copy
    of the state, and against itself with ``plain_kernels=True``."""
    jcfg, tcfg, tparams, jit = model
    _, tstate, c_prompt, c_pages, dec = _mixed_setup(jcfg, tcfg, tparams, jit)
    dec = [torch.from_numpy(a) for a in dec]
    chunk = (_i32(c_prompt[8:16]), 8, 8, _i32(c_pages), 1)
    apart = {k: v.clone() for k, v in tstate.items()}
    plain = {k: v.clone() for k, v in tstate.items()}
    last, dlog = tq.mixed_chunk(tcfg, tparams, tstate, *chunk, *dec)
    alast = tq.prefill_chunk(tcfg, tparams, apart, *chunk)
    adlog = tq.decode(tcfg, tparams, apart, *dec)
    plast, pdlog = tq.mixed_chunk(tcfg, tparams, plain, *chunk, *dec, plain_kernels=True)
    for ref_last, ref_dlog, ref_state in ((alast, adlog, apart), (plast, pdlog, plain)):
        np.testing.assert_allclose(last.numpy(), ref_last.numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(dlog[0].numpy(), ref_dlog[0].numpy(), rtol=0, atol=ATOL)
        for key in ("kv", "rec", "conv"):
            np.testing.assert_allclose(tstate[key][:, :, :2].numpy(),
                                       ref_state[key][:, :, :2].numpy(), rtol=0, atol=ATOL)


# ── slot snapshots ───────────────────────────────────────────────────────


def test_snapshot_outlives_its_slot_and_restores(model):
    """A snapshot of slot 0 after 16 tokens stays as it was while the slot
    runs on (a copy, not a view); imported into slot 2 it continues the
    prompt to the chain's logits and rows bit for bit, and the slot's later
    pieces leave the cached snapshot alone too."""
    _, tcfg, tparams, _ = model
    prompt = _prompt(8, PROMPT_T)
    tstate = tq.make_state(tcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=torch.float32)
    _port_chain(tcfg, tparams, tstate, prompt, PAGES, 0, [8, 16])
    snap = tq.slot_export(tstate, 0)
    kept = {k: v.clone() for k, v in snap.items()}
    toks, table = _i32(prompt), _i32(PAGES)
    last = tq.prefill_chunk(tcfg, tparams, tstate, toks[16:], 16, PROMPT_T - 16, table, 0)
    assert not torch.equal(tstate["rec"][:, :, 0], kept["rec"])  # the slot moved on
    for k in kept:
        assert torch.equal(snap[k], kept[k]), f"{k}: the snapshot changed with its slot"
    tq.slot_import(tstate, snap, 2)
    again = tq.prefill_chunk(tcfg, tparams, tstate, toks[16:], 16, PROMPT_T - 16, table, 2)
    assert torch.equal(again, last)
    for key in ("rec", "conv"):
        assert torch.equal(tstate[key][:, :, 2], tstate[key][:, :, 0])
        assert torch.equal(snap[key], kept[key]), f"{key}: the import aliased the snapshot"
