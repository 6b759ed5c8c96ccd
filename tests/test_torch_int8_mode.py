"""The port's int8 weight-only mode (``quantize="int8"``) for Qwen3 and the
Qwen3.5 hybrid against the JAX package's, on the CPU.

The configs and seeds are ``tests/test_int8_mode.py``'s (Qwen3: 2 layers,
hidden 64, tied head, seed 5; Qwen3.5: period 4, hidden 64, its
``init_bench_params`` tree made less uniform by seed 3), f32, page 4.

- The port's quantizer (``quantize_params_int8``, through
  ``ops/quant.py::quantize_int8_linear``) against the JAX
  ``quantize_params_int8``: every code equal, scales at rtol 1e-6 (as
  ``test_init_bench_params_int8_matches_quantize`` holds them).
- ``prefill`` (all logits), ``prefill_chunk`` (all logits),
  ``mixed_chunk`` and ``decode`` on the JAX-quantized params (carried over
  by ``params_from_jax``) against the JAX functions: logits and pool rows
  at atol 1e-4, the tolerance of the port's f32 model tests
  (``tests/test_torch_qwen3.py``, ``tests/test_torch_qwen35.py``: the same
  math summed in another order).
- JAX's own check: the int8 model's logits keep a cosine above 0.999 with
  the unquantized model's.
- The port's engines with ``quantize="int8"`` (quantizing the unquantized
  params at start) against the JAX engine on the JAX-quantized params:
  equal greedy streams, whole and with chunks and the prefix cache.
- Every other ``quantize`` value raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu.engine import contract as jc
from pegainfer_tpu.engine.jax_executor import JaxExecutor
from pegainfer_tpu.engine.scheduler import start_scheduler as j_start_scheduler
from pegainfer_tpu.models import qwen3 as jq3
from pegainfer_tpu.models import qwen35 as jq
from pegainfer_tpu_torch.engine import contract as tc
from pegainfer_tpu_torch.models import qwen3 as tq3
from pegainfer_tpu_torch.models import qwen35 as tq
from pegainfer_tpu_torch.models import qwen3_engine as t3engine
from pegainfer_tpu_torch.models import qwen35_engine as tqengine
from pegainfer_tpu_torch.ops import quant

PS = 4
NUM_PAGES = 32
MAX_SLOTS = 3
ATOL = 1e-4
WAIT_S = 300
# the chunk options of the engine tests: pieces of 64 (a page of the port's
# engine), the prefix cache on
CHUNK = dict(prefill_chunk=64, prefill_chunk_mixed=64, enable_prefix_cache=True)
WHOLE = dict(prefill_chunk=None, enable_prefix_cache=False)


def _q3_kw():
    return dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                vocab_size=128, rms_norm_eps=1e-6, rope_theta=1e6,
                tie_word_embeddings=True, eos_token_id=1, stop_token_ids=(1,),
                max_position_embeddings=512)


def _q35_kw():
    return dict(hidden_size=64, intermediate_size=128, num_hidden_layers=4,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                vocab_size=128, rms_norm_eps=1e-6, rope_theta=1e6,
                partial_rotary_factor=0.25,
                layer_types=("linear_attention",) * 3 + ("full_attention",),
                linear_num_key_heads=2, linear_num_value_heads=4,
                linear_key_head_dim=8, linear_value_head_dim=8,
                linear_conv_kernel_dim=4, tie_word_embeddings=True,
                eos_token_id=1, stop_token_ids=(1,), max_position_embeddings=512)


def _copy(tree):
    return jax.tree.map(lambda a: a, tree)


@pytest.fixture(scope="module")
def q3_models():
    """(JAX cfg, port cfg, JAX f32 params, JAX int8 params, port int8 params
    from the JAX ones)."""
    jcfg, tcfg = jq3.Qwen3Config(**_q3_kw()), tq3.Qwen3Config(**_q3_kw())
    jparams = jq3.init_random_params(jcfg, seed=5, dtype=jnp.float32)
    j8 = jq3.quantize_params_int8(_copy(jparams))
    return jcfg, tcfg, jparams, j8, tq3.params_from_jax(jax.tree.map(np.asarray, j8))


@pytest.fixture(scope="module")
def q35_models():
    jcfg, tcfg = jq.Qwen35Config(**_q35_kw()), tq.Qwen35Config(**_q35_kw())
    jparams = jq.init_bench_params(jcfg, dtype=jnp.float32, fill=0.02)
    rng = np.random.default_rng(3)  # as tests/test_int8_mode.py: logits not uniform
    for k in ("embed", "lm_head"):
        jparams[k] = jnp.asarray(rng.standard_normal(jparams[k].shape) * 0.05, jnp.float32)
    # the projections random too, so their codes span the int8 range
    for part in ("lin", "full"):
        for k in (tq.INT8_LIN if part == "lin" else tq.INT8_FULL):
            shape = jparams[part][k].shape
            jparams[part][k] = jnp.asarray(rng.standard_normal(shape) * 0.1, jnp.float32)
    j8 = jq.quantize_params_int8(_copy(jparams))
    return jcfg, tcfg, jparams, j8, tq.params_from_jax(jax.tree.map(np.asarray, j8))


def _port_f32(family, jparams):
    mod = tq3 if family == "qwen3" else tq
    return mod.params_from_jax(jax.tree.map(np.asarray, jparams))


def _containers(tree, path=()):
    """(path, leaf) of every int8 leaf of a JAX ({"q8", "s"}) or port
    ({"q", "s"}) tree."""
    for k, v in tree.items():
        if isinstance(v, dict) and ("q8" in v or "q" in v):
            yield path + (k,), v
        elif isinstance(v, dict):
            yield from _containers(v, path + (k,))


# ── the quantizer ───────────────────────────────────────────────────────


@pytest.mark.parametrize("family", ["qwen3", "qwen35"])
def test_quantizer_matches_jax(family, q3_models, q35_models):
    """Every leaf the JAX quantizer turns to int8, and no other, is a port
    container; its codes equal the JAX codes (transposed to [.., out, in])
    exactly and its scales to rtol 1e-6. The tied Qwen3 head is quantized
    apart from the embedding, which stays f32."""
    _, _, jparams, j8, _ = q3_models if family == "qwen3" else q35_models
    mod = tq3 if family == "qwen3" else tq
    mine = mod.quantize_params_int8(_port_f32(family, jparams))
    want = dict(_containers(j8))
    got = dict(_containers(mine))
    assert set(got) == set(want) and len(got) == (7 if family == "qwen3" else 15)
    for path, w in want.items():
        q8, s = np.asarray(w["q8"]), np.asarray(w["s"])
        assert got[path]["q"].dtype == torch.int8 and got[path]["s"].dtype == torch.float32
        np.testing.assert_array_equal(got[path]["q"].numpy(), np.swapaxes(q8, -1, -2),
                                      err_msg=str(path))
        np.testing.assert_allclose(got[path]["s"].numpy(), s, rtol=1e-6, atol=0)
    assert mine["embed"].dtype == torch.float32
    if family == "qwen35":
        assert not quant.is_quantized(mine["lin"]["wb"]) and not quant.is_quantized(
            mine["lin"]["wa"])


def test_quantize_int8_linear_edge_cases():
    """A zero channel gets scale 1 and codes 0; a channel's amax maps to
    +-127; ties round to even; works on a bf16 stack in pieces of
    channels (the output axis longer than a piece)."""
    w = torch.zeros((3, 5000), dtype=torch.float32)
    w[:, 1] = torch.tensor([1.0, -2.0, 0.5])
    w[:, 4999] = torch.tensor([127.0, 0.5, -1.5])  # q = 127, 0.5 -> 0, -1.5 -> -2
    c = quant.quantize_int8_linear(w)
    assert c["q"].shape == (5000, 3) and c["s"].shape == (5000,)
    assert c["s"][0] == 1.0 and not c["q"][0].any()
    assert c["q"][1].tolist() == [64, -127, 32] and c["s"][1] == np.float32(2.0) / 127
    assert c["q"][4999].tolist() == [127, 0, -2] and c["s"][4999] == 1.0
    stack = torch.randn((2, 3, 64, 40)).to(torch.bfloat16)
    cs = quant.quantize_int8_linear(stack)
    assert cs["q"].shape == (2, 3, 40, 64) and cs["s"].shape == (2, 3, 40)
    one = quant.quantize_int8_linear(stack[1, 2])
    assert torch.equal(cs["q"][1, 2], one["q"]) and torch.equal(cs["s"][1, 2], one["s"])


def test_int8_linear_is_the_jax_function():
    """x times the codes, f32 sums, times the scale, cast to x's dtype: the
    JAX ``int8_linear`` on the same codes, for f32 and bf16 rows."""
    from pegainfer_tpu.ops import quant as jquant

    rng = np.random.default_rng(0)
    w = rng.standard_normal((48, 20)).astype(np.float32)
    qj, sj = jquant.quant_int8_channel(jnp.asarray(w))
    c = quant.quantize_int8_linear(torch.from_numpy(w))
    np.testing.assert_array_equal(c["q"].numpy(), np.asarray(qj).T)
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 1e-5),
                               (torch.bfloat16, jnp.bfloat16, 1e-2)):
        x = rng.standard_normal((5, 48)).astype(np.float32)
        got = quant.int8_linear(torch.from_numpy(x).to(dtype), c)
        want = jquant.int8_linear(jnp.asarray(x, jdtype), qj, sj)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


# ── the model functions on JAX-quantized params ─────────────────────────


def _rows(pool, pages, n_tokens):
    """A request's k/v rows by position: [L, Hkv, 2, n_tokens, hd]."""
    x = np.asarray(pool)[:, :, pages].transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(*x.shape[:3], -1, x.shape[-1])[:, :, :, :n_tokens]


def _table(pages, width=8):
    t = np.zeros(width, np.int32)
    t[: len(pages)] = pages
    return t


# prompts: A whole (13 tokens, pages 1-4); B a whole prefix of 8 (pages 5-6)
# continued by a chunk of 9 at 8 (pages 7-9); then one decode step of A and
# B; then C's first chunk of 8 (pages 10-11) fused with a decode row of each
A_PAGES, B_PAGES, C_PAGES = [1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11]
# the rows each request holds at the end: prompt and two decode tokens
REQUEST_ROWS = ((A_PAGES, 15), (B_PAGES, 19), (C_PAGES, 8))


def _prompts():
    rng = np.random.default_rng(8)
    return (rng.integers(2, 128, 13).astype(np.int32), rng.integers(2, 128, 17).astype(np.int32),
            rng.integers(2, 128, 8).astype(np.int32))


@pytest.fixture(scope="module")
def q3_runs(q3_models):
    """The scenario on both sides: {step: (port out, JAX out)}, and the
    pools after it."""
    jcfg, tcfg, _, j8, t8 = q3_models
    A, B, C = _prompts()
    jkv = jq3.make_kv_pages(jcfg, NUM_PAGES, PS, dtype=jnp.float32)
    tkv = tq3.make_kv_pages(tcfg, NUM_PAGES, PS, dtype=torch.float32)
    out = {}
    # A whole, all logits (JAX: padded to 16)
    a16 = np.zeros(16, np.int32)
    a16[:13] = A
    jkv, jlast, jall = jq3.prefill(jcfg, j8, jkv, jnp.asarray(a16), jnp.int32(13),
                                   jnp.asarray(A_PAGES, jnp.int32), return_all_logits=True)
    tlast, tall = tq3.prefill(tcfg, t8, tkv, torch.from_numpy(A), torch.tensor(A_PAGES),
                              return_all_logits=True)
    out["prefill"] = ((tlast, tall), (np.asarray(jlast), np.asarray(jall)[:13]))
    # B: a whole prefix of 8, then a chunk of 9 at 8 with all its logits
    jkv, _, _ = jq3.prefill(jcfg, j8, jkv, jnp.asarray(B[:8]), jnp.int32(8),
                            jnp.asarray(B_PAGES[:2], jnp.int32))
    tq3.prefill(tcfg, t8, tkv, torch.from_numpy(B[:8]), torch.tensor(B_PAGES[:2]))
    b12 = np.zeros(12, np.int32)
    b12[:9] = B[8:]
    table = _table(B_PAGES)
    cp = jq3.make_chunk_pend(jcfg, 3, PS, jnp.float32)
    jkv, cp, jlast, jchunk = jq3.prefill_chunk_wa(
        jcfg, j8, jkv, cp, jnp.asarray(b12), jnp.int32(8), jnp.int32(9), jnp.asarray(table),
        return_all_logits=True)
    jkv = jq3.flush_chunk_pend(jkv, cp)
    tchunk = tq3.prefill_chunk(tcfg, t8, tkv, torch.from_numpy(B[8:]), 8, 9,
                               torch.from_numpy(table), return_all_logits=True)
    out["prefill_chunk"] = (tchunk, (np.asarray(jlast), np.asarray(jchunk)[:9]))
    # one decode step of A and B
    tables = np.stack([_table(A_PAGES), _table(B_PAGES)])
    dec = (np.asarray([A[-1], B[-1]], np.int32), np.asarray([13, 17], np.int32), tables,
           np.asarray([14, 18], np.int32))
    jkv, jdec = jq3.decode(jcfg, j8, jkv, *(jnp.asarray(a) for a in dec))
    tdec = tq3.decode(tcfg, t8, tkv, *(torch.from_numpy(a) for a in dec))
    out["decode"] = (tdec, np.asarray(jdec))
    # C's first chunk fused with a decode row of A and of B
    dec = (np.asarray([5, 6], np.int32), np.asarray([14, 18], np.int32), tables,
           np.asarray([15, 19], np.int32))
    cp = jq3.make_chunk_pend(jcfg, 2, PS, jnp.float32)
    dp = jq3.make_pend(jcfg, 2, jnp.float32)
    jkv, cp, dp, jlast, jdl = jq3.mixed_chunk_wa(
        jcfg, j8, jkv, cp, dp, jnp.asarray(C), jnp.int32(0), jnp.int32(8),
        jnp.asarray(_table(C_PAGES)), *(jnp.asarray(a) for a in dec))
    jkv = jq3.flush_pend(jq3.flush_chunk_pend(jkv, cp), dp, jnp.ones((2,), bool))
    tlast, tdl = tq3.mixed_chunk(tcfg, t8, tkv, torch.from_numpy(C), 0, 8,
                                 torch.from_numpy(_table(C_PAGES)),
                                 *(torch.from_numpy(a) for a in dec))
    out["mixed_chunk"] = ((tlast, tdl), (np.asarray(jlast), np.asarray(jdl)))
    return out, tkv.numpy(), np.asarray(jkv)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_qwen3_int8_prefill_matches_jax(q3_runs):
    (tlast, tall), (jlast, jall) = q3_runs[0]["prefill"]
    _close(tlast, jlast)
    _close(tall, jall)


def test_qwen3_int8_prefill_chunk_matches_jax(q3_runs):
    """The chunk's every row (``return_all_logits``, the echo path) and its
    last row against the JAX ``prefill_chunk_wa`` with all logits."""
    tchunk, (jlast, jchunk) = q3_runs[0]["prefill_chunk"]
    assert tchunk.shape == (9, 128)
    _close(tchunk, jchunk)
    _close(tchunk[-1], jlast)


def test_qwen3_int8_decode_matches_jax(q3_runs):
    tdec, jdec = q3_runs[0]["decode"]
    _close(tdec, jdec)


def test_qwen3_int8_mixed_chunk_matches_jax(q3_runs):
    """The fused step's logits, and every pool row of the three requests
    (the JAX side also writes its padding rows, which the port never
    does)."""
    out, tkv, jkv = q3_runs
    (tlast, tdl), (jlast, jdl) = out["mixed_chunk"]
    _close(tlast, jlast)
    _close(tdl, jdl)
    for pages, n in REQUEST_ROWS:
        np.testing.assert_allclose(_rows(tkv, pages, n), _rows(jkv, pages, n), rtol=0,
                                   atol=ATOL)


@pytest.fixture(scope="module")
def q35_runs(q35_models):
    jcfg, tcfg, _, j8, t8 = q35_models
    A, B, C = _prompts()
    grouped = dict(gdn_chunk_size=16, mode="grouped")
    jst = jq.make_state(jcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=jnp.float32)
    tst = tq.make_state(tcfg, NUM_PAGES, PS, MAX_SLOTS, kv_dtype=torch.float32)
    out = {}
    a16 = np.zeros(16, np.int32)
    a16[:13] = A
    jst, jlast, jall = jq.prefill(jcfg, j8, jst, jnp.asarray(a16), jnp.int32(13),
                                  jnp.asarray(A_PAGES, jnp.int32), jnp.int32(0),
                                  return_all_logits=True, **grouped)
    tlast, tall = tq.prefill(tcfg, t8, tst, torch.from_numpy(A), torch.tensor(A_PAGES), 0,
                             return_all_logits=True)
    out["prefill"] = ((tlast, tall), (np.asarray(jlast), np.asarray(jall)[:13]))
    # B into slot 1: a first chunk of 8 from position 0, then 9 at 8
    table = _table(B_PAGES)
    b = np.zeros(20, np.int32)
    b[:17] = B
    for start, valid, Tc in ((0, 8, 8), (8, 9, 12)):
        cp = jq.make_chunk_pend(jcfg, Tc // PS, PS, MAX_SLOTS, jnp.float32)
        jst, cp, jlast, jchunk = jq.prefill_chunk_wa(
            jcfg, j8, jst, cp, jnp.asarray(b[start:start + Tc]), jnp.int32(start),
            jnp.int32(valid), jnp.asarray(table), jnp.int32(1), return_all_logits=True,
            **grouped)
        jst = jq.flush_chunk_pend(jst, cp)
        tchunk = tq.prefill_chunk(tcfg, t8, tst, torch.from_numpy(B[start:]), start, valid,
                                  torch.from_numpy(table), 1, return_all_logits=True)
    out["prefill_chunk"] = (tchunk, (np.asarray(jlast), np.asarray(jchunk)[:9]))
    tables = np.stack([_table(A_PAGES), _table(B_PAGES)])
    slots = np.asarray([0, 1], np.int32)
    dec = (np.asarray([A[-1], B[-1]], np.int32), np.asarray([13, 17], np.int32), tables,
           np.asarray([14, 18], np.int32))
    jst, jdec = jq.decode(jcfg, j8, jst, *(jnp.asarray(a) for a in dec), jnp.asarray(slots))
    tdec = tq.decode(tcfg, t8, tst, *(torch.from_numpy(a) for a in dec),
                     torch.from_numpy(slots))
    out["decode"] = (tdec, np.asarray(jdec))
    dec = (np.asarray([5, 6], np.int32), np.asarray([14, 18], np.int32), tables,
           np.asarray([15, 19], np.int32))
    cp = jq.make_chunk_pend(jcfg, 2, PS, MAX_SLOTS, jnp.float32)
    dp = jq.make_pend(jcfg, 2, MAX_SLOTS, jnp.float32)
    jst, cp, dp, jlast, jdl = jq.mixed_chunk_wa(
        jcfg, j8, jst, cp, dp, jnp.asarray(C), jnp.int32(0), jnp.int32(8),
        jnp.asarray(_table(C_PAGES)), jnp.int32(2), *(jnp.asarray(a) for a in dec),
        jnp.asarray(slots), **grouped)
    jst = jq.flush_pend(jq.flush_chunk_pend(jst, cp), dp, jnp.ones((2,), bool))
    tlast, tdl = tq.mixed_chunk(tcfg, t8, tst, torch.from_numpy(C), 0, 8,
                                torch.from_numpy(_table(C_PAGES)), 2,
                                *(torch.from_numpy(a) for a in dec), torch.from_numpy(slots))
    out["mixed_chunk"] = ((tlast, tdl), (np.asarray(jlast), np.asarray(jdl)))
    return out, tst, jst


def test_qwen35_int8_prefill_matches_jax(q35_runs):
    (tlast, tall), (jlast, jall) = q35_runs[0]["prefill"]
    _close(tlast, jlast)
    _close(tall, jall)


def test_qwen35_int8_prefill_chunk_matches_jax(q35_runs):
    tchunk, (jlast, jchunk) = q35_runs[0]["prefill_chunk"]
    assert tchunk.shape == (9, 128)
    _close(tchunk, jchunk)
    _close(tchunk[-1], jlast)


def test_qwen35_int8_decode_matches_jax(q35_runs):
    tdec, jdec = q35_runs[0]["decode"]
    _close(tdec, jdec)


def test_qwen35_int8_mixed_chunk_matches_jax(q35_runs):
    """The fused step's logits, the pool rows and the three slots' state."""
    out, tst, jst = q35_runs
    (tlast, tdl), (jlast, jdl) = out["mixed_chunk"]
    _close(tlast, jlast)
    _close(tdl, jdl)
    for pages, n in REQUEST_ROWS:
        np.testing.assert_allclose(_rows(tst["kv"].numpy(), pages, n),
                                   _rows(jst["kv"], pages, n), rtol=0, atol=ATOL)
    for key in ("rec", "conv"):
        np.testing.assert_allclose(tst[key].numpy()[:, :, :MAX_SLOTS],
                                   np.asarray(jst[key])[:, :, :MAX_SLOTS], rtol=0, atol=ATOL)


@pytest.mark.parametrize("family", ["qwen3", "qwen35"])
def test_int8_logits_close_to_unquantized(family, q3_models, q35_models):
    """JAX's check (``tests/test_int8_mode.py``), on the port: the int8
    prefill's last logits keep a cosine above 0.999 with the f32 model's."""
    _, tcfg, jparams, _, t8 = q3_models if family == "qwen3" else q35_models
    tf = _port_f32(family, jparams)
    toks, table = torch.arange(3, 11, dtype=torch.int32), torch.tensor([1, 2])
    logits = []
    for params in (tf, t8):
        if family == "qwen3":
            kv = tq3.make_kv_pages(tcfg, 8, PS, dtype=torch.float32)
            logits.append(tq3.prefill(tcfg, params, kv, toks, table)[0].numpy())
        else:
            st = tq.make_state(tcfg, 8, PS, 1, kv_dtype=torch.float32)
            logits.append(tq.prefill(tcfg, params, st, toks, table, 0)[0].numpy())
    a, b = logits
    assert (a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999


# ── the engines ──────────────────────────────────────────────────────────


def _streams(mod, handle, prompts, max_tokens):
    """Each prompt alone, greedy, ignoring EOS: its token ids."""
    out = []
    for p in prompts:
        ch = mod.TokenChannel()
        handle.submit(mod.GenerateRequest(prompt_tokens=list(p), max_tokens=max_tokens,
                                          params=mod.SamplingParams(ignore_eos=True),
                                          channel=ch))
        toks = []
        while True:
            ev = ch.get(timeout=WAIT_S)
            assert ev is not None, "engine produced no event in time"
            if isinstance(ev, mod.Token):
                toks.append(ev.id)
            elif mod.is_terminal(ev):
                assert isinstance(ev, mod.Finished), ev
                break
        out.append(toks)
    return out


@pytest.mark.parametrize("opts", ["whole", "chunked"])
@pytest.mark.parametrize("family", ["qwen3", "qwen35"])
def test_int8_engine_matches_jax_engine(family, opts, q3_models, q35_models):
    """``start_engine_from_params(quantize="int8")`` on the unquantized
    params against the JAX engine on its quantized ones: three prompts (the
    last repeating the first; chunked, three pieces and then a prefix-cache
    hit), each's greedy stream equal; the port's tree is quantized in
    place."""
    jcfg, tcfg, jparams, j8, _ = q3_models if family == "qwen3" else q35_models
    options = WHOLE if opts == "whole" else CHUNK
    # the JAX engine takes no None chunk: a chunk above every prompt
    joptions = {**options, "prefill_chunk": options["prefill_chunk"] or 4096}
    rng = np.random.default_rng(4)
    prompts = [rng.integers(8, 128, n).tolist() for n in (150, 11)]
    prompts.append(prompts[0])
    if family == "qwen3":
        rt = jq3.make_runtime(jcfg, j8, num_pages=64, page_size=PS, kv_dtype=jnp.float32,
                              use_pallas=False)
        jopts = jc.EngineLoadOptions(**joptions)
    else:
        rt = jq.make_runtime(jcfg, j8, num_pages=64, page_size=PS, max_slots=2,
                             kv_dtype=jnp.float32, use_pallas=False, flat_decode=False,
                             prefill_mode="grouped")
        jopts = jc.EngineLoadOptions(precompile=False, max_batch_size=2, decode_block=1,
                                     **joptions)
    jhandle = j_start_scheduler(JaxExecutor(rt, jopts))
    try:
        ref = _streams(jc, jhandle, prompts, 8)
    finally:
        jhandle.shutdown()

    tparams = _port_f32(family, jparams)
    engine = t3engine if family == "qwen3" else tqengine
    thandle = engine.start_engine_from_params(
        tcfg, tparams, tc.EngineLoadOptions(quantize="int8", max_num_pages=64,
                                            max_batch_size=2, **options), device="cpu")
    ex = thandle._scheduler.executor
    try:
        out = _streams(tc, thandle, prompts, 8)
    finally:
        thandle.shutdown()
    assert out == ref and all(len(t) == 8 for t in out)
    assert quant.is_quantized(ex.params["lm_head"]) and ex.params is tparams
    if opts == "chunked":
        assert ex.chunk_pieces == 4 and ex.prefix_cache.hits == 1


@pytest.mark.parametrize("value", ["bf16", "int8-experts", "int4", "fp8"])
@pytest.mark.parametrize("family", ["qwen3", "qwen35"])
def test_other_quantize_values_raise(family, value):
    """Only ``quantize="int8"`` (and None) is served; any other value raises
    naming it, before a pool is made."""
    mod, engine = (tq3, t3engine) if family == "qwen3" else (tq, tqengine)
    cfg = (tq3.Qwen3Config(**_q3_kw()) if family == "qwen3"
           else tq.Qwen35Config(**_q35_kw()))
    params = mod.init_random_params(cfg, seed=0, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match=f"quantize={value!r}"):
        engine.start_engine_from_params(
            cfg, params, tc.EngineLoadOptions(quantize=value, max_num_pages=8,
                                              max_batch_size=2), device="cpu")
    assert not quant.is_quantized(params["lm_head"])
