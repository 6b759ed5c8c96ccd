"""The PyTorch port's ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The two
kernel wrappers run their plain versions here (CPU tensors) and are held
against the JAX Pallas kernels in interpret mode, on the cases of
tests/test_pallas_kernels.py, at f32 with rtol = atol = 2e-5 (the JAX
tests' own tolerance for those kernels).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pegainfer_tpu.ops import norm as jnorm
from pegainfer_tpu.ops import rope as jrope
from pegainfer_tpu.ops import sampling as jsmp
from pegainfer_tpu.ops.pallas.flash_prefill import flash_attention as j_flash_attention
from pegainfer_tpu.ops.pallas.paged_decode import paged_attention_decode as j_paged
from pegainfer_tpu_torch.ops import norm as tnorm
from pegainfer_tpu_torch.ops import rope as trope
from pegainfer_tpu_torch.ops import sampling as tsmp
from pegainfer_tpu_torch.ops.cuda import flash_prefill as tflash
from pegainfer_tpu_torch.ops.cuda import paged_decode as tpaged

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, w = _np(rng, (5, 3, 64)), _np(rng, (64,))
    ref = np.asarray(jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    out = tnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    hd, theta = 32, 1e6
    x = _np(rng, (7, 4, hd))
    pos = np.array([0, 1, 5, 17, 100, 1023, 4000], np.int32)
    inv = jrope.rope_inv_freq(hd, theta)
    np.testing.assert_array_equal(trope.rope_inv_freq(hd, theta), inv)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), jnp.asarray(inv, jnp.float32),
                                jnp.float32)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), torch.tensor(inv, dtype=torch.float32),
                                torch.float32)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    ref = np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js))
    out = trope.apply_rope(torch.from_numpy(x), tc, ts).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_matches_jax(seed):
    """Same random_val -> same token, for a batch mixing greedy,
    temperature, top-k, top-p and top-k + top-p rows."""
    rng = np.random.default_rng(seed)
    B, V = 8, 96
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    logits[1, 10] = logits[1, 20] = logits[1].max() + 1.0  # an exact tie
    temp = np.array([0.0, 0.0, 0.7, 1.0, 1.3, 0.9, 1.0, 0.5], np.float32)
    top_k = np.array([-1, -1, -1, 5, -1, 12, 1, 3], np.int32)
    top_p = np.array([1.0, 1.0, 1.0, 1.0, 0.8, 0.6, 1.0, 0.9], np.float32)
    rand = rng.uniform(0.0, 1.0, B).astype(np.float32)
    ref = np.asarray(jsmp.sample(jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
                                 jnp.asarray(top_p), jnp.asarray(rand)))
    out = tsmp.sample(torch.from_numpy(logits), torch.from_numpy(temp),
                      torch.from_numpy(top_k), torch.from_numpy(top_p),
                      torch.from_numpy(rand)).numpy()
    np.testing.assert_array_equal(out, ref)
    greedy = tsmp.sample_greedy(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(greedy, np.asarray(jsmp.sample_greedy(jnp.asarray(logits))))


def test_logprobs_match_jax():
    rng = np.random.default_rng(3)
    logits = _np(rng, (3, 50))
    toks = np.array([4, 0, 49], np.int32)
    ref = np.asarray(jsmp.token_logprob(jnp.asarray(logits), jnp.asarray(toks)))
    out = tsmp.token_logprob(torch.from_numpy(logits), torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    jv, ji = jsmp.top_logprobs(jnp.asarray(logits), 4)
    tv, ti = tsmp.top_logprobs(torch.from_numpy(logits), 4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ── kernel wrappers (plain path) vs Pallas interpret ─────────────────────


def _paged_setup(seed, B, Hq, Hkv, hd, num_pages, ps, P, seq_lens):
    rng = np.random.default_rng(seed)
    kp, vp = _np(rng, (Hkv, num_pages, ps, hd)), _np(rng, (Hkv, num_pages, ps, hd))
    tables = np.zeros((B, P), np.int32)
    nxt = 1
    for b, sl in enumerate(seq_lens):
        n = -(-sl // ps)
        tables[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return rng, _np(rng, (B, Hq, hd)), kp, vp, tables, np.asarray(seq_lens, np.int32)


# (form, B, Hq, Hkv, hd, ps, P, seq_lens, chunk_pages): the decode cases of
# tests/test_pallas_kernels.py — plain, cur_kv and pool layout
DECODE_CASES = [
    ("plain", 1, 4, 2, 64, 8, 8, [40], 2),
    ("plain", 4, 8, 4, 64, 8, 16, [1, 63, 128, 17], 4),
    ("plain", 2, 4, 1, 128, 16, 8, [100, 9], 8),
    ("plain", 3, 4, 2, 64, 8, 8, [33, 0, 5], 2),
    ("cur", 1, 4, 2, 64, 8, 8, [40], 2),
    ("cur", 4, 8, 4, 64, 8, 16, [1, 63, 128, 17], 4),
    ("cur", 3, 4, 2, 64, 8, 8, [33, 0, 5], 2),
    ("cur", 2, 4, 2, 64, 8, 8, [8, 9], 4),
    ("pool", 2, 8, 2, 64, 8, 8, [40, 21], 4),
]


@pytest.mark.parametrize("form,B,Hq,Hkv,hd,ps,P,seq_lens,cp", DECODE_CASES)
def test_paged_decode_wrapper_matches_pallas(form, B, Hq, Hkv, hd, ps, P, seq_lens, cp):
    num_pages = 32 if form == "pool" else 64
    rng, q, kp, vp, tables, sl = _paged_setup(len(seq_lens) + P, B, Hq, Hkv, hd,
                                              num_pages, ps, P, seq_lens)
    scale = hd ** -0.5
    cur = form in ("cur", "pool")
    ck, cv = (_np(rng, (B, Hkv, hd)), _np(rng, (B, Hkv, hd))) if cur else (None, None)
    J = jnp.asarray
    T = torch.from_numpy
    if form == "pool":
        L = 3
        pool = _np(rng, (L, Hkv, num_pages, 2, ps, hd))
        pool[1, :, :, 0], pool[1, :, :, 1] = kp, vp
        ref = j_paged(J(q), J(pool), J(pool), J(tables), J(sl), scale, chunk_pages=cp,
                      interpret=True, cur_k=J(ck), cur_v=J(cv), layer_id=jnp.int32(1))
        tpool = T(pool)
        out = tpaged.paged_attention_decode(T(q), tpool, tpool, T(tables), T(sl), scale,
                                            cur_k=T(ck), cur_v=T(cv), layer_id=1)
    else:
        kw = dict(cur_k=J(ck), cur_v=J(cv)) if cur else {}
        ref = j_paged(J(q), J(kp), J(vp), J(tables), J(sl), scale, chunk_pages=cp,
                      interpret=True, **kw)
        tkw = dict(cur_k=T(ck), cur_v=T(cv)) if cur else {}
        out = tpaged.paged_attention_decode(T(q), T(kp), T(vp), T(tables), T(sl), scale,
                                            **tkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)
    for b, s in enumerate(seq_lens):
        if s == 0:
            np.testing.assert_array_equal(out[b].numpy(), 0.0)


# (T, S, kv_valid, q_offset, Hq, Hkv, hd, tq, tk): whole-prompt cases of
# tests/test_pallas_kernels.py:23-28 and its chunk-continuation case
FLASH_CASES = [
    (128, 128, 128, 0, 4, 2, 64, 64, 64),
    (256, 256, 200, 0, 8, 2, 64, 128, 128),
    (128, 128, 37, 0, 4, 4, 128, 64, 64),
    (512, 512, 512, 0, 2, 1, 64, 128, 256),
    (16, 64, 40, 24, 4, 2, 64, 16, 32),
    # Qwen3.5's full-attention heads (hd 256, G 8), whole prompt and a chunk
    (32, 32, 32, 0, 16, 2, 256, 16, 16),
    (16, 48, 44, 24, 16, 2, 256, 16, 16),
]


@pytest.mark.parametrize("T,S,kv_valid,q_offset,Hq,Hkv,hd,tq,tk", FLASH_CASES)
def test_flash_attention_wrapper_matches_pallas(T, S, kv_valid, q_offset, Hq, Hkv, hd,
                                                tq, tk):
    rng = np.random.default_rng(T + S + hd)
    q, k, v = _np(rng, (T, Hq, hd)), _np(rng, (S, Hkv, hd)), _np(rng, (S, Hkv, hd))
    scale = hd ** -0.5
    ref = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.int32(kv_valid), jnp.int32(q_offset), scale,
                            tq=tq, tk=tk, interpret=True)
    out = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), kv_valid, q_offset, scale)
    live = max(0, min(T, kv_valid - q_offset))  # rows past kv_valid are garbage
    np.testing.assert_allclose(out.numpy()[:live], np.asarray(ref)[:live], **KERNEL_TOL)


def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU tensors take the plain version; another device without a
    kernel raises instead of falling back."""
    q = torch.empty((1, 4, 64), device="meta")
    k = torch.empty((8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tflash.flash_attention(q[0:1].reshape(1, 4, 64), k, k, 8, 0, 0.125)
    pages = torch.empty((2, 4, 8, 64), device="meta")
    tables = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    sl = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpaged.paged_attention_decode(q, pages, pages, tables, sl, 0.125)
