"""The PyTorch port's DeepSeek-V4 ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.

- ``ops/quant.py``: the hand-written E2M1 encoder must give ml_dtypes' codes
  (through the JAX ``quant.pack_fp4``) bit for bit, on every code, on every
  tie and past the saturation point; quantizers and decoders must agree
  bit for bit.
- ``ops/hc.py`` and ``ops/dsa.py``: f32 math at rtol = atol = 1e-5 (float
  sums in another order); top-k selections exactly, on tie-heavy inputs;
  the committed reference vectors (test_data/dsv4_op_vectors.json) at the
  tolerances of tests/test_dsv4_op_vectors.py.
- Kernels K3, K4 and K5: the wrappers run their plain versions for CPU
  tensors, held against the Pallas kernels in interpret mode on the cases of
  tests/test_pallas_kernels.py with those tests' tolerances: atol 2e-5 for
  K3 and K4, 2e-2 of max |y| for K5.
"""

import json
import pathlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pegainfer_tpu.models import dsv4 as jdsv4
from pegainfer_tpu.ops import dsa as jdsa
from pegainfer_tpu.ops import hc as jhc
from pegainfer_tpu.ops import quant as jquant
from pegainfer_tpu.ops.pallas import fp4_gemm as pfp4
from pegainfer_tpu_torch.models import dsv4 as tdsv4
from pegainfer_tpu_torch.ops import dsa as tdsa
from pegainfer_tpu_torch.ops import hc as thc
from pegainfer_tpu_torch.ops import quant as tquant
from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
from pegainfer_tpu_torch.ops.cuda import fp8_gemv as k4
from pegainfer_tpu_torch.utils.weights import numpy_to_torch

VEC_PATH = pathlib.Path(__file__).resolve().parent.parent / "test_data" / "dsv4_op_vectors.json"
TOL = dict(rtol=1e-5, atol=1e-5)
VEC_TOL = dict(rtol=2e-5, atol=2e-6)


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return numpy_to_torch(np.asarray(a))


def _container(jc):
    return {"q": _t(jc["q"]), "s": _t(jc["s"])}


# ── quant ────────────────────────────────────────────────────────────────


def test_pack_fp4_matches_jax_on_every_code_tie_and_saturation():
    codes = jquant._F4_VALUES  # the 16 E2M1 values, -0.0 included
    mids = np.array([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0], np.float32)
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        codes, mids, -mids, np.nextafter(mids, 0), np.nextafter(mids, 10),
        np.array([6.0, 6.5, 7.0, 100.0, -7.0, -100.0, 1e-30, -1e-30], np.float32),
        _np(rng, 256, 3.0),
    ]).astype(np.float32)
    vals = np.concatenate([vals, np.zeros(len(vals) % 2, np.float32)])
    np.testing.assert_array_equal(tquant.pack_fp4(vals), jquant.pack_fp4(vals))
    np.testing.assert_array_equal(tquant.pack_fp4(vals[::-1]), jquant.pack_fp4(vals[::-1]))


def test_unpack_fp4_matches_jax():
    q = np.arange(256, dtype=np.uint8).reshape(4, 64)
    ref = np.asarray(jquant.unpack_fp4(jnp.asarray(q)))
    np.testing.assert_array_equal(tquant.unpack_fp4(torch.from_numpy(q)).numpy(), ref)


@pytest.mark.parametrize("shape,block", [((256, 256), 128), ((512, 384), 128),
                                         ((256, 256), 256), ((48, 40), 128)])
def test_quantize_fp8_tensor_and_dequant_match_jax(shape, block):
    w = _np(np.random.default_rng(shape[0] + block), shape, 0.1)
    jc = jquant.quantize_fp8_tensor(w, block=block)
    tc = tquant.quantize_fp8_tensor(w, block=block)
    np.testing.assert_array_equal(tc["q"].view(torch.uint8).numpy(),
                                  np.asarray(jc["q"]).view(np.uint8))
    np.testing.assert_array_equal(tc["s"].float().numpy(), np.asarray(jc["s"], np.float32))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(tquant.dequant_any(tc, dt).float().numpy(),
                                      np.asarray(jquant.dequant_any(jc, jdt), np.float32))


@pytest.mark.parametrize("E,OUT,IN,group", [(4, 64, 256, 32), (2, 32, 256, 256),
                                            (3, 16, 48, 32)])
def test_quantize_fp4_stack_dequant_and_gather_match_jax(E, OUT, IN, group):
    rng = np.random.default_rng(E * OUT + IN)
    w = _np(rng, (E, OUT, IN), 0.1)
    jc = jquant.quantize_fp4_stack(w, group=group)
    tc = tquant.quantize_fp4_stack(w, group=group)
    np.testing.assert_array_equal(tc["q"].numpy(), np.asarray(jc["q"]))
    np.testing.assert_array_equal(tc["s"].float().numpy(), np.asarray(jc["s"], np.float32))
    np.testing.assert_array_equal(tquant.dequant_any(tc, torch.float32).numpy(),
                                  np.asarray(jquant.dequant_any(jc, jnp.float32)))
    idx = rng.integers(0, E, 5)
    np.testing.assert_array_equal(
        tquant.gather_dequant(tc, torch.from_numpy(idx), torch.float32).numpy(),
        np.asarray(jquant.gather_dequant(jc, jnp.asarray(idx), jnp.float32)))


def test_qlinear_matches_jax_for_containers_and_plain_weights():
    rng = np.random.default_rng(3)
    w = _np(rng, (256, 384), 0.1)
    jc = jquant.quantize_fp8_tensor(w)
    for rows in (3, 16):  # on the CPU both row counts dequantize and multiply
        x = _np(rng, (rows, 384))
        ref = np.asarray(jquant.qlinear(jnp.asarray(x), jc, kernel=False))
        out = tquant.qlinear(torch.from_numpy(x), _container(jc)).numpy()
        np.testing.assert_allclose(out, ref, **TOL)
        ref = np.asarray(jquant.qlinear(jnp.asarray(x), jnp.asarray(w)))
        np.testing.assert_allclose(tquant.qlinear(torch.from_numpy(x),
                                                  torch.from_numpy(w)).numpy(), ref, **TOL)


# ── hc ───────────────────────────────────────────────────────────────────


def test_hc_ops_match_jax():
    rng = np.random.default_rng(4)
    T, n, D, iters, eps = 5, 4, 32, 20, 1e-6
    mix = (2 + n) * n
    x = _np(rng, (T, D))
    streams = _np(rng, (T, n, D))
    fn, base, scale = _np(rng, (mix, n * D), 0.2), _np(rng, (mix,), 0.5), _np(rng, (3,), 1.0)
    np.testing.assert_array_equal(thc.hc_expand(torch.from_numpy(x), n).numpy(),
                                  np.asarray(jhc.hc_expand(jnp.asarray(x), n)))
    jm = jhc.hc_mixes(jnp.asarray(streams), jnp.asarray(fn), eps)
    tm = thc.hc_mixes(torch.from_numpy(streams), torch.from_numpy(fn), eps)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    mixes = np.asarray(jm)
    jout = jhc.hc_split_sinkhorn(jnp.asarray(mixes), jnp.asarray(scale), jnp.asarray(base),
                                 n, iters, eps)
    tout = thc.hc_split_sinkhorn(torch.from_numpy(mixes), torch.from_numpy(scale),
                                 torch.from_numpy(base), n, iters, eps)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    pre, post, comb = (np.asarray(a) for a in jout)
    np.testing.assert_allclose(
        thc.hc_pre(torch.from_numpy(streams), torch.from_numpy(pre)).numpy(),
        np.asarray(jhc.hc_pre(jnp.asarray(streams), jnp.asarray(pre))), **TOL)
    np.testing.assert_allclose(
        thc.hc_post(torch.from_numpy(x), torch.from_numpy(streams), torch.from_numpy(post),
                    torch.from_numpy(comb)).numpy(),
        np.asarray(jhc.hc_post(jnp.asarray(x), jnp.asarray(streams), jnp.asarray(post),
                               jnp.asarray(comb))), **TOL)
    np.testing.assert_allclose(
        thc.hc_head_pre(torch.from_numpy(mixes), torch.from_numpy(scale),
                        torch.from_numpy(base), n, eps).numpy(),
        np.asarray(jhc.hc_head_pre(jnp.asarray(mixes), jnp.asarray(scale),
                                   jnp.asarray(base), n, eps)), **TOL)


# ── dsa ──────────────────────────────────────────────────────────────────


@pytest.mark.parametrize("args", [(64, 10000.0, 1.0, 0.0, 0.0, 0),
                                  (64, 160000.0, 16.0, 32.0, 1.0, 65536),
                                  (8, 10000.0, 4.0, 32.0, 1.0, 256)])
def test_yarn_rope_and_fp8_rounding_match_jax(args):
    rd = args[0]
    inv = jdsa.yarn_inv_freq(*args)
    np.testing.assert_array_equal(tdsa.yarn_inv_freq(*args), inv)
    rng = np.random.default_rng(rd)
    x = _np(rng, (6, 3, rd + 128), 2.0)
    pos = np.array([0, 1, 7, 130, 4000, 65535], np.int32)
    ref = jdsa.rope_interleaved(jnp.asarray(x), jnp.asarray(pos)[:, None], jnp.asarray(inv), rd)
    out = tdsa.rope_interleaved(torch.from_numpy(x), torch.from_numpy(pos)[:, None],
                                torch.from_numpy(inv), rd)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
    rounded = np.asarray(ref)
    np.testing.assert_array_equal(
        tdsa.fp8_round_nope(torch.from_numpy(rounded), rd).numpy(),
        np.asarray(jdsa.fp8_round_nope(jnp.asarray(rounded), rd)))


def test_compressors_match_jax():
    rng = np.random.default_rng(5)
    hd, eps = 16, 1e-6
    for ratio in (3, 8):
        s, v = _np(rng, (26, hd)), _np(rng, (26, hd))
        ape, norm = _np(rng, (ratio, hd)), _np(rng, (hd,))
        ref = jdsa.compress_nonoverlap(jnp.asarray(s), jnp.asarray(v), jnp.asarray(ape),
                                       jnp.asarray(norm), ratio, eps)
        out = tdsa.compress_nonoverlap(*map(torch.from_numpy, (s, v, ape, norm)), ratio, eps)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        sg, vg = _np(rng, (3, ratio, hd)), _np(rng, (3, ratio, hd))
        ref = jdsa.compress_block_nonoverlap(*map(jnp.asarray, (sg, vg, ape, norm)), eps)
        out = tdsa.compress_block_nonoverlap(*map(torch.from_numpy, (sg, vg, ape, norm)), eps)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    s, v = _np(rng, (22, 2 * hd)), _np(rng, (22, 2 * hd))
    ape, norm = _np(rng, (4, 2 * hd)), _np(rng, (hd,))
    ref = jdsa.compress_overlap(*map(jnp.asarray, (s, v, ape, norm)), eps)
    out = tdsa.compress_overlap(*map(torch.from_numpy, (s, v, ape, norm)), eps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    parts = [_np(rng, (3, 4, 2 * hd)) for _ in range(4)]
    has_prev = np.array([True, False, True])
    ref = jdsa.compress_block_overlap(*map(jnp.asarray, parts), jnp.asarray(ape),
                                      jnp.asarray(norm), eps, jnp.asarray(has_prev))
    out = tdsa.compress_block_overlap(*map(torch.from_numpy, parts), torch.from_numpy(ape),
                                      torch.from_numpy(norm), eps, torch.from_numpy(has_prev))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_window_indices_match_jax():
    for T, W in ((1, 8), (13, 8), (40, 16)):
        np.testing.assert_array_equal(tdsa.window_indices(T, W).numpy(),
                                      np.asarray(jdsa.window_indices(T, W)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_indexer_and_topk_match_jax_on_ties(seed):
    rng = np.random.default_rng(seed)
    T, H, dk, C = 6, 3, 8, 24
    q, ck, w = _np(rng, (T, H, dk)), _np(rng, (C, dk)), _np(rng, (T, H))
    ref = jdsa.indexer_scores(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(w), 0.3)
    out = tdsa.indexer_scores(*map(torch.from_numpy, (q, ck, w)), 0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # tie-heavy scores: few distinct values, so most picks break a tie
    scores = rng.integers(0, 3, (T, C)).astype(np.float32)
    valid = np.array([0, 1, 5, 17, 24, 24], np.int32)
    for k in (1, 4, 7, 30):
        ids, ok = tdsa.topk_select(torch.from_numpy(scores), k, torch.from_numpy(valid))
        jids, jok = jdsa.topk_select(jnp.asarray(scores), k, jnp.asarray(valid))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(np.where(ok.numpy(), ids.numpy(), -1),
                                      np.where(np.asarray(jok), np.asarray(jids), -1))
        np.testing.assert_array_equal(
            tdsa.topk_mask(torch.from_numpy(scores), k, torch.from_numpy(valid)).numpy(),
            np.asarray(jdsa.topk_mask(jnp.asarray(scores), k, jnp.asarray(valid))))
        strict = np.asarray(jdsa.topk_strict(jnp.asarray(scores), k, jnp.asarray(valid), 3))
        np.testing.assert_array_equal(
            tdsa.topk_strict(torch.from_numpy(scores), k, torch.from_numpy(valid), 3).numpy(),
            strict)
        # the fast form selects what the stable-sort oracle selects
        np.testing.assert_array_equal(np.where(ok.numpy(), ids.numpy() + 3, -1),
                                      strict[:, :min(k, C)])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sparse_attention_matches_jax(dtype):
    rng = np.random.default_rng(7)
    T, h, d, K, N = 5, 4, 32, 6, 11
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    q, rows3, rows2, kv = (_np(rng, s) for s in ((T, h, d), (T, K, d), (N, d), (N, d)))
    v3, v2 = rng.random((T, K)) < 0.7, rng.random((T, N)) < 0.5
    v3[0] = False  # a query whose only candidates are masked
    sink = _np(rng, (h,))
    idx = rng.integers(-1, N, (T, K)).astype(np.int32)

    def both(x):
        return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)

    (jq, tq), (j3, t3), (j2, t2), (jkv, tkv) = map(both, (q, rows3, rows2, kv))
    ref = jdsa.sparse_attention_parts(jq, [(j3, jnp.asarray(v3)), (j2, jnp.asarray(v2))],
                                      jnp.asarray(sink), d ** -0.5)
    out = tdsa.sparse_attention_parts(tq, [(t3, torch.from_numpy(v3)),
                                           (t2, torch.from_numpy(v2))],
                                      torch.from_numpy(sink), d ** -0.5)
    tol = TOL if dtype == "f32" else dict(rtol=0, atol=1.6e-2)  # one bf16 ulp at |y| < 4
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **tol)
    ref = jdsa.sparse_attention(jq, jkv, jnp.asarray(idx), jnp.asarray(sink), 0.2)
    out = tdsa.sparse_attention(tq, tkv, torch.from_numpy(idx), torch.from_numpy(sink), 0.2)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **tol)


# ── the committed reference vectors ──────────────────────────────────────


@pytest.fixture(scope="module")
def vectors():
    with open(VEC_PATH) as f:
        return json.load(f)


def _a(v, dtype=np.float32):
    return torch.from_numpy(np.asarray(v, dtype))


@pytest.mark.parametrize("name", ["compressor_nonoverlap_r3", "compressor_nonoverlap_r4",
                                  "compressor_overlap", "indexer_scores", "indexer_topk_ties",
                                  "indexer_topk_exhaust", "hash_gate", "score_gate",
                                  "hc_split_sinkhorn", "sparse_attn", "window_topk_indices"])
def test_committed_op_vectors(vectors, name):
    v = vectors[name]
    exp = np.asarray
    if name.startswith("compressor_nonoverlap"):
        out = tdsa.compress_nonoverlap(_a(v["scores"]), _a(v["values"]), _a(v["ape"]),
                                       _a(v["norm"]), v["ratio"], v["eps"])
        np.testing.assert_allclose(out.numpy(), exp(v["out"], np.float32), **VEC_TOL)
    elif name == "compressor_overlap":
        out = tdsa.compress_overlap(_a(v["scores"]), _a(v["values"]), _a(v["ape"]),
                                    _a(v["norm"]), v["eps"])
        np.testing.assert_allclose(out.numpy(), exp(v["out"], np.float32), **VEC_TOL)
    elif name == "indexer_scores":
        out = tdsa.indexer_scores(_a(v["q"]), _a(v["ck"]), _a(v["w"]), v["scale"])
        np.testing.assert_allclose(out.numpy(), exp(v["out"], np.float32), **VEC_TOL)
    elif name.startswith("indexer_topk"):
        scores = _a(v["scores"])[None, :]
        count = torch.tensor([scores.shape[1]])
        want = exp(v["out"], np.int32)
        got = tdsa.topk_strict(scores, v["topk"], count, v["offset"])[0].numpy()
        np.testing.assert_array_equal(got, want)
        ids, ok = tdsa.topk_select(scores, v["topk"], count)
        fast = np.where(ok[0].numpy(), ids[0].numpy() + v["offset"], -1)
        np.testing.assert_array_equal(fast, want[:min(v["topk"], scores.shape[1])])
    elif name == "hash_gate":
        w, idx = tdsv4.hash_gate(_a(v["x"]), _a(v["gate_weight"]), _a(v["tid2eid"], np.int32),
                                 _a(v["token_ids"], np.int32), v["route_scale"])
        np.testing.assert_array_equal(idx.numpy(), exp(v["indices"], np.int32))
        np.testing.assert_allclose(w.numpy(), exp(v["weights"], np.float32), **VEC_TOL)
    elif name == "score_gate":
        E = len(v["raw_scores"][0])  # gate_weight = I reproduces raw_scores
        w, idx = tdsv4.score_gate(_a(v["raw_scores"]), torch.eye(E), _a(v["gate_bias"]),
                                  v["topk"], v["route_scale"])
        np.testing.assert_array_equal(idx.numpy(), exp(v["indices"], np.int32))
        np.testing.assert_allclose(w.numpy(), exp(v["weights"], np.float32), **VEC_TOL)
    elif name == "hc_split_sinkhorn":
        pre, post, comb = thc.hc_split_sinkhorn(_a(v["mixes"]), _a(v["hc_scale"]),
                                                _a(v["hc_base"]), v["hc"], v["iters"], v["eps"])
        np.testing.assert_allclose(pre.numpy(), exp(v["pre"], np.float32), **VEC_TOL)
        np.testing.assert_allclose(post.numpy(), exp(v["post"], np.float32), **VEC_TOL)
        np.testing.assert_allclose(comb.numpy(), exp(v["comb"], np.float32),
                                   rtol=3e-5, atol=3e-6)
    elif name == "sparse_attn":
        out = tdsa.sparse_attention(_a(v["q"]), _a(v["kv"]), _a(v["idxs"], np.int32),
                                    _a(v["sink"]), v["scale"])
        np.testing.assert_allclose(out.numpy(), exp(v["out"], np.float32), **VEC_TOL)
    else:
        np.testing.assert_array_equal(tdsa.window_indices(v["seq_len"], v["window"]).numpy(),
                                      exp(v["out"], np.int32))


def test_gates_match_jax():
    rng = np.random.default_rng(8)
    T, D, E, K, V = 9, 16, 8, 3, 32
    x, gw, bias = _np(rng, (T, D)), _np(rng, (E, D), 0.3), _np(rng, (E,), 0.2)
    tid2eid = rng.integers(0, E, (V, K)).astype(np.int32)
    toks = rng.integers(0, V, T).astype(np.int32)
    jw, je = jdsv4.hash_gate(jnp.asarray(x), jnp.asarray(gw), jnp.asarray(tid2eid),
                             jnp.asarray(toks), 1.5)
    tw, te = tdsv4.hash_gate(*map(torch.from_numpy, (x, gw, tid2eid, toks)), 1.5)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    # tied biased scores: equal rows of the gate weight
    gw[3], gw[5], bias[5] = gw[1], gw[1], bias[1]
    jw, je = jdsv4.score_gate(jnp.asarray(x), jnp.asarray(gw), jnp.asarray(bias), K, 1.5)
    tw, te = tdsv4.score_gate(*map(torch.from_numpy, (x, gw, bias)), K, 1.5)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)


# ── kernels K3, K4, K5: plain versions against the Pallas kernels ────────


@pytest.mark.parametrize("E,OUT,IN,group", [(4, 64, 256, 32), (4, 256, 512, 32),
                                            (2, 32, 256, 256), (8, 64, 1024, 32)])
def test_fp4_gemv_plain_matches_pallas(E, OUT, IN, group):
    rng = np.random.default_rng(E + OUT + IN)
    w = _np(rng, (E, OUT, IN), 0.1)
    jc = jquant.quantize_fp4_stack(w, group=group)
    M = 12
    x = _np(rng, (M, IN))
    idx = rng.integers(0, E, M).astype(np.int32)
    ref = np.asarray(pfp4.moe_fp4_gemv(jnp.asarray(x), jc["q"], jc["s"], jnp.asarray(idx),
                                       interpret=True))
    before = k3.launches
    out = k3.moe_fp4_gemv(torch.from_numpy(x), _t(jc["q"]), _t(jc["s"]), torch.from_numpy(idx))
    assert k3.launches == before  # a CPU tensor runs the plain version
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("OUT,IN,block", [(256, 256, 128), (512, 384, 128), (256, 256, 256)])
def test_fp8_gemv_plain_matches_pallas(OUT, IN, block):
    rng = np.random.default_rng(OUT + IN)
    w = _np(rng, (OUT, IN), 0.1)
    jc = jquant.quantize_fp8_tensor(w, block=block)
    x = _np(rng, (3, IN))
    ref = np.asarray(pfp4.fp8_gemv(jnp.asarray(x), jc["q"], jc["s"], interpret=True))
    before = k4.launches
    out = k4.fp8_gemv(torch.from_numpy(x), _t(jc["q"]), _t(jc["s"]))
    assert k4.launches == before
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("M,tm,choices", [(64, 16, [0, 1, 1, 1, 3, 7]),
                                          (256, 128, [2, 2, 2, 5, 6, 6, 6, 6]),
                                          (48, 48, [0, 4])])
def test_tile_segments_and_fp4_grouped_plain_match_pallas(M, tm, choices):
    """Skewed routing, empty experts and segments that cross a tile."""
    rng = np.random.default_rng(11)
    E, OUT, IN = 8, 64, 256
    q = rng.integers(0, 256, (E, OUT, IN // 2), dtype=np.uint8)
    s = np.exp2(rng.integers(-4, 3, (E, OUT, IN // 32))).astype(np.float32)
    x = _np(rng, (M, IN))
    flat_e = np.sort(rng.choice(choices, M)).astype(np.int32)
    jseg = pfp4.tile_segments(jnp.asarray(flat_e), tm, E)
    tseg = k5.tile_segments(torch.from_numpy(flat_e), tm, E)
    for a, b in zip(tseg, jseg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    js = jnp.asarray(s, jnp.bfloat16)
    y = np.asarray(pfp4.moe_fp4_grouped(jnp.asarray(x), jnp.asarray(q), js, *jseg,
                                        out_tile=32, tm=tm, interpret=True))
    before = k5.launches
    out = k5.moe_fp4_grouped(torch.from_numpy(x), torch.from_numpy(q), _t(js), *tseg, tm=tm)
    assert k5.launches == before
    scale = np.abs(y).max() + 1e-9
    assert np.abs(out.numpy() - y).max() / scale < 2e-2
    # and against the dequantized oracle of the JAX test
    wd = np.asarray(jquant.dequant_any({"q": jnp.asarray(q), "s": js}, jnp.float32))
    ref = np.stack([x[m] @ wd[flat_e[m]].T for m in range(M)])
    assert np.abs(out.numpy() - ref).max() / (np.abs(ref).max() + 1e-9) < 2e-2


def test_kernel_wrappers_refuse_other_devices():
    x = torch.zeros((2, 256), device="meta")
    with pytest.raises(ValueError):
        k4.fp8_gemv(x, x, x)
    with pytest.raises(ValueError):
        k3.moe_fp4_gemv(x, x, x, x)
    with pytest.raises(ValueError):
        k5.moe_fp4_grouped(x, x, x, x, x, x, x, tm=8)


def test_numpy_to_torch_keeps_fp8_and_bf16_bits():
    import ml_dtypes

    a = np.arange(256, dtype=np.uint8)
    a = a[(a & 0x7F) != 0x7F]  # E4M3 NaN codes aside
    t = numpy_to_torch(a.view(ml_dtypes.float8_e4m3fn))
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(t.float().numpy(),
                                  a.view(ml_dtypes.float8_e4m3fn).astype(np.float32))
    b = np.asarray(jnp.asarray(np.linspace(-3, 3, 17), jnp.bfloat16))
    tb = numpy_to_torch(b)
    assert tb.dtype == torch.bfloat16
    np.testing.assert_array_equal(tb.float().numpy(), b.astype(np.float32))
