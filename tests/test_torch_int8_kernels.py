"""The port's int8 quantizers and kernels K6-K9 against the JAX package, on
the CPU.

Inputs are made with numpy from a seed and handed to both packages. On a CPU
tensor each kernel wrapper runs its plain version; the JAX side runs the
Pallas kernels in interpret mode, as tests/test_pallas_kernels.py does.

- ``quant.quantize_int8_stack`` and the device requantizer
  ``quant.requantize_int8_stack`` must give the JAX package's codes and
  scales bit for bit.
- K6 ``moe_int8_gemv`` and K7 ``moe_int8_grouped``: unscaled f32 products
  of exact bf16 values, which differ only in the order of the f32 sums:
  rtol 1e-5 of max |y|. Scaled, the JAX tests' 2e-2.
- K8 ``moe_int8_chain`` and K9 ``moe_fp4_chain``: the JAX tests' rtol =
  atol = 2e-2 (act is rounded to bf16, so an f32 sum-order difference can
  move one element by one bf16 ulp), on tests/test_pallas_kernels.py's
  shapes plus K8 at an odd count of 128-wide I tiles and at M = 16, and K9
  in both perm13 forms.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pegainfer_tpu.ops import quant as jquant
from pegainfer_tpu.ops.pallas import fp4_gemm as pfp4
from pegainfer_tpu_torch.ops import quant as tquant
from pegainfer_tpu_torch.ops.cuda import fp4_chain as k9
from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
from pegainfer_tpu_torch.ops.cuda import int8_chain as k8
from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
from pegainfer_tpu_torch.ops.cuda import int8_grouped as k7
from pegainfer_tpu_torch.ops.moe import swiglu
from pegainfer_tpu_torch.utils.weights import numpy_to_torch

SUM_RTOL = 1e-5
CHAIN_TOL = dict(rtol=2e-2, atol=2e-2)
LIMIT = 7.0


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return numpy_to_torch(np.asarray(a))


def _close_rel(out, ref, rtol):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= rtol * (np.abs(ref).max() + 1e-30)


# ── int8 quantizers ──────────────────────────────────────────────────────


def test_quantize_int8_stack_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    w = _np(rng, (3, 16, 64), 0.1)
    w[1, 4] = 0.0  # an all-zero channel takes scale 1
    w[2, 3, :4] = [127.0, 63.5, -0.5, 1.5]  # codes exactly on .5 ties
    w[2, 3, 4:] = 0.0
    jc, tc = jquant.quantize_int8_stack(w), tquant.quantize_int8_stack(w)
    assert tc["q"].dtype == torch.int8 and tc["s"].dtype == torch.float32
    np.testing.assert_array_equal(tc["q"].numpy(), np.asarray(jc["q"]))
    np.testing.assert_array_equal(tc["s"].numpy(), np.asarray(jc["s"]))
    assert tc["s"][1, 4].item() == 1.0
    assert tc["q"][2, 3, :4].tolist() == [127, 64, 0, 2]  # half to even
    # dequantization and gathers of the int8 kind
    np.testing.assert_array_equal(
        tquant.dequant_any(tc, torch.float32).numpy(),
        np.asarray(jquant.dequant_any(jc, jnp.float32)))
    idx = np.array([2, 0, 2], np.int32)
    np.testing.assert_array_equal(
        tquant.gather_dequant(tc, torch.from_numpy(idx), torch.float32).numpy(),
        np.asarray(jquant.dequant_any(jc, jnp.float32))[idx])


@pytest.mark.parametrize("E,chunk", [(5, 2), (4, 8)])
def test_device_requantizer_matches_jax_host_path(E, chunk):
    """fp4 stack -> int8 as the JAX engine does at load (dequantize to f32,
    quantize_int8_stack on the host), here on a CPU tensor, chunk-wise."""
    rng = np.random.default_rng(E)
    jc4 = jquant.quantize_fp4_stack(_np(rng, (E, 32, 128), 0.1))
    ref = jquant.quantize_int8_stack(np.asarray(jquant.dequant_any(jc4, jnp.float32)))
    out = tquant.requantize_int8_stack({"q": _t(jc4["q"]), "s": _t(jc4["s"])}, chunk=chunk)
    np.testing.assert_array_equal(out["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(out["s"].numpy(), np.asarray(ref["s"]))
    with pytest.raises(ValueError, match="packed-fp4"):
        tquant.requantize_int8_stack(out)


# ── K6, K7: unscaled int8 products ───────────────────────────────────────


@pytest.mark.parametrize("E,OUT,IN", [(4, 64, 256), (4, 256, 512), (8, 64, 1024)])
def test_int8_gemv_plain_matches_pallas(E, OUT, IN):
    rng = np.random.default_rng(E + OUT + IN)
    jc = jquant.quantize_int8_stack(_np(rng, (E, OUT, IN), 0.1))
    M = 12
    x = _np(rng, (M, IN))
    idx = rng.integers(0, E, M).astype(np.int32)
    idx[6:] = idx[:6]  # repeated experts
    assert pfp4.int8_gemv_supported(jc["q"])
    ref = np.asarray(pfp4.moe_int8_gemv(jnp.asarray(x), jc["q"], jnp.asarray(idx),
                                        interpret=True))
    before = k6.launches
    out = k6.moe_int8_gemv(torch.from_numpy(x), _t(jc["q"]), torch.from_numpy(idx))
    assert k6.launches == before  # a CPU tensor runs the plain version
    _close_rel(out.numpy(), ref, SUM_RTOL)
    s = np.asarray(jc["s"])[idx]
    np.testing.assert_allclose(out.numpy() * s, ref * s, rtol=2e-2, atol=2e-2)


def test_int8_grouped_plain_matches_pallas():
    """Skewed routing, empty experts and segments that cross a tile (the
    JAX test's case), with the shared tile_segments."""
    rng = np.random.default_rng(13)
    E, OUT, IN, M, tm = 8, 64, 256, 64, 16
    jc = jquant.quantize_int8_stack(_np(rng, (E, OUT, IN), 0.1))
    x = _np(rng, (M, IN))
    flat_e = np.sort(rng.choice([0, 1, 1, 1, 3, 7], M)).astype(np.int32)
    seg = pfp4.tile_segments(jnp.asarray(flat_e), tm, E)
    ref = np.asarray(pfp4.moe_int8_grouped(jnp.asarray(x), jc["q"], *seg, out_tile=32, tm=tm,
                                           interpret=True))
    tseg = k5.tile_segments(torch.from_numpy(flat_e), tm, E)
    before = k7.launches
    out = k7.moe_int8_grouped(torch.from_numpy(x), _t(jc["q"]), *tseg, tm=tm)
    assert k7.launches == before
    _close_rel(out.numpy(), ref, SUM_RTOL)
    s = np.asarray(jc["s"])[flat_e]
    wd = np.asarray(jquant.dequant_any(jc, jnp.float32))
    oracle = np.stack([x[m] @ wd[flat_e[m]].T for m in range(M)])
    _close_rel(out.numpy() * s, oracle, 2e-2)


# ── K8: the int8 chain ───────────────────────────────────────────────────


def _int8_chain_inputs(rng, E, I, D, M):
    w1, w3 = (rng.integers(-127, 128, (E, I, D), dtype=np.int8) for _ in range(2))
    w2 = rng.integers(-127, 128, (E, D, I), dtype=np.int8)
    s1, s3 = (rng.uniform(0.001, 0.02, (E, I)).astype(np.float32) for _ in range(2))
    s2 = rng.uniform(0.001, 0.02, (E, D)).astype(np.float32)
    x = _np(rng, (M, D))
    idx = rng.integers(0, E, M).astype(np.int32)
    return x, w1, w3, w2, s1, s3, s2, idx


@pytest.mark.parametrize("E,I,D,M,in_tile", [
    (4, 256, 512, 6, 256),   # tests/test_pallas_kernels.py's shape
    (4, 384, 256, 5, 128),   # three 128-wide I tiles: an odd tile count
    (8, 256, 256, 16, 256),  # the largest M the gate takes
])
def test_int8_chain_plain_matches_pallas(E, I, D, M, in_tile):
    rng = np.random.default_rng(E + I + D + M)
    args = _int8_chain_inputs(rng, E, I, D, M)
    x, w1, w3, w2, s1, s3, s2, idx = args
    assert pfp4.int8_chain_supported({"q": jnp.asarray(w1)}, {"q": jnp.asarray(w2)}, M,
                                     in_tile=in_tile)
    assert k8.int8_chain_supported({"q": torch.from_numpy(w1)}, {"q": torch.from_numpy(w2)}, M,
                                   in_tile=in_tile)
    ref = np.asarray(pfp4.moe_int8_chain(*map(jnp.asarray, args), limit=LIMIT,
                                         in_tile=in_tile, interpret=True))
    before = k8.launches
    out = k8.moe_int8_chain(*map(torch.from_numpy, args), limit=LIMIT)
    assert k8.launches == before
    np.testing.assert_allclose(out.numpy(), ref, **CHAIN_TOL)
    # the chain's plain version is three K6 plain calls and the SwiGLU
    e = torch.from_numpy(idx).long()
    g = k6.moe_int8_gemv_plain(torch.from_numpy(x), torch.from_numpy(w1),
                               torch.from_numpy(idx)) * torch.from_numpy(s1)[e]
    u = k6.moe_int8_gemv_plain(torch.from_numpy(x), torch.from_numpy(w3),
                               torch.from_numpy(idx)) * torch.from_numpy(s3)[e]
    y = k6.moe_int8_gemv_plain(swiglu(g, u, LIMIT), torch.from_numpy(w2),
                               torch.from_numpy(idx)) * torch.from_numpy(s2)[e]
    assert torch.equal(out, y)


@pytest.mark.parametrize("I,D,M", [(256, 512, 16), (256, 512, 17), (128, 256, 4),
                                   (192, 256, 4), (256, 192, 4), (256, 384, 4)])
def test_int8_chain_gate_matches_jax(I, D, M):
    w1, w2 = np.zeros((2, I, D), np.int8), np.zeros((2, D, I), np.int8)
    want = pfp4.int8_chain_supported({"q": jnp.asarray(w1)}, {"q": jnp.asarray(w2)}, M)
    got = k8.int8_chain_supported({"q": torch.from_numpy(w1)}, {"q": torch.from_numpy(w2)}, M)
    assert got == want


# ── K9: the packed-fp4 chain ─────────────────────────────────────────────


def _fp4_stacks(rng, E, I, D):
    def stack(out_d, in_d):
        return jquant.quantize_fp4_stack(_np(rng, (E, out_d, in_d), 0.1))

    return stack(I, D), stack(I, D), stack(D, I)


def _tc(jc):
    return {"q": _t(jc["q"]), "s": _t(jc["s"])}


@pytest.mark.parametrize("perm13", [False, True])
def test_fp4_chain_plain_matches_pallas(perm13):
    E, I, D, M = 4, 256, 512, 6
    rng = np.random.default_rng(2)
    j1, j3, j2 = _fp4_stacks(rng, E, I, D)
    x = _np(rng, (M, D))
    idx = rng.integers(0, E, M).astype(np.int32)
    t1, t3, t2 = _tc(j1), _tc(j3), _tc(j2)
    np.testing.assert_array_equal(k9.perm13_rows(I).numpy(), np.asarray(pfp4.perm13_rows(I)))
    if perm13:
        perm = pfp4.perm13_rows(I)
        j1, j3 = ({"q": j["q"][:, perm], "s": j["s"][:, perm]} for j in (j1, j3))
        t1, t3 = k9.permute_w13(t1), k9.permute_w13(t3)
        for j, t in ((j1, t1), (j3, t3)):
            np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
    assert pfp4.fp4_chain_supported(j1, j2, M) and k9.fp4_chain_supported(t1, t2, M)
    ref = np.asarray(pfp4.moe_fp4_chain(
        jnp.asarray(x), j1["q"], j1["s"], j3["q"], j3["s"], j2["q"], j2["s"],
        jnp.asarray(idx), limit=LIMIT, interpret=True, perm13=perm13))
    before = k9.launches
    out = k9.moe_fp4_chain(torch.from_numpy(x), t1, t3, t2, torch.from_numpy(idx), LIMIT,
                           perm13=perm13)
    assert k9.launches == before
    np.testing.assert_allclose(out.numpy(), ref, **CHAIN_TOL)


def test_fp4_chain_forms_agree_and_match_three_k3_calls():
    """perm13 is a permutation of the hidden channels: both forms give the
    three-call result (tests/test_pallas_kernels.py's oracle)."""
    from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3

    E, I, D, M = 4, 256, 256, 5
    rng = np.random.default_rng(5)
    t1, t3, t2 = (_tc(j) for j in _fp4_stacks(rng, E, I, D))
    x = torch.from_numpy(_np(rng, (M, D)))
    idx = torch.from_numpy(rng.integers(0, E, M).astype(np.int32))
    g = k3.moe_fp4_gemv_plain(x, t1["q"], t1["s"], idx)
    u = k3.moe_fp4_gemv_plain(x, t3["q"], t3["s"], idx)
    three = k3.moe_fp4_gemv_plain(swiglu(g, u, LIMIT), t2["q"], t2["s"], idx)
    natural = k9.moe_fp4_chain(x, t1, t3, t2, idx, LIMIT)
    permuted = k9.moe_fp4_chain(x, k9.permute_w13(t1), k9.permute_w13(t3), t2, idx, LIMIT,
                                perm13=True)
    assert torch.equal(natural, three)
    np.testing.assert_allclose(permuted.numpy(), three.numpy(), **CHAIN_TOL)


def test_fp4_chain_wrapper_refuses_what_the_kernel_cannot_check():
    rng = np.random.default_rng(7)
    t1, t3, t2 = (_tc(j) for j in _fp4_stacks(rng, 2, 256, 256))
    x = torch.zeros((3, 256))
    idx = torch.zeros(3, dtype=torch.int32)
    p1, p3 = k9.permute_w13(t1), k9.permute_w13(t3)
    with pytest.raises(ValueError, match="perm13=True needs"):  # unmarked weights
        k9.moe_fp4_chain(x, t1, t3, t2, idx, LIMIT, perm13=True)
    with pytest.raises(ValueError, match="perm13=True needs"):  # one of two marked
        k9.moe_fp4_chain(x, p1, t3, t2, idx, LIMIT, perm13=True)
    with pytest.raises(ValueError, match="but perm13=False"):  # marked weights
        k9.moe_fp4_chain(x, p1, p3, t2, idx, LIMIT)
    q1, q3, q2 = (_tc(j) for j in _fp4_stacks(rng, 2, 128, 256))
    with pytest.raises(ValueError, match="I/2 % 128"):  # I = 128
        k9.moe_fp4_chain(x, k9.permute_w13(q1), k9.permute_w13(q3), q2, idx, LIMIT,
                         perm13=True)
    w3_coarse = {"q": t3["q"], "s": t3["s"][..., ::2].contiguous()}  # 4 groups, not 8
    with pytest.raises(ValueError, match="scale groups"):
        k9.moe_fp4_chain(x, t1, w3_coarse, t2, idx, LIMIT)


@pytest.mark.parametrize("I,D,M,group", [(256, 512, 16, 32), (256, 512, 17, 32),
                                         (128, 512, 4, 32), (256, 256, 4, 64),
                                         (512, 256, 4, 32)])
def test_fp4_chain_gate_matches_jax(I, D, M, group):
    def cont(out_d, in_d, lib):
        return {"q": lib.zeros((2, out_d, in_d // 2), dtype=lib.uint8),
                "s": lib.zeros((2, out_d, in_d // group), dtype=lib.float32)}

    want = pfp4.fp4_chain_supported(cont(I, D, jnp), cont(D, I, jnp), M)
    assert k9.fp4_chain_supported(cont(I, D, torch), cont(D, I, torch), M) == want


def test_int8_and_chain_wrappers_refuse_other_devices():
    x = torch.zeros((2, 256), device="meta")
    w = torch.zeros((2, 256, 256), dtype=torch.int8, device="meta")
    s = torch.zeros((2, 256), device="meta")
    with pytest.raises(ValueError):
        k6.moe_int8_gemv(x, w, x)
    with pytest.raises(ValueError):
        k7.moe_int8_grouped(x, w, x, x, x, x, tm=8)
    with pytest.raises(ValueError):
        k8.moe_int8_chain(x, w, w, w, s, s, s, x, LIMIT)
    c = {"q": torch.zeros((2, 256, 128), dtype=torch.uint8, device="meta"),
         "s": torch.zeros((2, 256, 8), device="meta")}
    with pytest.raises(ValueError):
        k9.moe_fp4_chain(x, c, c, c, x, LIMIT)
