"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: run with ``python -m pytest -m cuda tests/``
on a machine with an NVIDIA Hopper card; elsewhere each test skips.

bf16 tolerances are the JAX package's for these kernels
(tests/test_pallas_kernels.py): 3e-2 for decode, 2e-2 for prefill. Decode
is held row by row to min(3e-2, 2e-2 of the row's max |ref|): its output
averages n tokens' values and is about sqrt(e / n) in size, so at long
contexts a fixed 3e-2 would pass a merge that lost a split. The
quantized GEMV kernels K3 and K4 form the same exact f32 products as their
plain versions and differ only in the order of the f32 sums: atol 2e-5 (the
JAX tests' tolerance) on outputs of about unit RMS. K5 multiplies on the
tensor cores: 2e-2 of max |y|, the JAX test's tolerance. Shapes are those of
chip_smoke.py's kernel phase (DeepSeek-V4-Flash's full widths).

The int8 kernels: K6 forms the plain version's exact f32 products in
another order, on unscaled outputs of magnitude 1e4 (codes up to 127):
1e-5 of max |y|; K7 as K5. The chains K8 and K9 round act to bf16, where an
f32 sum-order difference moves an element by one bf16 ulp now and then:
2e-3 of max |y|. Routed experts are drawn from a 16-expert stack.
"""

import numpy as np
import pytest
import torch

from pegainfer_tpu_torch.ops.cuda import flash_prefill as fp
from pegainfer_tpu_torch.ops.cuda import fp4_chain as k9
from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
from pegainfer_tpu_torch.ops.cuda import fp8_gemv as k4
from pegainfer_tpu_torch.ops.cuda import int8_chain as k8
from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
from pegainfer_tpu_torch.ops.cuda import int8_grouped as k7
from pegainfer_tpu_torch.ops.cuda import paged_decode as pd

pytestmark = pytest.mark.cuda

DECODE_TOL = 3e-2
DECODE_RTOL = 2e-2
PREFILL_TOL = 2e-2
GEMV_TOL = 2e-5
GROUPED_RTOL = 2e-2
INT8_GEMV_RTOL = 1e-5
CHAIN_RTOL = 2e-3
LIMIT = 7.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dev, torch.bfloat16)


RAGGED = [1, 63, 700, 1280, 0]
# each case ends in a dead row; the split plan (ops/cuda/paged_decode.py::
# plan_splits) on 132 SMs is noted beside it. The page tables are as wide
# as the longest row unless a width is given.
DECODE_CASES = [
    pytest.param(128, 32, 8, RAGGED, None, id="hd128-G4-ragged"),  # 7 splits of 3 pages
    pytest.param(64, 8, 4, RAGGED, None, id="hd64-G2-ragged"),  # 10 splits of 2 pages
    pytest.param(128, 32, 8, [4096, 0], None, id="hd128-G4-ctx4096"),  # 16 splits of 4 pages
    pytest.param(128, 32, 8, [16384, 0], None, id="hd128-G4-ctx16384"),  # 16 of 16 pages
    # a row shorter than one split beside a long one: 10 splits of 5 pages
    pytest.param(128, 32, 8, [40, 3000, 0], None, id="hd128-G4-short-beside-long"),
    # 64 rows fill the card alone: one split, no scratch
    pytest.param(128, 32, 8, [(37 * i) % 900 + 1 for i in range(63)] + [0], None,
                 id="hd128-G4-B64"),
    pytest.param(256, 16, 2, RAGGED, None, id="hd256-G8-ragged"),  # 20 splits of 1 page
    # a table far wider than its rows (19 pages at most): 11 splits of 24
    # pages, all but the first past every row's length (empty partials)
    pytest.param(128, 32, 8, [1152, 70, 0], 256, id="hd128-G4-wide-table"),
]


def _decode_inputs(rng, dev, form, hd, Hq, Hkv, seq_lens, ps=64, L=2, width=None):
    """Arguments of one paged-decode call: a two-layer k/v-adjacent pool with
    each row's pages in order, in ``form`` (per-layer pages or the pool with
    layer_id, with or without the in-flight token). The page tables are as
    wide as the longest row, or ``width`` pages."""
    B = len(seq_lens)
    P = width or max(1, max(-(-s // ps) for s in seq_lens))
    tables = np.zeros((B, P), np.int32)
    nxt = 1
    for b, s in enumerate(seq_lens):
        n = -(-s // ps)
        tables[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    pool = _bf16(rng, (L, Hkv, nxt, 2, ps, hd), dev)
    tables = torch.from_numpy(tables).to(dev)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    q = _bf16(rng, (B, Hq, hd), dev)
    kw = {}
    if form.endswith("cur"):
        kw = dict(cur_k=_bf16(rng, (B, Hkv, hd), dev), cur_v=_bf16(rng, (B, Hkv, hd), dev))
    if form.startswith("pool"):
        args = (q, pool, pool, tables, sl, hd ** -0.5)
        kw["layer_id"] = L - 1
    else:
        args = (q, pool[L - 1, :, :, 0], pool[L - 1, :, :, 1], tables, sl, hd ** -0.5)
    return args, kw


def _assert_decode_close(out, ref):
    """Each row within min(DECODE_TOL, DECODE_RTOL x its max |ref|); a dead
    row's limit is 0."""
    d = (out.float() - ref.float()).abs().amax(dim=(1, 2))
    lim = torch.clamp(DECODE_RTOL * ref.float().abs().amax(dim=(1, 2)), max=DECODE_TOL)
    assert bool((d <= lim).all()), f"row errors {d.tolist()} over limits {lim.tolist()}"


@pytest.mark.parametrize("form", ["layer", "layer_cur", "pool", "pool_cur"])
@pytest.mark.parametrize("hd,Hq,Hkv,seq_lens,width", DECODE_CASES)
def test_paged_decode_kernel_matches_plain(dev, form, hd, Hq, Hkv, seq_lens, width):
    rng = np.random.default_rng(hd + Hq + len(seq_lens))
    args, kw = _decode_inputs(rng, dev, form, hd, Hq, Hkv, seq_lens, width=width)
    before = pd.launches
    out = pd.paged_attention_decode(*args, **kw)
    torch.cuda.synchronize()
    assert pd.launches == before + 1
    _assert_decode_close(out, pd.paged_attention_decode_plain(*args, **kw))
    assert out[-1].abs().max().item() == 0.0  # dead row


def test_paged_decode_kernel_on_two_streams(dev):
    """Calls on two streams at once, each many splits: each stream has its
    own ticket counters, so the splits of one call never meet those of a
    call on the other stream."""
    rng = np.random.default_rng(7)
    calls = [_decode_inputs(rng, dev, "pool_cur", 128, 32, 8, seq_lens)
             for seq_lens in ([4096], [3000, 700])]
    refs = [pd.paged_attention_decode_plain(*args, **kw) for args, kw in calls]
    streams = [torch.cuda.Stream(dev) for _ in calls]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = [[] for _ in calls]
    for _ in range(20):
        for st, (args, kw), o in zip(streams, calls, outs):
            with torch.cuda.stream(st):
                o.append(pd.paged_attention_decode(*args, **kw))
    torch.cuda.synchronize()
    for o, ref in zip(outs, refs):
        for out in o:
            _assert_decode_close(out, ref)


def test_paged_decode_wrapper_makes_no_host_sync(dev):
    """The wrapper plans its splits from shapes alone: a host read of a
    device value (seq_lens, say) would raise under this sync debug mode.
    One call that splits (B = 1, context 1,152) and one that does not
    (64 rows), each still right."""
    rng = np.random.default_rng(5)
    calls = [_decode_inputs(rng, dev, "pool_cur", 128, 32, 8, seq_lens)
             for seq_lens in ([1152], DECODE_CASES[5].values[3])]
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [pd.paged_attention_decode(*args, **kw) for args, kw in calls]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for out, (args, kw) in zip(outs, calls):
        _assert_decode_close(out, pd.paged_attention_decode_plain(*args, **kw))


@pytest.mark.parametrize("T,S,kv_valid,q_offset", [(1024, 1024, 1024, 0), (1000, 1000, 1000, 0),
                                                   (256, 768, 768, 512), (37, 37, 30, 0)])
def test_flash_prefill_kernel_matches_plain(dev, T, S, kv_valid, q_offset):
    rng = np.random.default_rng(T)
    Hq, Hkv, hd = 32, 8, 128
    q, k, v = _bf16(rng, (T, Hq, hd), dev), _bf16(rng, (S, Hkv, hd), dev), _bf16(
        rng, (S, Hkv, hd), dev)
    before = fp.launches
    out = fp.flash_attention(q, k, v, kv_valid, q_offset, hd ** -0.5)
    torch.cuda.synchronize()
    assert fp.launches == before + 1
    ref = fp.att.causal_attention(q, k, v, kv_valid, q_offset, hd ** -0.5)
    live = min(T, kv_valid - q_offset)
    assert (out[:live].float() - ref[:live].float()).abs().max().item() < PREFILL_TOL


def test_kernels_refuse_unsupported_shapes(dev):
    q = torch.zeros((4, 8, 48), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((4, 2, 48), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fp.flash_prefill(q, k, k, 4, 48 ** -0.5)
    with pytest.raises(ValueError):
        fp.flash_prefill(q.float(), k.float(), k.float(), 4, 48 ** -0.5)


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _fp8(dev, gen, out_dim, in_dim, block=128):
    """E4M3 codes from N(0, 1) and power-of-two block scales around
    1/sqrt(in_dim), so y has about unit RMS."""
    q = torch.randn((out_dim, in_dim), generator=gen, device=dev).to(torch.float8_e4m3fn)
    e = torch.randint(-1, 2, (out_dim // block, in_dim // block), generator=gen, device=dev)
    s = torch.exp2(e.float() - round(np.log2(in_dim) / 2)).to(torch.bfloat16)
    return q, s


def _fp4(dev, gen, E, out_dim, in_dim):
    q = torch.randint(0, 256, (E, out_dim, in_dim // 2), dtype=torch.uint8, generator=gen,
                      device=dev)
    e = torch.randint(-1, 2, (E, out_dim, in_dim // 32), generator=gen, device=dev)
    s = torch.exp2(e.float() - round(np.log2(2.93 * in_dim ** 0.5))).to(torch.bfloat16)
    return q, s


@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("OUT,IN", [(32768, 1024), (4096, 8192), (512, 4096), (256, 384)])
def test_fp8_gemv_kernel_matches_plain(dev, M, OUT, IN):
    gen = _gen(dev, OUT + IN + M)
    q, s = _fp8(dev, gen, OUT, IN)
    x = torch.randn((M, IN), generator=gen, device=dev).to(torch.bfloat16)
    before = k4.launches
    y = k4.fp8_gemv(x, q, s)
    torch.cuda.synchronize()
    assert k4.launches == before + 1 and y.shape == (M, OUT) and y.dtype == torch.float32
    assert (y - k4.fp8_gemv_plain(x, q, s)).abs().max().item() <= GEMV_TOL


@pytest.mark.parametrize("M,OUT,IN", [(6, 2048, 4096), (12, 4096, 2048), (12, 2048, 4096)])
def test_fp4_gemv_kernel_matches_plain(dev, M, OUT, IN):
    gen = _gen(dev, M + OUT)
    q, s = _fp4(dev, gen, 256, OUT, IN)
    x = torch.randn((M, IN), generator=gen, device=dev)
    idx = torch.randint(0, 256, (M,), generator=gen, device=dev, dtype=torch.int32)
    idx[M // 2:] = idx[: M - M // 2]  # repeated experts
    before = k3.launches
    y = k3.moe_fp4_gemv(x, q, s, idx)
    torch.cuda.synchronize()
    assert k3.launches == before + 1 and y.shape == (M, OUT)
    assert (y - k3.moe_fp4_gemv_plain(x, q, s, idx)).abs().max().item() <= GEMV_TOL


def _routing(gen, dev, M, E, skew):
    """Sorted expert ids for M rows: skewed toward a few experts (most
    experts empty), or spread over all of them."""
    if skew:
        hot = torch.tensor([0, 3, 3, 3, 3, 7, 200, 255], device=dev)
        pick = torch.randint(0, len(hot), (M,), generator=gen, device=dev)
        return torch.sort(hot[pick]).values.to(torch.int32)
    return torch.sort(torch.randint(0, E, (M,), generator=gen, device=dev)).values.to(
        torch.int32)


@pytest.mark.parametrize("M,OUT,IN,skew", [(6144, 2048, 4096, False), (6144, 4096, 2048, True),
                                           (54, 2048, 4096, True), (300, 4096, 2048, False)])
def test_fp4_grouped_kernel_matches_plain(dev, M, OUT, IN, skew):
    gen = _gen(dev, M + OUT)
    E = 256
    q, s = _fp4(dev, gen, E, OUT, IN)
    tm = 128 if M >= 128 else -(-M // 8) * 8
    Mp = -(-M // tm) * tm
    e = _routing(gen, dev, M, E, skew)
    e = torch.cat([e, e[-1:].expand(Mp - M)])  # pad rows carry the last expert
    seg = k5.tile_segments(e, tm, E)
    x = torch.randn((Mp, IN), generator=gen, device=dev).to(torch.bfloat16)
    before = k5.launches
    y = k5.moe_fp4_grouped(x, q, s, *seg, tm=tm)
    torch.cuda.synchronize()
    assert k5.launches == before + 1 and y.shape == (Mp, OUT)
    ref = k5.moe_fp4_grouped_plain(x, q, s, *seg, tm=tm)
    assert (y - ref).abs().max().item() <= GROUPED_RTOL * ref.abs().max().item()


def test_quantized_kernels_refuse_unsupported_shapes(dev):
    gen = _gen(dev, 0)
    q, s = _fp8(dev, gen, 256, 384)
    with pytest.raises(ValueError):  # more than 8 rows
        k4.fp8_gemv(torch.zeros((9, 384), device=dev), q, s)
    q4, s4 = _fp4(dev, gen, 2, 64, 256)
    with pytest.raises(ValueError):  # idx of another length
        k3.moe_fp4_gemv(torch.zeros((3, 256), device=dev), q4, s4,
                        torch.zeros(2, dtype=torch.int32, device=dev))
    seg = k5.tile_segments(torch.zeros(12, dtype=torch.int32, device=dev), 12, 2)
    with pytest.raises(ValueError):  # tm not a multiple of 8
        k5.moe_fp4_grouped(torch.zeros((12, 256), device=dev), q4, s4, *seg, tm=12)


def _int8(dev, gen, E, out_dim, in_dim):
    """int8 codes over the whole range and per-channel f32 scales around
    1 / (73 sqrt(in_dim)) (uniform codes have RMS 73), so y has about unit
    RMS once scaled."""
    q = torch.randint(-127, 128, (E, out_dim, in_dim), dtype=torch.int8, generator=gen,
                      device=dev)
    s = torch.rand((E, out_dim), generator=gen, device=dev) * 2 / (73 * in_dim ** 0.5)
    return q, s


def _rel_err(y, ref):
    return (y - ref).abs().max().item() / ref.abs().max().item()


def _idx(gen, dev, M, E, repeat):
    idx = torch.randint(0, E, (M,), generator=gen, device=dev, dtype=torch.int32)
    if repeat:
        idx[M // 2:] = idx[: M - M // 2]
    return idx


@pytest.mark.parametrize("M,repeat", [(1, False), (6, False), (12, True), (18, True)])
@pytest.mark.parametrize("OUT,IN", [(2048, 4096), (4096, 2048)])
def test_int8_gemv_kernel_matches_plain(dev, M, repeat, OUT, IN):
    gen = _gen(dev, M + OUT)
    q, _ = _int8(dev, gen, 16, OUT, IN)
    x = torch.randn((M, IN), generator=gen, device=dev)
    idx = _idx(gen, dev, M, 16, repeat)
    before = k6.launches
    y = k6.moe_int8_gemv(x, q, idx)
    torch.cuda.synchronize()
    assert k6.launches == before + 1 and y.shape == (M, OUT) and y.dtype == torch.float32
    assert _rel_err(y, k6.moe_int8_gemv_plain(x, q, idx)) <= INT8_GEMV_RTOL


@pytest.mark.parametrize("M,OUT,IN,skew", [(6144, 2048, 4096, False), (6144, 4096, 2048, True),
                                           (54, 2048, 4096, True), (300, 4096, 2048, False)])
def test_int8_grouped_kernel_matches_plain(dev, M, OUT, IN, skew):
    gen = _gen(dev, M + OUT)
    E = 256
    q, _ = _int8(dev, gen, E, OUT, IN)
    tm = 128 if M >= 128 else -(-M // 8) * 8
    Mp = -(-M // tm) * tm
    e = _routing(gen, dev, M, E, skew)
    e = torch.cat([e, e[-1:].expand(Mp - M)])
    seg = k5.tile_segments(e, tm, E)
    x = torch.randn((Mp, IN), generator=gen, device=dev).to(torch.bfloat16)
    before = k7.launches
    y = k7.moe_int8_grouped(x, q, *seg, tm=tm)
    torch.cuda.synchronize()
    assert k7.launches == before + 1 and y.shape == (Mp, OUT)
    assert _rel_err(y, k7.moe_int8_grouped_plain(x, q, *seg, tm=tm)) <= GROUPED_RTOL


@pytest.mark.parametrize("M,I,D,repeat", [(1, 2048, 4096, False), (6, 2048, 4096, False),
                                          (12, 2048, 4096, True), (16, 2048, 4096, False),
                                          (5, 384, 512, False)])  # 384: three 128-wide tiles
def test_int8_chain_kernel_matches_plain(dev, M, I, D, repeat):
    gen = _gen(dev, M + I)
    E = 16
    w1, s1 = _int8(dev, gen, E, I, D)
    w3, s3 = _int8(dev, gen, E, I, D)
    w2, s2 = _int8(dev, gen, E, D, I)
    x = torch.randn((M, D), generator=gen, device=dev)
    idx = _idx(gen, dev, M, E, repeat)
    args = (x, w1, w3, w2, s1 * 3, s3 * 3, s2, idx, LIMIT)  # g, u of RMS 3 meet the clamp
    before = k8.launches
    y = k8.moe_int8_chain(*args)
    torch.cuda.synchronize()
    assert k8.launches == before + 1 and y.shape == (M, D)
    assert _rel_err(y, k8.moe_int8_chain_plain(*args)) <= CHAIN_RTOL


@pytest.mark.parametrize("perm13", [False, True])
@pytest.mark.parametrize("M,I,D", [(1, 2048, 4096), (6, 2048, 4096), (16, 2048, 4096),
                                   (5, 256, 512)])
def test_fp4_chain_kernel_matches_plain(dev, perm13, M, I, D):
    gen = _gen(dev, M + I + perm13)
    E = 16
    w1, w3, w2 = ({"q": q, "s": s} for q, s in (_fp4(dev, gen, E, I, D), _fp4(dev, gen, E, I, D),
                                                _fp4(dev, gen, E, D, I)))
    if perm13:
        w1, w3 = k9.permute_w13(w1), k9.permute_w13(w3)
    x = torch.randn((M, D), generator=gen, device=dev)
    idx = _idx(gen, dev, M, E, repeat=M > 8)
    before = k9.launches
    y = k9.moe_fp4_chain(x, w1, w3, w2, idx, LIMIT, perm13=perm13)
    torch.cuda.synchronize()
    assert k9.launches == before + 1 and y.shape == (M, D)
    assert _rel_err(y, k9.moe_fp4_chain_plain(x, w1, w3, w2, idx, LIMIT, perm13)) <= CHAIN_RTOL


def test_int8_and_chain_kernels_refuse_unsupported_shapes(dev):
    gen = _gen(dev, 1)
    w1, s1 = _int8(dev, gen, 2, 256, 256)
    w2, s2 = _int8(dev, gen, 2, 256, 256)
    x = torch.zeros((17, 256), device=dev)
    idx = torch.zeros(17, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # M = 17: outside int8_chain_supported
        k8.moe_int8_chain(x, w1, w1, w2, s1, s1, s2, idx, LIMIT)
    w13, s13 = _int8(dev, gen, 2, 200, 256)
    w8, s8 = _int8(dev, gen, 2, 256, 200)
    with pytest.raises(ValueError):  # I = 200: outside the gate
        k8.moe_int8_chain(x[:2], w13, w13, w8, s13, s13, s8, idx[:2], LIMIT)
    with pytest.raises(ValueError):  # IN = 200, not a multiple of 16
        k6.moe_int8_gemv(torch.zeros((2, 200), device=dev), w8, idx[:2])
    c = {"q": torch.zeros((2, 256, 128), dtype=torch.uint8, device=dev),
         "s": torch.ones((2, 256, 8), dtype=torch.bfloat16, device=dev)}
    with pytest.raises(ValueError):  # M = 17
        k9.moe_fp4_chain(torch.zeros((17, 256), device=dev), c, c, c, idx, LIMIT)
    seg = k5.tile_segments(torch.zeros(12, dtype=torch.int32, device=dev), 12, 2)
    with pytest.raises(ValueError):  # tm not a multiple of 8
        k7.moe_int8_grouped(torch.zeros((12, 256), device=dev), w1, *seg, tm=12)
