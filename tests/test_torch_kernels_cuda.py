"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: run with ``python -m pytest -m cuda tests/``
on a machine with an NVIDIA Hopper card; elsewhere each test skips.

bf16 tolerances are the JAX package's for these kernels
(tests/test_pallas_kernels.py): 3e-2 for decode, 2e-2 for prefill. Decode
is held row by row to min(3e-2, 2e-2 of the row's max |ref|): its output
averages n tokens' values and is about sqrt(e / n) in size, so at long
contexts a fixed 3e-2 would pass a merge that lost a split. Prefill is
held the same way, each query row (position, head) to min(2e-2, 2e-2 of the
row's max |ref|): a late row averages about a thousand values and is about
0.05 in size, so a fixed 2e-2 would pass a kernel that dropped a key tile;
a right kernel rounds the output and p to bf16 once, a fraction of a
percent of the row's largest value. The
quantized GEMV kernels K3 and K4 form the same exact f32 products as their
plain versions and differ only in the order of the f32 sums: atol 2e-5 (the
JAX tests' tolerance) on outputs of about unit RMS. K5 forms the same
exact f32 products on the tensor cores (each weight rounded once to bf16,
as the plain version rounds it), so each row is held to 1e-4 of its own
max |y|, and its decode is checked bit for bit by rows of unit vectors.
Shapes are those of chip_smoke.py's kernel phase (DeepSeek-V4-Flash's full
widths).

The int8 kernels: K6 forms the plain version's exact f32 products in
another order, on unscaled outputs of magnitude 1e4 (codes up to 127):
each row to 1e-5 of its own max |y| (a row of an invalid id exactly 0); K7 forms exact f32 products too, on the tensor cores,
so each row is held to 1e-4 of its own max |y| (2e-2 of the global max
passes a kernel that drops one product of one row). The chains K8
and K9 round act to bf16, where an f32 sum-order difference moves an
element by one bf16 ulp now and then: K8 is held to 2e-3 of max |y|, K9
each row to CHAIN_ROW_RTOL of its own max |y| (a row of an invalid expert
id exactly 0). Routed experts are drawn from a 16-expert stack.
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
from pegainfer_tpu_torch.studies import k3_study as k3s
from pegainfer_tpu_torch.studies import k4_study as k4s
from pegainfer_tpu_torch.studies import k6_study as k6s

pytestmark = pytest.mark.cuda

DECODE_TOL = 3e-2
DECODE_RTOL = 2e-2
PREFILL_TOL = 2e-2
PREFILL_RTOL = 2e-2
GEMV_TOL = 2e-5
GROUPED_ROW_RTOL = 1e-4  # K5 and K7
INT8_GEMV_RTOL = 1e-5
CHAIN_RTOL = 2e-3  # K8, of the global max
CHAIN_ROW_RTOL = 1e-3  # K9, of each row's max (chip_smoke.py)
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


# (T, S, kv_valid, q_offset, hd, Hq, Hkv): Qwen3-4B's head shape (hd 128,
# G 4) whole-prompt, ragged and as chunks; hd 64; Qwen3.5's full attention
# (hd 256, G 8); G 1 and G 64; one query row; a long prompt
FLASH_CASES = [
    pytest.param(1024, 1024, 1024, 0, 128, 32, 8, id="hd128-G4-T1024"),
    pytest.param(1000, 1000, 1000, 0, 128, 32, 8, id="hd128-G4-T1000"),  # T % 32 != 0
    pytest.param(256, 768, 768, 512, 128, 32, 8, id="hd128-G4-chunk"),
    pytest.param(37, 37, 30, 0, 128, 32, 8, id="hd128-G4-kv30"),
    # a chunk at q_offset 768 whose kv_valid ends inside it, keys past it
    pytest.param(256, 1280, 1000, 768, 128, 32, 8, id="hd128-G4-chunk-kv-short"),
    pytest.param(4096, 4096, 4096, 0, 128, 32, 8, id="hd128-G4-T4096"),
    # a chunk at the end of a 32k context: one dropped key tile moves its rows
    # by less than a fixed 2e-2
    pytest.param(64, 32768, 32768, 32704, 128, 32, 8, id="hd128-G4-chunk-at-32k"),
    pytest.param(1, 1, 1, 0, 128, 32, 8, id="hd128-G4-T1"),
    pytest.param(1, 700, 700, 699, 128, 32, 8, id="hd128-G4-T1-at-699"),
    pytest.param(1024, 1024, 1024, 0, 64, 16, 8, id="hd64-G2-T1024"),
    pytest.param(1024, 1024, 1024, 0, 256, 16, 2, id="hd256-G8-T1024"),
    pytest.param(300, 300, 300, 0, 256, 16, 2, id="hd256-G8-T300"),  # T % 16 != 0
    pytest.param(200, 712, 650, 512, 256, 16, 2, id="hd256-G8-chunk"),
    pytest.param(777, 777, 777, 0, 128, 8, 8, id="hd128-G1-T777"),
    pytest.param(130, 130, 130, 0, 64, 64, 1, id="hd64-G64-T130"),
]


def _prefill_inputs(rng, dev, T, S, hd, Hq, Hkv):
    return _bf16(rng, (T, Hq, hd), dev), _bf16(rng, (S, Hkv, hd), dev), _bf16(rng, (S, Hkv, hd), dev)


def _assert_prefill_close(out, ref, live):
    """Each query row (position, head) below ``live`` within min(PREFILL_TOL,
    PREFILL_RTOL x its max |ref|)."""
    d = (out[:live].float() - ref[:live].float()).abs().amax(dim=2)
    lim = torch.clamp(PREFILL_RTOL * ref[:live].float().abs().amax(dim=2), max=PREFILL_TOL)
    assert bool(torch.isfinite(out[:live]).all())
    assert bool((d <= lim).all()), f"worst row at {(d / lim).max().item():.3f} of its limit"


@pytest.mark.parametrize("T,S,kv_valid,q_offset,hd,Hq,Hkv", FLASH_CASES)
def test_flash_prefill_kernel_matches_plain(dev, T, S, kv_valid, q_offset, hd, Hq, Hkv):
    rng = np.random.default_rng(T + S + hd)
    q, k, v = _prefill_inputs(rng, dev, T, S, hd, Hq, Hkv)
    before = fp.launches
    out = fp.flash_attention(q, k, v, kv_valid, q_offset, hd ** -0.5)
    torch.cuda.synchronize()
    assert fp.launches == before + 1
    ref = fp.att.causal_attention(q, k, v, kv_valid, q_offset, hd ** -0.5)
    _assert_prefill_close(out, ref, min(T, kv_valid - q_offset))


def test_flash_prefill_wrapper_makes_no_host_sync(dev):
    """The wrapper plans from shapes alone and encodes its tensor maps on the
    host: a host read of a device value would raise under this sync debug
    mode. A whole prompt and a chunk, each still right."""
    rng = np.random.default_rng(11)
    calls = [(_prefill_inputs(rng, dev, 1024, 1024, 128, 32, 8), 1024, 0),
             (_prefill_inputs(rng, dev, 256, 1280, 128, 32, 8), 1000, 768)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [fp.flash_attention(*qkv, kv_valid, q_offset, 128 ** -0.5)
                for qkv, kv_valid, q_offset in calls]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for out, (qkv, kv_valid, q_offset) in zip(outs, calls):
        ref = fp.att.causal_attention(*qkv, kv_valid, q_offset, 128 ** -0.5)
        _assert_prefill_close(out, ref, min(out.shape[0], kv_valid - q_offset))


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


def _fp4(dev, gen, E, out_dim, in_dim, group=32, pow2=True):
    """Codes over all 256 byte values and bf16 group scales around
    1 / (2.93 sqrt(in_dim)), so y has about unit RMS: powers of two (the
    checkpoint's), or with random mantissas."""
    q = torch.randint(0, 256, (E, out_dim, in_dim // 2), dtype=torch.uint8, generator=gen,
                      device=dev)
    e = torch.randint(-1, 2, (E, out_dim, in_dim // group), generator=gen, device=dev)
    s = torch.exp2(e.float() - round(np.log2(2.93 * in_dim ** 0.5)))
    if not pow2:
        s = s * (1 + torch.rand(s.shape, generator=gen, device=dev))
    return q, s.to(torch.bfloat16)


# K4 at the seven shapes of a DSv4-Flash decode step (k4_study.STEP_SHAPES:
# wq_a, wq_b, wkv, wo_b, shared w1 / w3, shared w2, idx_wq_b), whose plans
# split K into 1 to 16 parts, and the first tests' (256, 384)
K4_STEP_SHAPES = [(OUT, IN) for _, OUT, IN, _ in k4s.STEP_SHAPES]


@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("OUT,IN", [(32768, 1024), (4096, 8192), (512, 4096), (256, 384),
                                    (1024, 4096), (2048, 4096), (4096, 2048), (8192, 1024)])
def test_fp8_gemv_kernel_matches_plain(dev, M, OUT, IN):
    gen = _gen(dev, OUT + IN + M)
    q, s = _fp8(dev, gen, OUT, IN)
    x = torch.randn((M, IN), generator=gen, device=dev).to(torch.bfloat16)
    before = k4.launches
    y = k4.fp8_gemv(x, q, s)
    torch.cuda.synchronize()
    assert k4.launches == before + 1 and y.shape == (M, OUT) and y.dtype == torch.float32
    assert (y - k4.fp8_gemv_plain(x, q, s)).abs().max().item() <= GEMV_TOL


@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("OUT,IN", K4_STEP_SHAPES)
def test_fp8_gemv_kernel_mantissa_scales(dev, M, OUT, IN):
    """Block scales with random bf16 mantissas, so that the decode rounds
    each weight (power-of-two scales never do)."""
    gen = _gen(dev, OUT + IN + M + 1)
    q, s = k4s.fp8_weight(gen, OUT, IN, dev, mantissa=True)
    x = torch.randn((M, IN), generator=gen, device=dev).to(torch.bfloat16)
    y = k4.fp8_gemv(x, q, s)
    torch.cuda.synchronize()
    assert (y - k4.fp8_gemv_plain(x, q, s)).abs().max().item() <= GEMV_TOL


@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("OUT,IN,bo,bi", k4s.FULL_DIM_SHAPES)
def test_fp8_gemv_kernel_full_dim_blocks(dev, M, OUT, IN, bo, bi):
    """A scale block of the full dim, as quant.quantize_fp8_tensor makes it
    where 128 does not divide the dim: IN 400 (no K split, a last chunk of
    16 columns), OUT 1000 (a last row tile of 8 rows), and one scale a row
    over IN 1024."""
    gen = _gen(dev, OUT + IN + M + 2)
    q, s = k4s.fp8_weight(gen, OUT, IN, dev, mantissa=True, bo=bo, bi=bi)
    x = torch.randn((M, IN), generator=gen, device=dev).to(torch.bfloat16)
    y = k4.fp8_gemv(x, q, s)
    torch.cuda.synchronize()
    assert (y - k4.fp8_gemv_plain(x, q, s)).abs().max().item() <= GEMV_TOL


@pytest.mark.parametrize("OUT,IN", [(512, 4096), (32768, 1024), (4096, 8192)])
def test_fp8_gemv_kernel_same_bits_twice(dev, OUT, IN):
    """wkv (16 K parts a block), wq_b (none) and wo_b (4): partial sums
    meet in a fixed order, so two calls give the same bits."""
    gen = _gen(dev, OUT + IN + 3)
    q, s = k4s.fp8_weight(gen, OUT, IN, dev, mantissa=True)
    x = torch.randn((8, IN), generator=gen, device=dev).to(torch.bfloat16)
    assert torch.equal(k4.fp8_gemv(x, q, s), k4.fp8_gemv(x, q, s))


@pytest.mark.parametrize("case", k3s.check_cases(), ids=lambda c: c[0])
def test_fp4_gemv_kernel_matches_plain(dev, case):
    """K3 at the w1, w2 and w3 shapes (k3_study.check_cases): M 1, 2, 6, 12
    with distinct, repeated and B = 2's shared experts, M 20 and 40 (chunks
    of 16 rows past the first), scale groups of 32 and 64 with power-of-two
    and random-mantissa scales, and ids -1 and E (zero rows). y's block is
    filled with NaN first (k3_study.run_case), so an element left unwritten
    fails."""
    before = k3.launches
    y, ref = k3s.run_case(case, dev)
    torch.cuda.synchronize()
    assert k3.launches == before + 1 and y.shape == ref.shape and y.dtype == torch.float32
    assert k3s.max_err(y, ref) <= GEMV_TOL
    if case[5] == "invalid":
        assert (ref == 0).any(dim=1).any() and (y[(ref == 0).all(dim=1)] == 0).all()


@pytest.mark.parametrize("OUT,IN,M", [(2048, 4096, 6), (4096, 2048, 12), (2048, 4096, 40)])
def test_fp4_gemv_kernel_same_bits_twice(dev, OUT, IN, M):
    """A block's K parts meet in a fixed order and each y element is
    written once: two calls give the same bits."""
    gen = _gen(dev, OUT + M + 4)
    q, s = _fp4(dev, gen, 64, OUT, IN, pow2=False)
    x = torch.randn((M, IN), generator=gen, device=dev)
    idx = k3s.route("repeated", M, 64, torch.randperm(64, generator=gen, device=dev))
    assert torch.equal(k3.moe_fp4_gemv(x, q, s, idx), k3.moe_fp4_gemv(x, q, s, idx))


def _routing(gen, dev, M, E, skew):
    """Sorted expert ids for M rows: skewed toward a few experts (most
    experts empty), or spread over all of them."""
    if skew:
        hot = torch.tensor([0, 3, 3, 3, 3, 7, 200, 255], device=dev)
        pick = torch.randint(0, len(hot), (M,), generator=gen, device=dev)
        return torch.sort(hot[pick]).values.to(torch.int32)
    return torch.sort(torch.randint(0, E, (M,), generator=gen, device=dev)).values.to(
        torch.int32)


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
    seg = k5.tile_segments(torch.zeros(16, dtype=torch.int32, device=dev), 16, 2)
    x16 = torch.zeros((16, 256), device=dev)
    with pytest.raises(ValueError):  # scale groups of 8
        k5.moe_fp4_grouped(x16, q4, _fp4(dev, gen, 2, 64, 256, group=8)[1], *seg, tm=16)
    with pytest.raises(ValueError):  # OUT not a multiple of 64
        k5.moe_fp4_grouped(x16, *_fp4(dev, gen, 2, 96, 256), *seg, tm=16)
    with pytest.raises(ValueError):  # IN not a multiple of 64
        k5.moe_fp4_grouped(torch.zeros((16, 224), device=dev), *_fp4(dev, gen, 2, 64, 224),
                           *seg, tm=16)
    with pytest.raises(ValueError):  # f32 scales
        k5.moe_fp4_grouped(x16, q4, s4.float(), *seg, tm=16)
    with pytest.raises(ValueError):  # a plan of other rows
        k5.moe_fp4_grouped(x16, q4, s4, *seg, tm=16, plan=k5.plan(*seg, 16, 3))


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


@pytest.mark.parametrize("case", k6s.check_cases(), ids=lambda c: c[0])
def test_int8_gemv_kernel_matches_plain(dev, case):
    """K6 at the w1 and w2 shapes (k6_study.check_cases): M 1, 2, 6, 12 with
    distinct, repeated and B = 2's shared experts, M 20 and 40 (chunks of 16
    rows past the first), 16 and 20 rows on one expert (a second pass of 8
    rows), ids -1 and E (zero rows), and a ragged OUT 1000 with an IN of 400.
    Each row is held to INT8_GEMV_RTOL of its own max |ref|, a row of zeros
    exactly; y's block is filled with NaN first (k6_study.run_case), so an
    element left unwritten fails."""
    before = k6.launches
    y, ref = k6s.run_case(case, dev)
    torch.cuda.synchronize()
    assert k6.launches == before + 1 and y.shape == ref.shape and y.dtype == torch.float32
    assert k6s.row_err(y, ref)[1] <= 1.0
    if case[4] == "invalid":
        assert (ref == 0).all(dim=1).any() and (y[(ref == 0).all(dim=1)] == 0).all()


@pytest.mark.parametrize("OUT,IN,M", [(2048, 4096, 6), (4096, 2048, 12), (2048, 4096, 40)])
def test_int8_gemv_kernel_same_bits_twice(dev, OUT, IN, M):
    """A block's K parts meet in a fixed order and each y element is
    written once: two calls give the same bits."""
    gen = _gen(dev, OUT + M + 6)
    q, _ = _int8(dev, gen, 64, OUT, IN)
    x = torch.randn((M, IN), generator=gen, device=dev)
    idx = k6s.route("repeated", M, 64, torch.randperm(64, generator=gen, device=dev))
    assert torch.equal(k6.moe_int8_gemv(x, q, idx), k6.moe_int8_gemv(x, q, idx))


def _k7_routing(gen, dev, M, E, routing):
    """Sorted expert ids of M routed rows for K7's cases."""
    if routing in ("spread", "skewed"):
        return _routing(gen, dev, M, E, routing == "skewed")
    if routing == "two-experts":  # thousands of rows an expert: many row chunks
        return torch.sort(torch.randint(0, 2, (M,), generator=gen, device=dev) * 97).values.to(
            torch.int32)
    if routing == "one-expert":
        return torch.full((M,), 201, dtype=torch.int32, device=dev)
    if routing == "mid-n8":  # 69 = 64 + 5 rows, then 13 and 6: chunks end inside an n8
        return torch.repeat_interleave(torch.tensor([17, 40, 230], device=dev),
                                       torch.tensor([69, 13, M - 82], device=dev)).to(torch.int32)
    raise ValueError(routing)


def _uncover(seg, tm):
    """Leave rows of no segment: the second tile loses every segment, and
    the first tile's first segment ends up to three rows early."""
    seg_e, seg_lo, seg_hi, n_seg = (t.clone() for t in seg)
    n_seg[1] = 0
    seg_hi[0, 0] = torch.clamp(seg_hi[0, 0] - 3, min=seg_lo[0, 0])
    return seg_e, seg_lo, seg_hi, n_seg


def _row_share(y, ref, rtol):
    """The worst row's max |diff| over rtol x that row's max |ref|; a row of
    zeros must be exactly 0 (inf otherwise)."""
    d = (y - ref).abs().amax(dim=1)
    lim = rtol * ref.abs().amax(dim=1)
    return torch.where(d > 0, d / lim, torch.zeros_like(d)).max().item()


def _grouped_rows(gen, dev, M, IN, E, routing):
    """x_sorted, tm and segments of one grouped-GEMM call (K5, K7) of M
    routed rows, padded as models/dsv4.py pads them; "uncovered" is spread
    routing with rows of no segment."""
    tm = 128 if M >= 128 else -(-M // 8) * 8
    Mp = -(-M // tm) * tm
    e = _k7_routing(gen, dev, M, E, "spread" if routing == "uncovered" else routing)
    e = torch.cat([e, e[-1:].expand(Mp - M)])  # pad rows carry the last expert
    seg = k5.tile_segments(e, tm, E)
    if routing == "uncovered":
        seg = _uncover(seg, tm)
    x = torch.randn((Mp, IN), generator=gen, device=dev).to(torch.bfloat16)
    return x, tm, seg


@pytest.mark.parametrize("M,OUT,IN,routing,sync_debug", [
    (6144, 2048, 4096, "spread", False), (6144, 4096, 2048, "skewed", False),
    (54, 2048, 4096, "skewed", False), (300, 4096, 2048, "spread", False),
    (6144, 2048, 4096, "two-experts", False), (300, 2048, 4096, "one-expert", False),
    (8, 2048, 4096, "spread", False), (512, 2048, 4096, "uncovered", False),
    (88, 4096, 2048, "mid-n8", False), (6144, 2048, 4096, "spread", True)])
def test_int8_grouped_kernel_matches_plain(dev, M, OUT, IN, routing, sync_debug):
    """K7's products are exact in f32 and only their sum order differs from
    the plain version's: each row within GROUPED_ROW_RTOL of its max |ref|. The
    sync-debug case builds the plan in the wrapper under
    ``set_sync_debug_mode("error")``: neither reads a device value."""
    gen = _gen(dev, M + OUT)
    E = 256
    q, _ = _int8(dev, gen, E, OUT, IN)
    x, tm, seg = _grouped_rows(gen, dev, M, IN, E, routing)
    Mp = x.shape[0]
    k7.moe_int8_grouped(x, q, *seg, tm=tm)  # built and loaded outside the sync check
    torch.cuda.synchronize()
    before = k7.launches
    if sync_debug:
        torch.cuda.set_sync_debug_mode("error")
    try:
        y = k7.moe_int8_grouped(x, q, *seg, tm=tm)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert k7.launches == before + 1 and y.shape == (Mp, OUT)
    ref = k7.moe_int8_grouped_plain(x, q, *seg, tm=tm)
    assert _row_share(y, ref, GROUPED_ROW_RTOL) <= 1.0
    if routing == "uncovered":
        _, covered = k5._row_experts(*seg, tm)
        assert int((~covered).sum()) > tm and not bool(y[~covered].any())


@pytest.mark.parametrize("M,OUT,IN,routing,group,pow2,sync_debug", [
    (6144, 2048, 4096, "spread", 32, True, False), (6144, 4096, 2048, "skewed", 32, True, False),
    (54, 2048, 4096, "skewed", 32, True, False), (300, 4096, 2048, "spread", 32, True, False),
    (6144, 2048, 4096, "two-experts", 32, True, False),
    (300, 2048, 4096, "one-expert", 32, True, False), (8, 2048, 4096, "spread", 32, True, False),
    (512, 2048, 4096, "uncovered", 32, True, False), (88, 4096, 2048, "mid-n8", 32, True, False),
    (6144, 2048, 4096, "spread", 32, False, False), (300, 4096, 2048, "spread", 16, False, False),
    (300, 2048, 4096, "skewed", 64, False, False), (6144, 2048, 4096, "spread", 32, True, True)])
def test_fp4_grouped_kernel_matches_plain(dev, M, OUT, IN, routing, group, pow2, sync_debug):
    """K5's products are exact in f32 (bf16 weights, each rounded once, times
    bf16 x) and only their sum order differs from the plain version's: each
    row within GROUPED_ROW_RTOL of its max |ref|, at power-of-two and at
    arbitrary bf16 scales and groups of 16, 32, 64. The sync-debug case
    builds the plan in the wrapper under ``set_sync_debug_mode("error")``."""
    gen = _gen(dev, M + OUT + group)
    E = 256
    q, s = _fp4(dev, gen, E, OUT, IN, group=group, pow2=pow2)
    x, tm, seg = _grouped_rows(gen, dev, M, IN, E, routing)
    Mp = x.shape[0]
    k5.moe_fp4_grouped(x, q, s, *seg, tm=tm)  # built and loaded outside the sync check
    torch.cuda.synchronize()
    before = k5.launches
    if sync_debug:
        torch.cuda.set_sync_debug_mode("error")
    try:
        y = k5.moe_fp4_grouped(x, q, s, *seg, tm=tm)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert k5.launches == before + 1 and y.shape == (Mp, OUT) and y.dtype == torch.float32
    ref = k5.moe_fp4_grouped_plain(x, q, s, *seg, tm=tm)
    assert _row_share(y, ref, GROUPED_ROW_RTOL) <= 1.0
    if routing == "uncovered":
        _, covered = k5._row_experts(*seg, tm)
        assert int((~covered).sum()) > tm and not bool(y[~covered].any())


@pytest.mark.parametrize("pow2", [True, False], ids=["pow2-scales", "bf16-scales"])
def test_fp4_grouped_decode_is_exact(dev, pow2):
    """Rows that are unit vectors e_k make y[r, o] the decoded weight
    W[o, k] itself (one product by 1, the rest by 0): the kernel's weights
    must be ``quant.dequant_any``'s bit for bit, at power-of-two scales and
    at arbitrary bf16 scales in the normal range."""
    from pegainfer_tpu_torch.ops import quant

    gen = _gen(dev, 17)
    E, OUT, IN = 256, 4096, 2048
    q, s = _fp4(dev, gen, E, OUT, IN, pow2=pow2)
    experts = (3, 100, 255)
    e = torch.tensor(experts, device=dev).repeat_interleave(IN).to(torch.int32)
    x = torch.eye(IN, device=dev, dtype=torch.bfloat16).repeat(len(experts), 1)
    seg = k5.tile_segments(e, 128, E)
    y = k5.moe_fp4_grouped(x, q, s, *seg, tm=128)
    torch.cuda.synchronize()
    for i, ex in enumerate(experts):
        w = quant.dequant_any({"q": q[ex], "s": s[ex]}, torch.bfloat16).float()
        assert torch.equal(y[i * IN:(i + 1) * IN].T, w)


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


def _chain_idx(gen, dev, M, E, routing):
    """Expert ids of M routed rows for K9's cases: "distinct" experts, the
    second half "repeat"ing the first, all on "one" expert (two n8 columns
    at M > 8), or distinct with "invalid" ids (-1, E, E + 5) among them."""
    idx = torch.randperm(E, generator=gen, device=dev)[:M].to(torch.int32)
    if routing == "repeat":
        idx[M // 2:] = idx[: M - M // 2]
    elif routing == "one":
        idx[:] = idx[0]
    elif routing == "invalid":
        idx[1::3] = torch.tensor([-1, E, E + 5], dtype=torch.int32, device=dev).repeat(M)[
            : len(idx[1::3])]
    return idx


CHAIN_CASES = [  # (M, I, D, routing, group, pow2, limit)
    *((m, 2048, 4096, r, 32, True, LIMIT) for m, r in ((1, "distinct"), (6, "distinct"),
                                                        (12, "repeat"), (16, "distinct"))),
    (5, 256, 512, "distinct", 32, True, LIMIT),
    (16, 2048, 4096, "one", 32, True, LIMIT),  # two n8 columns of one expert
    (9, 2048, 4096, "invalid", 32, True, LIMIT),
    (6, 2048, 4096, "distinct", 32, True, 0.0),  # no clamp
    (6, 2048, 4096, "repeat", 64, True, LIMIT),
    (6, 2048, 4096, "distinct", 32, False, LIMIT),  # arbitrary bf16 scales
]


@pytest.mark.parametrize("perm13", [False, True])
@pytest.mark.parametrize("M,I,D,routing,group,pow2,limit", CHAIN_CASES)
def test_fp4_chain_kernel_matches_plain(dev, perm13, M, I, D, routing, group, pow2, limit):
    """K9 rounds act to bf16 where an f32 sum-order difference can move one
    element by one ulp: each row within CHAIN_ROW_RTOL of its own max |y|,
    and rows of invalid ids exactly 0."""
    gen = _gen(dev, M + I + group + perm13)
    E = 16
    w1, w3, w2 = ({"q": q, "s": s} for q, s in (_fp4(dev, gen, E, I, D, group, pow2),
                                                _fp4(dev, gen, E, I, D, group, pow2),
                                                _fp4(dev, gen, E, D, I, group, pow2)))
    if perm13:
        w1, w3 = k9.permute_w13(w1), k9.permute_w13(w3)
    x = torch.randn((M, D), generator=gen, device=dev)
    idx = _chain_idx(gen, dev, M, E, routing)
    before = k9.launches
    y = k9.moe_fp4_chain(x, w1, w3, w2, idx, limit, perm13=perm13)
    torch.cuda.synchronize()
    assert k9.launches == before + 1 and y.shape == (M, D)
    # the plain version gives 0 for a row of an invalid id, and _row_share
    # holds such a row to exactly 0
    ref = k9.moe_fp4_chain_plain(x, w1, w3, w2, idx, limit, perm13)
    assert _row_share(y, ref, CHAIN_ROW_RTOL) <= 1.0


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
