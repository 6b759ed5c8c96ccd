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
id exactly 0). Routed experts are drawn from a 16-expert stack. The int8
linear kernel (``csrc/int8_linear.cu``) forms its plain version's exact
f32 products in another order, then scales and rounds once: f32 outputs
each row to INT8_GEMV_RTOL of its own max |y|, bf16 outputs each row to one
bf16 ulp of its max (``int8_linear_study.row_err``).
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
from pegainfer_tpu_torch.ops.cuda import int8_linear as il
from pegainfer_tpu_torch.ops.cuda import paged_decode as pd
from pegainfer_tpu_torch.studies import k3_study as k3s
from pegainfer_tpu_torch.studies import k4_study as k4s
from pegainfer_tpu_torch.studies import int8_linear_study as ils
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


# Qwen3-4B's heads on one rank of a tensor-parallel engine (hd 128, G 4):
# Hq / Hkv 16 / 4 at TP 2 and 8 / 2 at TP 4, at 1, 2 and 8 rows
TP_DECODE_CASES = [
    pytest.param(Hq, Hkv, seq_lens, id=f"tp{tp}-B{len(seq_lens)}")
    for tp, Hq, Hkv in ((2, 16, 4), (4, 8, 2))
    for seq_lens in ([1152], [1025, 0], [1088, 300, 532, 64, 1, 2000, 700, 0])]


@pytest.mark.parametrize("form", ["pool_cur", "layer"])
@pytest.mark.parametrize("Hq,Hkv,seq_lens", TP_DECODE_CASES)
def test_paged_decode_kernel_at_the_tp_shard_heads(dev, form, Hq, Hkv, seq_lens):
    rng = np.random.default_rng(Hq + Hkv + len(seq_lens))
    args, kw = _decode_inputs(rng, dev, form, 128, Hq, Hkv, seq_lens)
    before = pd.launches
    out = pd.paged_attention_decode(*args, **kw)
    torch.cuda.synchronize()
    assert pd.launches == before + 1
    _assert_decode_close(out, pd.paged_attention_decode_plain(*args, **kw))


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
    # one rank's heads under tensor parallelism: TP 2 (16 / 4) and TP 4
    # (8 / 2), a whole prompt and a chunk at a query offset
    pytest.param(1024, 1024, 1024, 0, 128, 16, 4, id="hd128-G4-tp2-T1024"),
    pytest.param(256, 1280, 1280, 1024, 128, 16, 4, id="hd128-G4-tp2-chunk"),
    pytest.param(1024, 1024, 1024, 0, 128, 8, 2, id="hd128-G4-tp4-T1024"),
    pytest.param(256, 1280, 1280, 1024, 128, 8, 2, id="hd128-G4-tp4-chunk"),
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
# split K into 1 to 16 parts, and the first tests' (256, 384). Every case runs
# on a NaN-filled y (k4_study.run_poisoned), so an element left unwritten fails.
K4_STEP_SHAPES = [(OUT, IN) for _, OUT, IN, _ in k4s.STEP_SHAPES]


@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("OUT,IN", [(32768, 1024), (4096, 8192), (512, 4096), (256, 384),
                                    (1024, 4096), (2048, 4096), (4096, 2048), (8192, 1024)])
def test_fp8_gemv_kernel_matches_plain(dev, M, OUT, IN):
    gen = _gen(dev, OUT + IN + M)
    q, s = _fp8(dev, gen, OUT, IN)
    x = torch.randn((M, IN), generator=gen, device=dev).to(torch.bfloat16)
    before = k4.launches
    y = k4s.run_poisoned(x, q, s)
    torch.cuda.synchronize()
    assert k4.launches == before + 1 and y.shape == (M, OUT) and y.dtype == torch.float32
    assert k3s.max_err(y, k4.fp8_gemv_plain(x, q, s)) <= GEMV_TOL


@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("OUT,IN", K4_STEP_SHAPES)
def test_fp8_gemv_kernel_mantissa_scales(dev, M, OUT, IN):
    """Block scales with random bf16 mantissas, so that the decode rounds
    each weight (power-of-two scales never do)."""
    gen = _gen(dev, OUT + IN + M + 1)
    q, s = k4s.fp8_weight(gen, OUT, IN, dev, mantissa=True)
    x = torch.randn((M, IN), generator=gen, device=dev).to(torch.bfloat16)
    y = k4s.run_poisoned(x, q, s)
    torch.cuda.synchronize()
    assert k3s.max_err(y, k4.fp8_gemv_plain(x, q, s)) <= GEMV_TOL


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
    y = k4s.run_poisoned(x, q, s)
    torch.cuda.synchronize()
    assert k3s.max_err(y, k4.fp8_gemv_plain(x, q, s)) <= GEMV_TOL


@pytest.mark.parametrize("OUT,IN", [(512, 4096), (32768, 1024), (4096, 8192)])
def test_fp8_gemv_kernel_same_bits_twice(dev, OUT, IN):
    """wkv (16 K parts a block), wq_b (none) and wo_b (4): partial sums
    meet in a fixed order, so two calls give the same bits."""
    gen = _gen(dev, OUT + IN + 3)
    q, s = k4s.fp8_weight(gen, OUT, IN, dev, mantissa=True)
    x = torch.randn((8, IN), generator=gen, device=dev).to(torch.bfloat16)
    assert torch.equal(k4s.run_poisoned(x, q, s), k4s.run_poisoned(x, q, s))


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


@pytest.mark.parametrize("case", k6s.dense_check_cases(), ids=lambda c: c[0])
def test_int8_gemv_dense_matches_plain(dev, case):
    """K6 at one expert (``int8_gemv_dense``, the decode rows of the int8
    weight-only linears: one grid row a chunk of 16 rows) at Qwen3-4B's wq
    and wk and a ragged OUT 1000 x IN 400, M 1 to 64 (17 and 33: a last
    chunk of one row): each row to INT8_GEMV_RTOL of its own max |ref|, y's
    block NaN-filled first; one launch."""
    before = k6.launches
    y, ref = k6s.run_dense_case(case, dev)
    torch.cuda.synchronize()
    assert k6.launches == before + 1 and y.shape == ref.shape and y.dtype == torch.float32
    assert k6s.row_err(y, ref)[1] <= 1.0


def test_int8_linear_routes_decode_rows_to_k6(dev):
    """``quant.int8_linear`` on the card: at most INT8_GEMV_ROWS rows are one
    launch of the int8 linear kernel, which took K6 at one expert's place
    (its plain version with ``plain_kernels``, the scaled plain product bit
    for bit), more take the JAX form; K6 launches no more; each within a
    bf16 rounding of the scaled plain product. ``int8_linears`` on three
    weights is one launch."""
    from pegainfer_tpu_torch.ops import quant

    gen = _gen(dev, 77)
    w = {"q": torch.randint(-127, 128, (1024, 2560), generator=gen, device=dev,
                            dtype=torch.int8),
         "s": torch.rand(1024, generator=gen, device=dev) * 1e-3}
    for M in (1, quant.INT8_GEMV_ROWS, quant.INT8_GEMV_ROWS + 1, 300):
        x = torch.randn((M, 2560), generator=gen, device=dev).to(torch.bfloat16)
        ref = (k6.int8_gemv_dense_plain(x, w["q"]) * w["s"]).to(torch.bfloat16)
        before, k6_before = il.launches, k6.launches
        y = quant.int8_linear(x, w)
        plain = quant.int8_linear(x, w, plain_kernels=True)
        torch.cuda.synchronize()
        assert il.launches == before + (M <= quant.INT8_GEMV_ROWS)
        assert k6.launches == k6_before and y.dtype == torch.bfloat16
        if M <= quant.INT8_GEMV_ROWS:
            assert torch.equal(plain, ref)
        err = (y.float() - ref.float()).abs().amax(dim=1)
        # bf16 outputs: one rounding apart at most
        assert (err <= 2 ** -7 * ref.float().abs().amax(dim=1)).all()
        before = il.launches
        ys = quant.int8_linears(x, [w, w, w])
        torch.cuda.synchronize()
        assert il.launches == before + (M <= quant.INT8_GEMV_ROWS)
        assert all(torch.equal(a, y) for a in ys)


@pytest.mark.parametrize("case", ils.check_cases(), ids=lambda c: c[0])
def test_int8_linear_kernel_matches_plain(dev, case):
    """The int8 linear kernel (one launch for the case's weights: Qwen3-4B's
    wq, wk, a ragged OUT 1000 x IN 400, Qwen3's wq / wk / wv and the
    hybrid's two groups of four, a wide OUT 16384 x IN 512) at 1-64 rows (17
    and 33: a last n8 group of one row; the groups at 64 rows and the wide
    weight past 16 in the warpgroup form), bf16 and f32 rows: each row within one bf16 ulp (f32:
    INT8_GEMV_RTOL) of its own max |ref|, the outputs' block NaN-filled
    first (``int8_linear_study.run_case``), so an unwritten element fails."""
    before = il.launches
    ys, refs = ils.run_case(case, dev)
    torch.cuda.synchronize()
    assert il.launches == before + 1 and len(ys) == len(case[1])
    for y, ref in zip(ys, refs):
        assert y.shape == ref.shape and y.dtype == ref.dtype and y.is_contiguous()
        assert ils.row_err(y, ref)[1] <= 1.0


@pytest.mark.parametrize("case", ils.tp_check_cases(), ids=lambda c: c[0])
def test_int8_linear_kernel_at_the_tp_shard_shapes(dev, case):
    """The int8 linear kernel at Qwen3-4B's shard shapes of TP 2 and TP 4
    (``int8_linear_study.tp_check_cases``) at 1, 8, 16 and 64 rows, wo and
    w_down through the f32-output epilogue (the partial sums a rank
    reduces): each row within one bf16 ulp (f32: INT8_GEMV_RTOL) of its own
    max |ref|, the outputs' block NaN-filled first."""
    before = il.launches
    ys, refs = ils.run_case(case, dev)
    torch.cuda.synchronize()
    assert il.launches == before + 1
    for y, ref in zip(ys, refs):
        assert y.dtype == (torch.float32 if case[4] == "f32_out" else torch.bfloat16)
        assert y.shape == ref.shape and y.dtype == ref.dtype and y.is_contiguous()
        assert ils.row_err(y, ref)[1] <= 1.0


@pytest.mark.parametrize("M", [1, 16, 64])
def test_int8_linear_kernel_same_bits_twice_and_joined(dev, M):
    """A block's K parts meet in a fixed order and each y element is
    written once: two calls give the same bits, and the joined outputs are
    the listed ones side by side."""
    gen = _gen(dev, 200 + M)
    ws = [ils.random_weight(gen, 1, o, 2048, dev) for o in (2048, 2048, 4096, 4096)]
    qs, ss = [q[0] for q, _, _ in ws], [s[0] for _, s, _ in ws]
    x = torch.randn((M, 2048), generator=gen, device=dev).to(torch.bfloat16)
    a, b = il.int8_linear(x, qs, ss), il.int8_linear(x, qs, ss)
    joined = il.int8_linear(x, qs, ss, joined=True)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(joined, torch.cat(a, dim=-1))


def test_int8_linear_kernel_in_a_cuda_graph(dev):
    """Captured in a CUDA graph (no host read, no lazily made state) and
    replayed on new rows, it equals the eager launch bit for bit."""
    gen = _gen(dev, 210)
    ws = [ils.random_weight(gen, 1, o, 2560, dev) for o in (4096, 1024, 1024)]
    qs, ss = [q[0] for q, _, _ in ws], [s[0] for _, s, _ in ws]
    x = torch.randn((8, 2560), generator=gen, device=dev).to(torch.bfloat16)
    il.int8_linear(x, qs, ss)  # the first launch sets the kernel's attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = il.int8_linear(x, qs, ss, joined=True)
    x.copy_(torch.randn((8, 2560), generator=gen, device=dev).to(torch.bfloat16))
    before = il.launches
    graph.replay()
    torch.cuda.synchronize()
    assert il.launches == before
    assert torch.equal(out, il.int8_linear(x, qs, ss, joined=True))


def test_int8_linear_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q = torch.zeros((64, 256), dtype=torch.int8, device=dev)
    s = torch.ones(64, device=dev)
    x = torch.zeros((4, 256), dtype=torch.bfloat16, device=dev)
    for bad in (lambda: il.int8_linear(x, [q] * 5, [s] * 5),  # more than 4 weights
                lambda: il.int8_linear(torch.zeros((65, 256), dtype=torch.bfloat16, device=dev),
                                       [q], [s]),  # more than 64 rows
                lambda: il.int8_linear(x[:, :200], [q[:, :200]], [s]),  # IN not a multiple of 16
                lambda: il.int8_linear(x.half(), [q], [s]),  # fp16 rows
                lambda: il.int8_linear(x, [q.float()], [s]),  # q not int8
                lambda: il.int8_linear(x, [q], [s.half()]),  # s not f32
                lambda: il.int8_linear(x, [q[:, ::2]], [s])):  # q not contiguous
        with pytest.raises(ValueError):
            bad()


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


# ── Qwen3's decode step under CUDA graphs (engine/decode_graphs.py) ──────
# A tiny Qwen3 at hd 128, G 2 (so K1 runs), bf16 weights made on the card,
# and the same weights in the int8 mode (K6 at one expert in every linear).
# The graphed step must equal the eager step bit for bit: it launches the
# same kernels with the same arguments. The pools are compared past the
# null page (page 0), which padding rows write, the graphs' warm-ups
# included.

GRAPH_PS = 16
GRAPH_LAYERS = 2
GRAPH_BUCKETS = (1, 2, 4, 8)


def _graph_cfg():
    from pegainfer_tpu_torch.models import qwen3 as q3

    return q3.Qwen3Config(hidden_size=256, intermediate_size=512,
                          num_hidden_layers=GRAPH_LAYERS, num_attention_heads=4,
                          num_key_value_heads=2, head_dim=128, vocab_size=512,
                          rms_norm_eps=1e-6, rope_theta=1e6, tie_word_embeddings=False,
                          eos_token_id=1, stop_token_ids=(1,), max_position_embeddings=4096)


@pytest.fixture(scope="module")
def graph_models():
    """{"bf16": params, "int8": params} of ``_graph_cfg`` on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from pegainfer_tpu_torch.models import qwen3 as q3

    cfg = _graph_cfg()
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = q3.init_random_params_device(cfg, gen, "cuda", scale=0.05)
    int8 = q3.quantize_params_int8({**params, "layers": dict(params["layers"])})
    return {"bf16": params, "int8": int8}


def _graph_pool(num_pages=1 + 8 * 16):
    from pegainfer_tpu_torch.models import qwen3 as q3

    kv = q3.make_kv_pages(_graph_cfg(), num_pages, GRAPH_PS, device="cuda")
    return kv.normal_(generator=torch.Generator(device="cuda").manual_seed(5))


def _graph_batch(rows, B, P, seed=0):
    """Padded numpy inputs of one step: ``rows`` = [(context, pages)] live
    rows (the token at position context - 1 in flight), dead rows after."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros(B, np.int32)
    positions = np.zeros(B, np.int32)
    seq_lens = np.zeros(B, np.int32)
    tables = np.zeros((B, P), np.int32)
    for i, (ctx, pages) in enumerate(rows):
        tokens[i] = rng.integers(2, 512)
        positions[i] = ctx - 1
        seq_lens[i] = ctx
        tables[i, : len(pages)] = pages
    return tokens, positions, tables, seq_lens


def _graph_rows(n, P):
    """n live rows whose contexts fill between half and all of a width-P
    table, each on its own pages."""
    rows = []
    for i in range(n):
        ctx = (P // 2) * GRAPH_PS + 1 + (37 * i) % ((P // 2) * GRAPH_PS - 1)
        rows.append((ctx, list(range(1 + i * P, 1 + i * P + -(-ctx // GRAPH_PS)))))
    return rows


def _live_pages_equal(a, b):
    return torch.equal(a[:, :, 1:], b[:, :, 1:])


def _eager_step(cfg, params, kv, batch):
    from pegainfer_tpu_torch.models import qwen3 as q3

    with torch.no_grad():
        return q3.decode(cfg, params, kv, *[torch.from_numpy(a).cuda() for a in batch])


def _graphs(cfg, params, kv):
    from functools import partial

    from pegainfer_tpu_torch.engine.decode_graphs import DecodeGraphs
    from pegainfer_tpu_torch.models import qwen3 as q3

    return DecodeGraphs(partial(q3.decode, cfg, params, kv), torch.device("cuda"),
                        GRAPH_BUCKETS, cfg.num_key_value_heads)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_graphed_decode_step_equals_the_eager_step(graph_models, mode, B, P):
    """Two steps (the second one token on) at (B, P): logits and the pool
    equal the eager step's bit for bit, the second step a replay of the
    graph the first one captured."""
    cfg, params = _graph_cfg(), graph_models[mode]
    kv_e, kv_g = _graph_pool(), None
    kv_g = kv_e.clone()
    graphs = _graphs(cfg, params, kv_g)
    rows = _graph_rows(B, P)
    for step in range(2):
        batch = _graph_batch([(ctx + step, pages) for ctx, pages in rows], B, P, seed=step)
        want = _eager_step(cfg, params, kv_e, batch)
        got = graphs.run(*batch).clone()
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {step}: {(got - want).abs().max().item()}"
        assert _live_pages_equal(kv_g, kv_e)
    assert list(graphs.steps) == [(B, P)] and len(graphs.capture_log) == 1


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_graph_replayed_first_equals_the_eager_step(graph_models, mode):
    """K1's ticket counters are cached device tensors: made first inside a
    capture, their zeroing would run only in that graph (the int8 linear
    kernel keeps none; K6's zero expert ids, emptied too, are made on no
    graphed path now). With the caches emptied, graphs at B 1, 2 and 8 are
    captured, then the first one replays before any other graph and before
    any eager step at its B: it equals the eager step."""
    from pegainfer_tpu_torch.models import qwen3 as q3

    pd._tickets.clear()
    k6.zero_idx.cache_clear()
    q3._inv_freq.cache_clear()
    cfg, params = _graph_cfg(), graph_models[mode]
    kv_e = _graph_pool()
    kv_g = kv_e.clone()
    graphs = _graphs(cfg, params, kv_g)
    for B, P in ((1, 8), (2, 8), (8, 16)):
        graphs.prepare(B, P)
    batch = _graph_batch(_graph_rows(1, 8), 1, 8, seed=7)
    got = graphs.run(*batch).clone()
    want = _eager_step(cfg, params, kv_e, batch)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and _live_pages_equal(kv_g, kv_e)
    batch = _graph_batch(_graph_rows(8, 16), 8, 16, seed=8)
    got = graphs.run(*batch).clone()
    assert torch.equal(got, _eager_step(cfg, params, kv_e, batch))
    assert _live_pages_equal(kv_g, kv_e)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_graph_replays_count_their_launches(graph_models, mode):
    """After n steps of one (B, P) (the capture and n replays) K1 counts n x
    layers launches and the int8 linear kernel n x (4 x layers + 1) in the
    int8 mode (wq / wk / wv in one launch, wo, w_gate_up, w_down a layer and
    the head), 0 in bf16, K6 none: the warm-up's and the capture's own calls
    are not counted."""
    cfg, params = _graph_cfg(), graph_models[mode]
    graphs = _graphs(cfg, params, _graph_pool())
    rows = _graph_rows(2, 8)
    k1, k6_0, il_0 = pd.launches, k6.launches, il.launches
    n = 5
    for step in range(n):
        graphs.run(*_graph_batch([(ctx + step, pages) for ctx, pages in rows], 2, 8, step))
    torch.cuda.synchronize()
    assert pd.launches - k1 == n * GRAPH_LAYERS
    assert il.launches - il_0 == (n * (4 * GRAPH_LAYERS + 1) if mode == "int8" else 0)
    assert k6.launches == k6_0


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_graph_batch_shrinking_inside_its_bucket_leaves_live_pages_alone(graph_models, mode):
    """Four rows at B 4, then three in the same bucket, the third now on the
    pages the fourth left (a request that took them after its release): the
    row left behind is padding, so the pool and the live rows' logits equal
    the eager run's, and the new owner's page holds only its own rows."""
    cfg, params = _graph_cfg(), graph_models[mode]
    kv_e = _graph_pool()
    kv_g = kv_e.clone()
    graphs = _graphs(cfg, params, kv_g)
    rows = _graph_rows(4, 8)
    first = _graph_batch(rows, 4, 8, seed=1)
    second_rows = [(ctx + 1, pages) for ctx, pages in rows[:2]] + [(20, rows[3][1][:2])]
    second = _graph_batch(second_rows, 4, 8, seed=2)
    for batch in (first, second):
        want = _eager_step(cfg, params, kv_e, batch)
        got = graphs.run(*batch).clone()
        torch.cuda.synchronize()
        n = int((batch[3] > 0).sum())
        assert torch.equal(got[:n], want[:n])
        assert _live_pages_equal(kv_g, kv_e)
    assert list(graphs.steps) == [(4, 8)]


# ── the hybrid's and DeepSeek-V4's decode steps under CUDA graphs ────────
# A tiny Qwen3.5 hybrid at hd 256, G 8 (K1 as on the bench_config path; K6
# at one expert in the int8 mode) and a tiny DeepSeek-V4 at widths where
# the chains K8 / K9 take the decode rows (K3 / K4 with the chain off).
# The graphed step must equal the eager step bit for bit; only the dead
# slot (padding rows, the warm-ups) and the null page may differ.

SLOT_GRAPH_SLOTS = 8


def _q35_graph_cfg():
    from pegainfer_tpu_torch.models import qwen35 as q35

    return q35.Qwen35Config(
        hidden_size=256, intermediate_size=512, num_hidden_layers=4, num_attention_heads=16,
        num_key_value_heads=2, head_dim=256, vocab_size=512, rms_norm_eps=1e-6,
        rope_theta=1e6, partial_rotary_factor=0.25,
        layer_types=("linear_attention",) * 3 + ("full_attention",), linear_num_key_heads=2,
        linear_num_value_heads=4, linear_key_head_dim=32, linear_value_head_dim=32,
        linear_conv_kernel_dim=4, tie_word_embeddings=False, eos_token_id=1,
        stop_token_ids=(1,), max_position_embeddings=4096)


@pytest.fixture(scope="module")
def q35_graph_models():
    """{"bf16": params, "int8": params} of ``_q35_graph_cfg`` on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from pegainfer_tpu_torch.models import qwen35 as q35

    gen = torch.Generator(device="cuda").manual_seed(4)
    params = q35.init_random_params_device(_q35_graph_cfg(), gen, "cuda", scale=0.05)
    int8 = q35.quantize_params_int8({**params, "lin": dict(params["lin"]),
                                     "full": dict(params["full"])})
    return {"bf16": params, "int8": int8}


def _q35_graph_state():
    """A pool of 1 + 8 x 16 pages and SLOT_GRAPH_SLOTS + 1 slots, all
    random (requests in flight)."""
    from pegainfer_tpu_torch.models import qwen35 as q35

    state = q35.make_state(_q35_graph_cfg(), 1 + 8 * 16, GRAPH_PS, SLOT_GRAPH_SLOTS,
                           device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for t in state.values():
        t.normal_(0.0, 0.5, generator=gen)
    return state


def _q35_graph_batch(rows, slots, B, P, seed=0):
    """``_graph_batch``'s inputs and each live row's state slot, padding
    rows on the dead slot."""
    batch = _graph_batch(rows, B, P, seed)
    col = np.full(B, SLOT_GRAPH_SLOTS, np.int32)
    col[: len(slots)] = slots
    return (*batch, col)


def _q35_state_equal(a, b):
    """Every live slot's rows and every page past the null page."""
    return (torch.equal(a["kv"][:, :, 1:], b["kv"][:, :, 1:])
            and all(torch.equal(a[k][:, :, :SLOT_GRAPH_SLOTS], b[k][:, :, :SLOT_GRAPH_SLOTS])
                    for k in ("rec", "conv")))


def _q35_eager(cfg, params, state, batch):
    from pegainfer_tpu_torch.models import qwen35 as q35

    with torch.no_grad():
        return q35.decode(cfg, params, state, *[torch.from_numpy(a).cuda() for a in batch])


def _q35_graphs(cfg, params, state):
    from functools import partial

    from pegainfer_tpu_torch.engine.decode_graphs import DecodeGraphs, hybrid
    from pegainfer_tpu_torch.models import qwen35 as q35

    return DecodeGraphs(partial(q35.decode, cfg, params, state), torch.device("cuda"),
                        GRAPH_BUCKETS, cfg.num_key_value_heads, hybrid(SLOT_GRAPH_SLOTS))


def _clone_state(state):
    return {k: v.clone() for k, v in state.items()}


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_hybrid_graphed_decode_step_equals_the_eager_step(q35_graph_models, mode, B, P):
    """Two steps (the second a replay) at (B, P), the rows on slots in
    reverse order: logits, every live slot's rows and the pool past the
    null page equal the eager step's bit for bit; K1 counts a launch a
    step and the int8 linear kernel 4 x 3 + 4 + 1 = 17 in int8 through the
    replay (a layer's projections of the same rows in one launch), K6
    none."""
    cfg, params = _q35_graph_cfg(), q35_graph_models[mode]
    st_e = _q35_graph_state()
    st_g = _clone_state(st_e)
    graphs = _q35_graphs(cfg, params, st_g)
    rows = _graph_rows(B, P)
    slots = list(range(B - 1, -1, -1))
    for step in range(2):
        batch = _q35_graph_batch([(ctx + step, pages) for ctx, pages in rows], slots, B, P,
                                 seed=step)
        want = _q35_eager(cfg, params, st_e, batch)
        k1, k6_0, il_0 = pd.launches, k6.launches, il.launches
        got = graphs.run(*batch).clone()
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {step}: {(got - want).abs().max().item()}"
        assert _q35_state_equal(st_g, st_e)
        if step:  # a replay
            assert pd.launches - k1 == 1
            assert il.launches - il_0 == (17 if mode == "int8" else 0)
            assert k6.launches == k6_0
    assert list(graphs.steps) == [(B, P)] and len(graphs.capture_log) == 1


def _dsv4_graph_cfg():
    from pegainfer_tpu_torch.models import dsv4 as d4

    return d4.DSv4Config(
        vocab_size=512, dim=512, moe_inter_dim=256, n_layers=3, num_attention_heads=4,
        head_dim=64, q_lora_rank=64, qk_rope_head_dim=16, o_groups=2, o_lora_rank=32,
        sliding_window=8, n_routed_experts=8, n_shared_experts=1, n_activated_experts=2,
        n_hash_layers=1, routed_scaling_factor=1.5, swiglu_limit=7.0, rms_norm_eps=1e-6,
        index_n_heads=2, index_head_dim=32, index_topk=4, max_position_embeddings=4096,
        rope_theta=10000.0, compress_rope_theta=10000.0, compress_ratios=(0, 8, 4),
        yarn_original_seq_len=256, yarn_factor=4.0)


@pytest.fixture(scope="module")
def dsv4_graph_models():
    """{"fp4": resident params, "int8": their experts requantized, "bf16":
    every container dequantized (the bf16 mode)} on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from pegainfer_tpu_torch.models import dsv4 as d4

    cfg = _dsv4_graph_cfg()
    fp4 = d4.init_random_resident_device(cfg, torch.Generator(device="cuda").manual_seed(6),
                                         "cuda")
    int8 = {**fp4, "layers": [dict(lw) for lw in fp4["layers"]]}
    d4.requantize_experts_int8(int8)
    bf16 = {**fp4, "layers": [dict(lw) for lw in fp4["layers"]]}
    d4.dequantize_params(bf16, torch.bfloat16)
    return {"fp4": fp4, "int8": int8, "bf16": bf16}


def _dsv4_graph_state(slots=2):
    from pegainfer_tpu_torch.models import dsv4 as d4

    cfg = _dsv4_graph_cfg()
    state = d4.make_state(cfg, slots, 64, dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    for ls in state["layers"]:
        for t in ls.values():
            t.copy_(torch.empty(t.shape, device="cuda").normal_(0.0, 0.3, generator=gen))
    return state


def _dsv4_live_equal(a, b, slots=2):
    return all(torch.equal(x[k][:slots], y[k][:slots])
               for x, y in zip(a["layers"], b["layers"]) for k in x)


def _dsv4_batch(B, slots, step):
    """Live rows at positions 37 + 11 i + step (compressed blocks emitted
    at some), padding rows on the dead slot 2 at position 0."""
    tokens = np.zeros(B, np.int32)
    positions = np.zeros(B, np.int32)
    col = np.full(B, 2, np.int32)
    for i, s in enumerate(slots):
        tokens[i] = 3 + 101 * i + step
        positions[i] = 37 + 11 * i + step
        col[i] = s
    return tokens, positions, col


# (experts, moe_chain, the wrappers' launches a step: {module name: count})
DSV4_GRAPH_CASES = [("fp4", False, {"fp4_gemv": 9, "fp8_gemv": 22}),
                    ("fp4", True, {"fp4_chain": 3, "fp8_gemv": 22}),
                    ("int8", None, {"int8_chain": 3, "fp8_gemv": 22}),
                    ("int8", False, {"int8_gemv": 9, "fp8_gemv": 22}),
                    ("bf16", None, {})]


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("experts,moe_chain,per_step", DSV4_GRAPH_CASES,
                         ids=["fp4-K3", "fp4-K9", "int8-K8", "int8-K6", "bf16-gathers"])
def test_dsv4_graphed_decode_step_equals_the_eager_step(dsv4_graph_models, experts, moe_chain,
                                                        per_step, B):
    """Three steps at B (the later two replays): logits and the live slots'
    rows equal the eager step's bit for bit (the cooperative launches of K8
    and K9 are captured, and the bf16 mode's expert gathers), and each
    replay counts the step's launches (K3 / K6 3 a layer, K8 / K9 one, K4 7
    a layer and idx_wq_b on the ratio-4 layer; none in bf16)."""
    from functools import partial

    from pegainfer_tpu_torch.engine.decode_graphs import DecodeGraphs, dsv4
    from pegainfer_tpu_torch.models import dsv4 as d4
    from pegainfer_tpu_torch.ops.cuda import fp4_chain, fp4_gemv, fp8_gemv, int8_chain, int8_gemv

    mods = {"fp4_gemv": fp4_gemv, "fp8_gemv": fp8_gemv, "int8_gemv": int8_gemv,
            "int8_chain": int8_chain, "fp4_chain": fp4_chain}
    cfg, params = _dsv4_graph_cfg(), dsv4_graph_models[experts]
    st_e = _dsv4_graph_state()
    st_g = _dsv4_graph_state()
    graphs = DecodeGraphs(partial(d4.decode, cfg, params, st_g, moe_chain=moe_chain),
                          torch.device("cuda"), (1, 2), 0, dsv4(2))
    slots = [1, 0][:B]
    for step in range(3):
        batch = _dsv4_batch(B, slots, step)
        with torch.no_grad():
            want = d4.decode(cfg, params, st_e, *[torch.from_numpy(a).cuda() for a in batch],
                             moe_chain=moe_chain)
        before = {n: m.launches for n, m in mods.items()}
        got = graphs.run(*batch).clone()
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {step}: {(got - want).abs().max().item()}"
        assert _dsv4_live_equal(st_g, st_e)
        if step:
            assert {n: m.launches - before[n] for n, m in mods.items()} == {
                n: per_step.get(n, 0) for n in mods}
    assert list(graphs.steps) == [(B, 0)]


@pytest.mark.parametrize("family", ["qwen35", "dsv4"])
def test_graph_replayed_on_another_slot_set(q35_graph_models, dsv4_graph_models, family):
    """One B = 2 graph replayed first with its rows on one pair of slots,
    then on another pair (and a row moved to a slot the first pair held):
    each step equals the eager step and the live slots stay equal."""
    if family == "qwen35":
        cfg, params = _q35_graph_cfg(), q35_graph_models["int8"]
        st_e = _q35_graph_state()
        st_g = _clone_state(st_e)
        graphs = _q35_graphs(cfg, params, st_g)
        rows = _graph_rows(2, 8)
        for step, slots in enumerate(([0, 3], [5, 0], [3, 7])):
            batch = _q35_graph_batch([(ctx + step, pages) for ctx, pages in rows], slots, 2,
                                     8, seed=step)
            want = _q35_eager(cfg, params, st_e, batch)
            got = graphs.run(*batch).clone()
            torch.cuda.synchronize()
            assert torch.equal(got, want) and _q35_state_equal(st_g, st_e), slots
        return
    from functools import partial

    from pegainfer_tpu_torch.engine.decode_graphs import DecodeGraphs, dsv4
    from pegainfer_tpu_torch.models import dsv4 as d4

    cfg, params = _dsv4_graph_cfg(), dsv4_graph_models["fp4"]
    st_e, st_g = _dsv4_graph_state(4), _dsv4_graph_state(4)
    graphs = DecodeGraphs(partial(d4.decode, cfg, params, st_g), torch.device("cuda"),
                          (1, 2), 0, dsv4(4))
    for step, slots in enumerate(([0, 1], [2, 3], [3, 0])):
        tokens, positions, _ = _dsv4_batch(2, slots, step)
        batch = (tokens, positions, np.array(slots, np.int32))
        with torch.no_grad():
            want = d4.decode(cfg, params, st_e, *[torch.from_numpy(a).cuda() for a in batch])
        got = graphs.run(*batch).clone()
        torch.cuda.synchronize()
        assert torch.equal(got, want) and _dsv4_live_equal(st_g, st_e, 4), slots


def test_dsv4_resume_through_the_graph_equals_the_eager_resume(dsv4_graph_models):
    """A SlotExecutor prefills P, then resumes P + 5 from its snapshot
    through the B = 1 graph (five replays): the first token and the slot's
    rows equal the eager executor's (``dsv4.prefill_resume``); the cached
    logits of P + 5 are a copy that later replays leave alone."""
    from pegainfer_tpu_torch.engine import contract
    from pegainfer_tpu_torch.engine.executor import (DecodePlan, DecodeStepItem, PrefillPlan,
                                                      PrefillStepItem)
    from pegainfer_tpu_torch.engine.slot_executor import SlotExecutor
    from pegainfer_tpu_torch.models import dsv4 as d4

    cfg, params = _dsv4_graph_cfg(), dsv4_graph_models["fp4"]
    rng = np.random.default_rng(9)
    P = rng.integers(8, 512, 40).tolist()
    ext = P + rng.integers(8, 512, 5).tolist()
    sp = contract.SamplingParams()
    runs = {}
    for graphs in (True, False):
        state = d4.make_state(cfg, 2, 64, dtype=torch.bfloat16, device="cuda")
        ex = SlotExecutor(cfg, params, state, 2, 256,
                          contract.EngineLoadOptions(enable_cuda_graph=graphs))
        with torch.no_grad():
            ex.execute_prefill(PrefillPlan([PrefillStepItem(0, P, sp)]))
            ex.release_request(0)
            first = ex.execute_prefill(PrefillPlan([PrefillStepItem(1, ext, sp)]))
            tok = first.requests[0].first_token
            kept = ex.slot_prefix_cache.match(ext)[2].clone()
            rows = ex.slot_export(ex._slot(1))
            for _ in range(3):
                tok = ex.execute_decode(DecodePlan([DecodeStepItem(1, tok, sp)])).requests[0].token
        torch.cuda.synchronize()
        assert ex.resume_steps == 5
        assert torch.equal(ex.slot_prefix_cache.match(ext)[2], kept)
        runs[graphs] = (first.requests[0].first_token, rows, kept, ex.graph_captures)
    (tg, rows_g, lg, cap), (te, rows_e, le, _) = runs[True], runs[False]
    assert cap == 1 and tg == te and torch.equal(lg, le)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(rows_g["layers"], rows_e["layers"])
               for k in a)


# ── tensor parallelism's collectives on the card ─────────────────────────


def test_tp_collectives_on_the_card(dev, tmp_path):
    """``parallel/group.py``'s model collectives on CUDA tensors: two gloo
    ranks on the one card (threads; the smoke's [29] runs processes) reduce
    f32 partial sums to the same bits on both, a + b, and gather vocab
    shards in rank order; a one-rank NCCL group (the backend of a card a
    rank, whose call sites are the same) hands its input back."""
    import threading

    from pegainfer_tpu_torch.parallel import group

    gen = _gen(dev, 300)
    parts = [torch.randn((8, 2560), generator=gen, device=dev) for _ in range(2)]
    shards = [torch.randn((8, 64), generator=gen, device=dev) for _ in range(2)]
    out = [None, None]

    def rank(r):
        g = group.RankGroups(r, 2, str(tmp_path / "gloo"), "gloo", 60)
        out[r] = (g.all_reduce_sum(parts[r].clone()), g.gather_vocab(shards[r]))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert all(o is not None for o in out), "a rank failed"
    for summed, gathered in out:
        assert torch.equal(summed, parts[0] + parts[1])
        assert torch.equal(gathered, torch.cat(shards, dim=-1))
    one = group.RankGroups(0, 1, str(tmp_path / "nccl"), "nccl", 60)
    assert torch.equal(one.all_reduce_sum(parts[0].clone()), parts[0])
    assert torch.equal(one.gather_vocab(shards[0]), shards[0])
