"""The int8 expert-stream kernels (``csrc/expert_stream.cu``: expert_gemv in
its convert and native forms, expert_gemv_in_flight) and the fp4 decode
variants (``csrc/fp4_study.cu``: fp4_variant_gemv) against their plain
PyTorch versions, on the card. Marked ``cuda``: run with
``python -m pytest --noconftest -m cuda tests/test_torch_expert_studies_cuda.py``
on a machine with an NVIDIA Hopper card; elsewhere each test skips.

Each routed row is held to its own limit: the native form bit for bit (an
exact integer sum, rounded once), the convert forms and every fp4 variant
to 1e-5 of the row's max |y| (exact products, another f32 sum order). The
cases are those of ``chip_smoke.py``'s phases [2c] / [2d] (repeated experts,
M 1, an OUT no multiple of any tile, sums near 2^24) at fewer experts, plus
an expert id outside [0, E) (a row of 0), a D no multiple of 128, the
largest M the in-flight form takes, bits and arith weight for weight, the
scale loads of floor and bits_noscale in the SASS, and the wrappers'
refusals.
"""

import pytest
import torch

from pegainfer_tpu_torch.ops.cuda import expert_stream as es
from pegainfer_tpu_torch.ops.cuda import fp4_study as fs
from pegainfer_tpu_torch.studies import fp4_kernel_study as s4
from pegainfer_tpu_torch.studies.expert_stream_study import row_check

pytestmark = pytest.mark.cuda

RTOL = 1e-5
# (label, E, OUT, D, M, repeated experts); D 4112 is no multiple of 128
S3_CASES = [("M 12 repeated", 16, 2048, 4096, 12, True), ("M 1", 16, 2048, 4096, 1, False),
            ("OUT 2018", 4, 2018, 4096, 12, True), ("D 4112", 4, 200, 4112, 6, False)]
FP4_CASES = [("M 12 repeated", 16, 2048, 4096, 12, True), ("M 1", 16, 2048, 4096, 1, False),
             ("OUT 2018", 4, 2018, 4096, 12, True), ("IN 1024, g 64", 4, 300, 1024, 7, False)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _idx(gen, E, M, repeated, dev):
    idx = torch.randint(0, E, (M,), generator=gen, device=dev).int()
    if repeated:
        idx[5], idx[11] = idx[2], idx[0]
    return idx


def _s3(dev, case, one_sign=False):
    _, E, OUT, D, M, rep = case
    gen = torch.Generator(device=dev).manual_seed(OUT + D + M)
    q = torch.randint(-127, 128, (E, OUT, D), generator=gen, dtype=torch.int8, device=dev)
    x = torch.randint(-127, 128, (M, D), generator=gen, dtype=torch.int8, device=dev)
    if one_sign:
        q, x = q.abs(), x.abs()
    return q, x, _idx(gen, E, M, rep, dev)


def _ok(row):
    name, err, lim = row
    assert err <= lim, row


@pytest.mark.parametrize("rows", es.ROWS)
@pytest.mark.parametrize("native", [False, True], ids=["convert", "native"])
@pytest.mark.parametrize("case", S3_CASES, ids=[c[0] for c in S3_CASES])
def test_expert_gemv(dev, case, native, rows):
    q, x, idx = _s3(dev, case)
    xk = x if native else x.to(torch.bfloat16)
    got = es.expert_gemv(xk, q, idx, native, rows)
    _ok(row_check(case[0], got, es.expert_gemv_plain(xk, q, idx, native), 0.0 if native else RTOL))


@pytest.mark.parametrize("rows", es.ROWS)
def test_expert_gemv_native_rounds_sums_above_2_24_once(dev, rows):
    q, x, idx = _s3(dev, ("one sign", 4, 256, 4096, 12, True), one_sign=True)
    ref = es.expert_gemv_plain(x, q, idx, native=True)
    assert ref.abs().max().item() > 2 ** 24
    assert torch.equal(es.expert_gemv(x, q, idx, True, rows), ref)


@pytest.mark.parametrize("case", S3_CASES + [("M 50, T 1", 4, 256, 4096, 50, False)],
                         ids=[c[0] for c in S3_CASES] + ["M 50, T 1"])
def test_expert_gemv_in_flight(dev, case):
    q, x, idx = _s3(dev, case)
    xb = x.to(torch.bfloat16)
    if case[3] % 128:  # T 8 / 4 / 2 / 1 need D a multiple of 16 x 8/T
        assert es.in_flight_tile(case[4], case[3]) in (8, 4, 2)
    _ok(row_check(case[0], es.expert_gemv_in_flight(xb, q, idx),
                  es.expert_gemv_in_flight_plain(xb, q, idx), RTOL))


@pytest.mark.parametrize("tile", [1, 2, 4])
def test_expert_gemv_in_flight_tiles(dev, tile):
    q, x, idx = _s3(dev, S3_CASES[2])  # OUT 2018: T 4 leaves a short last tile
    xb = x.to(torch.bfloat16)
    _ok(row_check(f"T {tile}", es.expert_gemv_in_flight(xb, q, idx, tile),
                  es.expert_gemv_in_flight_plain(xb, q, idx), RTOL))


def test_the_copies_only_probe_waits_and_writes_zeros(dev):
    q, x, idx = _s3(dev, S3_CASES[0])
    xb = x.to(torch.bfloat16)
    y = es.expert_gemv_in_flight(xb, q, idx, copies_only=True)
    torch.cuda.synchronize()
    assert y.shape == (12, 2048) and y.eq(0).all()
    _ok(row_check("after the probe", es.expert_gemv_in_flight(xb, q, idx),
                  es.expert_gemv_in_flight_plain(xb, q, idx), RTOL))


def test_rows_of_no_expert_are_zero(dev):
    q, x, idx = _s3(dev, S3_CASES[0])
    idx[3], idx[7] = -1, 16
    xb = x.to(torch.bfloat16)
    for y in (es.expert_gemv(xb, q, idx), es.expert_gemv(x, q, idx, True),
              es.expert_gemv_in_flight(xb, q, idx)):
        assert y[3].eq(0).all() and y[7].eq(0).all() and y[0].abs().max() > 0
    qq = torch.randint(0, 256, (16, 2048, 2048), dtype=torch.uint8, device=dev)
    s = torch.ones((16, 2048, 128), dtype=torch.bfloat16, device=dev)
    for v in fs.VARIANTS:
        y = fs.fp4_variant_gemv(xb, qq, s, idx, v)
        assert y[3].eq(0).all() and y[7].eq(0).all() and y[0].abs().max() > 0


def _fp4(dev, case, pow2):
    _, E, OUT, IN, M, rep = case
    gen = torch.Generator(device=dev).manual_seed(OUT + IN + M)
    q = torch.randint(0, 256, (E, OUT, IN // 2), generator=gen, dtype=torch.uint8, device=dev)
    g = 64 if IN == 1024 else 32
    s = s4.random_scales(gen, (E, OUT, IN // g), dev, pow2=pow2)
    x = torch.randn((M, IN), generator=gen, device=dev)
    return q, s, x, _idx(gen, E, M, rep, dev)


@pytest.mark.parametrize("rows", fs.ROWS)
@pytest.mark.parametrize("variant", fs.VARIANTS)
@pytest.mark.parametrize("case", FP4_CASES, ids=[c[0] for c in FP4_CASES])
def test_fp4_variant_gemv(dev, case, variant, rows):
    q, s, x, idx = _fp4(dev, case, pow2=case[0] != "OUT 2018")
    got = fs.fp4_variant_gemv(x, q, s, idx, variant, rows)
    _ok(row_check(f"{variant} {case[0]}", got, fs.fp4_variant_gemv_plain(x, q, s, idx, variant),
                  RTOL))


@pytest.mark.parametrize("rows", fs.ROWS)
def test_bits_and_arith_give_the_same_weights(dev, rows):
    """x = the rows of the identity: y[k, o] is weight (o, k). Over every
    code and scales of random mantissas and signs, bits and arith read back
    equal bit for bit, and each equals its plain weights."""
    gen = torch.Generator(device=dev).manual_seed(rows)
    E, OUT, IN = 2, 64, 4096
    q = torch.randint(0, 256, (E, OUT, IN // 2), generator=gen, dtype=torch.uint8, device=dev)
    s = s4.random_scales(gen, (E, OUT, IN // 32), dev, pow2=False)
    x = torch.eye(IN, device=dev)
    for e in range(E):
        idx = torch.full((IN,), e, dtype=torch.int32, device=dev)
        got = {v: fs.fp4_variant_gemv(x, q, s, idx, v, rows) for v in ("bits", "arith")}
        assert torch.equal(got["bits"], got["arith"])
        assert torch.equal(got["bits"], fs.variant_weights(q, s, idx[:1], "bits")[0].T)


def test_check_functions_pass(dev):
    """The smoke's phase checks at fewer experts."""
    from pegainfer_tpu_torch.studies import expert_stream_study as s3

    q = torch.randint(-127, 128, (8, 2048, 4096), dtype=torch.int8, device=dev)
    rows = s3.check(q=q, seed=1)
    q4 = torch.randint(0, 256, (8, 2048, 2048), dtype=torch.uint8, device=dev)
    s = torch.exp2(torch.randint(-8, 0, (8, 2048, 128), device=dev).float()).to(torch.bfloat16)
    rows += s4.check(q=q4, s=s, seed=1)
    bad = [r for r in rows if not r[1] <= r[2]]
    assert not bad, bad


def test_scale_loads_remain_in_the_sass(dev):
    fs.fp4_variant_gemv(torch.zeros((1, 64), device=dev),
                        torch.zeros((1, 32, 32), dtype=torch.uint8, device=dev),
                        torch.ones((1, 32, 2), dtype=torch.bfloat16, device=dev),
                        torch.zeros(1, dtype=torch.int32, device=dev), "floor")  # builds
    counts = s4.scale_loads()
    assert s4.scale_loads_kept(counts), counts
    assert all(n > 0 for n in counts.values()), counts


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros((2, 64, 256), dtype=torch.int8, device=dev)
    x = torch.zeros((3, 256), dtype=torch.bfloat16, device=dev)
    idx = torch.zeros(3, dtype=torch.int32, device=dev)
    bad = [lambda: es.expert_gemv(x, q, idx, rows=48),
           lambda: es.expert_gemv(x, q, idx, native=True),  # bf16 x
           lambda: es.expert_gemv(x[:, :250].contiguous(), q[:, :, :250].contiguous(), idx),
           lambda: es.expert_gemv(x, q.float(), idx),
           lambda: es.expert_gemv(x, q, idx.long()),
           lambda: es.expert_gemv_in_flight(torch.zeros((60, 4096), device=dev),
                                            torch.zeros((2, 8, 4096), dtype=torch.int8,
                                                        device=dev),
                                            torch.zeros(60, dtype=torch.int32, device=dev))]
    q4 = torch.zeros((2, 64, 128), dtype=torch.uint8, device=dev)
    s = torch.ones((2, 64, 8), dtype=torch.bfloat16, device=dev)
    bad += [lambda: fs.fp4_variant_gemv(x, q4, s, idx, "lut"),
            lambda: fs.fp4_variant_gemv(x, q4, s, idx, "bits", rows=8),
            lambda: fs.fp4_variant_gemv(x, q4, s.float(), idx, "bits"),
            lambda: fs.fp4_variant_gemv(x, q4, torch.ones((2, 64, 16), dtype=torch.bfloat16,
                                                          device=dev), idx, "bits")]
    for call in bad:
        with pytest.raises(ValueError):
            call()


def test_in_flight_holds_its_tile_and_bytes(dev):
    """T 4 at M 12, D 4096: 196,608 B of codes a block, one block an SM."""
    assert es.in_flight_tile(12, 4096) == 4
    assert es.blocks_per_sm("in_flight", 4, 12, 4096) == 1
    assert es.blocks_per_sm("in_flight", 1, 12, 4096) >= 2
    assert es.blocks_per_sm("native", 32, 12, 4096) >= 1
    assert es.blocks_per_sm("convert", 64, 12, 4096) >= 1
