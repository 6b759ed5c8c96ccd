"""The bf16 weight-stream kernels (``csrc/gemv_stream.cu``: stream_sum in its
bulk and ldg forms, gemv, layer_gemv; ``csrc/gemv_chain.cu``: gemv_chain)
against their plain PyTorch versions, on the card. Marked ``cuda``: run with
``python -m pytest --noconftest -m cuda tests/test_torch_gemv_studies_cuda.py``
on a machine with an NVIDIA Hopper card; elsewhere each test skips.

Sums and GEMVs of bf16 weights form exact f32 products summed in another
order than the plain versions: stream_sum to ``gemv_stream_study.sum_limit``
(1e-5 of sqrt(N K) max |W|, well below one dropped row), gemv, layer_gemv
and a chain's one layer to 1e-5 of max |y|. Past one layer a chain is held by
``gemv_chain_study.check``: every layer against the plain layer on the
kernel's own rounded x, whole chains within twice the f32 plain chains'
drift from f64. Shapes cover short last chunks (N not a multiple of a
stage's rows), K not a multiple of 256, one-row stages and rings of 1 to 8
stages.
"""

import numpy as np
import pytest
import torch

from pegainfer_tpu_torch.ops.cuda import gemv_chain as gc
from pegainfer_tpu_torch.ops.cuda import gemv_stream as gs
from pegainfer_tpu_torch.studies import gemv_chain_study as chain_study
from pegainfer_tpu_torch.studies.gemv_stream_study import sum_limit

pytestmark = pytest.mark.cuda

RTOL = 1e-5
RINGS = [gs.RING, gs.Ring(40960, 2, 2), gs.Ring(20480, 8, 1), gs.Ring(1, 1, 1),
         gs.Ring(81920, 2, 1)]
SHAPES = [(19456, 2560), (19461, 2560), (1000, 264), (5, 2560), (4099, 1024)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
        dev, torch.bfloat16)


@pytest.mark.parametrize("N,K", SHAPES)
@pytest.mark.parametrize("ring", RINGS, ids=str)
def test_stream_sum_bulk_and_gemv(dev, N, K, ring):
    rng = np.random.default_rng(N + K)
    W, x = _bf16(rng, (N, K), dev, 0.05), _bf16(rng, (1, K), dev, 0.05)
    s = torch.full((1, 1), 0.375, device=dev)
    got = gs.stream_sum(W, s, "bulk", ring)
    ref = gs.stream_sum_plain(W, s)
    assert (got - ref).abs().item() <= sum_limit(W)
    y, yr = gs.gemv(x, W, s, ring), gs.gemv_plain(x, W, s)
    assert y.shape == (1, N) and (y - yr).abs().max().item() <= RTOL * yr.abs().max().item()


@pytest.mark.parametrize("N,K", SHAPES)
@pytest.mark.parametrize("ldg", [gs.LDG, gs.Ldg(1, 1), gs.Ldg(2, 8), gs.Ldg(8, 2)], ids=str)
def test_stream_sum_ldg(dev, N, K, ldg):
    rng = np.random.default_rng(N * K)
    W = _bf16(rng, (N, K), dev, 0.05)
    s = torch.full((1, 1), -2.5, device=dev)
    got = gs.stream_sum(W, s, "ldg", ldg)
    ref = gs.stream_sum_plain(W, s)
    assert (got - ref).abs().item() <= sum_limit(W)


def test_sums_are_the_same_bits_every_run(dev):
    """No float atomics: the partials are added in a fixed order."""
    W = _bf16(np.random.default_rng(0), (19461, 2560), dev, 0.05)
    s = torch.zeros((1, 1), device=dev)
    for mode in ("bulk", "ldg"):
        runs = {gs.stream_sum(W, s, mode).item() for _ in range(5)}
        assert len(runs) == 1, (mode, runs)


@pytest.mark.parametrize("ring", [gs.RING, gs.Ring(20480, 8, 2)], ids=str)
def test_layer_gemv_reads_each_layer_in_place(dev, ring):
    rng = np.random.default_rng(1)
    stack, x = _bf16(rng, (3, 4099, 1024), dev, 1 / 32), _bf16(rng, (1, 1024), dev)
    for l in range(3):
        y, yr = gs.layer_gemv(x, stack, l, ring), gs.layer_gemv_plain(x, stack, l)
        assert (y - yr).abs().max().item() <= RTOL * yr.abs().max().item()


@pytest.mark.parametrize("L,N,K", [(1, 2560, 2560), (4, 19456, 2560), (5, 4099, 1024),
                                   (3, 264, 264)])
@pytest.mark.parametrize("ring", [gc.RING, gs.Stages(20480, 2), gs.Stages(1, 8)], ids=str)
def test_gemv_chain_checks(dev, L, N, K, ring):
    rng = np.random.default_rng(L * N + K)
    stack, x = _bf16(rng, (L, N, K), dev, K ** -0.5), _bf16(rng, (1, K), dev)
    for name, err, lim in chain_study.check(x, stack, ring):
        assert err <= lim, (name, err, lim)


def test_gemv_chain_is_layer_gemv_bit_for_bit(dev):
    """Each row is summed in the same order by both kernels, so the chain
    equals layer_gemv launches with the bf16 cast between them."""
    rng = np.random.default_rng(7)
    stack, x = _bf16(rng, (6, 19456, 2560), dev, 2560 ** -0.5), _bf16(rng, (1, 2560), dev)
    xl = x
    for l in range(6):
        y = gs.layer_gemv(xl, stack, l)
        xl = y[:, :2560].to(torch.bfloat16)
    assert torch.equal(gc.gemv_chain(x, stack), y)


def test_layer_gemv_in_a_cuda_graph(dev):
    rng = np.random.default_rng(3)
    stack, x = _bf16(rng, (4, 4096, 1024), dev, 1 / 32), _bf16(rng, (1, 1024), dev)

    def chain():
        xl = x
        for l in range(4):
            y = gs.layer_gemv(xl, stack, l)
            xl = y[:, :1024].to(torch.bfloat16)
        return y

    want = chain()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = chain()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    W = torch.zeros((64, 260), dtype=torch.bfloat16, device=dev)
    s = torch.zeros((1, 1), device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        gs.stream_sum(W, s)
    W = torch.zeros((64, 256), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        gs.gemv(torch.zeros((1, 256), dtype=torch.bfloat16, device=dev), W, s,
                gs.Ring(200_000, 4, 1))
    with pytest.raises(ValueError, match="16-byte aligned"):
        gs.stream_sum(
            torch.zeros(64 * 256 + 1, dtype=torch.bfloat16, device=dev)[1:].view(64, 256), s)
    with pytest.raises(ValueError, match="neither"):
        gs.stream_sum(W, s, "tma")
    with pytest.raises(ValueError, match="N >= K"):
        gc.gemv_chain(torch.zeros((1, 256), dtype=torch.bfloat16, device=dev),
                      torch.zeros((2, 128, 256), dtype=torch.bfloat16, device=dev))
    with pytest.raises(ValueError, match="outside"):
        gs.layer_gemv(torch.zeros((1, 256), dtype=torch.bfloat16, device=dev),
                      torch.zeros((2, 64, 256), dtype=torch.bfloat16, device=dev), 2)
