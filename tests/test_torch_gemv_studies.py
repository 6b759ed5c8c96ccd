"""The bf16 weight-stream kernels of the port (``ops/cuda/gemv_stream.py``,
``ops/cuda/gemv_chain.py``) and their H100 studies, on the CPU.

- The TPU study kernels, run as the JAX package's own tests run Pallas on
  the CPU (``interpret=True``), against the port's CPU wrappers (the plain
  versions) on the same bf16 bits, at the TPU scripts' ``--interpret``
  sizes, chunks of 128 rows and rings of 2 and 4: ``make_stream_sum`` to
  ``sum_limit`` (1e-5 of sqrt(N K) max |W|), ``make_gemv``,
  ``make_layer_gemv`` (every layer) and ``make_mega`` (the whole chain) to
  1e-5 of max |y|.
- The studies' ``--cpu`` mode and checks, called in-process; the checks
  against sums that drop a short last chunk or one block's partial.
- A walk of the kernels' work split, with constants and loop heads read
  from the ``.cu`` sources and ``common.cuh``: over the card's grid sizes
  (132 SMs x 1-4 blocks) and ragged N, the producer and the consumers of a
  block walk the same (layer, chunk) items, every row of every layer is
  copied once with the bytes its barrier expects, and every y element is
  written once.
"""

import importlib.util
import json
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pegainfer_tpu_torch.ops.cuda import gemv_chain as gc
from pegainfer_tpu_torch.ops.cuda import gemv_stream as gs
from pegainfer_tpu_torch.studies import chain_mutant_check as mutants
from pegainfer_tpu_torch.studies import gemv_chain_study as chain_study
from pegainfer_tpu_torch.studies import gemv_stream_study as stream_study
from pegainfer_tpu_torch.studies.gemv_stream_study import bf16

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "pegainfer_tpu_torch" / "csrc"
RTOL = 1e-5
CK, NBUFS = 128, (2, 4)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tpu_stream():
    return _script("gemv_stream_study")


@pytest.fixture(scope="module")
def tpu_chain():
    return _script("gemv_chain_study")


def _jax(t):
    """A torch tensor as a JAX array of the same bits."""
    if t.dtype == torch.bfloat16:
        return jax.lax.bitcast_convert_type(jnp.asarray(t.view(torch.int16).numpy()),
                                            jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_inputs_have_the_tpu_scripts_bits():
    """The studies' bf16 helper rounds as ``jnp.asarray(a, jnp.bfloat16)``."""
    a = np.random.default_rng(0).standard_normal((64, 256)) * 0.05
    a[0, :4] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 3e-39]  # ties, a subnormal
    want = np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.int16)
    assert np.array_equal(bf16(a).view(torch.int16).numpy(), want)


@pytest.mark.parametrize("nbuf", NBUFS)
def test_stream_sum_matches_the_pallas_kernel(tpu_stream, nbuf):
    W, _, s = stream_study.inputs(1024, 256, "cpu")
    s = torch.full((1, 1), 0.625)
    want = tpu_stream.make_stream_sum(1024, 256, CK, nbuf, interpret=True)(_jax(W), _jax(s))
    got = gs.stream_sum(W, s)
    assert got.shape == (1, 1)
    assert _max_abs(got, want) <= stream_study.sum_limit(W)


@pytest.mark.parametrize("nbuf", NBUFS)
def test_gemv_matches_the_pallas_kernel(tpu_stream, nbuf):
    W, x, _ = stream_study.inputs(1024, 256, "cpu")
    s = torch.full((1, 1), -0.25)
    want = np.asarray(tpu_stream.make_gemv(1024, 256, CK, nbuf, interpret=True)(
        _jax(x), _jax(W), _jax(s)))
    got = gs.gemv(x, W, s)
    assert got.shape == (1, 1024)
    assert _max_abs(got, want) <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("nbuf", NBUFS)
@pytest.mark.parametrize("l", range(3))
def test_layer_gemv_matches_the_pallas_kernel(tpu_chain, nbuf, l):
    x, stack = chain_study.inputs(3, 512, 256, "cpu")
    want = np.asarray(tpu_chain.make_layer_gemv(3, 512, 256, CK, nbuf, interpret=True)(
        jnp.asarray([l], jnp.int32), _jax(x), _jax(stack)))
    got = gs.layer_gemv(x, stack, l)
    assert _max_abs(got, want) <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("nbuf", NBUFS)
def test_gemv_chain_matches_the_pallas_kernel(tpu_chain, nbuf):
    x, stack = chain_study.inputs(3, 512, 256, "cpu")
    want = np.asarray(tpu_chain.make_mega(3, 512, 256, CK, nbuf, interpret=True)(
        _jax(x), _jax(stack)))
    got = gc.gemv_chain(x, stack)
    assert got.shape == (1, 512)
    assert _max_abs(got, want) <= RTOL * np.abs(want).max()


def test_chain_check_on_the_cpu_passes_the_plain_chain():
    x, stack = chain_study.inputs(3, 512, 256, "cpu")
    rows = chain_study.check(x, stack)
    names = ["L 1", "layer 1, the kernel's x", "layer 2, the kernel's x", "L 2 whole",
             "L 3 whole"]
    assert [r[0] for r in rows] == names + ["square " + n for n in names]
    assert all(err <= lim for _, err, lim in rows)


def test_chain_check_fails_a_chain_that_rounds_x_by_truncation(monkeypatch):
    """A chain whose restage truncates x to bf16 instead of rounding it to
    nearest fails the per-layer checks."""
    x, stack = chain_study.inputs(3, 512, 256, "cpu")

    def truncating(x, stack, ring=None):
        K = stack.shape[2]
        for l in range(stack.shape[0]):
            y = gs.layer_gemv_plain(x, stack, l)
            x = (y[:, :K].view(torch.int32) & ~0xFFFF).view(torch.float32).to(torch.bfloat16)
        return y

    monkeypatch.setattr(gc, "gemv_chain", truncating)
    rows = chain_study.check(x, stack)
    assert not all(err <= lim for name, err, lim in rows if name.startswith("layer"))


# the stream checks at a small size: the default ring's 77 rows a stage at K
# 264, so N 1006 ends in a chunk of 5 rows
SMALL_CHECK = dict(device="cpu", shapes=((1006, 264), (1000, 264)), stack_shape=(2, 517, 264))


def test_stream_check_on_the_cpu_passes_the_plain_versions():
    rows = stream_study.check(**SMALL_CHECK)
    assert [r[0].split()[0] for r in rows] == ["stream_sum_bulk", "stream_sum_ldg", "gemv"] * 2 \
        + ["layer_gemv"] * 2
    assert all(r[0].split()[0] in gs.launches for r in rows)
    assert all(err <= lim for _, err, lim in rows)


def _dropping(kept_rows):
    """A stream_sum that leaves out rows of W (as a kernel that skipped a
    chunk or a block's partial would)."""
    def stream_sum(W, s, mode="bulk", cfg=None):
        keep = torch.ones(W.shape[0], dtype=torch.bool)
        keep[~kept_rows(W.shape[0], gs.RING.rows(W.shape[1]))] = False
        return gs.stream_sum_plain(W[keep], s)
    return stream_sum


def _all_but_last_chunk(N, rows):
    return torch.arange(N) < (N - 1) // rows * rows


def _all_but_block0(N, rows):
    chunks = -(-N // rows)
    blocks = min(chunks, gs.RING.blocks_per_sm * 132)
    return (torch.arange(N) // rows) % blocks != 0


@pytest.mark.parametrize("kept", [_all_but_last_chunk, _all_but_block0],
                         ids=["short-last-chunk", "block-partial"])
def test_stream_check_fails_a_sum_that_drops_rows(monkeypatch, kept):
    """The sum's limit sees a dropped short last chunk (5 rows) and a
    dropped block partial."""
    monkeypatch.setattr(gs, "stream_sum", _dropping(kept))
    rows = stream_study.check(**SMALL_CHECK)
    assert [n for n, err, lim in rows if not err <= lim] == [
        "stream_sum_bulk [1006, 264]", "stream_sum_ldg [1006, 264]",
        "stream_sum_bulk [1000, 264]", "stream_sum_ldg [1000, 264]"]


@pytest.mark.parametrize("study", [stream_study, chain_study], ids=["stream", "chain"])
def test_study_cpu_mode(study, capsys):
    assert study.main(["--cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["cpu"]
    if study is stream_study:
        r = out[0]
        assert (r["N"], r["K"]) == (1024, 256) and r["gemv_relerr"] < RTOL
    else:
        assert (out["L"], out["N"], out["K"]) == (3, 512, 256)
        assert all(err <= lim for _, err, lim in out["checks"])


def test_wrappers_raise_for_a_device_without_a_kernel():
    W = torch.zeros((64, 256), dtype=torch.bfloat16, device="meta")
    x = torch.zeros((1, 256), dtype=torch.bfloat16, device="meta")
    s = torch.zeros((1, 1), device="meta")
    for call in (lambda: gs.stream_sum(W, s), lambda: gs.gemv(x, W, s),
                 lambda: gs.layer_gemv(x, W[None], 0), lambda: gc.gemv_chain(x, W[None])):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()


# ── the kernels' work split, read from the sources ──────────────────────


def _source(name):
    return (CSRC / f"{name}.cu").read_text()


def _common():
    return (CSRC / "common.cuh").read_text()


def _const(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


CHUNK_LOOP = "for (int c = blockIdx.x; c < nchunks; c += gridDim.x, ++j)"
ROW_LOOP = "for (int rr = warp; rr < r; rr += kConsumerWarps)"
BYTES = "static_cast<uint32_t>(min(rows, N - c * rows)) * K * 2"
PRODUCE = ("ring.produce(j, w + static_cast<size_t>(c) * rows * K, "
           "wring::chunk_bytes(c, rows, N, K));")


@pytest.mark.parametrize("name", ["gemv_stream", "gemv_chain"])
def test_sources_walk_chunks_as_the_walk_does(name):
    """The loop heads the walk below emulates: the producer's and the
    consumers' chunk loops, a chunk's bytes (the ring's, in common.cuh), a
    warp a row (common.cuh's rows_gemv)."""
    text, common = _source(name), _common()
    assert text.count(CHUNK_LOOP) == 2  # the producer's and the consumers'
    assert text.count(PRODUCE) == 1 and text.count("ring.acquire(j)") == 1
    assert text.count("ring.release(j, lane)") == 1 and text.count("wring::rows_gemv(") == 1
    assert common.count(ROW_LOOP) == 1 and common.count(BYTES) == 1
    assert _const(common, "kConsumerWarps") == 8
    if name == "gemv_chain":
        assert "const int blocks = nchunks < sms * per_sm ? nchunks : sms * per_sm;" in text
        assert "float* yl = l == L - 1 ? y : ybuf + static_cast<size_t>(l & 1) * N;" in text


def _walk(L, N, K, rows, G, warps):
    """Every block's producer and consumer item sequences over the flat
    (layer, chunk) loop, and what each reads and writes."""
    nchunks = -(-N // rows)
    copied, written = {}, {}
    for b in range(G):
        produced = [(l, c) for l in range(L) for c in range(b, nchunks, G)]
        consumed = []
        for l in range(L):
            buf = "y" if l == L - 1 else f"ybuf{l & 1}"
            for c in range(b, nchunks, G):
                consumed.append((l, c))
                r = min(rows, N - c * rows)
                nbytes = r * K * 2
                assert nbytes % 16 == 0 and 0 < nbytes < 2 ** 20  # bulk copy, tx count
                for row in range(c * rows, c * rows + r):
                    copied[(l, row)] = copied.get((l, row), 0) + 1
                for warp in range(warps):
                    for rr in range(warp, r, warps):
                        key = (l, buf, c * rows + rr)
                        written[key] = written.get(key, 0) + 1
        assert produced == consumed
    return copied, written


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3, 4])
@pytest.mark.parametrize("N,K,ring", [(19456, 2560, gc.RING), (19461, 2560, gs.Stages(20480, 8)),
                                      (1000, 264, gc.RING), (19456, 2560, gs.Stages(1, 4))])
def test_every_row_read_once_and_every_y_written_once(blocks_per_sm, N, K, ring):
    warps = _const(_common(), "kConsumerWarps")
    rows = ring.rows(K)
    L = 3
    G = min(-(-N // rows), 132 * blocks_per_sm)  # the wrapper's / the chain's grid
    copied, written = _walk(L, N, K, rows, G, warps)
    assert copied == {(l, r): 1 for l in range(L) for r in range(N)}
    bufs = ["ybuf0", "ybuf1", "y"]
    assert set(written.values()) == {1}
    assert {(l, n) for l, _, n in written} == {(l, n) for l in range(L) for n in range(N)}
    # layer l + 1 never writes the buffer that layer l wrote (x_{l+1} is read from it)
    by_layer = {l: {b for ll, b, _ in written if ll == l} for l in range(L)}
    assert all(len(by_layer[l]) == 1 and by_layer[l] != by_layer[l + 1]
               for l in range(L - 1)) and by_layer[L - 1] == {bufs[2]}


def test_ring_shared_memory_matches_the_source():
    """``ring_smem`` (the wrappers' shared-memory check) adds what the
    ring's layout adds: barriers, x (the GEMV's and the chain's), the
    stages, each of the first two rounded up to 128 bytes."""
    common = _common()
    assert "return bar_bytes(stages) + x_bytes + static_cast<size_t>(stages) * stage_bytes;" \
        in common
    assert "return align128(16 * stages); }" in common
    assert "return gemv ? wring::align128(2 * K) : 0; }" in _source("gemv_stream")
    assert "wring::Ring ring(smem, wring::align128(2 * K), stages, rows * K * 2);" \
        in _source("gemv_chain")
    assert "constexpr int kMaxSmem = 232448 - 128;" in common
    assert gs.MAX_SMEM == 232448 - 128
    assert gs.ring_smem(2560, gs.Stages(40960, 4), True) == 128 + 5120 + 4 * 8 * 2560 * 2
    assert gs.ring_smem(264, gs.Ring(1, 3), False) == 128 + 3 * 264 * 2


def test_mbarrier_helpers_live_once_in_common_cuh():
    """K2's mbarrier helpers moved to common.cuh, shared by the weight streams."""
    defs = {p.name: p.read_text().count("void mbar_init(uint32_t bar, uint32_t count)")
            for p in CSRC.iterdir()}
    assert defs["common.cuh"] == 1 and sum(defs.values()) == 1
    for name in ("flash_prefill.cu", "gemv_stream.cu", "gemv_chain.cu"):
        assert '#include "common.cuh"' in (CSRC / name).read_text()


def test_the_weight_ring_lives_once_in_common_cuh():
    """The ring (barriers, producer step, a warp a row) is common.cuh's, and
    both weight-stream sources use it."""
    defs = {p.name: p.read_text().count("struct Ring {") for p in CSRC.iterdir()}
    assert defs["common.cuh"] == 1 and sum(defs.values()) == 1
    for name in ("gemv_stream", "gemv_chain"):
        text = _source(name)
        assert "wring::Ring ring(smem," in text and "ring.init();" in text
        assert "mbar_wait(" not in text and "bulk_copy_g2s(" not in text


FAULTS = [(k, f) for k, v in mutants.KERNELS.items()
          for f in [*v[3], *mutants.RING_FAULTS.get(k, {})]]


@pytest.mark.parametrize("kernel,fault", FAULTS, ids=[f"{k}-{f}" for k, f in FAULTS])
def test_mutant_faults_are_planted_once(kernel, fault, tmp_path, monkeypatch):
    """Each planted fault of chain_mutant_check finds its anchor once and
    changes the copy's source."""
    monkeypatch.setattr(mutants, "ROOT", tmp_path)
    shutil.copytree(ROOT / "pegainfer_tpu_torch" / "csrc",
                    tmp_path / "pegainfer_tpu_torch" / "csrc")
    (tmp_path / "tests").mkdir()
    shutil.copy(ROOT / "tests" / "test_torch_gemv_studies_cuda.py", tmp_path / "tests")
    copy = mutants.make_copy(kernel, fault)
    changed = [p.name for p in (copy / "pegainfer_tpu_torch" / "csrc").iterdir()
               if p.read_text() != (CSRC / p.name).read_text()]
    assert changed == ["common.cuh" if fault == "no-empty-wait" else f"gemv_{kernel}.cu"]
