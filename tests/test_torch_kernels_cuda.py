"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: run with ``python -m pytest -m cuda tests/``
on a machine with an NVIDIA Hopper card; elsewhere each test skips.

bf16 tolerances are the JAX package's for these kernels
(tests/test_pallas_kernels.py): 3e-2 for decode, 2e-2 for prefill.
"""

import numpy as np
import pytest
import torch

from pegainfer_tpu_torch.ops.cuda import flash_prefill as fp
from pegainfer_tpu_torch.ops.cuda import paged_decode as pd

pytestmark = pytest.mark.cuda

DECODE_TOL = 3e-2
PREFILL_TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        dev, torch.bfloat16)


@pytest.mark.parametrize("form", ["layer", "layer_cur", "pool", "pool_cur"])
@pytest.mark.parametrize("hd,Hq,Hkv", [(128, 32, 8), (64, 8, 4)])
def test_paged_decode_kernel_matches_plain(dev, form, hd, Hq, Hkv):
    rng = np.random.default_rng(hd + Hq)
    ps, L, num_pages = 64, 2, 64
    seq_lens = [1, 63, 700, 1280, 0]
    B, P = len(seq_lens), 21
    pool = _bf16(rng, (L, Hkv, num_pages, 2, ps, hd), dev)
    tables = np.zeros((B, P), np.int32)
    nxt = 1
    for b, s in enumerate(seq_lens):
        n = -(-s // ps)
        tables[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    tables = torch.from_numpy(tables).to(dev)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    q = _bf16(rng, (B, Hq, hd), dev)
    kw = {}
    if form.endswith("cur"):
        kw = dict(cur_k=_bf16(rng, (B, Hkv, hd), dev), cur_v=_bf16(rng, (B, Hkv, hd), dev))
    if form.startswith("pool"):
        args = (q, pool, pool, tables, sl, hd ** -0.5)
        kw["layer_id"] = 1
    else:
        args = (q, pool[1, :, :, 0], pool[1, :, :, 1], tables, sl, hd ** -0.5)
    before = pd.launches
    out = pd.paged_attention_decode(*args, **kw)
    torch.cuda.synchronize()
    assert pd.launches == before + 1
    ref = pd.paged_attention_decode_plain(*args, **kw)
    assert (out.float() - ref.float()).abs().max().item() < DECODE_TOL
    assert out[-1].abs().max().item() == 0.0  # dead row


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
