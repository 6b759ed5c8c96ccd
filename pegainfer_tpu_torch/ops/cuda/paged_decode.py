"""Paged GQA decode attention: kernel K1 (``csrc/paged_decode.cu``).

Replaces the TPU kernel ``pegainfer_tpu/ops/pallas/paged_decode.py::
paged_attention_decode``. The wrapper dispatches on the device of ``q``: a
CPU tensor takes the plain version (``ops.attention.paged_attention_decode``),
a CUDA tensor launches the kernel or raises. ``launches`` counts kernel
launches (one a call).

The kernel splits each row's context across blocks (split-KV);
``plan_splits`` picks the split from shapes alone, so a call reads no
device value and never waits for the card. It splits the table width P,
not the live length: the plan assumes tables as wide as the longest live
row (as ``engine/torch_executor.py`` builds them). In a table much wider
than its rows the live tokens fall into the first splits and the kernel
slows toward its one-split time. The splits of a (row, kv head) meet
through a ticket counter that the kernel leaves at 0; calls that share
counters must run in one stream order, so each (device, stream) has its
own (``_tickets``).
"""

from __future__ import annotations

import functools

import torch

from pegainfer_tpu_torch.ops import attention as att
from pegainfer_tpu_torch.ops.cuda import build

launches = 0

HEAD_DIMS = (64, 128, 256)
GROUP_SIZES = (1, 2, 4, 8)
BLOCKS_PER_SM = 2  # the grid aims at about this many blocks an SM
MAX_SPLITS = 256  # csrc/paged_decode.cu kMaxSplits
MIN_SPLIT_TOKENS = 64  # a split holds at least one tile of K/V (hd <= 128)

_tickets: dict = {}  # (device, stream handle) -> int32 zeros, one per (row, kv head)


def plan_splits(B: int, Hkv: int, P: int, ps: int, sm_count: int):
    """(S, pps): split a [B, P] page table's rows into S splits of pps
    pages; split s covers pages [s * pps, min((s + 1) * pps, P)). From
    shapes alone: the grid (B, Hkv, S) aims at BLOCKS_PER_SM blocks an SM,
    never more splits than pages (nor MAX_SPLITS), at least
    MIN_SPLIT_TOKENS tokens a split, and S = 1 once the B * Hkv blocks
    alone fill the card. P stands in for the live length, which only the
    card knows: a table much wider than its longest row gets too few live
    splits."""
    rows = B * Hkv
    if P <= 1 or rows >= sm_count:
        return 1, max(P, 1)
    want = min(P, MAX_SPLITS, -(-BLOCKS_PER_SM * sm_count // rows))
    pps = max(-(-P // want), -(-MIN_SPLIT_TOKENS // ps))
    return -(-P // pps), pps


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ticket_buffer(device: torch.device, stream: torch.cuda.Stream, n: int) -> torch.Tensor:
    """The ticket counters of ``stream``: the stream orders every call
    that uses them, so the splits of one call never meet another's."""
    key = (device, stream.cuda_stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return t


def paged_attention_decode_plain(q, k_pages, v_pages, page_tables, seq_lens, scale,
                                 cur_k=None, cur_v=None, layer_id=None):
    """The kernel's function in plain PyTorch, in every form it takes."""
    if layer_id is not None:
        k_pages, v_pages = k_pages[layer_id, :, :, 0], k_pages[layer_id, :, :, 1]
    return att.paged_attention_decode(q, k_pages, v_pages, page_tables, seq_lens,
                                      scale, cur_k=cur_k, cur_v=cur_v)


def paged_attention_decode(q, k_pages, v_pages, page_tables, seq_lens, scale,
                           cur_k=None, cur_v=None, layer_id=None):
    """Decode attention; contract of ``ops.attention.paged_attention_decode``.

    q: [B, Hq, hd]; page_tables: [B, P] int32; seq_lens: [B] int32 (0 = dead
    row, output 0). k_pages/v_pages are per-layer [Hkv, pages, ps, hd]; or,
    with ``layer_id`` (a Python int), both are the full k/v-adjacent pool
    [L, Hkv, pages, 2, ps, hd] and the kernel reads layer ``layer_id``
    straight from it. ``cur_k/cur_v`` [B, Hkv, hd] give the current token's
    k/v (the pages then hold seq_len - 1 tokens).
    """
    if q.device.type == "cpu":
        return paged_attention_decode_plain(q, k_pages, v_pages, page_tables, seq_lens,
                                            scale, cur_k=cur_k, cur_v=cur_v,
                                            layer_id=layer_id)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode: no kernel for device {q.device}")
    return _launch(q, k_pages, v_pages, page_tables, seq_lens, scale, cur_k, cur_v,
                   layer_id)


def _launch(q, k_pages, v_pages, page_tables, seq_lens, scale, cur_k, cur_v, layer_id):
    global launches
    B, Hq, hd = q.shape
    has_cur = cur_k is not None
    if has_cur != (cur_v is not None):
        raise ValueError("cur_k and cur_v come together")
    if layer_id is not None:
        if v_pages is not k_pages or k_pages.dim() != 6:
            raise ValueError("with layer_id, pass the [L, Hkv, pages, 2, ps, hd] pool "
                             "as both k_pages and v_pages")
        L, Hkv, _, _, ps, _ = k_pages.shape
        if not 0 <= layer_id < L:
            raise ValueError(f"layer_id {layer_id} outside [0, {L})")
        if not k_pages.is_contiguous():
            raise ValueError("the pool must be contiguous")
        esize = k_pages.element_size()
        k_ptr = k_pages.data_ptr() + layer_id * k_pages.stride(0) * esize
        v_ptr = k_ptr + k_pages.stride(3) * esize
        head_stride, page_stride = k_pages.stride(1), k_pages.stride(2)
    else:
        if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
            raise ValueError("k_pages/v_pages must be [Hkv, pages, ps, hd] alike")
        Hkv, _, ps, _ = k_pages.shape
        if k_pages.stride() != v_pages.stride() or k_pages.stride()[2:] != (hd, 1):
            raise ValueError("k_pages/v_pages need equal strides and contiguous "
                             "[ps, hd] pages")
        k_ptr, v_ptr = k_pages.data_ptr(), v_pages.data_ptr()
        head_stride, page_stride = k_pages.stride(0), k_pages.stride(1)
    if k_pages.shape[-1] != hd or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages {tuple(k_pages.shape)}")
    G = Hq // Hkv
    if hd not in HEAD_DIMS or G not in GROUP_SIZES:
        raise ValueError(f"paged decode kernel takes hd in {HEAD_DIMS} and "
                         f"G in {GROUP_SIZES}, got hd={hd} G={G}")
    tensors = [q, k_pages, v_pages, page_tables, seq_lens]
    if has_cur:
        tensors += [cur_k, cur_v]
        if cur_k.shape != (B, Hkv, hd) or cur_v.shape != (B, Hkv, hd):
            raise ValueError("cur_k/cur_v must be [B, Hkv, hd]")
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all inputs must be on the device of q")
    for t in [q, k_pages] + ([cur_k, cur_v] if has_cur else []):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"paged decode kernel takes bf16, got {t.dtype}")
    for t in [q, page_tables, seq_lens] + ([cur_k, cur_v] if has_cur else []):
        if not t.is_contiguous():
            raise ValueError("q, page tables, seq_lens and cur_k/cur_v must be contiguous")
    if page_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("page tables and seq_lens must be int32")
    if page_tables.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError("page tables / seq_lens do not match the batch")
    # the kernel copies K/V and cur rows 16 bytes at a time
    ptrs = [q.data_ptr(), k_ptr, v_ptr] + ([cur_k.data_ptr(), cur_v.data_ptr()] if has_cur else [])
    if any(p % 16 for p in ptrs) or head_stride % 8 or page_stride % 8:
        raise ValueError("paged decode kernel needs 16-byte aligned q, pages and cur_k/cur_v")

    out = torch.empty_like(q)
    if B == 0:
        return out
    P = page_tables.shape[1]
    S, pps = plan_splits(B, Hkv, P, ps, _sm_count(q.device))
    stream = torch.cuda.current_stream(q.device)
    part_acc = part_ml = tickets = None
    if S > 1:
        n = B * Hkv * S * G
        part = torch.empty(n * (hd + 2), dtype=torch.float32, device=q.device)
        part_acc, part_ml = part[: n * hd], part[n * hd:]
        tickets = _ticket_buffer(q.device, stream, B * Hkv)
    lib = build.load("paged_decode")
    err = lib.paged_decode_bf16(
        q.data_ptr(), k_ptr, v_ptr,
        cur_k.data_ptr() if has_cur else None, cur_v.data_ptr() if has_cur else None,
        page_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in (part_acc, part_ml, tickets)),
        B, Hkv, G, hd, P, ps, S, pps, head_stride, page_stride,
        float(scale), int(has_cur), stream.cuda_stream,
    )
    build.check_launch("paged_decode", err)
    launches += 1
    return out
