"""Megatron-style tensor parallelism for Qwen3: which axis of each parameter
a rank keeps. The Qwen3 part of ``pegainfer_tpu/parallel/sharding.py``.

The JAX package places the whole tree on a mesh and lets GSPMD insert the
collectives; here each rank is a process of its own that holds only its
slice (``shard_qwen3``) and the model functions reduce across ranks
themselves (``models/qwen3.py``'s ``tp`` argument, ``parallel/group.py``):

- wq / wk / wv ``[L, D, H*hd]`` and w_gate_up ``[L, D, 2I]``: the output
  axis (each rank a contiguous run of heads, of intermediate channels);
- wo ``[L, Hq*hd, D]`` and w_down ``[L, I, D]``: the input axis, so each
  rank's product is a partial sum, reduced across the ranks;
- lm_head ``[D, V]``: the vocab axis, each rank's logits gathered;
- the embedding, the norms and ``final_ln``: whole on every rank;
- the KV pool ``[L, Hkv, pages, 2, ps, hd]``: the kv-head axis, so paged
  attention is local to a rank (a GQA group never crosses ranks). Each
  rank allocates its own contiguous ``[L, Hkv/tp, ...]`` pool (K1 reads the
  pool at a layer offset, ``ops/cuda/paged_decode.py``).

An int8 container (``{"q": [.., out, in], "s": [.., out]}``,
``ops/quant.py``) follows the JAX ``place_tree`` rule: ``q`` is split as
its matrix, ``s`` with the output axis and whole when the input axis is
split. Quantize BEFORE sharding, as the JAX engine does: a row-parallel
weight then keeps the scales of the full input axis.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from pegainfer_tpu_torch.ops import quant

# the axis each leaf is split on, in the [in, out] sense of a projection
# (the JAX qwen3_param_specs): "out" the output axis, "in" the input axis,
# "gate_up" the output axis of gate and of up apart (see shard_qwen3);
# leaves not listed are whole on every rank
QWEN3_SPLIT = {
    "wq": "out", "wk": "out", "wv": "out", "wo": "in",
    "w_gate_up": "gate_up", "w_down": "in",
}
HEAD_SPLIT = "out"  # lm_head [D, V]: the vocab axis


def validate_qwen3_tp(cfg, tp: int) -> None:
    """The JAX ``validate_qwen3_tp``: ``tp`` divides the kv heads, the query
    heads, the intermediate width and the vocab."""
    if cfg.num_key_value_heads % tp:
        raise ValueError(f"tp={tp} must divide num_key_value_heads={cfg.num_key_value_heads}")
    if cfg.num_attention_heads % tp:
        raise ValueError(f"tp={tp} must divide num_attention_heads={cfg.num_attention_heads}")
    if cfg.intermediate_size % tp:
        raise ValueError(f"tp={tp} must divide intermediate_size={cfg.intermediate_size}")
    if cfg.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide vocab_size={cfg.vocab_size}")


def local_config(cfg, tp: int):
    """A rank's config: its query and kv heads and its intermediate width
    (the reshapes and the pool follow it); the vocab stays whole, since the
    head's logits are gathered."""
    validate_qwen3_tp(cfg, tp)
    return replace(cfg, num_attention_heads=cfg.num_attention_heads // tp,
                   num_key_value_heads=cfg.num_key_value_heads // tp,
                   intermediate_size=cfg.intermediate_size // tp)


def _run(n: int, rank: int, tp: int) -> slice:
    k = n // tp
    return slice(rank * k, (rank + 1) * k)


def _cut(t: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    idx = [slice(None)] * t.dim()
    idx[dim] = _run(t.shape[dim], rank, tp)
    return t[tuple(idx)]


def _gate_up(t: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    """``gate ‖ up`` along ``dim`` -> this rank's ``gate shard ‖ up shard``."""
    gate, up = t.chunk(2, dim=dim)
    return torch.cat([_cut(gate, dim, rank, tp), _cut(up, dim, rank, tp)], dim=dim)


def _own(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` (None: t's own), never a
    view of the caller's storage."""
    dev = t.device if device is None else torch.device(device)
    if t.device == dev:
        return t.clone(memory_format=torch.contiguous_format)
    return t.to(dev).contiguous()


def shard_leaf(w, split: Optional[str], rank: int, tp: int, device=None):
    """Rank ``rank``'s slice of one leaf (a tensor ``[.., in, out]`` or an
    int8 container), a contiguous copy on ``device`` (None: the leaf's
    own)."""
    if quant.is_quantized(w):  # q [.., out, in], s [.., out]
        q, s = w["q"], w["s"]
        if split == "in":
            q = _cut(q, -1, rank, tp)
        elif split == "gate_up":
            q, s = _gate_up(q, -2, rank, tp), _gate_up(s, -1, rank, tp)
        elif split == "out":
            q, s = _cut(q, -2, rank, tp), _cut(s, -1, rank, tp)
        return {"q": _own(q, device), "s": _own(s, device)}
    if split == "in":
        w = _cut(w, -2, rank, tp)
    elif split == "gate_up":
        w = _gate_up(w, -1, rank, tp)
    elif split == "out":
        w = _cut(w, -1, rank, tp)
    return _own(w, device)


def shard_qwen3(cfg, params, rank: int, tp: int, device=None):
    """Rank ``rank``'s tree of ``params`` (bf16 / f32 leaves or int8
    containers) at tensor-parallel width ``tp``: every leaf a contiguous
    copy on ``device`` (None: where the leaf lies).

    ``w_gate_up`` is ``gate ‖ up`` on its output axis (the JAX
    ``models/qwen3.py`` fuses them so, and ``_mlp`` splits it in halves): a
    contiguous run of that axis would give rank 0 all of gate and none of
    up, so rank r takes ``gate[.., r*I/tp:(r+1)*I/tp] ‖ up[same]``. The JAX
    package's contiguous spec works there only because GSPMD reshards the
    logical array before the split. A tied head (a view of ``embed.T``) is
    cut out of that view, so the embedding stays whole."""
    validate_qwen3_tp(cfg, tp)
    return {
        "embed": shard_leaf(params["embed"], None, rank, tp, device),
        "layers": {k: shard_leaf(v, QWEN3_SPLIT.get(k), rank, tp, device)
                   for k, v in params["layers"].items()},
        "final_ln": shard_leaf(params["final_ln"], None, rank, tp, device),
        "lm_head": shard_leaf(params["lm_head"], HEAD_SPLIT, rank, tp, device),
    }
