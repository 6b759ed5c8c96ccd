"""Megatron-style tensor parallelism for Qwen3 and the Qwen3.5 hybrid, and
DeepSeek-V4's mp8 model parallelism: which axis of each parameter a rank
keeps. The Qwen3, Qwen3.5 and DeepSeek-V4 parts of
``pegainfer_tpu/parallel/sharding.py`` (the hybrid's rules under
``shard_qwen35``, DeepSeek-V4's under ``shard_dsv4`` below).

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


# ── the Qwen3.5 hybrid (the JAX qwen35_param_specs / qwen35_state_specs) ──
# GDN layers: the key and value heads cut into contiguous runs (wq / wk on
# the key heads, wv / wz / wb / wa, dt_bias and A_log on the value heads),
# out_proj and mlp_down on their inputs; full layers as Qwen3's. conv_w is
# cut by its own rule (``conv_channels``). Leaves not listed are whole.
QWEN35_LIN_SPLIT = {
    "wq": "out", "wk": "out", "wv": "out", "wz": "out", "wb": "out", "wa": "out",
    "dt_bias": "out", "A_log": "out",  # [G, pl, Hv]: the value-head axis, last
    "out_proj": "in", "mlp_gate_up": "gate_up", "mlp_down": "in",
}
QWEN35_FULL_SPLIT = {
    "wq": "out", "wgate": "out", "wk": "out", "wv": "out", "wo": "in",
    "mlp_gate_up": "gate_up", "mlp_down": "in",
}


def validate_qwen35_tp(cfg, tp: int) -> None:
    """The JAX ``validate_qwen35_tp``: ``tp`` divides the GDN key and value
    heads, the full layers' query and kv heads, the intermediate width and
    the vocab."""
    for name, v in (
        ("linear_num_key_heads", cfg.linear_num_key_heads),
        ("linear_num_value_heads", cfg.linear_num_value_heads),
        ("num_attention_heads", cfg.num_attention_heads),
        ("num_key_value_heads", cfg.num_key_value_heads),
        ("intermediate_size", cfg.intermediate_size),
        ("vocab_size", cfg.vocab_size),
    ):
        if v % tp:
            raise ValueError(f"tp={tp} must divide {name}={v}")


def local_config_qwen35(cfg, tp: int):
    """A rank's hybrid config: its GDN key and value heads, its full layers'
    query and kv heads and its intermediate width (``key_dim``,
    ``value_dim`` and ``conv_dim`` follow; the state and the pool take
    them); the vocab stays whole, since the head's logits are gathered."""
    validate_qwen35_tp(cfg, tp)
    return replace(cfg, num_attention_heads=cfg.num_attention_heads // tp,
                   num_key_value_heads=cfg.num_key_value_heads // tp,
                   intermediate_size=cfg.intermediate_size // tp,
                   linear_num_key_heads=cfg.linear_num_key_heads // tp,
                   linear_num_value_heads=cfg.linear_num_value_heads // tp)


def conv_channels(cfg, t: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    """The conv channels ``q ‖ k ‖ v`` along ``dim`` -> this rank's
    ``q shard ‖ k shard ‖ v shard`` (its own key and value heads)."""
    kd = cfg.key_dim
    q, k, v = torch.split(t, [kd, kd, cfg.value_dim], dim=dim)
    return torch.cat([_cut(q, dim, rank, tp), _cut(k, dim, rank, tp),
                      _cut(v, dim, rank, tp)], dim=dim)


def shard_qwen35(cfg, params, rank: int, tp: int, device=None):
    """Rank ``rank``'s tree of the hybrid's ``params`` (bf16 / f32 leaves or
    int8 containers) at tensor-parallel width ``tp``: every leaf a
    contiguous copy on ``device`` (None: where the leaf lies).

    ``conv_w`` [G, pl, conv_dim, K] is the depthwise conv over the channels
    ``q ‖ k ‖ v`` (``models/qwen35.py::_gdn_project``), which
    ``_gdn_split_heads`` reads back as key and value heads: a contiguous run
    of that axis would give rank 0 all of q and k and another rank all of
    v, so rank r takes ``q[r] ‖ k[r] ‖ v[r]`` (``conv_channels``), the
    channels of its own heads. The JAX spec's contiguous run works there
    only because GSPMD reshards the logical array before the split, as for
    ``mlp_gate_up`` (``gate shard ‖ up shard``, ``shard_qwen3``). A tied
    head is cut out of the embedding's view; the norms, ``norm_w``, the
    embedding and ``final_ln`` stay whole."""
    validate_qwen35_tp(cfg, tp)
    lin = {k: shard_leaf(v, QWEN35_LIN_SPLIT.get(k), rank, tp, device)
           for k, v in params["lin"].items() if k != "conv_w"}
    lin["conv_w"] = _own(conv_channels(cfg, params["lin"]["conv_w"], -2, rank, tp), device)
    return {
        "embed": shard_leaf(params["embed"], None, rank, tp, device),
        "lin": lin,
        "full": {k: shard_leaf(v, QWEN35_FULL_SPLIT.get(k), rank, tp, device)
                 for k, v in params["full"].items()},
        "final_ln": shard_leaf(params["final_ln"], None, rank, tp, device),
        "lm_head": shard_leaf(params["lm_head"], HEAD_SPLIT, rank, tp, device),
    }


# ── DeepSeek-V4 (the JAX DSV4_LAYER_SHARDED / dsv4_param_specs) ──────────
# The reference's mp8 rank split: each rank keeps its attention heads
# (wq_b's rows, attn_sink), its o-groups (wo_a's rows, wo_b's input
# columns), its index heads (idx_wq_b's and idx_weights_proj's rows), its
# E / tp routed experts and its vocabulary rows (embed, head). Every other
# leaf is whole on every rank: wq_a, wkv, the compressors, the shared
# experts, the gate and the hc_* mixes. The value is the axis a leaf is cut
# on (a container's q and s alike; [out, in] weights, [E, out, in] stacks).
DSV4_LAYER_SPLIT = {
    "attn_sink": 0, "wq_b": 0, "wo_a": 0, "wo_b": 1, "idx_wq_b": 0,
    "idx_weights_proj": 0, "experts_w1": 0, "experts_w2": 0, "experts_w3": 0,
}
DSV4_TOP_SPLIT = {"embed": 0, "head": 0}


def validate_dsv4_mp8(cfg, world: int = 8) -> None:
    """The JAX ``validate_dsv4_mp8``: ``world`` divides the attention heads,
    the o-groups, the routed experts, the index heads and the vocab."""
    for name, v in (
        ("num_attention_heads", cfg.num_attention_heads),
        ("o_groups", cfg.o_groups),
        ("n_routed_experts", cfg.n_routed_experts),
        ("index_n_heads", cfg.index_n_heads),
        ("vocab_size", cfg.vocab_size),
    ):
        if v % world:
            raise ValueError(f"mp8 world={world} must divide {name}={v}")


def local_config_dsv4(cfg, tp: int):
    """A rank's DeepSeek-V4 config: its attention heads, o-groups, index
    heads and routed experts (the reshapes and the local expert ids follow
    them). The vocab stays whole: the embedding's rows are looked up masked
    and the head's logits gathered. The indexer's score scale keeps the
    whole count of index heads (``models/dsv4.py`` takes it times ``tp``)."""
    validate_dsv4_mp8(cfg, tp)
    return replace(cfg, num_attention_heads=cfg.num_attention_heads // tp,
                   o_groups=cfg.o_groups // tp, index_n_heads=cfg.index_n_heads // tp,
                   n_routed_experts=cfg.n_routed_experts // tp)


def _cut_scales(name: str, q: torch.Tensor, s: torch.Tensor, axis: int, rank: int,
                tp: int) -> torch.Tensor:
    """A block-scaled container's scales for ``q``'s cut on ``axis``: the
    grid follows the shape ratio (``quant.dequant_any``), so s is cut with
    q when tp divides its blocks on that axis, and kept whole when one
    block spans the axis (its one scale covers every rank's piece). A cut
    inside a block raises ValueError."""
    n = s.shape[axis]
    if n == 1:
        return s
    if n % tp:
        raise ValueError(f"{name}: a cut of {q.shape[axis]} into {tp} falls inside its scale "
                         f"blocks of {q.shape[axis] // n}")
    return _cut(s, axis, rank, tp)


def shard_dsv4_leaf(name: str, w, rank: int, tp: int, device=None):
    """Rank ``rank``'s piece of one DeepSeek-V4 leaf (``DSV4_LAYER_SPLIT``,
    ``DSV4_TOP_SPLIT``; a leaf not listed whole), a contiguous copy on
    ``device`` (None: the leaf's own)."""
    axis = DSV4_LAYER_SPLIT.get(name, DSV4_TOP_SPLIT.get(name))
    if isinstance(w, dict) and not quant.is_quantized(w):  # a compressor
        return {k: _own(v, device) for k, v in w.items()}
    if quant.is_quantized(w):
        q, s = w["q"], w["s"]
        if axis is not None:
            q, s = _cut(q, axis, rank, tp), _cut_scales(name, q, s, axis, rank, tp)
        return {"q": _own(q, device), "s": _own(s, device)}
    return _own(w if axis is None else _cut(w, axis, rank, tp), device)


def shard_dsv4(cfg, params, rank: int, tp: int, device=None):
    """Rank ``rank``'s tree of DeepSeek-V4 ``params`` (plain leaves, fp8 /
    packed-fp4 / int8 containers) at model-parallel width ``tp`` (1, 2, 4
    or 8: the reference's mp8 split folded 8 / tp checkpoint ranks a rank):
    every leaf a contiguous copy on ``device`` (None: where the leaf lies).
    The slot state is whole on every rank (the attention is multi-query:
    one joint KV row a position, which every head reads), so it has no
    shard."""
    validate_dsv4_mp8(cfg, tp)
    out = {k: shard_dsv4_leaf(k, v, rank, tp, device)
           for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: shard_dsv4_leaf(k, v, rank, tp, device) for k, v in lw.items()}
                     for lw in params["layers"]]
    return out
