"""Qwen3 (dense GQA) forward in PyTorch; counterpart of
``pegainfer_tpu/models/qwen3.py``.

Parameters keep the JAX package's tree: a dict with layer weights STACKED on
a leading [L, ...] axis, projections stored [in, out] (forward is x @ W) and
gate/up fused as ``w_gate_up`` — so ``params_from_jax`` is a plain copy and
both packages compute the same thing from the same weights. The KV pool keeps
the JAX layout ``[L, Hkv, pages, 2, page_size, hd]``.

KV writes: PyTorch updates the pool in place, so each layer writes its new
k/v straight into the pool (prefill: after computing them; a chunk: before
its attention gathers the request's pages; decode: right after its
attention). The JAX write-ahead ``pend`` chains (``decode_wa``,
``prefill_chunk_wa``) exist only to stop XLA from copying the pool and are
not carried over. Decode attention still has ``decode_wa``'s semantics: it
reads the past from the pages and the current token from the in-flight k/v
(``cur_k``/``cur_v``).

Attention goes through the kernel wrappers in ``ops.cuda``: on a CUDA tensor
they always launch their kernel (a shape the kernel cannot take raises), on
a CPU tensor they run the plain version. So do the int8 weight-only
projections (``quantize_params_int8``, the JAX package's ``quantize="int8"``
mode): every projection and the head go through ``_proj``, which applies a
bf16 ``[in, out]`` weight as ``x @ w`` and an int8 container through
``ops/quant.py::int8_linear`` (decode-shaped rows: K6). ``plain_kernels=True``
runs every kernel's plain version (K1, K2, K6) on any device, as the
oracle of the kernels.
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from pegainfer_tpu_torch.ops import attention as att
from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.ops.cuda.flash_prefill import flash_attention, flash_prefill
from pegainfer_tpu_torch.ops.cuda.paged_decode import paged_attention_decode
from pegainfer_tpu_torch.ops.norm import rms_norm
from pegainfer_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_inv_freq
from pegainfer_tpu_torch.utils.weights import numpy_to_torch


@dataclass(frozen=True)
class Qwen3Config:
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    vocab_size: int
    rms_norm_eps: float
    rope_theta: float
    tie_word_embeddings: bool
    eos_token_id: int = 151645
    stop_token_ids: tuple = ()
    max_position_embeddings: int = 40960

    @staticmethod
    def from_hf(cfg: Any) -> "Qwen3Config":
        """From a transformers Qwen3Config instance."""
        eos = cfg.eos_token_id
        if isinstance(eos, (list, tuple)):
            stop = tuple(eos)
            eos = eos[0]
        else:
            stop = (eos,)
        return Qwen3Config(
            hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size,
            num_hidden_layers=cfg.num_hidden_layers,
            num_attention_heads=cfg.num_attention_heads,
            num_key_value_heads=cfg.num_key_value_heads,
            head_dim=cfg.head_dim,
            vocab_size=cfg.vocab_size,
            rms_norm_eps=cfg.rms_norm_eps,
            rope_theta=cfg.rope_theta,
            tie_word_embeddings=cfg.tie_word_embeddings,
            eos_token_id=eos,
            stop_token_ids=stop,
            max_position_embeddings=getattr(cfg, "max_position_embeddings", 40960),
        )

    @staticmethod
    def from_model_path(model_path: str) -> "Qwen3Config":
        with open(os.path.join(model_path, "config.json")) as f:
            c = json.load(f)
        stop: List[int] = []
        gen_path = os.path.join(model_path, "generation_config.json")
        if os.path.exists(gen_path):
            with open(gen_path) as f:
                g = json.load(f)
            eos = g.get("eos_token_id", c.get("eos_token_id"))
            stop = eos if isinstance(eos, list) else [eos]
        eos_single = c.get("eos_token_id")
        if isinstance(eos_single, list):
            eos_single = eos_single[0]
        return Qwen3Config(
            hidden_size=c["hidden_size"],
            intermediate_size=c["intermediate_size"],
            num_hidden_layers=c["num_hidden_layers"],
            num_attention_heads=c["num_attention_heads"],
            num_key_value_heads=c["num_key_value_heads"],
            head_dim=c.get("head_dim", c["hidden_size"] // c["num_attention_heads"]),
            vocab_size=c["vocab_size"],
            rms_norm_eps=c["rms_norm_eps"],
            rope_theta=c["rope_theta"],
            tie_word_embeddings=c.get("tie_word_embeddings", False),
            eos_token_id=eos_single,
            stop_token_ids=tuple(stop) if stop else (eos_single,),
            max_position_embeddings=c.get("max_position_embeddings", 40960),
        )



# ── Params ───────────────────────────────────────────────────────────────
# {
#   "embed":    [V, D]
#   "layers": {
#     "input_ln": [L, D],
#     "wq": [L, D, Hq*hd], "wk": [L, D, Hkv*hd], "wv": [L, D, Hkv*hd],
#     "q_norm": [L, hd], "k_norm": [L, hd],
#     "wo": [L, Hq*hd, D],
#     "post_ln": [L, D],
#     "w_gate_up": [L, D, 2*I],   (gate ‖ up)
#     "w_down": [L, I, D],
#   },
#   "final_ln": [D],
#   "lm_head":  [D, V]   (a view of embed.T when tied)
# }
# In the int8 weight-only mode (``quantize_params_int8``) each projection
# and the head are containers {"q": int8 [.., out, in], "s": f32 [.., out]}
# (ops/quant.py); the embedding and the norms stay as they are.

_LAYER_KEYS = ("input_ln", "wq", "wk", "wv", "q_norm", "k_norm", "wo", "post_ln",
               "w_gate_up", "w_down")


def _to_torch(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    t = numpy_to_torch(x)
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_state_dict(cfg: Qwen3Config, sd: Dict[str, Any],
                           dtype=torch.bfloat16, device="cpu"):
    """Build the stacked tree from an HF-named state dict (numpy arrays or
    torch tensors, HF [out, in] layout)."""

    def get(name):
        return _to_torch(sd[name], dtype, device)

    def proj(name):  # HF [out,in] -> ours [in,out]
        return get(name).T

    L = cfg.num_hidden_layers

    def stack(f):
        return torch.stack([f(i) for i in range(L)]).contiguous()

    pre = "model.layers.{}."
    layers = {
        "input_ln": stack(lambda i: get(pre.format(i) + "input_layernorm.weight")),
        "wq": stack(lambda i: proj(pre.format(i) + "self_attn.q_proj.weight")),
        "wk": stack(lambda i: proj(pre.format(i) + "self_attn.k_proj.weight")),
        "wv": stack(lambda i: proj(pre.format(i) + "self_attn.v_proj.weight")),
        "q_norm": stack(lambda i: get(pre.format(i) + "self_attn.q_norm.weight")),
        "k_norm": stack(lambda i: get(pre.format(i) + "self_attn.k_norm.weight")),
        "wo": stack(lambda i: proj(pre.format(i) + "self_attn.o_proj.weight")),
        "post_ln": stack(
            lambda i: get(pre.format(i) + "post_attention_layernorm.weight")),
        "w_gate_up": stack(lambda i: torch.cat(
            [proj(pre.format(i) + "mlp.gate_proj.weight"),
             proj(pre.format(i) + "mlp.up_proj.weight")], dim=1)),
        "w_down": stack(lambda i: proj(pre.format(i) + "mlp.down_proj.weight")),
    }
    embed = get("model.embed_tokens.weight")
    lm_head = embed.T if cfg.tie_word_embeddings else proj("lm_head.weight").contiguous()
    return {"embed": embed, "layers": layers, "final_ln": get("model.norm.weight"),
            "lm_head": lm_head}


def leaf_from_jax(x, dtype, device):
    """One leaf of a JAX tree: a tensor (``dtype`` None keeps its dtype), or
    a JAX int8 weight-only leaf ``{"q8": int8 [.., in, out], "s": f32
    [.., out]}`` as the port's container ``{"q": [.., out, in], "s"}``."""
    if isinstance(x, dict):
        q8 = numpy_to_torch(np.asarray(x["q8"]))
        return {"q": q8.transpose(-1, -2).contiguous().to(device),
                "s": _to_torch(x["s"], torch.float32, device)}
    return _to_torch(x, dtype, device)


def params_from_jax(jax_params, dtype=None, device="cpu"):
    """The JAX package's Qwen3 parameter tree (numpy leaves: stacked
    [L, ...], [in, out] projections, fused w_gate_up) as the port's
    parameters. The layout is the same, so this is a copy (an int8
    weight-only leaf is transposed into the port's container); ``dtype``
    None keeps each leaf's dtype."""
    return {
        "embed": _to_torch(jax_params["embed"], dtype, device),
        "layers": {k: leaf_from_jax(jax_params["layers"][k], dtype, device)
                   for k in _LAYER_KEYS},
        "final_ln": _to_torch(jax_params["final_ln"], dtype, device),
        "lm_head": leaf_from_jax(jax_params["lm_head"], dtype, device),
    }


_INT8_KEYS = ("wq", "wk", "wv", "wo", "w_gate_up", "w_down")


def quantize_params_int8(params):
    """The int8 weight-only mode (the JAX ``quantize_params_int8``): each of
    ``wq wk wv wo w_gate_up w_down`` and the head becomes an int8 container
    (``ops/quant.py::quantize_int8_linear``, the JAX codes exactly); the
    embedding and the norms stay. A tied head (a view of ``embed.T``) is
    quantized on its own, the embedding kept.

    CONSUMES ``params`` as the JAX function does: each matrix is replaced in
    the tree by its container as soon as it is quantized, so its memory is
    freed unless the caller holds it elsewhere (pass a shallow copy of the
    tree to keep the bf16 weights). Returns the same tree."""
    layers = params["layers"]
    for k in _INT8_KEYS:
        layers[k] = quant.quantize_int8_linear(layers[k])
    params["lm_head"] = quant.quantize_int8_linear(params["lm_head"])
    return params


def _shapes(cfg: Qwen3Config):
    L, D, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    return {
        "input_ln": (L, D), "wq": (L, D, Hq * hd), "wk": (L, D, Hkv * hd),
        "wv": (L, D, Hkv * hd), "q_norm": (L, hd), "k_norm": (L, hd),
        "wo": (L, Hq * hd, D), "post_ln": (L, D), "w_gate_up": (L, D, 2 * I),
        "w_down": (L, I, D),
    }


_NORMS = ("input_ln", "q_norm", "k_norm", "post_ln")


def init_random_params(cfg: Qwen3Config, seed: int = 0, dtype=torch.bfloat16,
                       scale: float = 0.02, device="cpu"):
    """Random params drawn on the host with numpy, in the same order as the
    JAX package's ``init_random_params`` — the same seed gives the same
    float64 draws (equal weights at f32; at bf16 the two frameworks may
    round a draw differently)."""
    rng = np.random.default_rng(seed)

    def w(shape):
        return torch.from_numpy(rng.normal(0, scale, shape)).to(device=device, dtype=dtype)

    embed = w((cfg.vocab_size, cfg.hidden_size))
    layers = {}
    for k, shape in _shapes(cfg).items():  # dict order = the JAX draw order
        layers[k] = (torch.ones(shape, dtype=dtype, device=device) if k in _NORMS
                     else w(shape))
    lm_head = embed.T if cfg.tie_word_embeddings else w((cfg.hidden_size, cfg.vocab_size))
    return {"embed": embed, "layers": layers,
            "final_ln": torch.ones(cfg.hidden_size, dtype=dtype, device=device),
            "lm_head": lm_head}


def init_random_params_device(cfg: Qwen3Config, generator: torch.Generator,
                              device, dtype=torch.bfloat16, scale: float = 0.02):
    """Random normal(0, scale) params filled on ``device`` from a seeded
    generator of that device — full-size weights in seconds. Norm weights
    are 1. Unlike constant fills, random weights give every key its own
    attention score, so an indexing fault in a kernel shows."""

    def w(shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, scale, generator=generator)

    embed = w((cfg.vocab_size, cfg.hidden_size))
    layers = {k: (torch.ones(shape, dtype=dtype, device=device) if k in _NORMS
                  else w(shape))
              for k, shape in _shapes(cfg).items()}
    lm_head = embed.T if cfg.tie_word_embeddings else w((cfg.hidden_size, cfg.vocab_size))
    return {"embed": embed, "layers": layers,
            "final_ln": torch.ones(cfg.hidden_size, dtype=dtype, device=device),
            "lm_head": lm_head}


def tensor_bytes(leaves) -> int:
    """Bytes of tensors and int8 containers, each storage counted once (a
    tied head, a view of the embedding, adds nothing)."""
    seen, n = set(), 0
    for leaf in leaves:
        for t in (leaf["q"], leaf["s"]) if quant.is_quantized(leaf) else (leaf,):
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                n += t.numel() * t.element_size()
    return n


def params_bytes(params) -> int:
    return tensor_bytes([params["embed"], params["final_ln"], *params["layers"].values(),
                         params["lm_head"]])


def make_kv_pages(cfg: Qwen3Config, num_pages: int, page_size: int,
                  dtype=torch.bfloat16, device="cpu"):
    """KV pool [L, Hkv, num_pages, 2, page_size, hd] — head-major, k and v
    of a page adjacent (the JAX package's layout)."""
    return torch.zeros(
        (cfg.num_hidden_layers, cfg.num_key_value_heads, num_pages, 2, page_size,
         cfg.head_dim), dtype=dtype, device=device)


def kv_bytes_per_page(cfg: Qwen3Config, page_size: int, dtype=torch.bfloat16) -> int:
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (cfg.num_hidden_layers * 2 * page_size * cfg.num_key_value_heads
            * cfg.head_dim * itemsize)


def export_pages(kv_pages, page_ids):
    """Gather whole pages for a PD handoff (``engine/pd.py``; the JAX
    ``export_pages``): [L, Hkv, pages, 2, ps, hd] x ids [n] -> [L, Hkv, n,
    2, ps, hd], a copy."""
    return kv_pages.index_select(2, _page_ids(page_ids, kv_pages.device))


def import_pages(kv_pages, rows, page_ids) -> None:
    """Scatter handed-off page rows into this pool's pages ``page_ids`` in
    place, in one indexed copy (the JAX ``import_pages``); ``rows`` may lie
    on the host."""
    kv_pages.index_copy_(2, _page_ids(page_ids, kv_pages.device),
                         rows.to(device=kv_pages.device, dtype=kv_pages.dtype))


def _page_ids(page_ids, device) -> torch.Tensor:
    return torch.as_tensor(page_ids, dtype=torch.long).to(device)


# ── Forward building blocks ──────────────────────────────────────────────


def _layer(params, li: int) -> Dict[str, Any]:
    """Layer li's weights (an int8 container's q and s sliced alike)."""
    return {k: ({"q": v["q"][li], "s": v["s"][li]} if quant.is_quantized(v) else v[li])
            for k, v in params["layers"].items()}


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # made once per device: a host-to-device copy in every forward would
    # wait for the card, and a CUDA graph cannot capture one
    return torch.tensor(rope_inv_freq(head_dim, theta), dtype=torch.float32, device=device)


def _rope(cfg: Qwen3Config, positions: torch.Tensor, dtype):
    return rope_cos_sin(positions, _inv_freq(cfg.head_dim, cfg.rope_theta, positions.device),
                        dtype)


def _proj(container, name: str, x, plain_kernels: bool):
    """x [N, in] through the projection ``container[name]``: a bf16 ``[in,
    out]`` weight (``x @ w``) or an int8 container
    (``ops/quant.py::int8_linear``)."""
    w = container[name]
    if quant.is_quantized(w):
        return quant.int8_linear(x, w, plain_kernels)
    return x @ w


def _qkv(cfg: Qwen3Config, lw, x, cos, sin, plain_kernels: bool):
    """x: [T, D] -> q [T, Hq, hd], k, v [T, Hkv, hd] with qk-norm + RoPE."""
    T = x.shape[0]
    hd = cfg.head_dim
    q = _proj(lw, "wq", x, plain_kernels).reshape(T, cfg.num_attention_heads, hd)
    k = _proj(lw, "wk", x, plain_kernels).reshape(T, cfg.num_key_value_heads, hd)
    v = _proj(lw, "wv", x, plain_kernels).reshape(T, cfg.num_key_value_heads, hd)
    q = rms_norm(q, lw["q_norm"], cfg.rms_norm_eps)
    k = rms_norm(k, lw["k_norm"], cfg.rms_norm_eps)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mlp(lw, x, plain_kernels: bool):
    gate, up = _proj(lw, "w_gate_up", x, plain_kernels).chunk(2, dim=-1)
    act = F.silu(gate.float()).to(x.dtype) * up
    return _proj(lw, "w_down", act, plain_kernels)


def _head(params, x, plain_kernels: bool):
    """Logits [N, V] f32 of final-normed rows x [N, D]."""
    return _proj(params, "lm_head", x, plain_kernels).float()


def _scale(cfg: Qwen3Config) -> float:
    return cfg.head_dim ** -0.5


def _write_kv(kv_pages, li: int, k, v, page_ids, slots):
    """Write rows k/v [N, Hkv, hd] at (page_ids[n], slots[n]) of layer li."""
    layer = kv_pages[li]  # [Hkv, pages, 2, ps, hd]
    layer[:, :, 0][:, page_ids, slots] = k.transpose(0, 1).to(kv_pages.dtype)
    layer[:, :, 1][:, page_ids, slots] = v.transpose(0, 1).to(kv_pages.dtype)


# ── Prefill: one request ─────────────────────────────────────────────────


def prefill(cfg: Qwen3Config, params, kv_pages, tokens, page_table,
            return_all_logits: bool = False, plain_kernels: bool = False):
    """Prefill one prompt and write its KV into ``kv_pages`` in place.

    tokens: [T] int (the prompt, unpadded); page_table: [>= ceil(T/ps)] int
    pages of this request. Returns (last_logits [V] f32, all_logits [T, V]
    f32 | None).
    """
    T = tokens.shape[0]
    ps = kv_pages.shape[4]
    x = params["embed"][tokens.long()]
    positions = torch.arange(T, device=x.device)
    cos, sin = _rope(cfg, positions, x.dtype)
    page_ids = page_table.long()[positions // ps]
    slots = positions % ps
    scale = _scale(cfg)
    for li in range(cfg.num_hidden_layers):
        lw = _layer(params, li)
        h = rms_norm(x, lw["input_ln"], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, lw, h, cos, sin, plain_kernels)
        if plain_kernels:
            o = att.prefill_attention(q, k, v, T, scale)
        else:
            o = flash_prefill(q, k, v, T, scale)
        _write_kv(kv_pages, li, k, v, page_ids, slots)
        x = x + _proj(lw, "wo", o.reshape(T, -1), plain_kernels)
        h = rms_norm(x, lw["post_ln"], cfg.rms_norm_eps)
        x = x + _mlp(lw, h, plain_kernels)
    if return_all_logits:
        all_logits = _head(params, rms_norm(x, params["final_ln"], cfg.rms_norm_eps),
                           plain_kernels)
        return all_logits[T - 1], all_logits
    x = rms_norm(x[T - 1:], params["final_ln"], cfg.rms_norm_eps)
    return _head(params, x, plain_kernels)[0], None


# ── Chunked prefill continuation ─────────────────────────────────────────


def chunk_rows(page_table, start_pos: int, valid: int, ps: int):
    """Positions, page ids and slots of a chunk's ``valid`` rows."""
    positions = start_pos + torch.arange(valid, device=page_table.device)
    return positions, page_table.long()[positions // ps], positions % ps


def chunk_attention(kv_pages, li: int, q, page_table, start_pos: int, scale: float,
                    plain_kernels: bool):
    """Attention of a chunk's queries (absolute positions start_pos + i)
    over the request's keys, read back from the pool by absolute position;
    the chunk's own rows must already be written. Only the pages covering
    ``[0, start_pos + Tc)`` are gathered. ``li`` indexes the pool's first
    axis (a Qwen3 layer; a Qwen3.5 group's full-attention layer)."""
    _, Hkv, _, _, ps, hd = kv_pages.shape
    kv_valid = start_pos + q.shape[0]
    pages = page_table[: -(-kv_valid // ps)].long()
    # one gather fetches k and v (adjacent in a page): [Hkv, n, 2, ps, hd]
    # -> [2, n * ps, Hkv, hd], each half contiguous, as K2 takes it
    kv_seq = kv_pages[li][:, pages].permute(2, 1, 3, 0, 4).reshape(2, -1, Hkv, hd).contiguous()
    if plain_kernels:
        return att.causal_attention(q, kv_seq[0], kv_seq[1], kv_valid, start_pos, scale)
    return flash_attention(q, kv_seq[0], kv_seq[1], kv_valid, start_pos, scale)


def prefill_chunk(cfg: Qwen3Config, params, kv_pages, tokens, start_pos: int,
                  valid: int, page_table, plain_kernels: bool = False,
                  return_all_logits: bool = False):
    """Prefill continuation: run prompt positions ``[start_pos, start_pos +
    valid)`` of one request whose earlier positions are already in its
    pages, and write the chunk's k/v into ``kv_pages`` in place.

    The function of the JAX ``prefill_chunk`` (``prefill_chunk_wa`` and
    ``flush_chunk_pend``): each layer writes the chunk's rows into their
    pages, gathers the request's k/v by absolute position and attends with
    queries at ``start_pos + i`` (K2 with ``q_offset``). tokens: [>= valid]
    (rows past ``valid`` are ignored); page_table: [>= ceil((start_pos +
    valid) / ps)] the request's pages. Returns last_logits [V] f32, for
    chunk row ``valid - 1``; with ``return_all_logits`` (the JAX
    ``prefill_chunk_wa_all``, for echo's prompt logprobs) the logits of
    every chunk row [valid, V] f32, the last row those last logits.
    """
    ps = kv_pages.shape[4]
    x = params["embed"][tokens[:valid].long()]
    positions, page_ids, slots = chunk_rows(page_table, start_pos, valid, ps)
    cos, sin = _rope(cfg, positions, x.dtype)
    scale = _scale(cfg)
    for li in range(cfg.num_hidden_layers):
        lw = _layer(params, li)
        h = rms_norm(x, lw["input_ln"], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, lw, h, cos, sin, plain_kernels)
        _write_kv(kv_pages, li, k, v, page_ids, slots)
        o = chunk_attention(kv_pages, li, q, page_table, start_pos, scale, plain_kernels)
        x = x + _proj(lw, "wo", o.reshape(valid, -1), plain_kernels)
        h = rms_norm(x, lw["post_ln"], cfg.rms_norm_eps)
        x = x + _mlp(lw, h, plain_kernels)
    if return_all_logits:
        return _head(params, rms_norm(x, params["final_ln"], cfg.rms_norm_eps), plain_kernels)
    x = rms_norm(x[valid - 1:], params["final_ln"], cfg.rms_norm_eps)
    return _head(params, x, plain_kernels)[0]


def mixed_chunk(cfg: Qwen3Config, params, kv_pages, chunk_tokens, start_pos: int,
                valid: int, page_table, dec_tokens, dec_positions, dec_tables,
                dec_seq_lens, plain_kernels: bool = False):
    """The fused mixed step: a prefill chunk's ``valid`` rows and one decode
    row per active stream through shared GEMMs, attention split between
    them (the JAX ``mixed_chunk_wa`` and both flushes).

    The chunk rows are ``prefill_chunk``'s (write, gather, K2 at
    ``q_offset``); the decode rows are ``decode``'s (K1 over the pages with
    the in-flight k/v, written after). The prefilling request never also
    decodes, so the two row sets touch disjoint pages. Arguments as in
    ``prefill_chunk`` and ``decode``. Returns (last_logits [V] f32 for chunk
    row ``valid - 1``, dec_logits [B, V] f32).
    """
    B = dec_tokens.shape[0]
    ps = kv_pages.shape[4]
    x = params["embed"][torch.cat([chunk_tokens[:valid], dec_tokens]).long()]
    positions, page_ids, slots = chunk_rows(page_table, start_pos, valid, ps)
    cos, sin = _rope(cfg, torch.cat([positions, dec_positions.to(positions.dtype)]),
                     x.dtype)
    dpos = dec_positions.long()
    dec_page_ids = torch.gather(dec_tables.long(), 1, (dpos // ps)[:, None])[:, 0]
    dec_slots = dpos % ps
    scale = _scale(cfg)
    for li in range(cfg.num_hidden_layers):
        lw = _layer(params, li)
        h = rms_norm(x, lw["input_ln"], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, lw, h, cos, sin, plain_kernels)
        _write_kv(kv_pages, li, k[:valid], v[:valid], page_ids, slots)
        o_p = chunk_attention(kv_pages, li, q[:valid], page_table, start_pos, scale,
                               plain_kernels)
        qd, kd, vd = q[valid:], k[valid:], v[valid:]
        o_d = decode_attention(kv_pages, li, qd, kd, vd, dec_tables, dec_seq_lens,
                                scale, plain_kernels)
        _write_kv(kv_pages, li, kd, vd, dec_page_ids, dec_slots)
        o = torch.cat([o_p.reshape(valid, -1), o_d.reshape(B, -1)])
        x = x + _proj(lw, "wo", o, plain_kernels)
        h = rms_norm(x, lw["post_ln"], cfg.rms_norm_eps)
        x = x + _mlp(lw, h, plain_kernels)
    x = rms_norm(x[valid - 1:], params["final_ln"], cfg.rms_norm_eps)  # last chunk row ‖ B
    logits = _head(params, x, plain_kernels)
    return logits[0], logits[1:]


# ── Batched decode: one token per request ────────────────────────────────


def decode_attention(kv_pages, li: int, q, k, v, page_tables, seq_lens, scale: float,
                     plain_kernels: bool):
    """Decode attention of one layer: the past from the pages, the current
    token from the in-flight ``k``/``v`` (K1 with ``cur_k``/``cur_v``)."""
    if plain_kernels:
        return att.paged_attention_decode(
            q, kv_pages[li, :, :, 0], kv_pages[li, :, :, 1], page_tables, seq_lens,
            scale, cur_k=k, cur_v=v)
    return paged_attention_decode(q, kv_pages, kv_pages, page_tables, seq_lens, scale,
                                  cur_k=k, cur_v=v, layer_id=li)


def decode(cfg: Qwen3Config, params, kv_pages, tokens, positions, page_tables,
           seq_lens, plain_kernels: bool = False):
    """One decode step for a batch, with ``decode_wa``'s semantics: attention
    reads the past from the pages plus the current token's in-flight k/v,
    and each layer then writes that k/v into the pool in place.

    tokens, positions, seq_lens: [B] int32 — seq_lens counts tokens
    INCLUDING the one processed this step. page_tables: [B, P] int32;
    padding rows use the null page, position 0 and seq_len 0.
    Returns logits [B, V] f32.
    """
    B = tokens.shape[0]
    ps = kv_pages.shape[4]
    x = params["embed"][tokens.long()]
    cos, sin = _rope(cfg, positions, x.dtype)
    pos = positions.long()
    page_ids = torch.gather(page_tables.long(), 1, (pos // ps)[:, None])[:, 0]
    slots = pos % ps
    scale = _scale(cfg)
    for li in range(cfg.num_hidden_layers):
        lw = _layer(params, li)
        h = rms_norm(x, lw["input_ln"], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, lw, h, cos, sin, plain_kernels)
        o = decode_attention(kv_pages, li, q, k, v, page_tables, seq_lens, scale,
                              plain_kernels)
        _write_kv(kv_pages, li, k, v, page_ids, slots)
        x = x + _proj(lw, "wo", o.reshape(B, -1), plain_kernels)
        h = rms_norm(x, lw["post_ln"], cfg.rms_norm_eps)
        x = x + _mlp(lw, h, plain_kernels)
    x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
    return _head(params, x, plain_kernels)
