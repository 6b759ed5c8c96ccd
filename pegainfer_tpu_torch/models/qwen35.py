"""Qwen3.5 hybrid (Gated Delta Net + gated full attention) forward in
PyTorch; counterpart of ``pegainfer_tpu/models/qwen35.py``.

Layers repeat with a period p: (p - 1) linear-attention (GDN) layers, then
one full-attention layer; the G = L / p groups keep the JAX package's
grouped parameter tree, leaves stacked [G, p - 1, ...] under ``"lin"`` and
[G, ...] under ``"full"``, projections [in, out], so ``params_from_jax`` is
a copy. Every norm but the GDN output norm is the zero-centered RMSNorm
(scale 1 + w).

Per-request state (``make_state``):

- ``kv``   [G, Hkv, pages, 2, ps, hd]       paged KV of the full-attention layers
- ``rec``  [G, p-1, S+1, Hv, dk, dv] f32    GDN recurrent state a slot
- ``conv`` [G, p-1, S+1, K, conv_dim] f32   conv window a slot (the last K inputs)

with S = max_slots; row S is the dead slot that padded decode rows read and
write. A prefill writes its slot's rows whole, so a reused slot carries
nothing over; so does a chunked prompt's first piece (``start_pos`` 0 starts
from zeros), while a later piece continues from the slot's rows. PyTorch
updates the state in place: each layer writes its rows right after
computing them (the JAX ``pend`` / ``cpend`` records exist only to keep XLA
from copying the state). Decode has ``decode_wa``'s semantics: K1 reads the
past from the pages plus the in-flight k/v. ``slot_export`` /
``slot_import`` copy a slot's rows out and in (the prefix cache's state
snapshots).

Full attention goes through the kernel wrappers (K2 in prefill and, at
``q_offset`` = the piece's start, in a chunk; K1 in decode and for a fused
piece's decode rows): a CUDA tensor launches the kernel, a CPU tensor takes
the plain version. The GDN layers are torch ops (``ops/gdn.py``).

The int8 weight-only mode (``quantize_params_int8``, the JAX package's
``quantize="int8"``): every projection but ``wb`` / ``wa`` and the head go
through ``qwen3._proj`` (an int8 container through
``ops/quant.py::int8_linear``, decode-shaped rows on the int8 linear
kernel); the projections that read the same rows are one launch
(``ops/quant.py::int8_linears``: the GDN layer's wq, wk, wv and wz, the full
layer's wq, wgate, wk and wv). ``plain_kernels=True`` runs every kernel's
plain version (K1, K2, the int8 linear) on any device.

Tensor parallelism (``tp``, a rank's ``parallel/group.py::RankGroups``):
each rank holds its shard (``parallel/sharding.py::shard_qwen35``) and runs
these functions at its ``local_config_qwen35`` on a state made there (its
value heads' recurrent rows, its own conv channels ``q_r ‖ k_r ‖ v_r``, its
kv heads' pages). out_proj, the full layers' wo and every mlp_down keep
their partial sums f32 and reduce them across the ranks before one rounding
(``qwen3._row_proj``), and the head's vocab shards are gathered
(``qwen3._head``): 2 collectives a layer and 1 a forward, so every rank
holds the same logits bit for bit. ``tp=None`` is the one-process
forward.

Not ported here: the fused ``qkvzba`` / ``qgkv`` layout and the flat union
layout (the executor refuses the options that need them).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from pegainfer_tpu_torch.models import qwen3 as q3
from pegainfer_tpu_torch.models.qwen3 import (_proj, _projs, chunk_attention, chunk_rows,
                                              decode_attention)
from pegainfer_tpu_torch.ops import attention as att
from pegainfer_tpu_torch.ops import gdn, quant
from pegainfer_tpu_torch.ops.cuda.flash_prefill import flash_prefill
from pegainfer_tpu_torch.ops.norm import rms_norm_zero_centered as rms_norm
from pegainfer_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from pegainfer_tpu_torch.utils.weights import numpy_to_torch


@dataclass(frozen=True)
class Qwen35Config:
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    vocab_size: int
    rms_norm_eps: float
    rope_theta: float
    partial_rotary_factor: float
    layer_types: tuple
    linear_num_key_heads: int
    linear_num_value_heads: int
    linear_key_head_dim: int
    linear_value_head_dim: int
    linear_conv_kernel_dim: int
    tie_word_embeddings: bool
    eos_token_id: int = 151645
    stop_token_ids: tuple = ()
    max_position_embeddings: int = 262144

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @property
    def key_dim(self) -> int:
        return self.linear_num_key_heads * self.linear_key_head_dim

    @property
    def value_dim(self) -> int:
        return self.linear_num_value_heads * self.linear_value_head_dim

    @property
    def conv_dim(self) -> int:
        return 2 * self.key_dim + self.value_dim

    @property
    def period(self) -> int:
        """Length of the periodic layer pattern ((p-1) linear + 1 full)."""
        p = self.layer_types.index("full_attention") + 1
        expected = ("linear_attention",) * (p - 1) + ("full_attention",)
        if self.layer_types != expected * (len(self.layer_types) // p):
            raise ValueError(f"layer pattern not periodic: {self.layer_types}")
        return p

    @property
    def num_groups(self) -> int:
        return self.num_hidden_layers // self.period

    @staticmethod
    def from_hf(cfg: Any) -> "Qwen35Config":
        """From a transformers Qwen3NextConfig instance."""
        eos = cfg.eos_token_id
        if isinstance(eos, (list, tuple)):
            stop, eos = tuple(eos), eos[0]
        else:
            stop = (eos,) if eos is not None else ()
        return Qwen35Config(
            hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size,
            num_hidden_layers=cfg.num_hidden_layers,
            num_attention_heads=cfg.num_attention_heads,
            num_key_value_heads=cfg.num_key_value_heads,
            head_dim=cfg.head_dim,
            vocab_size=cfg.vocab_size,
            rms_norm_eps=cfg.rms_norm_eps,
            rope_theta=cfg.rope_theta,
            partial_rotary_factor=getattr(cfg, "partial_rotary_factor", 0.25),
            layer_types=tuple(cfg.layer_types),
            linear_num_key_heads=cfg.linear_num_key_heads,
            linear_num_value_heads=cfg.linear_num_value_heads,
            linear_key_head_dim=cfg.linear_key_head_dim,
            linear_value_head_dim=cfg.linear_value_head_dim,
            linear_conv_kernel_dim=cfg.linear_conv_kernel_dim,
            tie_word_embeddings=cfg.tie_word_embeddings,
            eos_token_id=eos,
            stop_token_ids=stop,
            max_position_embeddings=getattr(cfg, "max_position_embeddings", 262144),
        )

    @staticmethod
    def from_model_path(model_path: str) -> "Qwen35Config":
        """From a checkpoint directory's config.json (flat, or nested under
        ``text_config`` as Qwen3.5 checkpoints have it) and its
        generation_config.json's stop ids."""
        with open(os.path.join(model_path, "config.json")) as f:
            c = json.load(f)
        t = c.get("text_config", c)
        rope = t.get("rope_parameters", {})
        theta = rope.get("rope_theta", t.get("rope_theta", 1e7))
        prf = rope.get("partial_rotary_factor", t.get("partial_rotary_factor", 0.25))
        eos = t.get("eos_token_id", c.get("eos_token_id"))
        stop = tuple(eos) if isinstance(eos, list) else ((eos,) if eos else ())
        gen_path = os.path.join(model_path, "generation_config.json")
        if os.path.exists(gen_path):
            with open(gen_path) as f:
                g = json.load(f).get("eos_token_id", None)
            if g is not None:
                stop = tuple(g) if isinstance(g, list) else (g,)
        return Qwen35Config(
            hidden_size=t["hidden_size"],
            intermediate_size=t["intermediate_size"],
            num_hidden_layers=t["num_hidden_layers"],
            num_attention_heads=t["num_attention_heads"],
            num_key_value_heads=t["num_key_value_heads"],
            head_dim=t["head_dim"],
            vocab_size=t["vocab_size"],
            rms_norm_eps=t["rms_norm_eps"],
            rope_theta=theta,
            partial_rotary_factor=prf,
            layer_types=tuple(t["layer_types"]),
            linear_num_key_heads=t["linear_num_key_heads"],
            linear_num_value_heads=t["linear_num_value_heads"],
            linear_key_head_dim=t["linear_key_head_dim"],
            linear_value_head_dim=t["linear_value_head_dim"],
            linear_conv_kernel_dim=t["linear_conv_kernel_dim"],
            tie_word_embeddings=t.get("tie_word_embeddings", False),
            eos_token_id=stop[0] if stop else None,
            stop_token_ids=stop,
            max_position_embeddings=t.get("max_position_embeddings", 262144),
        )


def bench_config() -> Qwen35Config:
    """The JAX package's Qwen3.5-4B-class shapes (its ``bench_config``):
    period 4 (3 GDN + 1 full) x 8 groups = 32 layers, hidden 2048, full
    attention 16 / 2 heads of 256 with partial RoPE 0.25, GDN 16 key and 32
    value heads of 128, conv kernel 4, vocab 151,936."""
    return Qwen35Config(
        hidden_size=2048, intermediate_size=6144, num_hidden_layers=32,
        num_attention_heads=16, num_key_value_heads=2, head_dim=256,
        vocab_size=151936, rms_norm_eps=1e-6, rope_theta=1e7,
        partial_rotary_factor=0.25,
        layer_types=("linear_attention",) * 3 + ("full_attention",),
        linear_num_key_heads=16, linear_num_value_heads=32,
        linear_key_head_dim=128, linear_value_head_dim=128,
        linear_conv_kernel_dim=4, tie_word_embeddings=True,
    )


# ── Params ───────────────────────────────────────────────────────────────
# {
#   "embed": [V, D],
#   "lin":  {input_ln [G, p-1, D], wq / wk [.., D, Hk*dk], wv / wz [.., D, Hv*dv],
#            wb / wa [.., D, Hv], conv_w [.., conv_dim, K] f32, dt_bias / A_log
#            [.., Hv] f32, norm_w [.., dv], out_proj [.., Hv*dv, D], post_ln,
#            mlp_gate_up [.., D, 2I] (gate ‖ up), mlp_down [.., I, D]},
#   "full": {input_ln [G, D], wq / wgate [G, D, Hq*hd], wk / wv [G, D, Hkv*hd],
#            q_norm / k_norm [G, hd], wo [G, Hq*hd, D], post_ln, mlp_gate_up,
#            mlp_down},
#   "final_ln": [D],
#   "lm_head": [D, V],
# }
# In the int8 weight-only mode (``quantize_params_int8``) the INT8_LIN /
# INT8_FULL projections and the head are containers {"q": int8 [.., out,
# in], "s": f32 [.., out]} (ops/quant.py).

F32_KEYS = ("dt_bias", "A_log", "conv_w")  # kept f32 whatever the weights' dtype
_NORM_KEYS = ("input_ln", "post_ln", "q_norm", "k_norm", "norm_w")


def _shapes(cfg: Qwen35Config):
    """Leaf shapes in the JAX ``init_bench_params`` order (its draw order)."""
    G, pl_ = cfg.num_groups, cfg.period - 1
    D, I = cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    Hv = cfg.linear_num_value_heads
    kd, vd, K = cfg.key_dim, cfg.value_dim, cfg.linear_conv_kernel_dim
    lin = {
        "input_ln": (G, pl_, D),
        "wq": (G, pl_, D, kd), "wk": (G, pl_, D, kd),
        "wv": (G, pl_, D, vd), "wz": (G, pl_, D, vd),
        "wb": (G, pl_, D, Hv), "wa": (G, pl_, D, Hv),
        "conv_w": (G, pl_, cfg.conv_dim, K),
        "dt_bias": (G, pl_, Hv), "A_log": (G, pl_, Hv),
        "norm_w": (G, pl_, cfg.linear_value_head_dim),
        "out_proj": (G, pl_, vd, D),
        "post_ln": (G, pl_, D),
        "mlp_gate_up": (G, pl_, D, 2 * I), "mlp_down": (G, pl_, I, D),
    }
    full = {
        "input_ln": (G, D),
        "wq": (G, D, Hq * hd), "wgate": (G, D, Hq * hd),
        "wk": (G, D, Hkv * hd), "wv": (G, D, Hkv * hd),
        "q_norm": (G, hd), "k_norm": (G, hd),
        "wo": (G, Hq * hd, D),
        "post_ln": (G, D),
        "mlp_gate_up": (G, D, 2 * I), "mlp_down": (G, I, D),
    }
    return lin, full


def _tensor(x, dtype, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else numpy_to_torch(x)
    return t.to(device=device, dtype=t.dtype if dtype is None else dtype)


def _leaf_dtype(key, dtype):
    return torch.float32 if key in F32_KEYS else dtype


def _split_qkvz(cfg: Qwen35Config, w: torch.Tensor):
    """HF in_proj_qkvz [Hk*(2dk + 2R dv), D] -> Wq, Wk, Wv, Wz in [D, out]
    (a pure row reorder)."""
    Hk, dk = cfg.linear_num_key_heads, cfg.linear_key_head_dim
    Hv, dv = cfg.linear_num_value_heads, cfg.linear_value_head_dim
    R = Hv // Hk
    wh = w.reshape(Hk, 2 * dk + 2 * R * dv, -1)
    parts = (wh[:, :dk].reshape(Hk * dk, -1), wh[:, dk:2 * dk].reshape(Hk * dk, -1),
             wh[:, 2 * dk:2 * dk + R * dv].reshape(Hv * dv, -1),
             wh[:, 2 * dk + R * dv:].reshape(Hv * dv, -1))
    return tuple(p.T for p in parts)


def _split_ba(cfg: Qwen35Config, w: torch.Tensor):
    """HF in_proj_ba [Hk*2R, D] -> Wb, Wa in [D, Hv]."""
    Hk = cfg.linear_num_key_heads
    R = cfg.linear_num_value_heads // Hk
    wh = w.reshape(Hk, 2 * R, -1)
    return wh[:, :R].reshape(Hk * R, -1).T, wh[:, R:].reshape(Hk * R, -1).T


def _split_q_gate(cfg: Qwen35Config, w: torch.Tensor):
    """HF full-attention q_proj [Hq*2hd, D] -> Wq, Wgate in [D, Hq*hd]."""
    Hq, hd = cfg.num_attention_heads, cfg.head_dim
    wh = w.reshape(Hq, 2 * hd, -1)
    return wh[:, :hd].reshape(Hq * hd, -1).T, wh[:, hd:].reshape(Hq * hd, -1).T


def params_from_state_dict(cfg: Qwen35Config, sd: Dict[str, Any],
                           dtype=torch.bfloat16, device="cpu"):
    """The grouped tree from an HF Qwen3Next-named state dict (numpy arrays
    or torch tensors, HF [out, in] layout). ``dt_bias``, ``A_log`` and
    ``conv_w`` stay f32; a tied ``lm_head`` is a view of ``embed``."""
    p, G = cfg.period, cfg.num_groups

    def get(name):  # exact on the host, cast once per leaf
        return _tensor(sd[name], torch.float32, "cpu")

    def mlp(pre):
        return {"mlp_gate_up": torch.cat([get(f"{pre}.mlp.gate_proj.weight").T,
                                          get(f"{pre}.mlp.up_proj.weight").T], dim=1),
                "mlp_down": get(f"{pre}.mlp.down_proj.weight").T}

    def lin_layer(i):
        pre = f"model.layers.{i}"
        wq, wk, wv, wz = _split_qkvz(cfg, get(f"{pre}.linear_attn.in_proj_qkvz.weight"))
        wb, wa = _split_ba(cfg, get(f"{pre}.linear_attn.in_proj_ba.weight"))
        return {
            "input_ln": get(f"{pre}.input_layernorm.weight"),
            "wq": wq, "wk": wk, "wv": wv, "wz": wz, "wb": wb, "wa": wa,
            "conv_w": get(f"{pre}.linear_attn.conv1d.weight")[:, 0, :],  # [C, K]
            "dt_bias": get(f"{pre}.linear_attn.dt_bias"),
            "A_log": get(f"{pre}.linear_attn.A_log"),
            "norm_w": get(f"{pre}.linear_attn.norm.weight"),
            "out_proj": get(f"{pre}.linear_attn.out_proj.weight").T,
            "post_ln": get(f"{pre}.post_attention_layernorm.weight"),
            **mlp(pre),
        }

    def full_layer(i):
        pre = f"model.layers.{i}"
        wq, wg = _split_q_gate(cfg, get(f"{pre}.self_attn.q_proj.weight"))
        return {
            "input_ln": get(f"{pre}.input_layernorm.weight"),
            "wq": wq, "wgate": wg,
            "wk": get(f"{pre}.self_attn.k_proj.weight").T,
            "wv": get(f"{pre}.self_attn.v_proj.weight").T,
            "q_norm": get(f"{pre}.self_attn.q_norm.weight"),
            "k_norm": get(f"{pre}.self_attn.k_norm.weight"),
            "wo": get(f"{pre}.self_attn.o_proj.weight").T,
            "post_ln": get(f"{pre}.post_attention_layernorm.weight"),
            **mlp(pre),
        }

    lin_layers = [[lin_layer(g * p + j) for j in range(p - 1)] for g in range(G)]
    full_layers = [full_layer(g * p + p - 1) for g in range(G)]
    lin = {k: torch.stack([torch.stack([d[k] for d in grp]) for grp in lin_layers])
           .to(device=device, dtype=_leaf_dtype(k, dtype)) for k in lin_layers[0][0]}
    full = {k: torch.stack([d[k] for d in full_layers]).to(device=device, dtype=dtype)
            for k in full_layers[0]}
    embed = get("model.embed_tokens.weight").to(device=device, dtype=dtype)
    lm_head = (embed.T if cfg.tie_word_embeddings
               else get("lm_head.weight").T.contiguous().to(device=device, dtype=dtype))
    return {"embed": embed, "lin": lin, "full": full,
            "final_ln": get("model.norm.weight").to(device=device, dtype=dtype),
            "lm_head": lm_head}


def params_from_jax(jax_params, dtype=None, device="cpu"):
    """The JAX package's grouped Qwen3.5 tree (numpy leaves) as the port's
    parameters: the same layout, so a copy (an int8 weight-only leaf is
    transposed into the port's container, ``qwen3.leaf_from_jax``). ``dtype``
    None keeps each leaf's dtype; otherwise ``F32_KEYS`` stay f32 and the
    rest take ``dtype``."""
    def leaf(k, x):
        return q3.leaf_from_jax(x, None if dtype is None else _leaf_dtype(k, dtype), device)

    return {
        "embed": leaf("embed", jax_params["embed"]),
        "lin": {k: leaf(k, v) for k, v in jax_params["lin"].items()},
        "full": {k: leaf(k, v) for k, v in jax_params["full"].items()},
        "final_ln": leaf("final_ln", jax_params["final_ln"]),
        "lm_head": leaf("lm_head", jax_params["lm_head"]),
    }


def init_random_params(cfg: Qwen35Config, seed: int = 0, dtype=torch.bfloat16,
                       scale: float = 0.02, device="cpu"):
    """Random params drawn on the host with numpy as the JAX package's
    ``init_random_params`` draws them (``standard_normal`` in f32 times
    ``scale``, leaf by leaf in its order; norm weights kept at 1; an untied
    ``lm_head``): equal weights at f32."""
    rng = np.random.default_rng(seed)
    D, V = cfg.hidden_size, cfg.vocab_size

    def w(key, shape):
        if key in _NORM_KEYS:
            return torch.ones(shape, dtype=_leaf_dtype(key, dtype), device=device)
        arr = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(arr).to(device=device, dtype=_leaf_dtype(key, dtype))

    lin_s, full_s = _shapes(cfg)
    embed = w("embed", (V, D))
    lin = {k: w(k, s) for k, s in lin_s.items()}
    full = {k: w(k, s) for k, s in full_s.items()}
    return {"embed": embed, "lin": lin, "full": full,
            "final_ln": torch.ones(D, dtype=dtype, device=device),
            "lm_head": w("lm_head", (D, V))}


def init_random_params_device(cfg: Qwen35Config, generator: torch.Generator, device,
                              dtype=torch.bfloat16, scale: float = 0.02):
    """Random normal(0, scale) params filled on ``device`` from a seeded
    generator of that device, full-size weights in seconds; norm weights 1,
    ``F32_KEYS`` f32, an untied ``lm_head`` as the JAX tree has it."""
    D, V = cfg.hidden_size, cfg.vocab_size

    def w(key, shape):
        dt = _leaf_dtype(key, dtype)
        if key in _NORM_KEYS:
            return torch.ones(shape, dtype=dt, device=device)
        return torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, scale, generator=generator)

    lin_s, full_s = _shapes(cfg)
    return {"embed": w("embed", (V, D)),
            "lin": {k: w(k, s) for k, s in lin_s.items()},
            "full": {k: w(k, s) for k, s in full_s.items()},
            "final_ln": torch.ones(D, dtype=dtype, device=device),
            "lm_head": w("lm_head", (D, V))}


# the int8 weight-only mode's projections (the JAX quantize_params_int8's
# key lists, for the split layout)
INT8_LIN = ("wq", "wk", "wv", "wz", "out_proj", "mlp_gate_up", "mlp_down")
INT8_FULL = ("wq", "wgate", "wk", "wv", "wo", "mlp_gate_up", "mlp_down")


def quantize_params_int8(params):
    """The int8 weight-only mode (the JAX ``quantize_params_int8``, split
    layout): the GDN layers' ``INT8_LIN``, the full layers' ``INT8_FULL``
    and the head become int8 containers (``quantize_int8_linear``, the JAX
    codes exactly); ``wb``, ``wa``, the conv, the gates, the norms and the
    embedding stay. CONSUMES ``params`` as ``qwen3.quantize_params_int8``
    does (each matrix replaced in the tree as it goes). Returns the tree."""
    for part, keys in (("lin", INT8_LIN), ("full", INT8_FULL)):
        for k in keys:
            params[part][k] = quant.quantize_int8_linear(params[part][k])
    params["lm_head"] = quant.quantize_int8_linear(params["lm_head"])
    return params


def params_bytes(params) -> int:
    return q3.tensor_bytes([params["embed"], params["final_ln"], *params["lin"].values(),
                            *params["full"].values(), params["lm_head"]])


# ── State ────────────────────────────────────────────────────────────────


def make_state(cfg: Qwen35Config, num_pages: int, page_size: int, max_slots: int,
               kv_dtype=torch.bfloat16, device="cpu"):
    """The KV pool and ``max_slots`` + 1 rows (the last the dead slot) of
    recurrent and conv state, all zero."""
    G, pl_ = cfg.num_groups, cfg.period - 1
    return {
        "kv": torch.zeros((G, cfg.num_key_value_heads, num_pages, 2, page_size,
                           cfg.head_dim), dtype=kv_dtype, device=device),
        "rec": torch.zeros((G, pl_, max_slots + 1, cfg.linear_num_value_heads,
                            cfg.linear_key_head_dim, cfg.linear_value_head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((G, pl_, max_slots + 1, cfg.linear_conv_kernel_dim,
                             cfg.conv_dim), dtype=torch.float32, device=device),
    }


def kv_bytes_per_page(cfg: Qwen35Config, page_size: int, dtype=torch.bfloat16) -> int:
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (cfg.num_groups * 2 * page_size * cfg.num_key_value_heads * cfg.head_dim
            * itemsize)


def slot_bytes(cfg: Qwen35Config) -> int:
    """Bytes of one slot's recurrent and conv state (f32, every GDN layer)."""
    per_layer = (cfg.linear_num_value_heads * cfg.linear_key_head_dim
                 * cfg.linear_value_head_dim + cfg.linear_conv_kernel_dim * cfg.conv_dim)
    return cfg.num_groups * (cfg.period - 1) * per_layer * 4


# ── Forward building blocks ──────────────────────────────────────────────


def _mlp(lw, x, pk: bool, tp=None):
    gate, up = _proj(lw, "mlp_gate_up", x, pk).chunk(2, dim=-1)
    return q3._row_proj(lw, "mlp_down", F.silu(gate.float()).to(x.dtype) * up, pk, tp)


def _gdn_project(cfg: Qwen35Config, lw, h, pk: bool):
    """h: [N, D] -> the conv input [N, conv_dim] (q ‖ k ‖ v), z [N, Hv, dv],
    g and beta [N, Hv] f32."""
    Hv, dv = cfg.linear_num_value_heads, cfg.linear_value_head_dim
    if quant.is_quantized(lw["wq"]):
        # the four projections of h side by side from one int8 launch on
        # decode rows: mixed and z are views of its output, no copy
        y = quant.int8_linears(h, [lw[k] for k in ("wq", "wk", "wv", "wz")], pk, joined=True)
        mixed, z = y[:, :cfg.conv_dim], y[:, cfg.conv_dim:]
    else:
        mixed = torch.cat([h @ lw[k] for k in ("wq", "wk", "wv")], dim=-1)
        z = h @ lw["wz"]
    z = z.reshape(-1, Hv, dv)
    beta = torch.sigmoid((h @ lw["wb"]).float())
    g = -torch.exp(lw["A_log"].float()) * F.softplus(
        (h @ lw["wa"]).float() + lw["dt_bias"].float())
    return mixed, z, g, beta


def _gdn_split_heads(cfg: Qwen35Config, mixed):
    """Post-conv [N, conv_dim] -> q, k repeated to Hv heads; v [N, Hv, dv]."""
    Hk, dk = cfg.linear_num_key_heads, cfg.linear_key_head_dim
    Hv, dv = cfg.linear_num_value_heads, cfg.linear_value_head_dim
    R = Hv // Hk
    kd = cfg.key_dim
    q = mixed[:, :kd].reshape(-1, Hk, dk)
    k = mixed[:, kd:2 * kd].reshape(-1, Hk, dk)
    v = mixed[:, 2 * kd:].reshape(-1, Hv, dv)
    if R > 1:
        q = q.repeat_interleave(R, dim=1)
        k = k.repeat_interleave(R, dim=1)
    return q, k, v


def _gated_norm(cfg: Qwen35Config, norm_w, out, z):
    """HF RMSNormGated: a per-head RMSNorm with the plain weight (not 1 + w),
    applied after the cast to z's dtype, then x silu(z) in f32."""
    of = out.float()
    var = (of * of).mean(dim=-1, keepdim=True)
    normed = (of * torch.rsqrt(var + cfg.rms_norm_eps)).to(z.dtype) * norm_w
    return normed.float() * F.silu(z.float())


def _rope(cfg: Qwen35Config, positions: torch.Tensor, dtype):
    """cos / sin [N, rotary_dim] of the partial RoPE (inv_freq made once a
    device, as Qwen3's: a CUDA graph cannot capture a host copy)."""
    return rope_cos_sin(positions, q3._inv_freq(cfg.rotary_dim, cfg.rope_theta,
                                                positions.device), dtype)


def _full_qkv(cfg: Qwen35Config, fw, h, cos, sin, pk: bool):
    """Full-attention projections: q [N, Hq, hd] and its gate [N, Hq*hd]
    from q_proj, k / v [N, Hkv, hd]; q and k normed, then RoPE over their
    first ``rotary_dim`` dims."""
    N, hd = h.shape[0], cfg.head_dim
    q, gate, k, v = _projs(fw, ("wq", "wgate", "wk", "wv"), h, pk)
    q = q.reshape(N, cfg.num_attention_heads, hd)
    k = k.reshape(N, cfg.num_key_value_heads, hd)
    v = v.reshape(N, cfg.num_key_value_heads, hd)
    q = rms_norm(q, fw["q_norm"], cfg.rms_norm_eps)
    k = rms_norm(k, fw["k_norm"], cfg.rms_norm_eps)
    rd = cfg.rotary_dim
    q = torch.cat([apply_rope(q[..., :rd], cos, sin), q[..., rd:]], dim=-1)
    k = torch.cat([apply_rope(k[..., :rd], cos, sin), k[..., rd:]], dim=-1)
    return q, k, v, gate


def _gated_out(fw, x, o, gate, pk: bool, tp=None):
    """x + wo (o ∘ sigmoid(gate)), the sigmoid in f32 cast to x's dtype."""
    o = o.reshape(x.shape[0], -1) * torch.sigmoid(gate.float()).to(x.dtype)
    return x + q3._row_proj(fw, "wo", o, pk, tp)


def _write_kv(kv, gi: int, k, v, page_ids, slots):
    """Write rows k / v [N, Hkv, hd] at (page_ids[n], slots[n]) of group gi."""
    layer = kv[gi]  # [Hkv, pages, 2, ps, hd]
    layer[:, :, 0][:, page_ids, slots] = k.transpose(0, 1).to(kv.dtype)
    layer[:, :, 1][:, page_ids, slots] = v.transpose(0, 1).to(kv.dtype)


def _at(v, i):
    """A leaf at index i of its leading axes (an int8 container's q and s
    alike)."""
    return {"q": v["q"][i], "s": v["s"][i]} if quant.is_quantized(v) else v[i]


def _lin_weights(params, gi: int, j: int):
    return {k: _at(v, (gi, j)) for k, v in params["lin"].items()}


def _full_weights(params, gi: int):
    return {k: _at(v, gi) for k, v in params["full"].items()}


def _gdn_step_rows(cfg: Qwen35Config, lw, state, gi: int, j: int, rows, mixed, g, beta):
    """The GDN core of one token a row (decode rows): conv step and
    recurrence step from the rows' slots ``rows`` [B] of layer (gi, j),
    written back in place. Returns out [B, Hv, dv] f32."""
    conv, rec = state["conv"][gi, j], state["rec"][gi, j]  # views
    y, conv_rows = gdn.causal_conv1d_step(mixed, lw["conv_w"], conv[rows])
    q, k, v = _gdn_split_heads(cfg, y)
    out, rec_rows = gdn.gdn_step(q, k, v, g, beta, rec[rows])
    conv[rows] = conv_rows
    rec[rows] = rec_rows
    return out


def _gdn_chunk_rows(cfg: Qwen35Config, lw, state, gi: int, j: int, slot: int,
                    start_pos: int, mixed, g, beta, gdn_chunk_size: int):
    """The GDN core of a prompt's chunk (its rows, no padding): conv
    continuation and the chunkwise rule from the slot's rows of layer
    (gi, j), or from zeros when the chunk starts the prompt (a recycled
    slot holds the previous request's state), written back in place.
    Returns out [Tc, Hv, dv] f32."""
    conv, rec = state["conv"][gi, j], state["rec"][gi, j]  # views
    if start_pos > 0:
        conv0, rec0 = conv[slot], rec[slot]
    else:
        conv0, rec0 = torch.zeros_like(conv[slot]), torch.zeros_like(rec[slot])
    y, conv_state = gdn.causal_conv1d_cont(mixed, lw["conv_w"], conv0, mixed.shape[0])
    q, k, v = _gdn_split_heads(cfg, y)
    out, rec_state = gdn.gdn_chunk(q, k, v, g, beta, rec0, chunk=gdn_chunk_size)
    conv[slot] = conv_state
    rec[slot] = rec_state
    return out


# ── Prefill: one request ─────────────────────────────────────────────────


def prefill(cfg: Qwen35Config, params, state, tokens, page_table, slot: int,
            return_all_logits: bool = False, plain_kernels: bool = False,
            gdn_chunk_size: int = gdn.CHUNK, tp=None):
    """Prefill one prompt: write its KV into the pool and its slot's
    recurrent and conv rows (whole), in place.

    tokens: [T] int (the prompt, unpadded); page_table: [>= ceil(T/ps)] int
    pages of this request; slot: its state slot; ``tp``: a rank's groups
    (module docstring). Returns (last_logits [V] f32, all_logits [T, V] f32
    | None).
    """
    T = tokens.shape[0]
    eps = cfg.rms_norm_eps
    ps = state["kv"].shape[4]
    x = params["embed"][tokens.long()]
    positions = torch.arange(T, device=x.device)
    cos, sin = _rope(cfg, positions, x.dtype)
    page_ids = page_table.long()[positions // ps]
    pslots = positions % ps
    scale = cfg.head_dim ** -0.5
    S0 = torch.zeros((cfg.linear_num_value_heads, cfg.linear_key_head_dim,
                      cfg.linear_value_head_dim), dtype=torch.float32, device=x.device)
    for gi in range(cfg.num_groups):
        for j in range(cfg.period - 1):
            lw = _lin_weights(params, gi, j)
            mixed, z, g, beta = _gdn_project(cfg, lw, rms_norm(x, lw["input_ln"], eps), plain_kernels)
            y, conv_state = gdn.causal_conv1d(mixed, lw["conv_w"])
            q, k, v = _gdn_split_heads(cfg, y)
            out, rec_state = gdn.gdn_chunk(q, k, v, g, beta, S0, chunk=gdn_chunk_size)
            state["conv"][gi, j, slot] = conv_state
            state["rec"][gi, j, slot] = rec_state
            out = _gated_norm(cfg, lw["norm_w"], out, z).to(x.dtype)
            x = x + q3._row_proj(lw, "out_proj", out.reshape(T, -1), plain_kernels, tp)
            x = x + _mlp(lw, rms_norm(x, lw["post_ln"], eps), plain_kernels, tp)
        fw = _full_weights(params, gi)
        q, k, v, gate = _full_qkv(cfg, fw, rms_norm(x, fw["input_ln"], eps), cos, sin,
                                  plain_kernels)
        if plain_kernels:
            o = att.prefill_attention(q, k, v, T, scale)
        else:
            o = flash_prefill(q, k, v, T, scale)
        _write_kv(state["kv"], gi, k, v, page_ids, pslots)
        x = _gated_out(fw, x, o, gate, plain_kernels, tp)
        x = x + _mlp(fw, rms_norm(x, fw["post_ln"], eps), plain_kernels, tp)
    if return_all_logits:
        all_logits = q3._head(params, rms_norm(x, params["final_ln"], eps), plain_kernels, tp)
        return all_logits[T - 1], all_logits
    return q3._head(params, rms_norm(x[T - 1:], params["final_ln"], eps), plain_kernels,
                    tp)[0], None


# ── Chunked prefill continuation and the fused mixed step ────────────────


def _chunk_forward(cfg: Qwen35Config, params, state, chunk_tokens, start_pos: int,
                   valid: int, page_table, slot: int, dec, plain_kernels: bool,
                   gdn_chunk_size: int, all_rows: bool = False, tp=None):
    """A prompt's chunk of ``valid`` rows, and with ``dec`` = (tokens,
    positions, page tables, seq_lens, slots) one decode row per stream,
    through shared GEMMs; only the sequence mixing splits. Returns logits
    [1 + B, V] f32: chunk row ``valid - 1``, then the decode rows; with
    ``all_rows`` every chunk row's first, [valid + B, V]."""
    eps = cfg.rms_norm_eps
    kv = state["kv"]
    ps = kv.shape[4]
    positions, page_ids, pslots = chunk_rows(page_table, start_pos, valid, ps)
    toks = chunk_tokens[:valid]
    if dec is not None:
        dec_tokens, dec_positions, dec_tables, dec_seq_lens, dec_slots = dec
        toks = torch.cat([toks, dec_tokens.to(toks.dtype)])
        positions = torch.cat([positions, dec_positions.to(positions.dtype)])
        dpos = dec_positions.long()
        dec_page_ids = torch.gather(dec_tables.long(), 1, (dpos // ps)[:, None])[:, 0]
        dec_pslots = dpos % ps
        rows = dec_slots.long()
    x = params["embed"][toks.long()]
    N = x.shape[0]
    cos, sin = _rope(cfg, positions, x.dtype)
    scale = cfg.head_dim ** -0.5
    for gi in range(cfg.num_groups):
        for j in range(cfg.period - 1):
            lw = _lin_weights(params, gi, j)
            mixed, z, g, beta = _gdn_project(cfg, lw, rms_norm(x, lw["input_ln"], eps), plain_kernels)
            out = _gdn_chunk_rows(cfg, lw, state, gi, j, slot, start_pos, mixed[:valid],
                                  g[:valid], beta[:valid], gdn_chunk_size)
            if dec is not None:
                out = torch.cat([out, _gdn_step_rows(cfg, lw, state, gi, j, rows,
                                                     mixed[valid:], g[valid:],
                                                     beta[valid:])])
            out = _gated_norm(cfg, lw["norm_w"], out, z).to(x.dtype)
            x = x + q3._row_proj(lw, "out_proj", out.reshape(N, -1), plain_kernels, tp)
            x = x + _mlp(lw, rms_norm(x, lw["post_ln"], eps), plain_kernels, tp)
        fw = _full_weights(params, gi)
        q, k, v, gate = _full_qkv(cfg, fw, rms_norm(x, fw["input_ln"], eps), cos, sin,
                                  plain_kernels)
        _write_kv(kv, gi, k[:valid], v[:valid], page_ids, pslots)
        o = chunk_attention(kv, gi, q[:valid], page_table, start_pos, scale,
                            plain_kernels).reshape(valid, -1)
        if dec is not None:
            qd, kd, vd = q[valid:], k[valid:], v[valid:]
            o_d = decode_attention(kv, gi, qd, kd, vd, dec_tables, dec_seq_lens, scale,
                                   plain_kernels)
            _write_kv(kv, gi, kd, vd, dec_page_ids, dec_pslots)
            o = torch.cat([o, o_d.reshape(N - valid, -1)])
        x = _gated_out(fw, x, o, gate, plain_kernels, tp)
        x = x + _mlp(fw, rms_norm(x, fw["post_ln"], eps), plain_kernels, tp)
    x = rms_norm(x if all_rows else x[valid - 1:], params["final_ln"], eps)  # ‖ B
    return q3._head(params, x, plain_kernels, tp)


def prefill_chunk(cfg: Qwen35Config, params, state, tokens, start_pos: int, valid: int,
                  page_table, slot: int, plain_kernels: bool = False,
                  gdn_chunk_size: int = gdn.CHUNK, return_all_logits: bool = False,
                  tp=None):
    """Prefill continuation: prompt positions ``[start_pos, start_pos +
    valid)`` of one request whose earlier positions are in its pages and its
    slot's rows, written in place (the function of the JAX
    ``prefill_chunk_wa`` followed by ``flush_chunk_pend``).

    GDN layers continue from the slot's rec / conv rows, or from zeros at
    ``start_pos`` 0, and write them back; full layers write the chunk's k/v
    rows into the pool, then attend over the gathered pages (K2 at
    ``q_offset`` = ``start_pos``). tokens: [>= valid] (rows past ``valid``
    are ignored); page_table: [>= ceil((start_pos + valid) / ps)] the
    request's pages. Returns last_logits [V] f32, for chunk row
    ``valid - 1``; with ``return_all_logits`` (the JAX
    ``prefill_chunk_wa_all``, for echo's prompt logprobs) the logits of
    every chunk row [valid, V] f32, the last row those last logits.
    ``tp``: a rank's groups (module docstring).
    """
    logits = _chunk_forward(cfg, params, state, tokens, start_pos, valid, page_table, slot,
                            None, plain_kernels, gdn_chunk_size, return_all_logits, tp)
    return logits if return_all_logits else logits[0]


def mixed_chunk(cfg: Qwen35Config, params, state, chunk_tokens, start_pos: int,
                valid: int, page_table, slot: int, dec_tokens, dec_positions, dec_tables,
                dec_seq_lens, dec_slots, plain_kernels: bool = False,
                gdn_chunk_size: int = gdn.CHUNK, tp=None):
    """The fused mixed step: a prompt's chunk rows and one decode row per
    active stream through shared GEMMs (the JAX ``mixed_chunk_wa`` and both
    flushes). The chunk rows are ``prefill_chunk``'s; the decode rows are
    ``decode``'s (conv and recurrence steps on their slots, K1 over the
    pages with the in-flight k/v at ``layer_id`` = the group; padding rows
    on the dead slot). The prefilling request's slot is never among
    ``dec_slots``. Arguments as in ``prefill_chunk`` and ``decode``, ``tp``
    a rank's groups (module docstring).
    Returns (last_logits [V] f32 for chunk row ``valid - 1``, dec_logits
    [B, V] f32).
    """
    logits = _chunk_forward(cfg, params, state, chunk_tokens, start_pos, valid, page_table,
                            slot, (dec_tokens, dec_positions, dec_tables, dec_seq_lens,
                                   dec_slots), plain_kernels, gdn_chunk_size, tp=tp)
    return logits[0], logits[1:]


# ── Slot snapshots (the hybrid prefix cache) ─────────────────────────────


def export_pages(state, page_ids):
    """Gather whole pages of the full-attention layers for a PD handoff
    (the JAX ``export_pages``): kv [G, Hkv, pages, 2, ps, hd] x ids [n],
    a copy."""
    return q3.export_pages(state["kv"], page_ids)


def import_pages(state, rows, page_ids) -> None:
    """Scatter handed-off page rows into ``page_ids`` in place, in one
    indexed copy (the JAX ``import_pages``)."""
    q3.import_pages(state["kv"], rows, page_ids)


def slot_export(state, slot: int):
    """A copy of ``slot``'s recurrent and conv rows of every GDN layer
    (the JAX ``slot_export`` / ``cpend_snapshot``): later pieces overwrite
    the slot in place, so a view would change under the cache."""
    return {"rec": state["rec"][:, :, slot].clone(), "conv": state["conv"][:, :, slot].clone()}


def slot_import(state, snap, slot: int) -> None:
    """Copy a snapshot into ``slot``'s rows (the JAX ``slot_import`` /
    ``cpend_restore``); the snapshot stays the cache's."""
    state["rec"][:, :, slot].copy_(snap["rec"])
    state["conv"][:, :, slot].copy_(snap["conv"])


# ── Batched decode: one token per request ────────────────────────────────


def decode(cfg: Qwen35Config, params, state, tokens, positions, page_tables, seq_lens,
           slots, plain_kernels: bool = False, tp=None):
    """One decode step for a batch, with ``decode_wa``'s semantics: each GDN
    layer reads its rows of ``slots`` and writes them back in place, and
    each full layer attends over the pages plus the current token's
    in-flight k/v (K1, ``layer_id`` = the group), then writes that k/v.

    tokens, positions, seq_lens, slots: [B] int32 — seq_lens counts tokens
    INCLUDING this one; page_tables: [B, P] int32. Padding rows carry
    seq_len 0, position 0, the null page and the dead slot (``max_slots``);
    live rows carry distinct slots; ``tp``: a rank's groups (module
    docstring). Returns logits [B, V] f32.
    """
    B = tokens.shape[0]
    eps = cfg.rms_norm_eps
    kv = state["kv"]
    ps = kv.shape[4]
    x = params["embed"][tokens.long()]
    cos, sin = _rope(cfg, positions, x.dtype)
    pos = positions.long()
    page_ids = torch.gather(page_tables.long(), 1, (pos // ps)[:, None])[:, 0]
    pslots = pos % ps
    rows = slots.long()
    scale = cfg.head_dim ** -0.5
    for gi in range(cfg.num_groups):
        for j in range(cfg.period - 1):
            lw = _lin_weights(params, gi, j)
            mixed, z, g, beta = _gdn_project(cfg, lw, rms_norm(x, lw["input_ln"], eps), plain_kernels)
            out = _gdn_step_rows(cfg, lw, state, gi, j, rows, mixed, g, beta)
            out = _gated_norm(cfg, lw["norm_w"], out, z).to(x.dtype)
            x = x + q3._row_proj(lw, "out_proj", out.reshape(B, -1), plain_kernels, tp)
            x = x + _mlp(lw, rms_norm(x, lw["post_ln"], eps), plain_kernels, tp)
        fw = _full_weights(params, gi)
        q, k, v, gate = _full_qkv(cfg, fw, rms_norm(x, fw["input_ln"], eps), cos, sin,
                                  plain_kernels)
        o = decode_attention(kv, gi, q, k, v, page_tables, seq_lens, scale, plain_kernels)
        _write_kv(kv, gi, k, v, page_ids, pslots)
        x = _gated_out(fw, x, o, gate, plain_kernels, tp)
        x = x + _mlp(fw, rms_norm(x, fw["post_ln"], eps), plain_kernels, tp)
    x = rms_norm(x, params["final_ln"], eps)
    return q3._head(params, x, plain_kernels, tp)
