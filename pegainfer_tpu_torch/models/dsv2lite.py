"""DeepSeek-V2-Lite in PyTorch on one device: configuration, parameters,
forward, checkpoint loader and engine. Counterpart of
``pegainfer_tpu/models/dsv2lite.py``.

The family: MLA attention with no q-LoRA and plain RoPE, the first
``first_k_dense_replace`` layers a dense SwiGLU MLP, the rest MoE layers of
``n_routed_experts`` experts under softmax top-k routing plus
``n_shared_experts`` shared ones.

- **Absorbed-MLA latent cache.** Prefill materializes the per-head K/V (the
  scores [H, T, T] in f32 under the causal mask); decode keeps only the
  ``kv_lora_rank``-wide latent c_kv (after ``kv_a_layernorm``) and the
  shared 64-wide rope key of each token, in f32, and absorbs kv_b into the
  query and the output: ``q_nope . k_nope = (q_nope . W_kb) . c_kv`` and
  ``o = (attn . c_kv) . W_vb``. The step writes its own row into the state
  before it attends, so the row is visible to itself, and padding rows
  write the dead slot (row ``max_slots``). Decode has no host sync and no
  shape that depends on the data, so it is captured as a CUDA graph.
- **Routed experts in three forms**, chosen by the rows T as in the JAX
  package: ``_moe_dense`` (every expert in f32 under the routing's one-hot
  weights; the plain version the tests hold the others against, never on
  the card's path), the decode form for T < 8 (only the routed experts'
  rows read, gathered per (token, k) row; f32 products and sums, the
  activation kept in f32 before w2) and the grouped prefill form from 8
  rows on (``ops/moe.py::bf16_grouped``: rows sorted by expert, products in
  the activations' dtype with f32 sums, the activation rounded to it before
  w2). The port prefills the prompt unpadded, while the JAX executor pads
  it to a power-of-two bucket, so a short prompt may take another form in
  each package.

Products that the JAX package computes in f32 from bf16 weights (the
routing gate, the dense and shared MLPs, the routed experts' decode form,
the absorbed projections) are f32 products here too: on the card without
an f32 copy of the weight (``_bmm_f32``), elsewhere as plain f32 products.
Everything is torch ops, as the JAX package leaves the family to XLA: no
hand-written kernel is on this path. Expert parallelism (the JAX engine's
``ep`` mesh) is not ported: ``start_engine`` with ``ep_size`` above 1
raises ``NotImplementedError``.

Entry points run on ``cuda`` unless the caller passes another device; with
no card they raise instead of running on the CPU.
"""

from __future__ import annotations

import functools
import json
import logging
import os
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch

from pegainfer_tpu_torch.engine import torch_executor as tx
from pegainfer_tpu_torch.engine.contract import EngineHandle, EngineLoadOptions
from pegainfer_tpu_torch.engine.decode_graphs import dsv2lite as dsv2lite_family
from pegainfer_tpu_torch.engine.scheduler import start_scheduler
from pegainfer_tpu_torch.engine.slot_executor import SlotExecutor, SlotModel
from pegainfer_tpu_torch.ops.dsa import rope_interleaved
from pegainfer_tpu_torch.ops.moe import bf16_grouped, swiglu
from pegainfer_tpu_torch.ops.norm import rms_norm
from pegainfer_tpu_torch.ops.rope import rope_inv_freq
from pegainfer_tpu_torch.utils.device import resolve_device
from pegainfer_tpu_torch.utils.weights import SafetensorsReader, numpy_to_torch, safetensor_files

log = logging.getLogger("pegainfer_torch.dsv2lite")

PREFILL_MOE_TOKENS = 8  # from this many rows on, routed experts run grouped
DEFAULT_MAX_MODEL_LEN = 4096
MAX_SLOTS = 2  # the reference serves batch <= 2
FAMILY = "DeepSeek-V2-Lite"
# no quantized mode: the JAX engine ignores ``quantize`` for this family, and
# the port refuses what it does not do
QUANTIZE = (None,)

# whole prompts: TorchExecutor's chunk rules do not apply
check_supported = partial(tx.check_supported, family=FAMILY, quantize=QUANTIZE, chunked=False)


@dataclass(frozen=True)
class DSv2LiteConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    moe_intermediate_size: int
    num_hidden_layers: int
    first_k_dense_replace: int
    num_attention_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    n_routed_experts: int
    n_shared_experts: int
    num_experts_per_token: int
    routed_scaling_factor: float
    norm_topk_prob: bool
    rms_norm_eps: float
    rope_theta: float
    max_position_embeddings: int
    eos_token_id: int = 100001
    bos_token_id: int = 100000

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @staticmethod
    def from_model_path(model_path: str) -> "DSv2LiteConfig":
        """Parse and check a checkpoint's config.json with the JAX package's
        checks and messages: ``model_type`` deepseek_v2, no q-LoRA, a
        warning for ``rope_scaling`` (plain RoPE is served), and an
        ``eos_token_id`` list read as its first element."""
        with open(os.path.join(model_path, "config.json")) as f:
            c = json.load(f)
        if c.get("model_type") != "deepseek_v2":
            raise ValueError(
                f"DeepSeek-V2-Lite expects model_type=deepseek_v2, got "
                f"{c.get('model_type')}")
        if c.get("q_lora_rank") is not None:
            raise ValueError(
                "DeepSeek-V2-Lite first gate expects q_lora_rank=null "
                f"(got {c.get('q_lora_rank')}) — the full V2 q-LoRA path "
                "is not implemented (reference config.rs:96-99)")
        if c.get("rope_scaling") is not None:
            log.warning("rope_scaling present but the Lite gate serves "
                        "plain-RoPE context only (reference runtime.rs "
                        "supported_plain_rope_context)")
        eos = c.get("eos_token_id", 100001)
        if isinstance(eos, list):
            eos = eos[0]
        return DSv2LiteConfig(
            vocab_size=c["vocab_size"],
            hidden_size=c["hidden_size"],
            intermediate_size=c["intermediate_size"],
            moe_intermediate_size=c["moe_intermediate_size"],
            num_hidden_layers=c["num_hidden_layers"],
            first_k_dense_replace=c.get("first_k_dense_replace", 1),
            num_attention_heads=c["num_attention_heads"],
            kv_lora_rank=c["kv_lora_rank"],
            qk_nope_head_dim=c["qk_nope_head_dim"],
            qk_rope_head_dim=c["qk_rope_head_dim"],
            v_head_dim=c["v_head_dim"],
            n_routed_experts=c["n_routed_experts"],
            n_shared_experts=c["n_shared_experts"],
            num_experts_per_token=c["num_experts_per_tok"],
            routed_scaling_factor=c.get("routed_scaling_factor", 1.0),
            norm_topk_prob=c.get("norm_topk_prob", False),
            rms_norm_eps=c["rms_norm_eps"],
            rope_theta=c.get("rope_theta", 10000.0),
            max_position_embeddings=c.get("max_position_embeddings", 4096),
            eos_token_id=eos,
            bos_token_id=c.get("bos_token_id", 100000),
        )


def probe_model(model_path: str) -> bool:
    """Whether ``model_path`` holds a DeepSeek-V2-Lite checkpoint (a
    deepseek_v2 config without q-LoRA)."""
    try:
        with open(os.path.join(model_path, "config.json")) as f:
            c = json.load(f)
    except OSError:
        return False
    return c.get("model_type") == "deepseek_v2" and c.get("q_lora_rank") is None


# ── Params ───────────────────────────────────────────────────────────────
# The JAX package's tree: projections [in, out] (x @ W); attention and norm
# leaves stacked over all L layers ("attn"), the dense MLP over the first
# Ld = first_k_dense_replace ("dense"), the MoE leaves over the other Lm
# ("moe"), expert stacks w1 / w3 [Lm, E, I, D] and w2 [Lm, E, D, I] (HF's
# [out, in] rows).


def _shapes(cfg: DSv2LiteConfig):
    """Every leaf's shape, in the JAX ``init_random_params``'s order."""
    L, Ld = cfg.num_hidden_layers, cfg.first_k_dense_replace
    Lm = L - Ld
    D, H = cfg.hidden_size, cfg.num_attention_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim)
    E, Im, I = cfg.n_routed_experts, cfg.moe_intermediate_size, cfg.intermediate_size
    Ish = cfg.n_shared_experts * Im
    return {
        "embed": (cfg.vocab_size, D),
        "attn": {"input_ln": (L, D), "post_ln": (L, D), "wq": (L, D, H * (dn + dr)),
                 "kv_a": (L, D, r + dr), "kv_a_norm": (L, r), "kv_b": (L, r, H * (dn + dv)),
                 "wo": (L, H * dv, D)},
        "dense": {"gate": (Ld, D, I), "up": (Ld, D, I), "down": (Ld, I, D)},
        "moe": {"gate_w": (Lm, D, E), "shared_gate": (Lm, D, Ish), "shared_up": (Lm, D, Ish),
                "shared_down": (Lm, Ish, D), "experts_w1": (Lm, E, Im, D),
                "experts_w3": (Lm, E, Im, D), "experts_w2": (Lm, E, D, Im)},
        "final_ln": (D,),
        "lm_head": (D, cfg.vocab_size),
    }


_NORMS = ("input_ln", "post_ln", "kv_a_norm", "final_ln")


def _map_shapes(cfg: DSv2LiteConfig, leaf):
    """The tree with ``leaf(name, shape)`` at every leaf, made in order."""
    return {k: ({n: leaf(n, s) for n, s in v.items()} if isinstance(v, dict) else leaf(k, v))
            for k, v in _shapes(cfg).items()}


def init_random_params(cfg: DSv2LiteConfig, seed: int = 0, dtype=torch.bfloat16,
                       scale: float = 0.05) -> Dict[str, Any]:
    """Random params on the host, drawn as the JAX ``init_random_params``
    draws them (the same numpy draws in the same order, f32 times
    ``scale`` cast to ``dtype``; norms ones), so both packages can take one
    tree."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name in _NORMS:
            return torch.ones(shape, dtype=dtype)
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dtype)

    return _map_shapes(cfg, leaf)


def init_random_device(cfg: DSv2LiteConfig, generator: torch.Generator, device,
                       dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random params made on ``device`` from a seeded generator of that
    device, one layer of a stack at a time (a host init of a full-width
    64-expert stack would need tens of GB of f32). Projections are N(0,
    in_dim^-1), so each product keeps about the RMS of its input; the
    embedding N(0, 1); norms ones."""
    def leaf(name, shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        if name in _NORMS:
            return out.fill_(1.0)
        std = 1.0 if name == "embed" else shape[-2] ** -0.5  # [..., in, out]
        if name.startswith("experts_"):
            std = shape[-1] ** -0.5  # [..., out, in] rows
        for part in (out if out.dim() > 2 else [out]):  # a layer of a stack at a time
            part.copy_(torch.empty(part.shape, dtype=torch.float32, device=device).normal_(
                0.0, std, generator=generator))
        return out

    return _map_shapes(cfg, leaf)


def params_from_jax(jax_params, device="cpu") -> Dict[str, Any]:
    """The JAX package's params tree with numpy leaves as the port's: the
    same keys, layouts and bits."""
    return {k: (params_from_jax(v, device) if isinstance(v, dict)
                else numpy_to_torch(v).to(device))
            for k, v in jax_params.items()}


def params_bytes(params) -> int:
    return sum(params_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in params.values())


def make_state(cfg: DSv2LiteConfig, max_slots: int, max_model_len: int,
               dtype=torch.float32, device="cpu") -> Dict[str, torch.Tensor]:
    """The per-slot latent decode cache: ``ckv`` [L, S, T, r] and ``kr``
    [L, S, T, dr], f32 as in the JAX package; row ``max_slots`` of S is the
    dead slot (padding rows write there)."""
    S, L = max_slots + 1, cfg.num_hidden_layers
    return {"ckv": torch.zeros((L, S, max_model_len, cfg.kv_lora_rank), dtype=dtype,
                               device=device),
            "kr": torch.zeros((L, S, max_model_len, cfg.qk_rope_head_dim), dtype=dtype,
                              device=device)}


# ── Checkpoint ───────────────────────────────────────────────────────────


def load_params(cfg: DSv2LiteConfig, model_path: str, device=None,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """The params tree of an HF checkpoint on ``device`` (``cuda`` unless
    the caller asks for another), in ``dtype``: the JAX
    ``params_from_state_dict`` bit for bit. Streams: each tensor is read
    with a seek (``utils/weights.py::SafetensorsReader``), copied to the
    device, cast there and written into its stack, which is allocated once;
    projections are transposed to [in, out] on the device, expert rows keep
    HF's [out, in]. The host holds one tensor at a time."""
    dev = resolve_device(device)
    where = {}
    for path in safetensor_files(model_path):
        r = SafetensorsReader(path)
        for name in r.keys():
            where[name] = r
    L, Ld = cfg.num_hidden_layers, cfg.first_k_dense_replace

    def put(dst, name, transpose=True):
        if name not in where:
            raise ValueError(f"{model_path}: the checkpoint has no tensor {name}")
        t = where[name].read(name).to(dev)
        t = t.T if transpose and t.dim() == 2 else t
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"{model_path}: {name} has shape {tuple(t.shape)}, the config "
                             f"gives {tuple(dst.shape)}")
        dst.copy_(t)

    pre = "model.layers.{}."
    attn = {"input_ln": "input_layernorm", "post_ln": "post_attention_layernorm",
            "wq": "self_attn.q_proj", "kv_a": "self_attn.kv_a_proj_with_mqa",
            "kv_a_norm": "self_attn.kv_a_layernorm", "kv_b": "self_attn.kv_b_proj",
            "wo": "self_attn.o_proj"}
    dense = {"gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj"}
    moe = {"gate_w": "mlp.gate", "shared_gate": "mlp.shared_experts.gate_proj",
           "shared_up": "mlp.shared_experts.up_proj",
           "shared_down": "mlp.shared_experts.down_proj"}
    experts = {"experts_w1": "gate_proj", "experts_w3": "up_proj", "experts_w2": "down_proj"}
    params = _map_shapes(cfg, lambda name, shape: torch.empty(shape, dtype=dtype, device=dev))
    for key, hf in attn.items():
        for i in range(L):
            put(params["attn"][key][i], pre.format(i) + hf + ".weight")
    for key, hf in dense.items():
        for i in range(Ld):
            put(params["dense"][key][i], pre.format(i) + hf + ".weight")
    for key, hf in moe.items():
        for i in range(Ld, L):
            put(params["moe"][key][i - Ld], pre.format(i) + hf + ".weight")
    for key, hf in experts.items():
        for i in range(Ld, L):
            for e in range(cfg.n_routed_experts):
                put(params["moe"][key][i - Ld, e],
                    f"{pre.format(i)}mlp.experts.{e}.{hf}.weight", transpose=False)
    put(params["embed"], "model.embed_tokens.weight", transpose=False)
    put(params["final_ln"], "model.norm.weight")
    put(params["lm_head"], "lm_head.weight")
    return params


# ── Forward pieces ───────────────────────────────────────────────────────


@functools.lru_cache(maxsize=None)
def _inv_freq(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # made once per device: a CUDA graph cannot capture a host-to-device copy
    return torch.tensor(rope_inv_freq(dim, theta), dtype=torch.float32, device=device)


def _rope(x, positions, inv_freq):
    """Interleaved-pair rotation on the whole last dim (the DeepSeek rope;
    the JAX ``_rope``)."""
    return rope_interleaved(x, positions, inv_freq, x.shape[-1])


def split_bf16(x):
    """f32 ``x`` as three bf16 parts hi, mid, lo whose sum is x exactly: each
    part holds the next 8 significant bits of the rest, and f32 has 24."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def _bmm_f32(x, w):
    """x [G, N, K] @ w [G, K, M] with f32 products and sums, f32 [G, N, M]
    (the JAX ``x.astype(f32) @ w.astype(f32)``). On the card a bf16 ``w``
    is not copied to f32: bf16 rows go through one bf16 GEMM with f32 sums
    (their products are exact), and f32 rows are first split exactly into
    three bf16 parts (``split_bf16``), which that GEMM takes as 3N rows
    before their three results are added. Elsewhere, or for an f32 ``w``,
    a plain f32 product."""
    if not (x.is_cuda and w.dtype == torch.bfloat16):
        return torch.bmm(x.float(), w.float())
    if x.dtype == torch.bfloat16:
        return torch.bmm(x, w, out_dtype=torch.float32)
    N = x.shape[1]
    y = torch.bmm(torch.cat(split_bf16(x), dim=1), w, out_dtype=torch.float32)
    return y[:, :N] + y[:, N:2 * N] + y[:, 2 * N:]


def _mm_f32(x, w):
    """x [N, K] @ w [K, M] with f32 products and sums (``_bmm_f32``)."""
    return _bmm_f32(x[None], w[None])[0]


def _route(cfg: DSv2LiteConfig, gate_w, h):
    """Softmax scores in f32, then the top k (the JAX ``_route``). The
    descending sort is stable, so ties go to the lower expert as in
    ``lax.top_k``. Returns (ids [T, K] int64, weights [T, K] f32)."""
    scores = torch.softmax(_mm_f32(h, gate_w), dim=-1)
    wts, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    K = cfg.num_experts_per_token
    wts, idx = wts[:, :K], idx[:, :K]
    if cfg.norm_topk_prob:
        wts = wts / wts.sum(dim=-1, keepdim=True)
    return idx, wts * cfg.routed_scaling_factor


def _silu_mlp(h, gate, up, down):
    """The SwiGLU MLP in f32 (the dense layers and the shared experts)."""
    return _mm_f32(swiglu(_mm_f32(h, gate), _mm_f32(h, up), 0.0), down)


def _moe_dense(cfg: DSv2LiteConfig, mw, h, idx, wts):
    """Every expert in f32 on every row, combined under the routing's one-hot
    weights (the JAX ``_moe_dense``): the plain version of the routed
    experts. h [T, D] -> [T, D] f32."""
    hf = h.float()
    g = torch.einsum("td,eid->tei", hf, mw["experts_w1"].float())
    u = torch.einsum("td,eid->tei", hf, mw["experts_w3"].float())
    y = torch.einsum("tei,edi->ted", swiglu(g, u, 0.0), mw["experts_w2"].float())
    onehot = torch.nn.functional.one_hot(idx, cfg.n_routed_experts).float()  # [T, K, E]
    w_full = torch.einsum("tk,tke->te", wts.float(), onehot)
    return torch.einsum("te,ted->td", w_full, y)


def _moe_gathered(cfg: DSv2LiteConfig, mw, h, idx, wts):
    """The decode form: each (token, k) row times its own expert's rows,
    gathered (only the routed experts are read), f32 products and sums, the
    activation kept in f32 before w2. Against ``_moe_dense`` only the order
    of the f32 sums differs. h [T, D] -> [T, D] f32."""
    T, K = idx.shape
    e = idx.reshape(-1)
    xs = h[torch.arange(T, device=h.device).repeat_interleave(K)]

    def rows(x, w):  # x [M, in] times w[e] [M, out, in]: [M, out]
        return _bmm_f32(x[:, None, :], w[e].transpose(1, 2))[:, 0]

    act = swiglu(rows(xs, mw["experts_w1"]), rows(xs, mw["experts_w3"]), 0.0)
    per = rows(act, mw["experts_w2"])
    return (per * wts.reshape(-1, 1).float()).reshape(T, K, -1).sum(dim=1)


def _moe_grouped(cfg: DSv2LiteConfig, mw, h, idx, wts):
    """The prefill form (the JAX ``_moe_grouped``): rows sorted by expert,
    each expert's run of rows times its weights with f32 sums in the
    activations' dtype, the activation rounded to it before w2. h [T, D] ->
    [T, D] f32."""
    T, K = idx.shape
    per = bf16_grouped(h, mw["experts_w1"], mw["experts_w2"], mw["experts_w3"],
                       idx.reshape(-1), torch.arange(T, device=h.device).repeat_interleave(K),
                       cfg.n_routed_experts, 0.0, dtype=h.dtype)
    return (per * wts.reshape(-1, 1).float()).reshape(T, K, -1).sum(dim=1)


def _moe(cfg: DSv2LiteConfig, mw, h):
    """Shared experts plus the routed ones: h [T, D] -> [T, D] f32."""
    idx, wts = _route(cfg, mw["gate_w"], h)
    shared = _silu_mlp(h, mw["shared_gate"], mw["shared_up"], mw["shared_down"])
    form = _moe_grouped if h.shape[0] >= PREFILL_MOE_TOKENS else _moe_gathered
    return shared + form(cfg, mw, h, idx, wts)


def _mlp(cfg: DSv2LiteConfig, params, li: int, h):
    """Layer ``li``'s dense MLP or MoE: [T, D] -> [T, D] f32."""
    Ld = cfg.first_k_dense_replace
    if li < Ld:
        dw = params["dense"]
        return _silu_mlp(h, dw["gate"][li], dw["up"][li], dw["down"][li])
    return _moe(cfg, {k: v[li - Ld] for k, v in params["moe"].items()}, h)


def _kv_b(cfg: DSv2LiteConfig, params, li: int):
    """kv_b [r, H * (dn + dv)] as (W_kb [r, H, dn], W_vb [r, H, dv])."""
    dn = cfg.qk_nope_head_dim
    kvb = params["attn"]["kv_b"][li].view(cfg.kv_lora_rank, cfg.num_attention_heads, -1)
    return kvb[..., :dn], kvb[..., dn:]


def _latent(cfg: DSv2LiteConfig, aw, li: int, h, positions, inv):
    """The layer's queries and latent rows: q [T, H, dn + dr] (the rope part
    rotated), c_kv [T, r] and the rope key [T, dr]."""
    H, dn, r = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = (h @ aw["wq"][li]).view(h.shape[0], H, -1)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], positions[:, None], inv)], dim=-1)
    kva = h @ aw["kv_a"][li]
    ckv = rms_norm(kva[:, :r], aw["kv_a_norm"][li], cfg.rms_norm_eps)
    kr = _rope(kva[:, None, r:], positions[:, None], inv)[:, 0]
    return q, ckv, kr


def _head(cfg: DSv2LiteConfig, params, x):
    """Logits f32 of the rows of x (the product in the tree's dtype, as in
    the JAX package)."""
    return (rms_norm(x, params["final_ln"], cfg.rms_norm_eps) @ params["lm_head"]).float()


# ── Prefill (materialized K/V) ──────────────────────────────────────────


def prefill(cfg: DSv2LiteConfig, params, tokens, state=None, slot=None,
            return_all_logits: bool = False):
    """Prefill one unpadded prompt ``tokens`` [T]. With ``state`` the slot's
    latent rows [0, T) are written in place (clamped to the cache length).
    Returns (last logits [V] f32, every row's [T, V] f32 or None)."""
    T = tokens.shape[0]
    H, dn, dv = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    aw = params["attn"]
    x = params["embed"][tokens.long()]
    positions = torch.arange(T, device=tokens.device)
    inv = _inv_freq(cfg.qk_rope_head_dim, cfg.rope_theta, tokens.device)
    scale = cfg.qk_head_dim ** -0.5
    causal = positions[None, :] <= positions[:, None]
    for li in range(cfg.num_hidden_layers):
        h = rms_norm(x, aw["input_ln"][li], cfg.rms_norm_eps)
        q, ckv, kr = _latent(cfg, aw, li, h, positions, inv)
        kv = (ckv @ aw["kv_b"][li]).view(T, H, dn + dv)
        k = torch.cat([kv[..., :dn], kr[:, None, :].expand(T, H, -1)], dim=-1)
        att = torch.einsum("thd,shd->hts", q.float(), k.float()) * scale
        att = torch.softmax(att.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("hts,shd->thd", att, kv[..., dn:].float())
        x = x + o.reshape(T, H * dv).to(x.dtype) @ aw["wo"][li]
        h2 = rms_norm(x, aw["post_ln"][li], cfg.rms_norm_eps)
        x = x + _mlp(cfg, params, li, h2).to(x.dtype)
        if state is not None:
            Tc = min(T, state["ckv"].shape[2])
            state["ckv"][li, slot, :Tc] = ckv[:Tc]
            state["kr"][li, slot, :Tc] = kr[:Tc]
    if return_all_logits:
        every = _head(cfg, params, x)
        return every[-1], every
    return _head(cfg, params, x[-1:])[0], None


# ── Decode (absorbed MLA over the latent cache) ─────────────────────────


def decode(cfg: DSv2LiteConfig, params, state, tokens, positions, slots):
    """One step for a padded batch: tokens / positions / slots [B] int32,
    padding rows on the dead slot. Each row's latent row is written into
    ``state`` at its (slot, position) first, then the rows attend over
    their slot's rows [0, position]. Returns logits [B, V] f32."""
    B = tokens.shape[0]
    H, dn, dv = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    aw = params["attn"]
    x = params["embed"][tokens.long()]
    pos, sl = positions.long(), slots.long()
    inv = _inv_freq(cfg.qk_rope_head_dim, cfg.rope_theta, tokens.device)
    scale = cfg.qk_head_dim ** -0.5
    T = state["ckv"].shape[2]
    hidden = torch.arange(T, device=tokens.device)[None, None, :] > pos[:, None, None]
    for li in range(cfg.num_hidden_layers):
        h = rms_norm(x, aw["input_ln"][li], cfg.rms_norm_eps)
        q, ckv_t, kr_t = _latent(cfg, aw, li, h, pos, inv)
        state["ckv"][li, sl, pos] = ckv_t.to(state["ckv"].dtype)
        state["kr"][li, sl, pos] = kr_t.to(state["kr"].dtype)
        ckv, kr = state["ckv"][li][sl].float(), state["kr"][li][sl].float()  # [B, T, .]
        w_kb, w_vb = _kv_b(cfg, params, li)
        # q_abs [B, H, r]: the query absorbed into the latent space, by head
        q_abs = _bmm_f32(q[..., :dn].transpose(0, 1), w_kb.permute(1, 2, 0)).transpose(0, 1)
        att = (torch.bmm(q_abs, ckv.transpose(1, 2))
               + torch.bmm(q[..., dn:].float(), kr.transpose(1, 2))) * scale  # [B, H, T]
        att = torch.softmax(att.masked_fill(hidden, float("-inf")), dim=-1)
        o_lat = torch.bmm(att, ckv)  # [B, H, r]
        o = _bmm_f32(o_lat.transpose(0, 1), w_vb.transpose(0, 1)).transpose(0, 1)
        x = x + o.reshape(B, H * dv).to(x.dtype) @ aw["wo"][li]
        h2 = rms_norm(x, aw["post_ln"][li], cfg.rms_norm_eps)
        x = x + _mlp(cfg, params, li, h2).to(x.dtype)
    return _head(cfg, params, x)


# ── Slot snapshots (PD handoff) ─────────────────────────────────────────


def slot_export(state, slot: int):
    """A copy of ``slot``'s latent rows in every layer (later steps
    overwrite the slot in place)."""
    return {k: v[:, slot].clone() for k, v in state.items()}


def slot_import(state, snap, slot: int) -> None:
    """Copy a snapshot into ``slot``'s rows (a host snapshot is copied
    over)."""
    for k, v in state.items():
        v[:, slot].copy_(snap[k])


def snapshot_bytes(state) -> int:
    """Bytes of one slot's rows (what ``slot_export`` copies)."""
    return sum(v.numel() // v.shape[1] * v.element_size() for v in state.values())


# ── Engine ───────────────────────────────────────────────────────────────


def slot_model(cfg: DSv2LiteConfig, params) -> SlotModel:
    """The family's functions for ``SlotExecutor``, bound to ``cfg`` and
    ``params``; no resume function, so no slot prefix cache (as in the JAX
    executor, which has none for this family)."""
    def prefill_fn(tokens, state, slot, all_logits):
        return prefill(cfg, params, tokens, state, slot, return_all_logits=all_logits)

    return SlotModel(family=FAMILY, quantize=QUANTIZE, prefill=prefill_fn,
                     decode=partial(decode, cfg, params), slot_export=slot_export,
                     slot_import=slot_import, snapshot_bytes=snapshot_bytes,
                     graph_family=dsv2lite_family)


def start_engine_from_params(cfg: DSv2LiteConfig, params,
                             options: Optional[EngineLoadOptions] = None,
                             device=None) -> EngineHandle:
    """Serve ``params`` (already on ``device``) on ``min(max_batch_size,
    2)`` slots of f32 latent cache, ``max_model_len`` (4,096 by default)
    rows each, through ``SlotExecutor``: whole-prompt prefills, the decode
    step and decode blocks under CUDA graphs by default (the ``dsv2lite``
    family, each bucket captured at first use). As in the JAX executor, the
    family has no prefix cache and no chunked prefill: ``enable_prefix_cache``
    and ``prefill_chunk`` are taken and have no effect. Returns the submit
    handle; ``handle._scheduler.executor`` is the ``SlotExecutor``."""
    opts = options or EngineLoadOptions()
    check_supported(opts)
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params are on {params['embed'].device}, engine on {dev}")
    max_slots = min(opts.max_batch_size, MAX_SLOTS)
    max_model_len = opts.max_model_len or DEFAULT_MAX_MODEL_LEN
    state = make_state(cfg, max_slots, max_model_len, device=dev)
    executor = SlotExecutor(cfg, params, state, max_slots, max_model_len, opts,
                            model=slot_model(cfg, params))
    log.info("DeepSeek-V2-Lite: %d slots, max_model_len %d, %.2f GB of params, %.2f MB of "
             "latent cache a slot", max_slots, max_model_len, params_bytes(params) / 1e9,
             snapshot_bytes(state) / 1e6)
    return start_scheduler(executor, seed=opts.seed)


def start_engine(model_path: str, options: Optional[EngineLoadOptions] = None, device=None,
                 ep_size: Optional[int] = None) -> EngineHandle:
    """Serve the HF checkpoint at ``model_path`` on one device (the JAX
    ``start_engine`` at ``ep_size`` 1): its config, the streaming loader in
    bf16, then ``start_engine_from_params``. Expert parallelism is not
    ported: ``ep_size`` above 1 raises ``NotImplementedError``, as does any
    ``quantize``, before the checkpoint is read."""
    opts = options or EngineLoadOptions()
    check_supported(opts)
    dev = resolve_device(device)
    if ep_size not in (None, 0, 1):
        raise NotImplementedError(
            f"ep_size={ep_size}: the port serves DeepSeek-V2-Lite on one device (expert "
            "parallelism over the ep mesh is not ported)")
    cfg = DSv2LiteConfig.from_model_path(model_path)
    log.info("loading DeepSeek-V2-Lite (%d layers, hidden %d, %d experts)",
             cfg.num_hidden_layers, cfg.hidden_size, cfg.n_routed_experts)
    return start_engine_from_params(cfg, load_params(cfg, model_path, dev), opts, dev)
