"""DeepSeek-V4 forward in PyTorch (MoE + DSA + hyper-connections);
counterpart of ``pegainfer_tpu/models/dsv4.py``.

Architecture: 64-head MLA-style attention over one joint 512-d KV vector per
token, q and o through LoRA factorizations, per-head sink logits; each
layer's compress ratio selects sliding-window attention (0), a
non-overlapping compressed cache (ratio not in {0, 4}) or the overlapping
ratio-4 cache with the lightning indexer's top-k; MoE with hash routing
(the first ``n_hash_layers``) or score routing, one shared expert plus
routed experts; the residual stream is ``hc_mult`` hyper-connection streams.

Weights are served resident as in the checkpoint: fp8 dense projections and
packed-fp4 routed experts ({"q","s"} containers, ``ops/quant.py``), or with
the experts requantized to int8 at load (the int8-experts mode), or
dequantized to plain bf16 at load (the bf16 mode, whose products are the
JAX package's XLA paths in torch: no kernel). The quantized products go
through the kernel wrappers, on the JAX engine's
default routes on the TPU: fp8 linears with at most 8 rows (decode) through
K4 (``quant.qlinear``); routed experts from 8 tokens on through the grouped
GEMMs (K5 fp4, K7 int8) and below through the GEMVs (K3 fp4, K6 int8) or
one fused chain launch a layer (K8 int8, K9 fp4) while M = T x K <= 16 and
the chain is on. ``moe_chain`` sets the chain: None takes the JAX default
for the format (on for int8, off for fp4), True or False forces it. On a
CPU tensor each wrapper runs its plain version; ``plain_kernels=True`` runs
the plain versions on any device (the oracle of the kernels). Everything
else is plain torch, as the JAX package leaves it to XLA.

Layers run as a Python loop, one entry per layer (the JAX package's segment
grouping only keeps XLA's compile time down). Caches update in place:
``prefill`` with a state writes the slot's rows, ``decode`` writes each
batch row's slot, and padding rows write to the dead slot (row
``max_slots`` of every cache).

Model parallelism (``tp``, a rank's ``parallel/group.py::RankGroups``, with
its shard ``parallel/sharding.py::shard_dsv4`` and ``local_config_dsv4``):
the reference's mp8 split, as the JAX package runs it under GSPMD on its MP8
mesh. A rank embeds its vocabulary rows (masked, all-reduced: one rank's
row and zeros, so the sum is exact), computes its attention heads and its
o-groups (``wo_b``'s input columns: an f32 partial sum, all-reduced), scores
the ratio-4 layers' compressed rows with its index heads (the partial
scores all-reduced in f32 before the top-k), runs its E / tp routed experts
on the tokens routed to them (``moe_ep``: ids shifted by ``rank * E / tp``,
rows of other ranks' experts contribute 0, the weighted routed sum
all-reduced in f32 before the whole shared expert is added) and gathers the
head's vocabulary shards. A forward makes ``collectives_per_forward(cfg)``
collectives: 2 a layer, 1 more a ratio-4 layer, the embedding and the head.
Every rank then holds the same streams to the bit, so the gates, the
indexer's top-k and the hyper-connection mixes decide alike on every rank;
a ``RouteTape`` (``tape``) records those decisions, or replays another
run's.
"""

from __future__ import annotations

import functools
import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pegainfer_tpu_torch.ops import dsa, hc, quant
from pegainfer_tpu_torch.ops.moe import bf16_grouped, swiglu
from pegainfer_tpu_torch.ops.cuda import fp4_chain as k9
from pegainfer_tpu_torch.ops.cuda import fp4_gemv as k3
from pegainfer_tpu_torch.ops.cuda import fp4_grouped as k5
from pegainfer_tpu_torch.ops.cuda import int8_chain as k8
from pegainfer_tpu_torch.ops.cuda import int8_gemv as k6
from pegainfer_tpu_torch.ops.cuda import int8_grouped as k7
from pegainfer_tpu_torch.utils.weights import numpy_to_torch

PREFILL_MOE_TOKENS = 8  # from this many tokens on, routed experts run grouped


def collectives_per_forward(cfg) -> int:
    """The collectives of one model-parallel forward: the embedding's
    reduce, two a layer (the attention output's and the routed experts'
    reduces), one more a ratio-4 layer (the indexer's scores) and the head's
    gather."""
    return 2 * cfg.n_layers + sum(r == 4 for r in cfg.compress_ratios) + 2


def _world(tp) -> int:
    return 1 if tp is None else tp.size


class RouteTape:
    """The decisions a run takes from its streams, in call order: each MoE
    call's gate (``"route"``: route weights [T, K] f32, expert ids [T, K])
    and each ratio-4 layer's indexer selection (``"select"``: the prefill's
    top-k mask [T, C], or the decode step's ids [B, k] and their validity).
    Recording (``replay`` None) keeps them on the device. Replaying hands
    back ``replay``'s entries (an earlier tape's ``host()``) in place of the
    run's own and counts in ``flips`` the rows whose own choice differs, of
    ``rows``: a near-tie that the rounding of another order of sums swaps.
    An entry of another kind or shape than the decision raises RuntimeError
    (the two runs made other calls). Past the end of ``replay`` the run
    decides for itself again."""

    def __init__(self, replay=None):
        self.entries = []
        self.replay = replay
        self.flips = self.rows = 0

    def __call__(self, kind: str, own: tuple) -> tuple:
        if self.replay is None or len(self.entries) >= len(self.replay):
            self.entries.append((kind, own))
            return own
        want, theirs = self.replay[len(self.entries)]
        shapes = [tuple(t.shape) for t in theirs], [tuple(t.shape) for t in own]
        if want != kind or shapes[0] != shapes[1]:
            raise RuntimeError(f"route tape: replaying a {want!r} entry of shapes {shapes[0]} "
                               f"at a {kind!r} decision of shapes {shapes[1]}")
        theirs = tuple(t.to(own[0].device) for t in theirs)
        self.entries.append((kind, theirs))
        differ = _decision_rows(kind, own) != _decision_rows(kind, theirs)
        self.flips += int(differ.any(dim=-1).sum())
        self.rows += differ.shape[0]
        return theirs

    def host(self) -> list:
        """The entries as CPU tensors (to hand to another process)."""
        return [(kind, tuple(t.cpu() for t in ts)) for kind, ts in self.entries]


def _decision_rows(kind: str, entry: tuple) -> torch.Tensor:
    """What a decision chose, a row a token, in a form that compares by
    equality: the sorted expert ids, the selection mask, or the sorted
    selected ids (-1 for invalid picks)."""
    if kind == "route":
        return torch.sort(entry[1], dim=-1).values
    if len(entry) == 1:
        return entry[0]
    ids, valid = entry
    return torch.sort(torch.where(valid, ids, -1), dim=-1).values


@dataclass(frozen=True)
class DSv4Config:
    vocab_size: int
    dim: int
    moe_inter_dim: int
    n_layers: int
    num_attention_heads: int
    head_dim: int
    q_lora_rank: int
    qk_rope_head_dim: int
    o_groups: int
    o_lora_rank: int
    sliding_window: int
    n_routed_experts: int
    n_shared_experts: int
    n_activated_experts: int
    n_hash_layers: int
    routed_scaling_factor: float
    swiglu_limit: float
    rms_norm_eps: float
    index_n_heads: int
    index_head_dim: int
    index_topk: int
    max_position_embeddings: int
    rope_theta: float
    compress_rope_theta: float
    compress_ratios: tuple
    yarn_factor: float = 16.0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_original_seq_len: int = 65536
    hc_mult: int = 4
    hc_sinkhorn_iters: int = 20
    hc_eps: float = 1.0e-6
    bos_token_id: int = 0
    eos_token_id: int = 1

    @staticmethod
    def from_model_path(model_path: str) -> "DSv4Config":
        with open(os.path.join(model_path, "config.json")) as f:
            c = json.load(f)
        rs = c["rope_scaling"]
        return DSv4Config(
            vocab_size=c["vocab_size"],
            dim=c["hidden_size"],
            moe_inter_dim=c["moe_intermediate_size"],
            n_layers=c["num_hidden_layers"],
            num_attention_heads=c["num_attention_heads"],
            head_dim=c["head_dim"],
            q_lora_rank=c["q_lora_rank"],
            qk_rope_head_dim=c["qk_rope_head_dim"],
            o_groups=c["o_groups"],
            o_lora_rank=c["o_lora_rank"],
            sliding_window=c["sliding_window"],
            n_routed_experts=c["n_routed_experts"],
            n_shared_experts=c["n_shared_experts"],
            n_activated_experts=c["num_experts_per_tok"],
            n_hash_layers=c["num_hash_layers"],
            routed_scaling_factor=c["routed_scaling_factor"],
            swiglu_limit=c["swiglu_limit"],
            rms_norm_eps=c["rms_norm_eps"],
            index_n_heads=c["index_n_heads"],
            index_head_dim=c["index_head_dim"],
            index_topk=c["index_topk"],
            max_position_embeddings=c["max_position_embeddings"],
            rope_theta=c["rope_theta"],
            compress_rope_theta=c["compress_rope_theta"],
            compress_ratios=tuple(c["compress_ratios"][: c["num_hidden_layers"]]),
            yarn_factor=rs["factor"],
            yarn_beta_fast=rs["beta_fast"],
            yarn_beta_slow=rs["beta_slow"],
            yarn_original_seq_len=rs["original_max_position_embeddings"],
            hc_mult=c.get("hc_mult", 4),
            hc_sinkhorn_iters=c.get("hc_sinkhorn_iters", 20),
            hc_eps=c.get("hc_eps", 1.0e-6),
            bos_token_id=c["bos_token_id"],
            eos_token_id=c["eos_token_id"],
        )

    def rope_inv_freq(self, layer: int) -> np.ndarray:
        """Per-layer inv_freq: YaRN only on compressed-attention layers."""
        if self.compress_ratios[layer] > 0:
            return dsa.yarn_inv_freq(
                self.qk_rope_head_dim, self.compress_rope_theta, self.yarn_factor,
                self.yarn_beta_fast, self.yarn_beta_slow, self.yarn_original_seq_len)
        return dsa.yarn_inv_freq(self.qk_rope_head_dim, self.rope_theta, 1.0, 0.0, 0.0, 0)


@functools.lru_cache(maxsize=None)
def _inv_freq(cfg: DSv4Config, layer: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(cfg.rope_inv_freq(layer)).to(device)


# ── Params ───────────────────────────────────────────────────────────────
# {"embed": [V, D], "head": [V, D], "norm": [D], "hc_head_fn": [n, n*D] f32,
#  "hc_head_base": [n], "hc_head_scale": [1],
#  "layers": [per layer: norms, hc_{attn,ffn}_{fn,base,scale}, attn_sink,
#     wq_a, wq_b, wkv, wo_b, shared_w{1,2,3}, idx_wq_b (fp8 containers when
#     resident), wo_a, gate_weight, gate_tid2eid | gate_bias, comp, idx_comp,
#     idx_weights_proj, experts_w{1,2,3} (packed-fp4 or int8 containers)]}
# Linear weights are [out, in] (y = x @ W.T), as in the JAX package.

# tensors the checkpoint holds fp8-blocked, and the fp4 expert stacks
FP8_KEYS = ("wq_a", "wq_b", "wkv", "wo_b", "shared_w1", "shared_w2", "shared_w3",
            "idx_wq_b")
FP4_KEYS = ("experts_w1", "experts_w2", "experts_w3")


def init_random_params(cfg: DSv4Config, seed: int = 0, dtype=torch.bfloat16,
                       scale: float = 0.05) -> Dict[str, Any]:
    """Random params drawn on the host with numpy in the JAX package's
    order (``dsv4.init_random_params``): the same seed gives the same draws,
    equal weights at f32."""
    rng = np.random.default_rng(seed)
    D, n = cfg.dim, cfg.hc_mult
    H, hd = cfg.num_attention_heads, cfg.head_dim
    mix_hc = (2 + n) * n

    def w(*shape, s=scale):
        return torch.from_numpy(rng.normal(0, s, shape)).to(dtype)

    def f32(*shape, s=scale):
        return torch.from_numpy(rng.normal(0, s, shape)).float()

    def ones(*shape):
        return torch.ones(shape, dtype=dtype)

    layers = []
    for li in range(cfg.n_layers):
        ratio = cfg.compress_ratios[li]
        lw: Dict[str, Any] = {
            "attn_norm": ones(D),
            "ffn_norm": ones(D),
            "hc_attn_fn": f32(mix_hc, n * D, s=0.2),
            "hc_attn_base": f32(mix_hc, s=0.5),
            "hc_attn_scale": torch.ones(3),
            "hc_ffn_fn": f32(mix_hc, n * D, s=0.2),
            "hc_ffn_base": f32(mix_hc, s=0.5),
            "hc_ffn_scale": torch.ones(3),
            "attn_sink": f32(H, s=0.3),
            "q_norm": ones(cfg.q_lora_rank),
            "kv_norm": ones(hd),
            "wq_a": w(cfg.q_lora_rank, D),
            "wq_b": w(H * hd, cfg.q_lora_rank),
            "wkv": w(hd, D),
            "wo_a": w(cfg.o_groups * cfg.o_lora_rank, H * hd // cfg.o_groups),
            "wo_b": w(D, cfg.o_groups * cfg.o_lora_rank),
            "gate_weight": w(cfg.n_routed_experts, D),
            "shared_w1": w(cfg.moe_inter_dim, D),
            "shared_w2": w(D, cfg.moe_inter_dim),
            "shared_w3": w(cfg.moe_inter_dim, D),
            "experts_w1": w(cfg.n_routed_experts, cfg.moe_inter_dim, D),
            "experts_w2": w(cfg.n_routed_experts, D, cfg.moe_inter_dim),
            "experts_w3": w(cfg.n_routed_experts, cfg.moe_inter_dim, D),
        }
        if li < cfg.n_hash_layers:
            lw["gate_tid2eid"] = torch.from_numpy(rng.integers(
                0, cfg.n_routed_experts, (cfg.vocab_size, cfg.n_activated_experts))
            ).to(torch.int32)
        else:
            lw["gate_bias"] = f32(cfg.n_routed_experts, s=0.2)
        if ratio > 0:
            coff = 2 if ratio == 4 else 1
            lw["comp"] = {"ape": f32(ratio, coff * hd, s=0.3), "wkv": w(coff * hd, D),
                          "wgate": w(coff * hd, D), "norm": ones(hd)}
        if ratio == 4:
            ihd = cfg.index_head_dim
            lw["idx_wq_b"] = w(cfg.index_n_heads * ihd, cfg.q_lora_rank)
            lw["idx_weights_proj"] = w(cfg.index_n_heads, D)
            lw["idx_comp"] = {"ape": f32(ratio, 2 * ihd, s=0.3), "wkv": w(2 * ihd, D),
                              "wgate": w(2 * ihd, D), "norm": ones(ihd)}
        layers.append(lw)
    return {
        "embed": w(cfg.vocab_size, D),
        "head": w(cfg.vocab_size, D),
        "norm": ones(D),
        "hc_head_fn": f32(n, n * D, s=0.2),
        "hc_head_base": f32(n, s=0.5),
        "hc_head_scale": torch.ones(1),
        "layers": layers,
    }


def quantize_params_resident(params: Dict[str, Any], experts: str = "fp4") -> Dict[str, Any]:
    """Host params tree -> resident tree: fp8 containers on FP8_KEYS and
    packed-fp4 (``experts="fp4"``) or int8 (``"int8"``) containers on the
    expert stacks, everything else untouched (the JAX package's
    ``quantize_params_resident``)."""
    if experts not in ("fp4", "int8"):
        raise ValueError(f"experts must be 'fp4' or 'int8', got {experts!r}")
    quantize = quant.quantize_int8_stack if experts == "int8" else quant.quantize_fp4_stack
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for lw in params["layers"]:
        nlw = dict(lw)
        for k in FP8_KEYS:
            if k in nlw:
                nlw[k] = quant.quantize_fp8_tensor(nlw[k].float().numpy())
        for k in FP4_KEYS:
            if k in nlw:
                nlw[k] = quantize(nlw[k].float().numpy())
        out["layers"].append(nlw)
    return out


def requantize_experts_int8(params) -> None:
    """Requantize every packed-fp4 expert stack of a resident tree to int8,
    in place, one stack at a time on its own device (the JAX engine's
    ``quantize="int8-experts"`` load step, ``dsv4_engine.py:208-212``).
    Stacks that are already int8 stay as they are. On the card the freed
    fp4 blocks (1.2 GB at full width) are smaller than the int8 stack that
    replaces them (2.1 GB), so the allocator's cache is emptied after each
    stack, or its reserve would grow past the card."""
    for lw in params["layers"]:
        for k in FP4_KEYS:
            w = lw.get(k)
            if quant.is_quantized(w) and w["q"].dtype == torch.uint8:
                lw[k] = quant.requantize_int8_stack(w)
                del w
                if lw[k]["q"].is_cuda:
                    torch.cuda.empty_cache()


def dequantize_params(params, dtype) -> None:
    """Dequantize every ``{"q","s"}`` container of a tree to a plain
    ``dtype`` tensor, in place (the JAX engine's ``quantize="bf16"``, which
    dequantizes at load): a container at a time, expert stacks 8 experts at
    a time so their f32 temporaries stay small. Exact for fp8 and fp4
    containers in bf16 or f32 (codes times powers of two)."""
    chunk = 8
    for lw in params["layers"]:
        for k, w in list(lw.items()):
            if not quant.is_quantized(w):
                continue
            if w["q"].dim() == 2:
                lw[k] = quant.dequant_any(w, dtype)
                continue
            q = w["q"]  # packed fp4 holds two values a byte
            shape = (*q.shape[:-1], 2 * q.shape[-1]) if q.dtype == torch.uint8 else q.shape
            out = torch.empty(shape, dtype=dtype, device=q.device)
            for e0 in range(0, out.shape[0], chunk):
                out[e0:e0 + chunk] = quant.dequant_any(
                    {"q": q[e0:e0 + chunk], "s": w["s"][e0:e0 + chunk]}, dtype)
            lw[k] = out
            del w, q
            if out.is_cuda:
                torch.cuda.empty_cache()


def params_from_jax(jax_params, device="cpu"):
    """The JAX package's DSv4 params tree with numpy leaves (plain or
    resident) as the port's tree: same keys and layouts; fp8 and bf16 leaves
    keep their bits, ``{"q","s"}`` containers stay containers."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return numpy_to_torch(v).to(device)

    return conv(jax_params)


def init_random_resident_device(cfg: DSv4Config, generator: torch.Generator, device,
                                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random resident params made on ``device`` from a seeded generator of
    that device: packed-fp4 expert codes, E4M3 codes and power-of-two bf16
    scales built there directly (a host init would need tens of GB of f32
    per full-width layer). Each scale is 2^k nearest to 1 / (code RMS x
    sqrt(IN)), so a product keeps about unit RMS through the random layers
    (E4M3 codes drawn from N(0, 1), uniform E2M1 codes with RMS 2.93);
    block scales vary by a factor of 2 either way so the kernels' scale
    lookups are exercised."""
    D, n = cfg.dim, cfg.hc_mult
    H, hd = cfg.num_attention_heads, cfg.head_dim
    mix_hc = (2 + n) * n
    E, I = cfg.n_routed_experts, cfg.moe_inter_dim

    def normal(shape, std, dt=dtype):
        return torch.empty(shape, dtype=torch.float32, device=device).normal_(
            0.0, std, generator=generator).to(dt)

    def scales(shape, in_dim, code_rms):
        base = round(-math.log2(code_rms * math.sqrt(in_dim)))
        jitter = torch.randint(-1, 2, shape, device=device, generator=generator)
        return torch.exp2((base + jitter).float()).to(quant.SCALE_DTYPE)

    def fp8(out_dim, in_dim, block=128):  # a dim block does not divide: one block
        q = normal((out_dim, in_dim), 1.0, torch.float32).to(quant.F8)
        so = out_dim // block if out_dim % block == 0 else 1
        si = in_dim // block if in_dim % block == 0 else 1
        return {"q": q, "s": scales((so, si), in_dim, 1.0)}

    def fp4(out_dim, in_dim, group=32):
        q = torch.randint(0, 256, (E, out_dim, in_dim // 2), dtype=torch.uint8,
                          device=device, generator=generator)
        return {"q": q, "s": scales((E, out_dim, in_dim // group), in_dim, 2.93)}

    def lin(out_dim, in_dim):
        return normal((out_dim, in_dim), in_dim ** -0.5)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def hc_params(prefix):
        return {f"{prefix}_fn": normal((mix_hc, n * D), (n * D) ** -0.5, torch.float32),
                f"{prefix}_base": normal((mix_hc,), 0.5, torch.float32),
                f"{prefix}_scale": torch.ones(3, device=device)}

    layers = []
    for li in range(cfg.n_layers):
        ratio = cfg.compress_ratios[li]
        lw: Dict[str, Any] = {
            "attn_norm": ones(D), "ffn_norm": ones(D),
            **hc_params("hc_attn"), **hc_params("hc_ffn"),
            "attn_sink": normal((H,), 0.3, torch.float32),
            "q_norm": ones(cfg.q_lora_rank), "kv_norm": ones(hd),
            "wq_a": fp8(cfg.q_lora_rank, D),
            "wq_b": fp8(H * hd, cfg.q_lora_rank),
            "wkv": fp8(hd, D),
            "wo_a": lin(cfg.o_groups * cfg.o_lora_rank, H * hd // cfg.o_groups),
            "wo_b": fp8(D, cfg.o_groups * cfg.o_lora_rank),
            "gate_weight": lin(E, D),
            "shared_w1": fp8(I, D), "shared_w2": fp8(D, I), "shared_w3": fp8(I, D),
            "experts_w1": fp4(I, D), "experts_w2": fp4(D, I), "experts_w3": fp4(I, D),
        }
        if li < cfg.n_hash_layers:
            lw["gate_tid2eid"] = torch.randint(
                0, E, (cfg.vocab_size, cfg.n_activated_experts), dtype=torch.int32,
                device=device, generator=generator)
        else:
            lw["gate_bias"] = normal((E,), 0.2, torch.float32)
        if ratio > 0:
            coff = 2 if ratio == 4 else 1
            lw["comp"] = {"ape": normal((ratio, coff * hd), 0.3, torch.float32),
                          "wkv": lin(coff * hd, D), "wgate": lin(coff * hd, D),
                          "norm": ones(hd)}
        if ratio == 4:
            ihd = cfg.index_head_dim
            lw["idx_wq_b"] = fp8(cfg.index_n_heads * ihd, cfg.q_lora_rank)
            lw["idx_weights_proj"] = lin(cfg.index_n_heads, D)
            lw["idx_comp"] = {"ape": normal((ratio, 2 * ihd), 0.3, torch.float32),
                              "wkv": lin(2 * ihd, D), "wgate": lin(2 * ihd, D),
                              "norm": ones(ihd)}
        layers.append(lw)
    return {
        "embed": normal((cfg.vocab_size, D), 1.0),
        "head": lin(cfg.vocab_size, D),
        "norm": ones(D),
        "hc_head_fn": normal((n, n * D), (n * D) ** -0.5, torch.float32),
        "hc_head_base": normal((n,), 0.5, torch.float32),
        "hc_head_scale": torch.ones(1, device=device),
        "layers": layers,
    }


def params_bytes(params) -> int:
    def walk(v):
        if isinstance(v, dict):
            return sum(walk(x) for x in v.values())
        if isinstance(v, list):
            return sum(walk(x) for x in v)
        return v.numel() * v.element_size()

    return walk(params)


def make_state(cfg: DSv4Config, max_slots: int, max_blocks: int, dtype=torch.float32,
               device="cpu"):
    """Per-slot decode caches; row ``max_slots`` is the dead slot."""
    S, W = max_slots + 1, cfg.sliding_window
    hd, ihd = cfg.head_dim, cfg.index_head_dim

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    layers = []
    for li in range(cfg.n_layers):
        ratio = cfg.compress_ratios[li]
        ls: Dict[str, Any] = {"kv": z(S, W, hd)}
        if ratio > 0:
            coff = 2 if ratio == 4 else 1
            R = 8 if ratio == 4 else ratio
            ls["ckv"] = z(S, max_blocks + 1, hd)  # +1: the dead column
            ls["ps"] = z(S, R, coff * hd, dt=torch.float32)
            ls["pv"] = z(S, R, coff * hd, dt=torch.float32)
        if ratio == 4:
            ls["ick"] = z(S, max_blocks + 1, ihd)
            ls["ips"] = z(S, 8, 2 * ihd, dt=torch.float32)
            ls["ipv"] = z(S, 8, 2 * ihd, dt=torch.float32)
        layers.append(ls)
    return {"layers": layers}


# ── Forward pieces ───────────────────────────────────────────────────────


def _rms(x, wt, eps):
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)).to(x.dtype) * wt


def _attn_q(cfg, lw, x, positions, inv_freq, plain):
    """x: [T, D] -> (q [T, H, hd] rope'd, qa [T, q_lora])."""
    qa = _rms(quant.qlinear(x, lw["wq_a"], plain), lw["q_norm"], cfg.rms_norm_eps)
    q = quant.qlinear(qa, lw["wq_b"], plain).reshape(
        x.shape[0], cfg.num_attention_heads, cfg.head_dim)
    return dsa.rope_interleaved(q, positions[:, None], inv_freq, cfg.qk_rope_head_dim), qa


def _attn_kv(cfg, lw, x, positions, inv_freq, plain):
    """x: [T, D] -> joint kv rows [T, hd] (rope'd, fp8 storage rounding)."""
    kv = _rms(quant.qlinear(x, lw["wkv"], plain), lw["kv_norm"], cfg.rms_norm_eps)
    kv = dsa.rope_interleaved(kv, positions, inv_freq, cfg.qk_rope_head_dim)
    return dsa.fp8_round_nope(kv, cfg.qk_rope_head_dim)


def _attn_out(cfg, lw, o, plain, tp=None):
    """o: [T, H, hd] -> [T, D] through the grouped o-LoRA. Under ``tp`` the
    rank's o-groups give an f32 partial sum of wo_b's product, reduced
    across the ranks."""
    T, G = o.shape[0], cfg.o_groups
    per_g = cfg.num_attention_heads * cfg.head_dim // G
    wo_a = lw["wo_a"].reshape(G, cfg.o_lora_rank, per_g)
    oa = torch.einsum("tgp,grp->tgr", o.reshape(T, G, per_g), wo_a)
    y = quant.qlinear(oa.reshape(T, G * cfg.o_lora_rank), lw["wo_b"], plain,
                      f32_out=tp is not None)
    return y if tp is None else tp.all_reduce_sum(y).to(o.dtype)


def _compress_scores_values(x, comp):
    # the JAX package passes (wgate, wkv) to compress_scores_values(x, wkv,
    # wgate): its scores come from comp["wkv"], its values from
    # comp["wgate"]. Kept as is, so both packages compute the same model.
    return dsa.compress_scores_values(x, comp["wgate"], comp["wkv"])


def _compress_layer(cfg, comp, x, ratio, inv_freq):
    """Prefill compressor: x [T, D] -> (compressed rows [C, hd] rope'd at
    group-start positions with fp8-rounded nope dims, scores, values)."""
    scores, values = _compress_scores_values(x, comp)
    if ratio == 4:
        c = dsa.compress_overlap(scores, values, comp["ape"], comp["norm"], cfg.rms_norm_eps)
    else:
        c = dsa.compress_nonoverlap(scores, values, comp["ape"], comp["norm"], ratio,
                                    cfg.rms_norm_eps)
    cpos = torch.arange(c.shape[0], device=x.device) * ratio
    c = dsa.rope_interleaved(c.to(x.dtype), cpos, inv_freq, cfg.qk_rope_head_dim)
    return dsa.fp8_round_nope(c, cfg.qk_rope_head_dim), scores, values


def _emit_compressed_block(cfg, comp, ps_rows, pv_rows, positions, ratio, inv_freq):
    """Decode-side block emission from the pending projection rings
    ps_rows/pv_rows [B, R, out] (the emitting token is its group's last).
    Rows that do not emit get garbage, written to the dead column."""
    if ratio == 4:
        R = 8
        base_cur = ((positions - 3) % R)[:, None]
        r = torch.arange(4, device=positions.device)[None, :]

        def take(rows, idx):
            return torch.gather(rows, 1, idx[..., None].expand(-1, -1, rows.shape[-1]))

        cur_idx, prev_idx = (base_cur + r) % R, (base_cur + 4 + r) % R
        block = dsa.compress_block_overlap(
            take(ps_rows, prev_idx), take(pv_rows, prev_idx),
            take(ps_rows, cur_idx), take(pv_rows, cur_idx),
            comp["ape"], comp["norm"], cfg.rms_norm_eps, (positions + 1) // ratio > 1)
    else:  # ring slot of token c * ratio + r is r
        block = dsa.compress_block_nonoverlap(ps_rows, pv_rows, comp["ape"], comp["norm"],
                                              cfg.rms_norm_eps)
    cpos = ((positions + 1) // ratio - 1) * ratio
    block = dsa.rope_interleaved(block, cpos, inv_freq, cfg.qk_rope_head_dim)
    return dsa.fp8_round_nope(block, cfg.qk_rope_head_dim)


def hash_gate(xf32, gate_weight, tid2eid, token_ids, topk_scale: float):
    """Hash-layer routing: experts from the token-id table; weight =
    sqrt(softplus(x . gw[e])), normalized by the row sum (0 when the sum is
    0), then scaled."""
    experts = tid2eid[token_ids.long()]  # [T, K]
    dots = torch.einsum("td,tkd->tk", xf32, gate_weight.float()[experts.long()])
    w = torch.sqrt(F.softplus(dots))
    wsum = w.sum(dim=-1, keepdim=True)
    return torch.where(wsum > 0, w / wsum, 0.0) * topk_scale, experts


def score_gate(xf32, gate_weight, gate_bias, k: int, topk_scale: float):
    """Score routing: score = sqrt(softplus(x . gw)); the k experts with the
    highest score + bias, the lower index first on ties (stable sort); the
    route weight is the unbiased score, normalized then scaled."""
    score = torch.sqrt(F.softplus(xf32 @ gate_weight.float().T))  # [T, E]
    order = torch.sort(score + gate_bias.float(), dim=-1, descending=True,
                       stable=True).indices[:, :k]
    w = torch.gather(score, 1, order)
    wsum = w.sum(dim=-1, keepdim=True)
    return torch.where(wsum > 0, w / wsum, 0.0) * topk_scale, order


def _routed_experts(lw) -> str:
    """The routed experts' format: "fp4" (packed), "int8" or "bf16" (plain
    stacks, the dequantized-at-load mode). A layer mixing formats raises."""
    kinds = {lw[k]["q"].dtype if quant.is_quantized(lw[k]) else None for k in FP4_KEYS}
    if kinds == {torch.uint8}:
        return "fp4"
    if kinds == {torch.int8}:
        return "int8"
    if kinds == {None}:
        return "bf16"
    raise NotImplementedError(
        f"a layer's routed experts mix formats ({sorted(map(str, kinds))}); the port serves "
        "packed-fp4, int8 or plain stacks, one format a layer")


def _int8_srows(w, e: torch.Tensor) -> torch.Tensor:
    """Each row's per-output-channel scales s[e(row)], f32 [rows, OUT]: the
    int8 kernels return unscaled products and the scale commutes with the
    dot."""
    return w["s"][e.long()].float()


def _moe(cfg: DSv4Config, lw, is_hash: bool, x, token_ids, plain: bool = False,
         moe_chain: Optional[bool] = None, tp=None, tape=None):
    """x: [T, D] -> MoE output [T, D] (shared + routed experts). Under ``tp``
    the gate stays global (E whole, ``gate_weight`` whole) and the rank runs
    its E / tp experts (``cfg.n_routed_experts``, its local config's) on the
    rows routed to them: the JAX ``ops/moe_ep.py::moe_ep``."""
    T = x.shape[0]
    E, K = cfg.n_routed_experts, cfg.n_activated_experts
    limit = cfg.swiglu_limit
    xf32 = x.float()
    if is_hash:
        weights, route_idx = hash_gate(xf32, lw["gate_weight"], lw["gate_tid2eid"],
                                       token_ids, cfg.routed_scaling_factor)
    else:
        weights, route_idx = score_gate(xf32, lw["gate_weight"], lw["gate_bias"], K,
                                        cfg.routed_scaling_factor)
    if tape is not None:
        weights, route_idx = tape("route", (weights, route_idx))

    g = quant.qlinear(x, lw["shared_w1"], plain).float()
    u = quant.qlinear(x, lw["shared_w3"], plain).float()
    shared = quant.qlinear(swiglu(g, u, limit).to(x.dtype), lw["shared_w2"], plain)

    fmt = _routed_experts(lw)
    w1, w2, w3 = lw["experts_w1"], lw["experts_w2"], lw["experts_w3"]
    M = T * K
    flat_e = route_idx.reshape(M).to(torch.int32)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    flat_w = weights.reshape(M)
    mine = None  # under tp: the rows routed to this rank's experts
    if tp is not None:
        if moe_chain:
            raise NotImplementedError("the fused expert chains (moe_chain=True) do not run "
                                      "under model parallelism, as in the JAX engine")
        if fmt == "int8":
            raise NotImplementedError("int8 experts do not run under model parallelism, "
                                      "as in the JAX engine")
        moe_chain = False
        # local ids; another rank's expert becomes E, which sorts last and
        # takes no work item of the grouped kernels; its rows are zeroed below
        flat_e = flat_e - tp.rank * E
        mine = (flat_e >= 0) & (flat_e < E)
        flat_e = torch.where(mine, flat_e, E)
    if T >= PREFILL_MOE_TOKENS and fmt == "bf16":
        per = bf16_grouped(x, w1, w2, w3, flat_e, flat_t, E, limit)
    elif T >= PREFILL_MOE_TOKENS:
        # rows sorted by expert in tiles of tm, pad rows carrying the last
        # expert id; K5 (fp4) or K7 (int8, scaled after) runs each tile's
        # expert segments
        order = torch.argsort(flat_e, stable=True)
        src_t = flat_t[order]
        e_sorted = flat_e[order]
        tm = 128 if M >= 128 else -(-M // 8) * 8
        Mp = -(-M // tm) * tm
        xs = F.pad(x.to(torch.bfloat16)[src_t], (0, 0, 0, Mp - M))
        e_pad = torch.cat([e_sorted, e_sorted[-1:].expand(Mp - M)])
        seg = k5.tile_segments(e_pad, tm, E)
        if fmt == "int8" and plain:
            def gemm(rows, w):
                return (k7.moe_int8_grouped_plain(rows, w["q"], *seg, tm=tm)
                        * _int8_srows(w, e_pad))
        elif fmt == "int8":
            work = k7.plan(*seg, tm, E)  # K7's work items, shared by w1, w3 and w2

            def gemm(rows, w):
                return (k7.moe_int8_grouped(rows, w["q"], *seg, tm=tm, plan=work)
                        * _int8_srows(w, e_pad))
        elif plain:
            def gemm(rows, w):
                return k5.moe_fp4_grouped_plain(rows, w["q"], w["s"], *seg, tm=tm)
        else:
            # under tp the rows of other ranks' experts (the sorted tail) are
            # owned by no work item, so K5 leaves them unwritten
            work = k5.plan(*seg, tm, E, own_tail=tp is None)  # shared by w1, w3 and w2

            def gemm(rows, w):
                return k5.moe_fp4_grouped(rows, w["q"], w["s"], *seg, tm=tm, plan=work)

        act = swiglu(gemm(xs, w1), gemm(xs, w3), limit)  # [Mp, I] f32
        per = torch.empty((M, x.shape[1]), dtype=torch.float32, device=x.device)
        per[order] = gemm(act.to(torch.bfloat16), w2)[:M]  # back to token order
    else:
        # decode: only the routed experts' weights are read, by one chain
        # launch a layer (K8 / K9) or three GEMVs (K6 / K3); plain bf16
        # stacks are gathered row by row (the JAX XLA path)
        xs = xf32[flat_t]
        chain = (fmt == "int8") if moe_chain is None else moe_chain
        if fmt == "bf16":
            rows_e = flat_e.long() if tp is None else flat_e.long().clamp(max=E - 1)

            def rows(inp, w):
                return quant.bmm_f32(inp.to(torch.bfloat16), w[rows_e])

            per = rows(swiglu(rows(xs, w1), rows(xs, w3), limit), w2)
        elif fmt == "int8" and chain and k8.int8_chain_supported(w1, w2, M):
            fn = k8.moe_int8_chain_plain if plain else k8.moe_int8_chain
            per = fn(xs, w1["q"], w3["q"], w2["q"], w1["s"], w3["s"], w2["s"], flat_e, limit)
        elif fmt == "fp4" and chain and k9.fp4_chain_supported(w1, w2, M):
            fn = k9.moe_fp4_chain_plain if plain else k9.moe_fp4_chain
            per = fn(xs, w1, w3, w2, flat_e, limit)
        else:
            if fmt == "int8":
                gemv8 = k6.moe_int8_gemv_plain if plain else k6.moe_int8_gemv

                def rows(inp, w):
                    return gemv8(inp, w["q"], flat_e) * _int8_srows(w, flat_e)
            else:
                gemv = k3.moe_fp4_gemv_plain if plain else k3.moe_fp4_gemv

                def rows(inp, w):
                    return gemv(inp, w["q"], w["s"], flat_e)

            act = swiglu(rows(xs, w1), rows(xs, w3), limit)  # [M, I] f32
            per = rows(act, w2)
    if mine is not None:  # rows of other ranks' experts: 0, whatever was left there
        per = torch.where(mine[:, None], per, 0.0)
    # each token's K routed rows, weighted and summed in a fixed order (no
    # atomics, so a run repeats to the bit)
    routed = (per * flat_w[:, None]).reshape(T, K, -1).sum(dim=1)
    if tp is not None:
        routed = tp.all_reduce_sum(routed)
    return (routed + shared.float()).to(x.dtype)


def _hc_branch(cfg, lw, streams, name):
    mixes = hc.hc_mixes(streams, lw[f"hc_{name}_fn"], cfg.rms_norm_eps)
    pre, post, comb = hc.hc_split_sinkhorn(
        mixes, lw[f"hc_{name}_scale"], lw[f"hc_{name}_base"], cfg.hc_mult,
        cfg.hc_sinkhorn_iters, cfg.hc_eps)
    return hc.hc_pre(streams, pre), post, comb


# ── Prefill ──────────────────────────────────────────────────────────────


def _embed(params, tokens, tp=None):
    """The embedding rows of ``tokens``; under ``tp`` the rank's vocabulary
    rows looked up (zeros for the others' tokens) and summed across the
    ranks, which is exact."""
    emb = params["embed"]
    if tp is None:
        return emb[tokens.long()]
    n = emb.shape[0]
    local = tokens.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    rows = torch.where(mine[:, None], emb[local.clamp(0, n - 1)], 0)
    return tp.all_reduce_sum(rows).to(emb.dtype)


def prefill(cfg: DSv4Config, params, tokens, state=None, slot=None,
            last_only: bool = False, plain_kernels: bool = False,
            moe_chain: Optional[bool] = None, tp=None, tape: Optional[RouteTape] = None):
    """Prefill one (unpadded) prompt. Returns (logits, caches | state):
    logits [T, V] f32, or [1, V] for the last token with ``last_only``.
    Without ``state`` the second value is the per-layer cache dicts; with
    ``state`` and ``slot``, the slot's decode caches are written in place
    and ``state`` is returned. ``moe_chain``, ``tp`` and ``tape``: see the
    module docstring."""
    T = tokens.shape[0]
    positions = torch.arange(T, device=tokens.device)
    streams = hc.hc_expand(_embed(params, tokens, tp), cfg.hc_mult)
    caches: List[Dict[str, Any]] = []
    for li, lw in enumerate(params["layers"]):
        streams, cache = _prefill_layer(
            cfg, lw, streams, tokens, positions, cfg.compress_ratios[li],
            li < cfg.n_hash_layers, _inv_freq(cfg, li, tokens.device), plain_kernels,
            moe_chain, tp, tape)
        caches.append(cache)
    logits = _head_logits(cfg, params, streams[-1:] if last_only else streams, tp)
    if state is None:
        return logits, caches
    _seed_state(cfg, state, caches, T, slot)
    return logits, state


def _prefill_layer(cfg, lw, streams, tokens, positions, ratio, is_hash, inv_freq, plain,
                   moe_chain, tp=None, tape=None):
    T = tokens.shape[0]
    h_in, post, comb = _hc_branch(cfg, lw, streams, "attn")
    h_norm = _rms(h_in, lw["attn_norm"], cfg.rms_norm_eps)
    q, qa = _attn_q(cfg, lw, h_norm, positions, inv_freq, plain)
    kv = _attn_kv(cfg, lw, h_norm, positions, inv_freq, plain)

    cache: Dict[str, Any] = {"kv": kv, "ckv": None, "ick": None}
    win_idx = dsa.window_indices(T, cfg.sliding_window, device=tokens.device)
    win_part = (kv[torch.clamp(win_idx, min=0).long()], win_idx >= 0)
    if ratio == 0:
        parts = [win_part]
    else:
        ckv, c_s, c_v = _compress_layer(cfg, lw["comp"], h_norm, ratio, inv_freq)
        cache["ckv"], cache["comp_sv"] = ckv, (c_s, c_v)
        valid = (positions + 1) // ratio
        if ratio == 4:
            ihd = cfg.index_head_dim
            iq = quant.qlinear(qa, lw["idx_wq_b"], plain).reshape(T, cfg.index_n_heads, ihd)
            iq = dsa.rope_interleaved(iq, positions[:, None], inv_freq, cfg.qk_rope_head_dim)
            ick, i_s, i_v = _compress_layer(cfg, lw["idx_comp"], h_norm, ratio, inv_freq)
            cache["ick"], cache["idx_sv"] = ick, (i_s, i_v)
            iw = h_norm @ lw["idx_weights_proj"].T  # [T, idx_heads]
            score_scale = 1.0 / math.sqrt(ihd) / math.sqrt(cfg.index_n_heads * _world(tp))
            scores = dsa.indexer_scores(iq, ick, iw, score_scale)
            if tp is not None:  # this rank's index heads: a partial sum
                scores = tp.all_reduce_sum(scores)
            sel = dsa.topk_mask(scores, cfg.index_topk, valid)
            if tape is not None:
                (sel,) = tape("select", (sel,))
        else:  # non-overlap: the causal prefix of compressed rows
            sel = torch.arange(ckv.shape[0], device=tokens.device)[None, :] < valid[:, None]
        parts = [win_part, (ckv, sel)]

    o = dsa.sparse_attention_parts(q, parts, lw["attn_sink"], cfg.head_dim ** -0.5)
    streams = hc.hc_post(_attn_out(cfg, lw, o, plain, tp), streams, post, comb)

    f_in, post, comb = _hc_branch(cfg, lw, streams, "ffn")
    f_norm = _rms(f_in, lw["ffn_norm"], cfg.rms_norm_eps)
    ffn_out = _moe(cfg, lw, is_hash, f_norm, tokens, plain, moe_chain, tp, tape)
    return hc.hc_post(ffn_out, streams, post, comb), cache


def _ring_seed(dst, slot: int, src, seq_len: int, R: int):
    """Fill the ring dst[slot] ([R, d], keyed by position % R) from src
    [T, d]: ring slot r gets the last position p < seq_len with p % R == r;
    slots no position reaches keep their rows (decode rewrites them before
    any read)."""
    r = torch.arange(R, device=dst.device)
    p = seq_len - 1 - ((seq_len - 1 - r) % R)
    rows = src[torch.clamp(p, min=0)].to(dst.dtype)
    dst[slot] = torch.where((p >= 0)[:, None], rows, dst[slot])


def _seed_state(cfg: DSv4Config, state, caches, seq_len: int, slot: int) -> None:
    """Write a prefilled request's caches into its decode slot, in place."""
    slot = int(slot)
    for li, cache in enumerate(caches):
        ratio = cfg.compress_ratios[li]
        ls = state["layers"][li]
        _ring_seed(ls["kv"], slot, cache["kv"], seq_len, cfg.sliding_window)
        if ratio > 0:
            R = 8 if ratio == 4 else ratio
            C = min(cache["ckv"].shape[0], ls["ckv"].shape[1] - 1)
            ls["ckv"][slot, :C] = cache["ckv"][:C].to(ls["ckv"].dtype)
            c_s, c_v = cache["comp_sv"]
            _ring_seed(ls["ps"], slot, c_s, seq_len, R)
            _ring_seed(ls["pv"], slot, c_v, seq_len, R)
        if ratio == 4:
            Ci = min(cache["ick"].shape[0], ls["ick"].shape[1] - 1)
            ls["ick"][slot, :Ci] = cache["ick"][:Ci].to(ls["ick"].dtype)
            i_s, i_v = cache["idx_sv"]
            _ring_seed(ls["ips"], slot, i_s, seq_len, 8)
            _ring_seed(ls["ipv"], slot, i_v, seq_len, 8)


# ── Decode ───────────────────────────────────────────────────────────────


def _decode_layer(cfg, lw, ls, streams, tokens, positions, slots, ratio, is_hash,
                  inv_freq, plain, moe_chain, tp=None, tape=None):
    """One decode layer; updates this layer's slot caches ``ls`` in place."""
    W = cfg.sliding_window
    pos, sl = positions.long(), slots.long()
    h_in, post, comb = _hc_branch(cfg, lw, streams, "attn")
    h_norm = _rms(h_in, lw["attn_norm"], cfg.rms_norm_eps)
    q, qa = _attn_q(cfg, lw, h_norm, positions, inv_freq, plain)  # [B, H, hd]
    kv_new = _attn_kv(cfg, lw, h_norm, positions, inv_freq, plain)  # [B, hd]
    ls["kv"][sl, pos % W] = kv_new.to(ls["kv"].dtype)

    # window part: the ring itself (slot r live iff r <= pos; the softmax
    # does not care about the ring's order)
    win_rows = ls["kv"][sl]  # [B, W, hd]
    win_valid = torch.arange(W, device=pos.device)[None, :] <= pos[:, None]
    if ratio == 0:
        parts = [(win_rows, win_valid)]
    else:
        R = 8 if ratio == 4 else ratio
        comp = lw["comp"]
        s_new, v_new = _compress_scores_values(h_norm, comp)
        ls["ps"][sl, pos % R] = s_new
        ls["pv"][sl, pos % R] = v_new
        n_blocks = (pos + 1) // ratio  # valid compressed rows
        emit = (pos + 1) % ratio == 0
        max_blocks = ls["ckv"].shape[1] - 1
        c_idx = torch.where(emit, torch.clamp(n_blocks - 1, max=max_blocks - 1), max_blocks)
        block = _emit_compressed_block(cfg, comp, ls["ps"][sl], ls["pv"][sl], pos, ratio,
                                       inv_freq)
        ls["ckv"][sl, c_idx] = block.to(ls["ckv"].dtype)
        if ratio == 4:
            icomp = lw["idx_comp"]
            is_new, iv_new = _compress_scores_values(h_norm, icomp)
            ls["ips"][sl, pos % 8] = is_new
            ls["ipv"][sl, pos % 8] = iv_new
            iblock = _emit_compressed_block(cfg, icomp, ls["ips"][sl], ls["ipv"][sl], pos,
                                            ratio, inv_freq)
            ls["ick"][sl, c_idx] = iblock.to(ls["ick"].dtype)
            ihd = cfg.index_head_dim
            iq = quant.qlinear(qa, lw["idx_wq_b"], plain).reshape(-1, cfg.index_n_heads, ihd)
            iq = dsa.rope_interleaved(iq, positions[:, None], inv_freq, cfg.qk_rope_head_dim)
            iw = h_norm @ lw["idx_weights_proj"].T
            score_scale = 1.0 / math.sqrt(ihd) / math.sqrt(cfg.index_n_heads * _world(tp))
            dots = torch.einsum("bhd,bcd->bhc", iq.float(),
                                ls["ick"][sl, :max_blocks].float())
            scores = torch.einsum("bh,bhc->bc", iw.float(), torch.relu(dots)) * score_scale
            if tp is not None:  # this rank's index heads: a partial sum
                scores = tp.all_reduce_sum(scores)
            # gather only the top-k compressed rows; invalid picks read the
            # dead column and are masked out of the softmax
            top_ids, top_valid = dsa.topk_select(scores, cfg.index_topk, n_blocks)
            if tape is not None:
                top_ids, top_valid = tape("select", (top_ids, top_valid))
            safe_ids = torch.where(top_valid, top_ids.long(), max_blocks)
            parts = [(win_rows, win_valid), (ls["ckv"][sl[:, None], safe_ids], top_valid)]
        else:  # every valid block
            cand = torch.arange(max_blocks, device=pos.device)[None, :]
            parts = [(win_rows, win_valid),
                     (ls["ckv"][sl, :max_blocks], cand < n_blocks[:, None])]

    # B queries of one token each: per-query candidate rows
    o = dsa.sparse_attention_parts(q, parts, lw["attn_sink"], cfg.head_dim ** -0.5)
    streams = hc.hc_post(_attn_out(cfg, lw, o, plain, tp), streams, post, comb)

    f_in, post, comb = _hc_branch(cfg, lw, streams, "ffn")
    f_norm = _rms(f_in, lw["ffn_norm"], cfg.rms_norm_eps)
    ffn_out = _moe(cfg, lw, is_hash, f_norm, tokens, plain, moe_chain, tp, tape)
    return hc.hc_post(ffn_out, streams, post, comb)


def _head_logits(cfg: DSv4Config, params, streams, tp=None):
    """Logits [N, V] f32; under ``tp`` the rank's vocabulary shard, gathered."""
    mixes = hc.hc_mixes(streams, params["hc_head_fn"], cfg.rms_norm_eps)
    pre = hc.hc_head_pre(mixes, params["hc_head_scale"], params["hc_head_base"],
                         cfg.hc_mult, cfg.hc_eps)
    xf = _rms(hc.hc_pre(streams, pre), params["norm"], cfg.rms_norm_eps)
    logits = (xf @ params["head"].T).float()
    return logits if tp is None else tp.gather_vocab(logits)


def decode(cfg: DSv4Config, params, state, tokens, positions, slots,
           plain_kernels: bool = False, moe_chain: Optional[bool] = None, tp=None,
           tape: Optional[RouteTape] = None):
    """One decode step for a batch. tokens/positions/slots: [B] int32
    (padding rows: the dead slot, position 0). Updates ``state`` in place;
    returns logits [B, V] f32. ``moe_chain``, ``tp`` and ``tape``: see the
    module docstring."""
    streams = hc.hc_expand(_embed(params, tokens, tp), cfg.hc_mult)
    for li, lw in enumerate(params["layers"]):
        streams = _decode_layer(
            cfg, lw, state["layers"][li], streams, tokens, positions, slots,
            cfg.compress_ratios[li], li < cfg.n_hash_layers,
            _inv_freq(cfg, li, tokens.device), plain_kernels, moe_chain, tp, tape)
    return _head_logits(cfg, params, streams, tp)


# ── Slot snapshots (the slot prefix cache, PD handoff) ───────────────────


def slot_export(state, slot: int):
    """A copy of ``slot``'s rows in every layer's caches (the JAX
    ``slot_export``): the window ring, the compressed rows and the running
    compressor rings are the request's whole attention state. Later steps
    overwrite the slot in place, so a view would change under the cache."""
    return {"layers": [{key: rows[slot].clone() for key, rows in ls.items()}
                       for ls in state["layers"]]}


def slot_import(state, snap, slot: int) -> None:
    """Copy a snapshot into ``slot``'s rows (the JAX ``slot_import``); the
    snapshot stays its owner's. A snapshot on the host is copied over."""
    for ls, rows in zip(state["layers"], snap["layers"]):
        for key, cache in ls.items():
            cache[slot].copy_(rows[key])


def snapshot_bytes(state) -> int:
    """Bytes of one slot's rows (what ``slot_export`` copies)."""
    return sum(c.numel() // c.shape[0] * c.element_size()
               for ls in state["layers"] for c in ls.values())


def prefill_resume(cfg: DSv4Config, params, state, tokens, start_pos: int, slot: int,
                   plain_kernels: bool = False, moe_chain: Optional[bool] = None, tp=None,
                   tape: Optional[RouteTape] = None):
    """Continue a prompt from a cached prefix (the JAX
    ``prefill_resume_grouped``): feed the suffix ``tokens`` [n] one token a
    step through ``decode`` at B = 1 on ``slot``, at positions ``start_pos
    + i``. DSv4's state depends on position (window ring, running
    compressor rings), so continuing a prompt is exactly a run of decode
    steps. The JAX function pads the suffix to a power of two and sends the
    padding steps to the dead slot to bound its compiles; eager code has no
    compiles to bound, so this runs exactly n steps. Returns the last
    step's logits [V] f32. ``tp`` and ``tape``: see the module docstring."""
    if tokens.shape[0] == 0:
        raise ValueError("prefill_resume needs at least one token")
    n, dev = tokens.shape[0], tokens.device
    # made on the device (no host copy a step)
    slots = torch.full((1,), slot, dtype=torch.int32, device=dev)
    positions = torch.arange(start_pos, start_pos + n, dtype=torch.int32, device=dev)
    for i in range(n):
        logits = decode(cfg, params, state, tokens[i:i + 1], positions[i:i + 1], slots,
                        plain_kernels=plain_kernels, moe_chain=moe_chain, tp=tp, tape=tape)
    return logits[0]
