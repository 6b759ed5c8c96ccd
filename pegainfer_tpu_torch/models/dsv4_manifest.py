"""DeepSeek-V4 mp8 checkpoint manifest: the port's copy of
``pegainfer_tpu/models/dsv4_manifest.py``.

Before a load, every rank file ``mp8/model{rank}-mp8.safetensors`` is held
to the expected tensor set with its per-rank shard shapes and dtypes, from
the eight headers alone (``deep=True`` also compares the small replicated
tensors across ranks by value, reading their bytes). The schema is the one
``models/dsv4_weights.py::load_params`` reads, and the problems are the JAX
function's strings.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from pegainfer_tpu_torch.models.dsv4 import DSv4Config
from pegainfer_tpu_torch.utils.weights import SafetensorsReader

WORLD = 8

# the stored dtypes a tensor may have (test fixtures use wider containers
# where the safetensors package lacks the narrow dtype)
BF16 = ("BF16",)
F32 = ("F32",)
FP8_W = ("F8_E4M3",)
SCALE = ("F8_E8M0", "F32")  # a real checkpoint's E8M0; fixtures' exact powers of two
FP4_W = ("F4", "F4_E2M1", "F4_E2M1_X2", "F8_E4M3")  # packed F4 or a container
INT = ("I32", "I64")


def rank_files(model_path: str) -> List[str]:
    return [os.path.join(model_path, "mp8", f"model{r}-mp8.safetensors") for r in range(WORLD)]


@dataclass
class ExpectedTensor:
    shape: Tuple[int, ...]
    dtypes: Tuple[str, ...]
    # a block-scale grid: a scale dim is 1 (one block) or the weight's dim
    # over the block
    scale_of: Tuple[int, ...] = ()
    scale_block: Tuple[int, int] = (128, 128)

    def check(self, name: str, shape: Tuple[int, ...], dtype: str,
              errors: List[str]) -> None:
        if dtype not in self.dtypes:
            errors.append(f"{name}: dtype {dtype}, expected one of {self.dtypes}")
        if self.scale_of:
            if len(shape) != len(self.scale_of):
                errors.append(f"{name}: scale rank {shape} vs {self.scale_of}")
                return
            for ax in range(len(shape)):
                q, s = self.scale_of[ax], shape[ax]
                blk = self.scale_block[ax - len(shape) + 2] if ax >= len(shape) - 2 else 1
                # the exact-grid rule of the loader's check_grid
                ok = (s == q) if blk == 1 else (s == 1 or q == blk * s)
                if not ok:
                    errors.append(f"{name}: scale dim {ax} = {s} fits neither 1 nor "
                                  f"{q}/{blk} for weight {self.scale_of}")
            return
        # a packed-F4 header carries the logical shape
        if tuple(shape) != tuple(self.shape):
            errors.append(f"{name}: shape {tuple(shape)}, expected {self.shape}")


def _fp8(man: Dict[str, ExpectedTensor], prefix: str, shape: Tuple[int, ...]) -> None:
    man[f"{prefix}.weight"] = ExpectedTensor(shape, FP8_W)
    man[f"{prefix}.scale"] = ExpectedTensor((), SCALE, scale_of=shape)


def _fp4(man: Dict[str, ExpectedTensor], prefix: str, shape: Tuple[int, ...]) -> None:
    man[f"{prefix}.weight"] = ExpectedTensor(shape, FP4_W)
    man[f"{prefix}.scale"] = ExpectedTensor((), SCALE, scale_of=shape, scale_block=(1, 32))


def expected_rank_manifest(cfg: DSv4Config, rank: int) -> Dict[str, ExpectedTensor]:
    """Tensor name -> expected per-rank shard shape and dtypes of one mp8
    rank file; the loader's reads exactly."""
    D, n = cfg.dim, cfg.hc_mult
    H, hd = cfg.num_attention_heads, cfg.head_dim
    V, E = cfg.vocab_size, cfg.n_routed_experts
    mix_hc = (2 + n) * n
    for dim, what in ((V, "vocab"), (H, "heads"),
                      (cfg.o_groups * cfg.o_lora_rank, "o-group lora"),
                      (E, "experts"), (cfg.index_n_heads, "index heads")):
        if dim % WORLD:
            raise ValueError(f"{what} ({dim}) not divisible by world {WORLD}")
    E_loc = E // WORLD

    man: Dict[str, ExpectedTensor] = {
        "embed.weight": ExpectedTensor((V // WORLD, D), BF16),
        "head.weight": ExpectedTensor((V // WORLD, D), BF16),
        "norm.weight": ExpectedTensor((D,), BF16),
        "hc_head_fn": ExpectedTensor((n, n * D), F32),
        "hc_head_base": ExpectedTensor((n,), F32),
        "hc_head_scale": ExpectedTensor((1,), F32),
    }
    for li in range(cfg.n_layers):
        p = f"layers.{li}"
        ratio = cfg.compress_ratios[li]
        man[f"{p}.attn_norm.weight"] = ExpectedTensor((D,), BF16)
        man[f"{p}.ffn_norm.weight"] = ExpectedTensor((D,), BF16)
        for side in ("attn", "ffn"):
            man[f"{p}.hc_{side}_fn"] = ExpectedTensor((mix_hc, n * D), F32)
            man[f"{p}.hc_{side}_base"] = ExpectedTensor((mix_hc,), F32)
            man[f"{p}.hc_{side}_scale"] = ExpectedTensor((3,), F32)
        man[f"{p}.attn.attn_sink"] = ExpectedTensor((H // WORLD,), F32)
        man[f"{p}.attn.q_norm.weight"] = ExpectedTensor((cfg.q_lora_rank,), BF16)
        man[f"{p}.attn.kv_norm.weight"] = ExpectedTensor((hd,), BF16)
        _fp8(man, f"{p}.attn.wq_a", (cfg.q_lora_rank, D))
        _fp8(man, f"{p}.attn.wq_b", (H * hd // WORLD, cfg.q_lora_rank))
        _fp8(man, f"{p}.attn.wkv", (hd, D))
        man[f"{p}.attn.wo_a.weight"] = ExpectedTensor(
            (cfg.o_groups * cfg.o_lora_rank // WORLD, H * hd // cfg.o_groups), BF16)
        _fp8(man, f"{p}.attn.wo_b", (D, cfg.o_groups * cfg.o_lora_rank // WORLD))
        man[f"{p}.ffn.gate.weight"] = ExpectedTensor((E, D), BF16)
        if li < cfg.n_hash_layers:
            man[f"{p}.ffn.gate.tid2eid"] = ExpectedTensor((V, cfg.n_activated_experts), INT)
        else:
            man[f"{p}.ffn.gate.bias"] = ExpectedTensor((E,), F32)
        _fp8(man, f"{p}.ffn.shared_experts.w1", (cfg.moe_inter_dim, D))
        _fp8(man, f"{p}.ffn.shared_experts.w2", (D, cfg.moe_inter_dim))
        _fp8(man, f"{p}.ffn.shared_experts.w3", (cfg.moe_inter_dim, D))
        for le in range(E_loc):
            ge = rank * E_loc + le
            _fp4(man, f"{p}.ffn.experts.{ge}.w1", (cfg.moe_inter_dim, D))
            _fp4(man, f"{p}.ffn.experts.{ge}.w2", (D, cfg.moe_inter_dim))
            _fp4(man, f"{p}.ffn.experts.{ge}.w3", (cfg.moe_inter_dim, D))
        if ratio > 0:
            coff = 2 if ratio == 4 else 1
            cp = f"{p}.attn.compressor"
            man[f"{cp}.ape"] = ExpectedTensor((ratio, coff * hd), F32)
            man[f"{cp}.wkv.weight"] = ExpectedTensor((coff * hd, D), BF16)
            man[f"{cp}.wgate.weight"] = ExpectedTensor((coff * hd, D), BF16)
            man[f"{cp}.norm.weight"] = ExpectedTensor((hd,), BF16)
        if ratio == 4:
            ihd = cfg.index_head_dim
            ip = f"{p}.attn.indexer"
            _fp8(man, f"{ip}.wq_b", (cfg.index_n_heads * ihd // WORLD, cfg.q_lora_rank))
            man[f"{ip}.weights_proj.weight"] = ExpectedTensor(
                (cfg.index_n_heads // WORLD, D), BF16)
            icp = f"{ip}.compressor"
            man[f"{icp}.ape"] = ExpectedTensor((ratio, 2 * ihd), F32)
            man[f"{icp}.wkv.weight"] = ExpectedTensor((2 * ihd, D), BF16)
            man[f"{icp}.wgate.weight"] = ExpectedTensor((2 * ihd, D), BF16)
            man[f"{icp}.norm.weight"] = ExpectedTensor((ihd,), BF16)
    return man


# replicated tensors small enough to compare across ranks
_DEEP_KEYS = ("norm.weight", "hc_head_fn", "hc_head_base", "hc_head_scale")


def validate_checkpoint(cfg: DSv4Config, model_path: str, deep: bool = False) -> List[str]:
    """Every rank file against its expected manifest, from the headers.
    Returns the problems (empty: the checkpoint loads)."""
    errors: List[str] = []
    readers = []
    for rank, path in enumerate(rank_files(model_path)):
        if not os.path.exists(path):
            errors.append(f"rank {rank}: missing file {path}")
            continue
        readers.append((rank, SafetensorsReader(path)))

    for rank, r in readers:
        man = expected_rank_manifest(cfg, rank)
        seen = set(r.keys())
        for name in sorted(set(man) - seen):
            errors.append(f"rank {rank}: missing tensor {name}")
        for name in sorted(seen - set(man)):
            errors.append(f"rank {rank}: unexpected tensor {name}")
        for name in sorted(seen & set(man)):
            man[name].check(f"rank {rank}: {name}", r.shape(name), r.stored_dtype(name), errors)

    if deep and len(readers) == WORLD and not errors:
        for name in _DEEP_KEYS:
            ref = readers[0][1].read(name)
            for rank, r in readers[1:]:
                if not torch.equal(r.read(name), ref):
                    errors.append(f"rank {rank}: replicated tensor {name} differs from rank 0")
    return errors
