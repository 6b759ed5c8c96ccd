"""DeepSeek-V4 mp8 checkpoint loader: the port's counterpart of
``pegainfer_tpu/models/dsv4_weights.py::load_params``.

The checkpoint is ``<model>/mp8/model{rank}-mp8.safetensors`` for ranks
0-7: vocab, attention-head, o-group, index-head and expert shards per rank,
and replicated norms, hyper-connection tensors, compressors, gates and
shared experts (``models/dsv4_manifest.py`` gives the schema). The tree is
the JAX loader's on one device, key for key and bit for bit:

- ``resident=True``: fp8 linears stay ``{"q": float8_e4m3fn, "s": bf16}``
  containers and the routed experts ``{"q": uint8 [E, out, in/2], "s":
  bf16}`` packed-fp4 stacks, their E8M0 (or f32) scales made bf16, which is
  exact for powers of two;
- ``resident=False`` (the engine's ``quantize="bf16"``): every fp8 / fp4
  tensor dequantized at load and stored in bf16, also exact (E4M3 or E2M1
  values times powers of two).

Sharded tensors are concatenated over the ranks in rank order (``wo_b`` on
its input axis), expert ``rank * E_loc + i`` is rank ``rank``'s i-th, hc
tensors, ``attn_sink``, ``gate_bias`` and the compressors' ``ape`` stay
f32, ``gate_tid2eid`` is int32 and every other plain tensor bf16.

The load streams: each tensor (one expert's, one rank's shard) is read
with a seek, copied to the device and written into its leaf, which is
allocated once there; the bf16 mode dequantizes on the device. The host
holds one tensor at a time, never a rank file or a stack.

``load_params_rank`` is the model-parallel load (the JAX
``load_params_sharded``): rank r of N reads only the checkpoint ranks r·8/N
… (r+1)·8/N − 1, joins their pieces into its shard (8 / N checkpoint ranks
folded into one) and takes the whole tensors from the first of them, so
the whole tree is never built; the shard is ``parallel/sharding.py::
shard_dsv4``'s of the whole tree, bit for bit.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from pegainfer_tpu_torch.models.dsv4 import DSv4Config
from pegainfer_tpu_torch.models.dsv4_manifest import WORLD, rank_files, validate_checkpoint
from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.utils.device import resolve_device
from pegainfer_tpu_torch.utils.weights import E8M0, F4_DTYPES, SafetensorsReader


def check_grid(q_shape: Sequence[int], s_shape: Sequence[int], prefix: str) -> None:
    """The container's block grid follows from the shape ratios
    (``quant.dequant_any``), which is exact only when each scale dim is one
    block or the weight's dim over 128: anything else must not load."""
    for ax in (-2, -1):
        if not (s_shape[ax] == 1 or q_shape[ax] == 128 * s_shape[ax]):
            raise ValueError(f"{prefix}: scales {tuple(s_shape)} are no 128-block grid of "
                             f"{tuple(q_shape)}")


def _validate(cfg: DSv4Config, model_path: str) -> None:
    problems = validate_checkpoint(cfg, model_path)
    if problems:
        raise ValueError(f"mp8 checkpoint fails manifest validation ({len(problems)} "
                         f"problems): {'; '.join(problems[:5])}")


def load_params(cfg: DSv4Config, model_path: str, resident: bool = True,
                validate: bool = True, device=None) -> Dict[str, Any]:
    """The params tree of an mp8 checkpoint on ``device`` (``cuda`` unless
    the caller asks for another). With ``validate`` the headers are held to
    the manifest first and a checkpoint with problems raises ValueError
    before any tensor is read."""
    if validate:
        _validate(cfg, model_path)
    ranks = list(enumerate(SafetensorsReader(p) for p in rank_files(model_path)))
    return _load(cfg, ranks, resident, resolve_device(device))


def load_params_rank(cfg: DSv4Config, model_path: str, rank: int, tp: int,
                     resident: bool = True, device=None, validate: bool = True,
                     files_read: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """Rank ``rank``'s shard of an mp8 checkpoint at model-parallel width
    ``tp`` (1, 2, 4 or 8) on ``device``: the manifest check over every
    file's header first (``validate``), then only its own rank files'
    tensors (module docstring). ``files_read``, when given, gets each file
    this load read tensors from, with the bytes read."""
    if tp not in (1, 2, 4, 8) or not 0 <= rank < tp:
        raise ValueError(f"rank {rank} of tp={tp}: tp must divide the mp8 world {WORLD}")
    if validate:
        _validate(cfg, model_path)
    per = WORLD // tp
    paths = rank_files(model_path)[rank * per:(rank + 1) * per]
    ranks = [(rank * per + i, SafetensorsReader(p)) for i, p in enumerate(paths)]
    tree = _load(cfg, ranks, resident, resolve_device(device))
    if files_read is not None:
        for _, r in ranks:
            files_read[os.path.basename(r.path)] = r.bytes_read
    return tree


def _load(cfg: DSv4Config, readers: List[Tuple[int, SafetensorsReader]], resident: bool,
          dev: torch.device) -> Dict[str, Any]:
    """The tree of the checkpoint ranks ``readers`` ((mp8 rank, reader), in
    rank order): their pieces of the sharded tensors joined, the whole
    tensors from the first."""
    ranks = [r for _, r in readers]
    bf16 = torch.bfloat16

    def get(r, name):  # one tensor's stored bits on the device
        return r.read(name).to(dev)

    def scale(r, name):  # an E8M0 or f32 scale as f32 on the device
        s = get(r, name)
        return quant.e8m0_to_float(s) if r.stored_dtype(name) == E8M0 else s.float()

    def parts(sharded: bool):
        return ranks if sharded else ranks[:1]

    def joined(shape, n: int, axis: int, dtype):  # a leaf of n parts along axis
        full = list(shape)
        full[axis] *= n
        return torch.empty(full, dtype=dtype, device=dev)

    def plain(name, dtype=bf16, sharded=False, axis=0):
        rs = parts(sharded)
        out = joined(rs[0].shape(name), len(rs), axis, dtype)
        for i, part in enumerate(out.chunk(len(rs), dim=axis)):
            part.copy_(get(rs[i], name))
        return out

    def fp8(prefix, sharded=False, axis=0):
        rs, wn, sn = parts(sharded), f"{prefix}.weight", f"{prefix}.scale"
        q_shape, s_shape = rs[0].shape(wn), rs[0].shape(sn)
        if resident:
            q, s = joined(q_shape, len(rs), axis, quant.F8), joined(s_shape, len(rs), axis,
                                                                    quant.SCALE_DTYPE)
        else:
            w = joined(q_shape, len(rs), axis, bf16)
        for i, r in enumerate(rs):
            check_grid(r.shape(wn), r.shape(sn), prefix)
            qi, si = get(r, wn), scale(r, sn)
            if resident:
                q.chunk(len(rs), dim=axis)[i].copy_(qi)
                s.chunk(len(rs), dim=axis)[i].copy_(si)
            else:
                w.chunk(len(rs), dim=axis)[i].copy_(quant.dequant_any({"q": qi, "s": si}, bf16))
        return {"q": q, "s": s} if resident else w

    def experts(pre, name, E_loc):
        """Every rank's ``{pre}.ffn.experts.{ge}.{name}`` into one [E, out,
        in] stack: packed fp4 (fixtures' E4M3 containers of E2M1 values
        repacked on the host, exactly) or bf16."""
        first = f"{pre}.ffn.experts.{readers[0][0] * E_loc}.{name}"
        out_d, in_d = ranks[0].shape(f"{first}.weight")
        s_shape = ranks[0].shape(f"{first}.scale")
        if not (s_shape[-1] == 1 or in_d == 32 * s_shape[-1]):
            raise ValueError(f"{first}: scales {s_shape} are no 32-group grid of "
                             f"[{out_d}, {in_d}]")
        E = len(ranks) * E_loc
        if resident:
            q = torch.empty((E, out_d, in_d // 2), dtype=torch.uint8, device=dev)
            s = torch.empty((E, *s_shape), dtype=quant.SCALE_DTYPE, device=dev)
        else:
            w = torch.empty((E, out_d, in_d), dtype=bf16, device=dev)
        for i, (rank, r) in enumerate(readers):
            for le in range(E_loc):
                ge = rank * E_loc + le
                base = f"{pre}.ffn.experts.{ge}.{name}"
                wn, sn = f"{base}.weight", f"{base}.scale"
                packed = r.stored_dtype(wn) in F4_DTYPES
                at = i * E_loc + le  # the expert's place in this stack
                if resident:
                    q[at] = get(r, wn) if packed else torch.from_numpy(
                        quant.pack_fp4(r.read(wn).float().numpy()))
                    s[at] = scale(r, sn)
                else:  # an E4M3 container dequantizes as a [1, 32] block grid
                    w[at] = quant.dequant_any({"q": get(r, wn), "s": scale(r, sn)}, bf16)
        return {"q": q, "s": s} if resident else w

    def compressor(prefix):
        # by name, as the JAX loader maps them (models/dsv4.py keeps the
        # reference's order of the two in its compressor call)
        return {"ape": plain(f"{prefix}.ape", torch.float32),
                "wkv": plain(f"{prefix}.wkv.weight"),
                "wgate": plain(f"{prefix}.wgate.weight"),
                "norm": plain(f"{prefix}.norm.weight")}

    E_loc = cfg.n_routed_experts // WORLD
    f32 = torch.float32
    layers = []
    for li in range(cfg.n_layers):
        pre = f"layers.{li}"
        ratio = cfg.compress_ratios[li]
        lw: Dict[str, Any] = {
            "attn_norm": plain(f"{pre}.attn_norm.weight"),
            "ffn_norm": plain(f"{pre}.ffn_norm.weight"),
            **{k: plain(f"{pre}.{k}", f32)
               for k in ("hc_attn_fn", "hc_attn_base", "hc_attn_scale", "hc_ffn_fn",
                         "hc_ffn_base", "hc_ffn_scale")},
            "attn_sink": plain(f"{pre}.attn.attn_sink", f32, sharded=True),
            "q_norm": plain(f"{pre}.attn.q_norm.weight"),
            "kv_norm": plain(f"{pre}.attn.kv_norm.weight"),
            "wq_a": fp8(f"{pre}.attn.wq_a"),
            "wq_b": fp8(f"{pre}.attn.wq_b", sharded=True),
            "wkv": fp8(f"{pre}.attn.wkv"),
            "wo_a": plain(f"{pre}.attn.wo_a.weight", sharded=True),
            # wo_b shards on its input axis: a rank holds its o-groups' columns
            "wo_b": fp8(f"{pre}.attn.wo_b", sharded=True, axis=1),
            "gate_weight": plain(f"{pre}.ffn.gate.weight"),
            "shared_w1": fp8(f"{pre}.ffn.shared_experts.w1"),
            "shared_w2": fp8(f"{pre}.ffn.shared_experts.w2"),
            "shared_w3": fp8(f"{pre}.ffn.shared_experts.w3"),
        }
        if li < cfg.n_hash_layers:
            lw["gate_tid2eid"] = plain(f"{pre}.ffn.gate.tid2eid", torch.int32)
        else:
            lw["gate_bias"] = plain(f"{pre}.ffn.gate.bias", f32)
        for name in ("w1", "w2", "w3"):
            lw[f"experts_{name}"] = experts(pre, name, E_loc)
        if ratio > 0:
            lw["comp"] = compressor(f"{pre}.attn.compressor")
        if ratio == 4:
            ip = f"{pre}.attn.indexer"
            lw["idx_wq_b"] = fp8(f"{ip}.wq_b", sharded=True)
            lw["idx_weights_proj"] = plain(f"{ip}.weights_proj.weight", sharded=True)
            lw["idx_comp"] = compressor(f"{ip}.compressor")
        layers.append(lw)

    return {
        "embed": plain("embed.weight", sharded=True),
        "head": plain("head.weight", sharded=True),
        "norm": plain("norm.weight"),
        "hc_head_fn": plain("hc_head_fn", f32),
        "hc_head_base": plain("hc_head_base", f32),
        "hc_head_scale": plain("hc_head_scale", f32),
        "layers": layers,
    }
