"""DeepSeek-V4 engine startup: mp8 checkpoint or parameters -> slot state
-> SlotExecutor -> scheduler. Counterpart of
``pegainfer_tpu/models/dsv4_engine.py`` on one device.

It serves resident fp8 / packed-fp4 weights (the JAX engine's
``quantize=None``, checkpoint-exact, with its fused kernels on), with
``quantize="int8-experts"`` (or ``PEGAINFER_DSV4_EXPERTS=int8``) the same
weights with the routed experts requantized to int8 per output channel at
start (the JAX engine's speed mode), or with ``quantize="bf16"`` every fp8
/ fp4 tensor dequantized to bf16 at load (the numerics oracle; no kernel).
``start_engine(path)`` loads the mp8 checkpoint (``models/dsv4_weights.py``,
validated against ``dsv4_manifest.py`` first). ``decode_block``,
``decode_block_max`` and ``decode_pipeline_depth`` go to the executor and
its scheduler (blocks of N steps, graphed at first use). Runs on ``cuda``
unless the caller passes another device; with no card it raises instead of
running on the CPU.

``tp_size`` N in {2, 4, 8} serves the model split as the reference's mp8
ranks (the JAX engine's MP8 mesh; unset, one process whatever the card
count, where the JAX engine takes the largest world the devices allow):
one process a rank
(``parallel/tp_executor.py``), rank r on ``cuda:{device_ordinals[r]}`` when
the options list one ordinal a rank (``[0, 0]``: two ranks on one card,
over gloo), else on the first N cards (NCCL); ``device="cpu"`` puts every
rank on the CPU. Each rank holds its heads, o-groups, index heads, E / N
routed experts and vocabulary rows (``parallel/sharding.py::shard_dsv4``,
or from a checkpoint ``dsv4_weights.load_params_rank``: its own rank files
only), the whole slot state and its own slot prefix cache, its size agreed
by the ranks. It serves resident fp4 weights and ``quantize="bf16"``; as
the JAX engine, ``quantize="int8-experts"`` raises ValueError there and
``PEGAINFER_DSV4_EXPERTS=int8`` is ignored with its warning. The decode
step is eager: the graph options, ``moe_chain=True`` (the fused chains),
``PEGAINFER_DSV4_EP`` (the JAX engine's token-shipping expert transport)
and the PD hooks raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import replace
from typing import Optional

import torch

from pegainfer_tpu_torch.engine.contract import EngineHandle, EngineLoadOptions
from pegainfer_tpu_torch.engine.scheduler import start_scheduler
from pegainfer_tpu_torch.engine.slot_executor import SlotExecutor, check_supported
from pegainfer_tpu_torch.engine.torch_executor import check_tp_supported
from pegainfer_tpu_torch.models import dsv4
from pegainfer_tpu_torch.models.dsv4_weights import load_params, load_params_rank
from pegainfer_tpu_torch.ops import quant
from pegainfer_tpu_torch.parallel import sharding, tp_executor
from pegainfer_tpu_torch.utils.device import resolve_device

log = logging.getLogger("pegainfer_torch.dsv4")

DEFAULT_MAX_MODEL_LEN = 4096
MAX_SLOTS = 2  # the reference serves batch <= 2


def probe_model(model_path: str) -> bool:
    """Whether ``model_path`` holds a DeepSeek-V4 checkpoint."""
    try:
        with open(os.path.join(model_path, "config.json")) as f:
            c = json.load(f)
    except OSError:
        return False
    return c.get("model_type") == "deepseek_v4"


def max_blocks_for(cfg: dsv4.DSv4Config, max_model_len: int) -> int:
    """Compressed-cache rows a slot needs for ``max_model_len`` tokens."""
    ratios = [r for r in cfg.compress_ratios if r > 0]
    if not ratios:
        return 1
    return -(-max_model_len // min(ratios))


def resolve_tp_size(tp_size: Optional[int], n_devices: int) -> int:
    """The JAX ``resolve_tp_size``: an explicit ``tp_size`` (1, 2, 4 or 8, at
    most ``n_devices``), else the largest divisor of the mp8 world 8 that
    the devices allow (the reference is a fixed world of 8; a smaller world
    folds 8 / n checkpoint ranks into each)."""
    if tp_size and tp_size > 0:
        if tp_size not in (1, 2, 4, 8):
            raise ValueError(f"DSv4 tp_size must divide mp8 world 8, got {tp_size}")
        if tp_size > n_devices:
            raise ValueError(f"tp_size={tp_size} but only {n_devices} devices")
        return tp_size
    for n in (8, 4, 2):
        if n_devices >= n:
            return n
    return 1


def n_devices(dev: torch.device, opts: EngineLoadOptions, tp_size: Optional[int]) -> int:
    """The devices ``resolve_tp_size`` counts: the cards, or the ranks that
    ``device_ordinals`` places on them (two ranks can share a card), on
    ``cuda``; on the CPU as many as ``tp_size`` asks for, else 1."""
    if dev.type == "cuda":
        return max(torch.cuda.device_count(), len(opts.device_ordinals))
    return max(tp_size or 1, 1)


def check_tp_options(opts: EngineLoadOptions, moe_chain: Optional[bool]) -> None:
    """What the model-parallel engine refuses, before any weight is read
    (``quantize="int8-experts"`` is refused separately, as the JAX engine's
    ValueError)."""
    check_tp_supported(opts)
    if moe_chain:
        raise NotImplementedError("moe_chain=True: the fused expert chains do not run under "
                                  "model parallelism (the JAX engine runs no fused kernel "
                                  "under a mesh)")
    if os.environ.get("PEGAINFER_DSV4_EP"):
        raise NotImplementedError("PEGAINFER_DSV4_EP: the token-shipping expert transport "
                                  "(moe_ep_a2a) is not ported; model parallelism combines the "
                                  "routed experts by an all-reduce")


def start_engine_from_params(cfg: dsv4.DSv4Config, params,
                             options: Optional[EngineLoadOptions] = None,
                             device=None, moe_chain: Optional[bool] = None,
                             tp_size: int = 1, store: Optional[str] = None) -> EngineHandle:
    """Serve ``params`` (already on ``device``) with bf16 slot state. With
    ``quantize="int8-experts"`` the packed-fp4 expert stacks of ``params``
    are requantized to int8 in place first (stacks already int8 stay); a
    tree of plain expert stacks cannot be, and raises ValueError. With
    ``quantize="bf16"`` every container of ``params`` is dequantized in
    place to the dtype of its embedding (bf16 from a checkpoint).
    ``moe_chain`` picks the fused decode chain (None: on for int8 experts,
    off for fp4; ``models/dsv4.py``). Returns the submit handle;
    ``handle._scheduler.executor`` is the ``SlotExecutor``, or with
    ``tp_size`` > 1 rank 0's ``TPExecutor`` (module docstring; ``store``:
    the ranks' ``FileStore`` path or ``tcp://host:port``, None a temporary
    file), whose ranks cut their shards from ``params`` (the caller's tree
    is left as it is)."""
    opts = options or EngineLoadOptions()
    check_supported(opts)
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params are on {params['embed'].device}, engine on {dev}")
    if (tp_size or 1) > 1:
        if opts.quantize == "int8-experts":
            raise ValueError("quantize='int8-experts' not supported under a multichip mesh")
        return start_scheduler(start_tp_executor(cfg, opts, dev, tp_size, params=params,
                                                 moe_chain=moe_chain, store=store),
                               seed=opts.seed)
    if opts.quantize == "int8-experts":
        if not all(quant.is_quantized(lw[k]) for lw in params["layers"] for k in dsv4.FP4_KEYS):
            raise ValueError("quantize='int8-experts' requires resident (non-bf16) weights")
        before, t = dsv4.params_bytes(params), time.perf_counter()
        dsv4.requantize_experts_int8(params)
        log.info("DSv4 experts requantized to int8 per output channel in %.1f s: "
                 "%.2f GB -> %.2f GB of params", time.perf_counter() - t, before / 1e9,
                 dsv4.params_bytes(params) / 1e9)
    elif opts.quantize == "bf16":
        before, t = dsv4.params_bytes(params), time.perf_counter()
        dsv4.dequantize_params(params, params["embed"].dtype)
        log.info("DSv4 weights dequantized to %s in %.1f s: %.2f GB -> %.2f GB of params",
                 params["embed"].dtype, time.perf_counter() - t, before / 1e9,
                 dsv4.params_bytes(params) / 1e9)
    max_slots, max_model_len, state = slot_state(cfg, opts, dev)
    log.info("DSv4: %d slots, max_model_len %d", max_slots, max_model_len)
    executor = SlotExecutor(cfg, params, state, max_slots, max_model_len, opts, moe_chain)
    log.info("decode blocks of %d tokens (steady %d), %d in flight", executor.decode_block,
             executor.decode_block_max, executor.decode_pipeline_depth)
    cache = executor.slot_prefix_cache
    log.info("DSv4 slot prefix cache: %s (%.2f MB a snapshot)",
             f"{cache.max_entries} entries" if cache is not None else "off",
             executor.snapshot_bytes / 1e6)
    return start_scheduler(executor, seed=opts.seed)


def slot_state(cfg: dsv4.DSv4Config, opts: EngineLoadOptions, dev: torch.device):
    """(slots, max_model_len, the bf16 slot state on ``dev``) of the
    options."""
    max_slots = min(opts.max_batch_size, MAX_SLOTS)
    max_model_len = opts.max_model_len or DEFAULT_MAX_MODEL_LEN
    state = dsv4.make_state(cfg, max_slots, max_blocks_for(cfg, max_model_len),
                            dtype=torch.bfloat16, device=dev)
    return max_slots, max_model_len, state


def start_engine(model_path: str, options: Optional[EngineLoadOptions] = None,
                 device=None, tp_size: Optional[int] = None,
                 store: Optional[str] = None) -> EngineHandle:
    """Serve the mp8 checkpoint at ``model_path`` (the JAX ``start_engine``):
    its config, the world (an explicit ``tp_size`` checked by
    ``resolve_tp_size`` against ``n_devices``), the loader (resident unless
    ``quantize="bf16"``), the int8 requantization when asked for, then
    ``start_engine_from_params``; above 1 the ranks each load their own
    files (``start_tp_executor``). With ``tp_size`` unset (None or 0, the
    CLI's default) it serves one process whatever the card count: the JAX
    auto rule would pick 2, 4 or 8 on a host of several cards, where the
    default options (the decode graphs) do not run split.
    ``PEGAINFER_DSV4_EXPERTS=int8`` asks for int8 experts as
    ``quantize="int8-experts"`` does; under bf16 or model parallelism it is
    ignored with the JAX engine's warning. Whether the options serve is
    known before the checkpoint is read."""
    opts = options or EngineLoadOptions()
    check_supported(opts)
    dev = resolve_device(device)
    tp = resolve_tp_size(tp_size, n_devices(dev, opts, tp_size)) if tp_size else 1
    cfg = dsv4.DSv4Config.from_model_path(model_path)
    log.info("loading DeepSeek-V4 (%d layers, dim %d)", cfg.n_layers, cfg.dim)
    resident = opts.quantize != "bf16"
    experts_int8 = (opts.quantize == "int8-experts"
                    or os.environ.get("PEGAINFER_DSV4_EXPERTS", "") == "int8")
    if experts_int8 and (not resident or tp > 1):
        why = ("requires resident (non-bf16) weights" if not resident
               else "not supported under a multichip mesh")
        if opts.quantize == "int8-experts":
            raise ValueError(f"quantize='int8-experts' {why}")
        log.warning("PEGAINFER_DSV4_EXPERTS=int8 ignored: %s — serving %s", why,
                    "fp8/fp4 resident" if resident else "bf16")
    elif experts_int8:
        opts = replace(opts, quantize="int8-experts")
    if tp > 1:
        return start_scheduler(start_tp_executor(cfg, opts, dev, tp, model_path=model_path,
                                                 store=store), seed=opts.seed)
    t = time.perf_counter()
    params = load_params(cfg, model_path, resident=resident, device=dev)
    log.info("DSv4 params: %.2f GB (%s) loaded in %.1f s", dsv4.params_bytes(params) / 1e9,
             "fp8/fp4 resident" if resident else "bf16", time.perf_counter() - t)
    return start_engine_from_params(cfg, params, opts, dev)


# ── model parallelism ────────────────────────────────────────────────────


def start_tp_executor(cfg: dsv4.DSv4Config, opts: EngineLoadOptions, dev: torch.device,
                      tp: int, params=None, model_path: Optional[str] = None,
                      moe_chain: Optional[bool] = None,
                      store: Optional[str] = None) -> tp_executor.TPExecutor:
    """The ranks of a model-parallel engine (module docstring) from the
    caller's ``params`` or from the checkpoint at ``model_path``: rank 0's
    ``TPExecutor``, which the engine puts behind its scheduler. Never falls
    back to one process."""
    sharding.validate_dsv4_mp8(cfg, tp)
    check_tp_options(opts, moe_chain)
    return tp_executor.start_engine_ranks(cfg, opts, dev, tp, tp_rank_executor, params,
                                          model_path, store)


def tp_rank_executor(spec, rank: int, tp, params) -> SlotExecutor:
    """Rank ``rank``'s executor of a model-parallel engine (``spec``: a
    ``parallel/tp_executor.py::TPSpec``; ``tp``: the rank's groups): its
    shard of ``params``, or its own rank files of the checkpoint at
    ``spec.model_path`` loaded on its device, dequantized there under
    ``quantize="bf16"``; the whole slot state; its local config.
    ``load_report`` keeps the files the load read (bytes each), its seconds
    and the device memory it took at its peak."""
    dev = torch.device(spec.devices[rank])
    opts = spec.options
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t, files = time.perf_counter(), {}
    if params is None:
        shard = load_params_rank(spec.cfg, spec.model_path, rank, spec.size,
                                 resident=opts.quantize != "bf16", device=dev, files_read=files)
    else:
        shard = sharding.shard_dsv4(spec.cfg, params, rank, spec.size, dev)
    del params
    if opts.quantize == "bf16":
        dsv4.dequantize_params(shard, shard["embed"].dtype)
    report = {"files": files, "seconds": time.perf_counter() - t, "peak_bytes": None}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        report["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    max_slots, max_model_len, state = slot_state(spec.cfg, opts, dev)
    ex = SlotExecutor(sharding.local_config_dsv4(spec.cfg, spec.size), shard, state, max_slots,
                      max_model_len, opts, tp=tp)
    ex.load_report = report
    return ex


def start_route_tape(ex, replay=None) -> None:
    """``TPExecutor.on_ranks`` function: the rank's model calls record their
    decisions from now on (``dsv4.RouteTape``), or with ``replay`` (a
    tape's ``host()`` entries) take those in place of their own."""
    ex.tape = dsv4.RouteTape(replay)


def take_route_tape(ex) -> dict:
    """``TPExecutor.on_ranks`` function: the rank's tape since
    ``start_route_tape`` (its entries on the host, and the flips of a
    replay), which it stops."""
    tape, ex.tape = ex.tape, None
    return {"entries": tape.host(), "flips": tape.flips, "rows": tape.rows}
