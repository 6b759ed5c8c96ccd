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
running on the CPU. Tensor parallelism (the JAX engine's MP8 mesh) is not
ported: ``tp_size`` above 1 raises ``NotImplementedError``.
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
from pegainfer_tpu_torch.models import dsv4
from pegainfer_tpu_torch.models.dsv4_weights import load_params
from pegainfer_tpu_torch.ops import quant
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


def start_engine_from_params(cfg: dsv4.DSv4Config, params,
                             options: Optional[EngineLoadOptions] = None,
                             device=None, moe_chain: Optional[bool] = None) -> EngineHandle:
    """Serve ``params`` (already on ``device``) with bf16 slot state. With
    ``quantize="int8-experts"`` the packed-fp4 expert stacks of ``params``
    are requantized to int8 in place first (stacks already int8 stay); a
    tree of plain expert stacks cannot be, and raises ValueError. With
    ``quantize="bf16"`` every container of ``params`` is dequantized in
    place to the dtype of its embedding (bf16 from a checkpoint).
    ``moe_chain`` picks the fused decode chain (None: on for int8 experts,
    off for fp4; ``models/dsv4.py``). Returns the submit handle;
    ``handle._scheduler.executor`` is the ``SlotExecutor``."""
    opts = options or EngineLoadOptions()
    check_supported(opts)
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params are on {params['embed'].device}, engine on {dev}")
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
    max_slots = min(opts.max_batch_size, MAX_SLOTS)
    max_model_len = opts.max_model_len or DEFAULT_MAX_MODEL_LEN
    state = dsv4.make_state(cfg, max_slots, max_blocks_for(cfg, max_model_len),
                            dtype=torch.bfloat16, device=dev)
    log.info("DSv4: %d slots, max_model_len %d", max_slots, max_model_len)
    executor = SlotExecutor(cfg, params, state, max_slots, max_model_len, opts, moe_chain)
    log.info("decode blocks of %d tokens (steady %d), %d in flight", executor.decode_block,
             executor.decode_block_max, executor.decode_pipeline_depth)
    cache = executor.slot_prefix_cache
    log.info("DSv4 slot prefix cache: %s (%.2f MB a snapshot)",
             f"{cache.max_entries} entries" if cache is not None else "off",
             executor.snapshot_bytes / 1e6)
    return start_scheduler(executor, seed=opts.seed)


def start_engine(model_path: str, options: Optional[EngineLoadOptions] = None,
                 device=None, tp_size: Optional[int] = None) -> EngineHandle:
    """Serve the mp8 checkpoint at ``model_path`` on one device (the JAX
    ``start_engine`` at ``tp_size`` 1): its config, the loader (resident
    unless ``quantize="bf16"``), the int8 requantization when asked for,
    then ``start_engine_from_params``. ``PEGAINFER_DSV4_EXPERTS=int8`` asks
    for int8 experts as ``quantize="int8-experts"`` does; under bf16 it is
    ignored with a warning. Whether the options serve is known before the
    checkpoint is read."""
    opts = options or EngineLoadOptions()
    check_supported(opts)
    dev = resolve_device(device)
    if tp_size not in (None, 0, 1):
        raise NotImplementedError(
            f"tp_size={tp_size}: the port serves DeepSeek-V4 on one device (tensor "
            "parallelism over the MP8 mesh is not ported)")
    cfg = dsv4.DSv4Config.from_model_path(model_path)
    log.info("loading DeepSeek-V4 (%d layers, dim %d)", cfg.n_layers, cfg.dim)
    resident = opts.quantize != "bf16"
    if os.environ.get("PEGAINFER_DSV4_EXPERTS", "") == "int8":
        if resident:
            opts = replace(opts, quantize="int8-experts")
        else:
            log.warning("PEGAINFER_DSV4_EXPERTS=int8 ignored: requires resident (non-bf16) "
                        "weights; serving bf16")
    t = time.perf_counter()
    params = load_params(cfg, model_path, resident=resident, device=dev)
    log.info("DSv4 params: %.2f GB (%s) loaded in %.1f s", dsv4.params_bytes(params) / 1e9,
             "fp8/fp4 resident" if resident else "bf16", time.perf_counter() - t)
    return start_engine_from_params(cfg, params, opts, dev)
