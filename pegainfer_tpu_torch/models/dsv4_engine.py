"""DeepSeek-V4 engine startup: parameters -> slot state -> SlotExecutor ->
scheduler. Counterpart of ``pegainfer_tpu/models/dsv4_engine.py``.

It serves resident fp8 / packed-fp4 weights (the JAX engine's
``quantize=None``, checkpoint-exact, with its fused kernels on), or with
``quantize="int8-experts"`` the same weights with the routed experts
requantized to int8 per output channel at start (the JAX engine's speed
mode). Runs on ``cuda`` unless the caller passes another device; with no
card it raises instead of running on the CPU.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import torch

from pegainfer_tpu_torch.engine.contract import EngineHandle, EngineLoadOptions
from pegainfer_tpu_torch.engine.scheduler import start_scheduler
from pegainfer_tpu_torch.engine.slot_executor import SlotExecutor, check_supported
from pegainfer_tpu_torch.models import dsv4
from pegainfer_tpu_torch.utils.device import resolve_device

log = logging.getLogger("pegainfer_torch.dsv4")

DEFAULT_MAX_MODEL_LEN = 4096
MAX_SLOTS = 2  # the reference serves batch <= 2


def max_blocks_for(cfg: dsv4.DSv4Config, max_model_len: int) -> int:
    """Compressed-cache rows a slot needs for ``max_model_len`` tokens."""
    ratios = [r for r in cfg.compress_ratios if r > 0]
    if not ratios:
        return 1
    return -(-max_model_len // min(ratios))


def start_engine_from_params(cfg: dsv4.DSv4Config, params,
                             options: Optional[EngineLoadOptions] = None,
                             device=None, moe_chain: Optional[bool] = None) -> EngineHandle:
    """Serve resident ``params`` (already on ``device``) with bf16 slot
    state. With ``quantize="int8-experts"`` the packed-fp4 expert stacks of
    ``params`` are requantized to int8 in place first (stacks already int8
    stay). ``moe_chain`` picks the fused decode chain (None: on for int8
    experts, off for fp4; ``models/dsv4.py``). Returns the submit handle;
    ``handle._scheduler.executor`` is the ``SlotExecutor``."""
    opts = options or EngineLoadOptions()
    check_supported(opts)
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params are on {params['embed'].device}, engine on {dev}")
    if opts.quantize == "int8-experts":
        before, t = dsv4.params_bytes(params), time.perf_counter()
        dsv4.requantize_experts_int8(params)
        log.info("DSv4 experts requantized to int8 per output channel in %.1f s: "
                 "%.2f GB -> %.2f GB of params", time.perf_counter() - t, before / 1e9,
                 dsv4.params_bytes(params) / 1e9)
    max_slots = min(opts.max_batch_size, MAX_SLOTS)
    max_model_len = opts.max_model_len or DEFAULT_MAX_MODEL_LEN
    state = dsv4.make_state(cfg, max_slots, max_blocks_for(cfg, max_model_len),
                            dtype=torch.bfloat16, device=dev)
    log.info("DSv4: %d slots, max_model_len %d", max_slots, max_model_len)
    executor = SlotExecutor(cfg, params, state, max_slots, max_model_len, opts, moe_chain)
    return start_scheduler(executor, seed=opts.seed)


def start_engine(model_path: str, options: Optional[EngineLoadOptions] = None,
                 device=None) -> EngineHandle:
    """Serving a DeepSeek-V4 checkpoint needs its mp8 loader
    (``pegainfer_tpu/models/dsv4_weights.py`` and ``dsv4_manifest.py``),
    which is not ported yet."""
    resolve_device(device)
    raise NotImplementedError(
        "the PyTorch port has no DeepSeek-V4 checkpoint loader yet (the mp8 "
        "loader of models/dsv4_weights.py); serve parameters with "
        f"start_engine_from_params instead of loading {model_path!r}")
