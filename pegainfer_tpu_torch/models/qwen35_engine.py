"""Qwen3.5 hybrid engine startup: checkpoint or parameters -> KV pool and
state slots -> HybridExecutor -> scheduler. Counterpart of
``pegainfer_tpu/models/qwen35_engine.py``.

Serves the per-layer grouped weights in bf16, or with ``quantize="int8"``
their projections and head as int8 weight-only containers, with
``max_batch_size`` state slots, with chunked prefill, the fused mixed step
and the hybrid prefix cache when ``prefill_chunk`` / ``enable_prefix_cache``
ask for them. With ``precompile`` and ``enable_cuda_graph`` (the defaults)
the decode step's graphs of every batch bucket are captured at width 8
before the scheduler starts, as the JAX engine precompiles its ladder.
``decode_block``, ``decode_block_max`` and ``decode_pipeline_depth`` go to
the executor and its scheduler (blocks of N steps, graphed at first use).
Runs on ``cuda`` unless the caller passes another device;
with no card it raises instead of running on the CPU. Refused with
``NotImplementedError`` (``engine/hybrid_executor.py::check_supported``):
any other ``quantize``.
"""

from __future__ import annotations

import json
import logging
import time
import os
from typing import Optional

import torch

from pegainfer_tpu_torch.engine.contract import EngineHandle, EngineLoadOptions
from pegainfer_tpu_torch.engine.hybrid_executor import HybridExecutor, check_supported
from pegainfer_tpu_torch.engine.kv import DEFAULT_MAX_SNAPSHOTS
from pegainfer_tpu_torch.engine.scheduler import start_scheduler
from pegainfer_tpu_torch.models import qwen35 as q35
from pegainfer_tpu_torch.utils.device import resolve_device
from pegainfer_tpu_torch.utils.weights import load_state_dict

log = logging.getLogger("pegainfer_torch.qwen35")

DEFAULT_PAGE_SIZE = 64


def probe_model(model_path: str) -> bool:
    """Whether ``model_path`` holds a Qwen3.5 / Qwen3Next checkpoint."""
    try:
        with open(os.path.join(model_path, "config.json")) as f:
            archs = json.load(f).get("architectures", [])
    except OSError:
        return False
    return any(a in ("Qwen3NextForCausalLM", "Qwen3_5ForCausalLM") for a in archs)


def compute_num_pages(cfg: q35.Qwen35Config, page_size: int, fraction: float,
                      max_slots: int, device: torch.device, dtype=torch.bfloat16,
                      prefix_cache: bool = False) -> int:
    """Size the KV pool to ``fraction`` of the card's free memory, read after
    the weights are on it, less the state of ``max_slots`` + 1 slots (the
    dead one too), which is allocated beside the pool, and with the prefix
    cache on less its ``DEFAULT_MAX_SNAPSHOTS`` state snapshots of one slot
    each (428 MB at ``bench_config()``)."""
    if device.type != "cuda":
        raise ValueError("the KV pool is sized from free CUDA memory; "
                         "pass EngineLoadOptions.max_num_pages on the CPU")
    free, _total = torch.cuda.mem_get_info(device)
    snapshots = DEFAULT_MAX_SNAPSHOTS if prefix_cache else 0
    free -= (max_slots + 1 + snapshots) * q35.slot_bytes(cfg)
    n = int(free * fraction) // q35.kv_bytes_per_page(cfg, page_size, dtype)
    return max(min(n, 1 << 16), 2)


def quantize_int8(params, device: torch.device):
    """The int8 weight-only mode at start (``q35.quantize_params_int8``,
    which consumes the tree: each bf16 matrix is freed as it goes, so the
    pool, sized afterwards, gets the memory). Logs the weight bytes before
    and after."""
    before = q35.params_bytes(params)
    t = time.perf_counter()
    params = q35.quantize_params_int8(params)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    log.info("int8 weight-only: %.2f GB -> %.2f GB of weights in %.1f s", before / 1e9,
             q35.params_bytes(params) / 1e9, time.perf_counter() - t)
    return params


def start_engine_from_params(cfg: q35.Qwen35Config, params,
                             options: Optional[EngineLoadOptions] = None,
                             device=None) -> EngineHandle:
    """Serve ``params`` (already on ``device``). The pool takes the
    embedding's dtype; ``max_batch_size`` sets the number of state slots.
    With ``quantize="int8"`` the projections and the head are quantized
    first, in the caller's tree (``quantize_int8``). Returns the submit
    handle; ``handle._scheduler.executor`` is the ``HybridExecutor``."""
    opts = options or EngineLoadOptions()
    check_supported(opts)
    dev = resolve_device(device)
    dtype = params["embed"].dtype
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params are on {params['embed'].device}, engine on {dev}")
    if opts.quantize == "int8":
        params = quantize_int8(params, dev)
    max_slots = opts.max_batch_size
    num_pages = opts.max_num_pages or compute_num_pages(
        cfg, DEFAULT_PAGE_SIZE, opts.kv_memory_fraction, max_slots, dev, dtype,
        prefix_cache=opts.enable_prefix_cache)
    log.info("KV pool: %d pages x %d tokens; %d state slots of %.1f MB", num_pages,
             DEFAULT_PAGE_SIZE, max_slots, q35.slot_bytes(cfg) / 1e6)
    state = q35.make_state(cfg, num_pages, DEFAULT_PAGE_SIZE, max_slots, kv_dtype=dtype,
                           device=dev)
    executor = HybridExecutor(cfg, params, state, opts)
    log.info("decode blocks of %d tokens (steady %d), %d in flight", executor.decode_block,
             executor.decode_block_max, executor.decode_pipeline_depth)
    if opts.precompile and opts.enable_cuda_graph:
        t = time.perf_counter()
        executor.precompile()
        log.info("decode graphs: %d captured at width 8 in %.1f s", executor.graph_captures,
                 time.perf_counter() - t)
    return start_scheduler(executor, seed=opts.seed)


def start_engine(model_path: str, options: Optional[EngineLoadOptions] = None,
                 device=None) -> EngineHandle:
    """Load an HF Qwen3Next-format checkpoint (safetensors) in bf16 and serve
    it."""
    dev = resolve_device(device)
    cfg = q35.Qwen35Config.from_model_path(model_path)
    log.info("loading %s (%d layers: %d linear + 1 full per period-%d group)", model_path,
             cfg.num_hidden_layers, cfg.period - 1, cfg.period)
    params = q35.params_from_state_dict(cfg, load_state_dict(model_path),
                                        dtype=torch.bfloat16, device=dev)
    return start_engine_from_params(cfg, params, options, dev)
