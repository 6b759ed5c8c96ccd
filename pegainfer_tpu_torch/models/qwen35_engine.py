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

``tp_size`` > 1 serves the hybrid tensor-parallel, as Qwen3's engine does
(``models/qwen3_engine.py``; the JAX engine's ``shard_qwen35``): one process
a rank (``parallel/tp_executor.py``), each holding its shard
(``parallel/sharding.py::shard_qwen35``; int8 quantized before the split),
its ``max_batch_size`` state slots at its ``local_config_qwen35`` (its value
heads' recurrent rows, its own conv channels) and a pool sized from its own
free memory less its slots and snapshots, the fraction divided among the
ranks that share its card, the ranks agreeing on the least. The decode
step is eager: the graph options and the PD hooks raise
``NotImplementedError``.
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
from pegainfer_tpu_torch.engine.torch_executor import check_tp_supported
from pegainfer_tpu_torch.models import qwen35 as q35
from pegainfer_tpu_torch.parallel import sharding, tp_executor
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
                             device=None, tp_size: int = 1,
                             store: Optional[str] = None) -> EngineHandle:
    """Serve ``params`` (already on ``device``). The pool takes the
    embedding's dtype; ``max_batch_size`` sets the number of state slots.
    With ``quantize="int8"`` the projections and the head are quantized
    first, in the caller's tree (``quantize_int8``). Returns the submit
    handle; ``handle._scheduler.executor`` is the ``HybridExecutor``, or
    with ``tp_size`` > 1 rank 0's ``TPExecutor`` (``store``: the ranks'
    ``FileStore`` path or ``tcp://host:port``, None a temporary file; 0 or
    1 is one process, as the JAX engine reads ``tp_size or 1``)."""
    opts = options or EngineLoadOptions()
    check_supported(opts)
    dev = resolve_device(device)
    dtype = params["embed"].dtype
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params are on {params['embed'].device}, engine on {dev}")
    if (tp_size or 1) > 1:
        return start_scheduler(start_tp_executor(cfg, opts, dev, tp_size, params=params,
                                                 store=store), seed=opts.seed)
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
                 device=None, tp_size: int = 1, store: Optional[str] = None) -> EngineHandle:
    """Load an HF Qwen3Next-format checkpoint (safetensors) in bf16 and serve
    it; with ``tp_size`` > 1 each rank loads it and keeps its shard
    (``start_engine_from_params``)."""
    dev = resolve_device(device)
    cfg = q35.Qwen35Config.from_model_path(model_path)
    log.info("loading %s (%d layers: %d linear + 1 full per period-%d group)", model_path,
             cfg.num_hidden_layers, cfg.period - 1, cfg.period)
    if (tp_size or 1) > 1:
        opts = options or EngineLoadOptions()
        check_supported(opts)
        return start_scheduler(start_tp_executor(cfg, opts, dev, tp_size,
                                                 model_path=model_path, store=store),
                               seed=opts.seed)
    params = q35.params_from_state_dict(cfg, load_state_dict(model_path),
                                        dtype=torch.bfloat16, device=dev)
    return start_engine_from_params(cfg, params, options, dev)


# ── tensor parallelism ───────────────────────────────────────────────────


def start_tp_executor(cfg: q35.Qwen35Config, opts: EngineLoadOptions, dev: torch.device,
                      tp: int, params=None, model_path: Optional[str] = None,
                      store: Optional[str] = None) -> tp_executor.TPExecutor:
    """The ranks of a tensor-parallel hybrid engine (module docstring) from
    the caller's ``params`` (int8 quantized here first, in the caller's
    tree) or from ``model_path``: rank 0's ``TPExecutor``, which the engine
    puts behind its scheduler. Never falls back to one process."""
    sharding.validate_qwen35_tp(cfg, tp)
    check_tp_supported(opts)
    return tp_executor.start_engine_ranks(cfg, opts, dev, tp, tp_rank_executor, params,
                                          model_path, store, quantize_int8)


def tp_rank_executor(spec, rank: int, tp, params) -> HybridExecutor:
    """Rank ``rank``'s executor of a tensor-parallel hybrid engine
    (``spec``: a ``parallel/tp_executor.py::TPSpec``; ``tp``: the rank's
    groups): its shard of ``params``, or of the checkpoint at
    ``spec.model_path`` loaded on its device (and quantized there before the
    split), its state slots and its pool at the local config."""
    dev = torch.device(spec.devices[rank])
    opts = spec.options
    if params is None:
        params = q35.params_from_state_dict(spec.cfg, load_state_dict(spec.model_path),
                                            dtype=torch.bfloat16, device=dev)
        if opts.quantize == "int8":
            params = quantize_int8(params, dev)
    shard = sharding.shard_qwen35(spec.cfg, params, rank, spec.size, dev)
    del params
    lcfg = sharding.local_config_qwen35(spec.cfg, spec.size)
    dtype = shard["embed"].dtype
    max_slots = opts.max_batch_size
    num_pages = tp_executor.agree_num_pages(
        spec, rank, tp, dev,
        lambda fraction: compute_num_pages(lcfg, DEFAULT_PAGE_SIZE, fraction, max_slots, dev,
                                           dtype, prefix_cache=opts.enable_prefix_cache))
    state = q35.make_state(lcfg, num_pages, DEFAULT_PAGE_SIZE, max_slots, kv_dtype=dtype,
                           device=dev)
    return HybridExecutor(lcfg, shard, state, opts, tp=tp)
