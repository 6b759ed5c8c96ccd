"""Qwen3 engine startup: checkpoint or parameters -> (int8 weights) -> KV
pool -> executor -> (decode graphs) -> scheduler. Counterpart of
``pegainfer_tpu/models/qwen3_engine.py``: with ``precompile`` and
``enable_cuda_graph`` (the defaults) the executor captures its decode
graph of each batch bucket before the scheduler starts; ``decode_block``,
``decode_block_max`` and ``decode_pipeline_depth`` go to the executor and
its scheduler (blocks of N steps, graphed at first use).

Runs on ``cuda`` unless the caller passes another device; with no card it
raises instead of running on the CPU.

``tp_size`` > 1 serves the model tensor-parallel (Megatron-style, as the
JAX engine under GSPMD): one process a rank (``parallel/tp_executor.py``),
rank r on ``cuda:{device_ordinals[r]}`` when the options list one ordinal
a rank (``[0, 0]``: two ranks on one card, over gloo), else on the first
``tp_size`` cards (NCCL); ``device="cpu"`` puts every rank on the CPU. Each
rank holds its shard (``parallel/sharding.py``; int8 quantized before the
split) and a pool sized from its own free memory, the fraction divided
among the ranks that share its card, the ranks then agreeing on the least.
The decode step is eager: the graph options and the PD hooks raise
``NotImplementedError``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import torch

from pegainfer_tpu_torch.engine.contract import EngineHandle, EngineLoadOptions
from pegainfer_tpu_torch.engine.scheduler import start_scheduler
from pegainfer_tpu_torch.engine.torch_executor import (TorchExecutor, check_supported,
                                                       check_tp_supported)
from pegainfer_tpu_torch.models import qwen3 as q3
from pegainfer_tpu_torch.parallel import sharding, tp_executor
from pegainfer_tpu_torch.utils.device import resolve_device
from pegainfer_tpu_torch.utils.weights import load_state_dict

log = logging.getLogger("pegainfer_torch.qwen3")

DEFAULT_PAGE_SIZE = 64


def probe_model(model_path: str) -> bool:
    """Whether ``model_path`` holds a Qwen3 checkpoint."""
    try:
        with open(os.path.join(model_path, "config.json")) as f:
            archs = json.load(f).get("architectures", [])
    except OSError:
        return False
    return "Qwen3ForCausalLM" in archs


def compute_num_pages(cfg: q3.Qwen3Config, page_size: int, fraction: float,
                      device: torch.device, dtype=torch.bfloat16) -> int:
    """Size the KV pool to ``fraction`` of the card's free memory, read after
    the weights are on it."""
    if device.type != "cuda":
        raise ValueError("the KV pool is sized from free CUDA memory; "
                         "pass EngineLoadOptions.max_num_pages on the CPU")
    free, _total = torch.cuda.mem_get_info(device)
    n = int(free * fraction) // q3.kv_bytes_per_page(cfg, page_size, dtype)
    return max(min(n, 1 << 16), 2)


def quantize_int8(params, device: torch.device):
    """The int8 weight-only mode at start (``q3.quantize_params_int8``,
    which consumes the tree: each bf16 matrix is freed as it goes, so the
    pool, sized afterwards, gets the memory). Logs the weight bytes before
    and after."""
    before = q3.params_bytes(params)
    t = time.perf_counter()
    params = q3.quantize_params_int8(params)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    log.info("int8 weight-only: %.2f GB -> %.2f GB of weights in %.1f s", before / 1e9,
             q3.params_bytes(params) / 1e9, time.perf_counter() - t)
    return params


def start_engine_from_params(cfg: q3.Qwen3Config, params,
                             options: Optional[EngineLoadOptions] = None,
                             device=None, tp_size: int = 1,
                             store: Optional[str] = None) -> EngineHandle:
    """Serve ``params`` (already on ``device``). The pool takes the
    embedding's dtype. With ``quantize="int8"`` the projections and the head
    are quantized first, in the caller's tree (``quantize_int8``). Returns
    the submit handle; ``handle._scheduler.executor`` is the
    ``TorchExecutor``, or with ``tp_size`` > 1 rank 0's ``TPExecutor``
    (``store``: the ranks' ``FileStore`` path or ``tcp://host:port``,
    None a temporary file; 0 or 1 is one process, as the JAX engine reads
    ``tp_size or 1``)."""
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
    num_pages = opts.max_num_pages or compute_num_pages(
        cfg, DEFAULT_PAGE_SIZE, opts.kv_memory_fraction, dev, dtype)
    log.info("KV pool: %d pages x %d tokens", num_pages, DEFAULT_PAGE_SIZE)
    kv = q3.make_kv_pages(cfg, num_pages, DEFAULT_PAGE_SIZE, dtype=dtype, device=dev)
    executor = TorchExecutor(cfg, params, kv, opts)
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
    """Load an HF Qwen3 checkpoint (safetensors) in bf16 and serve it; with
    ``tp_size`` > 1 each rank loads it and keeps its shard
    (``start_engine_from_params``)."""
    dev = resolve_device(device)
    cfg = q3.Qwen3Config.from_model_path(model_path)
    log.info("loading %s (%d layers, hidden %d)", model_path, cfg.num_hidden_layers,
             cfg.hidden_size)
    if (tp_size or 1) > 1:
        opts = options or EngineLoadOptions()
        check_supported(opts)
        return start_scheduler(start_tp_executor(cfg, opts, dev, tp_size,
                                                 model_path=model_path, store=store),
                               seed=opts.seed)
    params = q3.params_from_state_dict(cfg, load_state_dict(model_path),
                                       dtype=torch.bfloat16, device=dev)
    return start_engine_from_params(cfg, params, options, dev)


# ── tensor parallelism ───────────────────────────────────────────────────


def start_tp_executor(cfg: q3.Qwen3Config, opts: EngineLoadOptions, dev: torch.device,
                      tp: int, params=None, model_path: Optional[str] = None,
                      store: Optional[str] = None) -> tp_executor.TPExecutor:
    """The ranks of a tensor-parallel engine (module docstring) from the
    caller's ``params`` (int8 quantized here first, in the caller's tree)
    or from ``model_path``: rank 0's ``TPExecutor``, which the engine puts
    behind its scheduler. Never falls back to one process."""
    sharding.validate_qwen3_tp(cfg, tp)
    check_tp_supported(opts)
    return tp_executor.start_engine_ranks(cfg, opts, dev, tp, tp_rank_executor, params,
                                          model_path, store, quantize_int8)


def tp_rank_executor(spec, rank: int, tp, params) -> TorchExecutor:
    """Rank ``rank``'s executor of a tensor-parallel engine (``spec``: a
    ``parallel/tp_executor.py::TPSpec``; ``tp``: the rank's groups): its
    shard of ``params``, or of the checkpoint at ``spec.model_path`` loaded
    on its device (and quantized there before the split), and its pool."""
    dev = torch.device(spec.devices[rank])
    opts = spec.options
    if params is None:
        params = q3.params_from_state_dict(spec.cfg, load_state_dict(spec.model_path),
                                           dtype=torch.bfloat16, device=dev)
        if opts.quantize == "int8":
            params = quantize_int8(params, dev)
    shard = sharding.shard_qwen3(spec.cfg, params, rank, spec.size, dev)
    del params
    lcfg = sharding.local_config(spec.cfg, spec.size)
    dtype = shard["embed"].dtype
    num_pages = tp_executor.agree_num_pages(
        spec, rank, tp, dev,
        lambda fraction: compute_num_pages(lcfg, DEFAULT_PAGE_SIZE, fraction, dev, dtype))
    kv = q3.make_kv_pages(lcfg, num_pages, DEFAULT_PAGE_SIZE, dtype=dtype, device=dev)
    return TorchExecutor(lcfg, shard, kv, opts, tp=tp)
