"""Qwen3 engine startup: checkpoint or parameters -> KV pool -> executor ->
scheduler. Counterpart of ``pegainfer_tpu/models/qwen3_engine.py``.

Runs on ``cuda`` unless the caller passes another device; with no card it
raises instead of running on the CPU.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from pegainfer_tpu_torch.engine.contract import EngineHandle, EngineLoadOptions
from pegainfer_tpu_torch.engine.scheduler import start_scheduler
from pegainfer_tpu_torch.engine.torch_executor import TorchExecutor, check_supported
from pegainfer_tpu_torch.models import qwen3 as q3
from pegainfer_tpu_torch.utils.device import resolve_device
from pegainfer_tpu_torch.utils.weights import load_state_dict

log = logging.getLogger("pegainfer_torch.qwen3")

DEFAULT_PAGE_SIZE = 64


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


def start_engine_from_params(cfg: q3.Qwen3Config, params,
                             options: Optional[EngineLoadOptions] = None,
                             device=None) -> EngineHandle:
    """Serve ``params`` (already on ``device``). The pool takes the weights'
    dtype. Returns the submit handle; ``handle._scheduler.executor`` is the
    ``TorchExecutor``."""
    opts = options or EngineLoadOptions()
    check_supported(opts)
    dev = resolve_device(device)
    dtype = params["embed"].dtype
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params are on {params['embed'].device}, engine on {dev}")
    num_pages = opts.max_num_pages or compute_num_pages(
        cfg, DEFAULT_PAGE_SIZE, opts.kv_memory_fraction, dev, dtype)
    log.info("KV pool: %d pages x %d tokens", num_pages, DEFAULT_PAGE_SIZE)
    kv = q3.make_kv_pages(cfg, num_pages, DEFAULT_PAGE_SIZE, dtype=dtype, device=dev)
    executor = TorchExecutor(cfg, params, kv, opts)
    return start_scheduler(executor, seed=opts.seed)


def start_engine(model_path: str, options: Optional[EngineLoadOptions] = None,
                 device=None) -> EngineHandle:
    """Load an HF Qwen3 checkpoint (safetensors) in bf16 and serve it."""
    dev = resolve_device(device)
    cfg = q3.Qwen3Config.from_model_path(model_path)
    log.info("loading %s (%d layers, hidden %d)", model_path, cfg.num_hidden_layers,
             cfg.hidden_size)
    params = q3.params_from_state_dict(cfg, load_state_dict(model_path),
                                       dtype=torch.bfloat16, device=dev)
    return start_engine_from_params(cfg, params, options, dev)
