"""Safetensors checkpoint loading (HF layout), counterpart of
``pegainfer_tpu/utils/weights.py``, and host numpy arrays as tensors."""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict

import numpy as np
import torch

# numpy dtypes that torch cannot take directly (ml_dtypes' bf16 and fp8,
# as the JAX package's arrays come out of np.asarray), by name: their bits
# are reinterpreted, so the port needs no ml_dtypes
_BITCAST = {"bfloat16": (np.uint16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def numpy_to_torch(arr) -> torch.Tensor:
    """A host numpy array as a new CPU tensor of the same dtype."""
    arr = np.asarray(arr)
    bits = _BITCAST.get(arr.dtype.name)
    if bits is not None:
        return torch.from_numpy(arr.view(bits[0]).copy()).view(bits[1])
    return torch.from_numpy(np.array(arr))  # a writable copy


def safetensor_files(model_path: str) -> list:
    index = os.path.join(model_path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            idx = json.load(f)
        files = sorted({v for v in idx["weight_map"].values()})
        return [os.path.join(model_path, f) for f in files]
    files = sorted(glob(os.path.join(model_path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {model_path}")
    return files


def load_state_dict(model_path: str) -> Dict[str, object]:
    """All tensors as host torch tensors (bf16 kept as bf16)."""
    from safetensors.torch import load_file

    sd: Dict[str, object] = {}
    for path in safetensor_files(model_path):
        sd.update(load_file(path))
    return sd
