"""Safetensors checkpoint loading (HF layout); counterpart of
``pegainfer_tpu/utils/weights.py``."""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict


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
