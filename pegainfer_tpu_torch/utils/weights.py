"""Safetensors checkpoint loading (HF layout), counterpart of
``pegainfer_tpu/utils/weights.py``, and host numpy arrays as tensors.

The safetensors file format is read here with the standard library, so the
port needs no ``safetensors`` package: an 8-byte little-endian header
length, a JSON header ``{name: {"dtype", "shape", "data_offsets"}}`` (and
an optional ``"__metadata__"`` of strings), then the tensors' raw bytes,
each at ``data_offsets`` [begin, end) from the end of the header.
"""

from __future__ import annotations

import json
import mmap
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

# the safetensors dtype names the reader takes
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16,
    "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn,
}
# a header larger than this is malformed (the safetensors package's limit)
MAX_HEADER_BYTES = 100 * 1024 * 1024


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


def _header(path: str, f, size: int) -> tuple:
    """(tensor entries, data start) of an open safetensors file; raises
    ValueError on a malformed header or offsets outside the file."""
    head = f.read(8)
    if len(head) != 8:
        raise ValueError(f"{path}: shorter than a safetensors header")
    n = int.from_bytes(head, "little")
    if n > min(size - 8, MAX_HEADER_BYTES):
        raise ValueError(f"{path}: header of {n} bytes does not fit the file's {size}")
    try:
        header = json.loads(f.read(n))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: malformed safetensors header: {e}") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the safetensors header is not an object")
    data_len = size - 8 - n
    entries = {}
    for name, e in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = SAFETENSORS_DTYPES[e["dtype"]]
            shape = [int(d) for d in e["shape"]]
            begin, end = (int(o) for o in e["data_offsets"])
        except (KeyError, TypeError, ValueError) as err:
            raise ValueError(f"{path}: tensor {name!r} has a malformed entry {e!r}") from err
        numel = int(np.prod(shape, dtype=np.int64))
        if min(shape, default=0) < 0 or not 0 <= begin <= end <= data_len:
            raise ValueError(f"{path}: tensor {name!r} at [{begin}, {end}) lies outside the "
                             f"file's {data_len} data bytes")
        if end - begin != numel * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} {e['dtype']} has "
                             f"{end - begin} bytes")
        entries[name] = (dtype, shape, begin, end)
    return entries, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file as a CPU tensor, bit for bit.
    The tensors lie in a private copy-on-write map of the file (pages are
    read as they are used); a tensor whose bytes are not aligned to its
    element size is copied out."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        entries, start = _header(path, f, size)
        if not entries:
            return {}
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, (dtype, shape, begin, end) in entries.items():
        lo = start + begin
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
        elif lo % dtype.itemsize:
            raw = torch.frombuffer(bytearray(buf[lo:start + end]), dtype=torch.uint8)
            out[name] = raw.view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                         offset=lo).reshape(shape)
    return out


def load_state_dict(model_path: str) -> Dict[str, object]:
    """All tensors of a checkpoint's safetensors files as host torch
    tensors, in their stored dtypes (bf16 kept as bf16)."""
    sd: Dict[str, object] = {}
    for path in safetensor_files(model_path):
        sd.update(load_file(path))
    return sd
