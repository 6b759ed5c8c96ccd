"""Safetensors checkpoint loading (HF layout), counterpart of
``pegainfer_tpu/utils/weights.py``, and host numpy arrays as tensors.

The safetensors file format is read here with the standard library, so the
port needs no ``safetensors`` package: an 8-byte little-endian header
length, a JSON header ``{name: {"dtype", "shape", "data_offsets"}}`` (and
an optional ``"__metadata__"`` of strings), then the tensors' raw bytes,
each at ``data_offsets`` [begin, end) from the end of the header.

``load_file`` maps a whole file; ``SafetensorsReader`` reads one tensor at
a time with a seek, and also takes the DeepSeek-V4 mp8 checkpoint's narrow
dtypes (``F8_E8M0`` scales and packed ``F4`` weights).
"""

from __future__ import annotations

import json
import mmap
import os
from glob import glob
from typing import Dict

import numpy as np
import torch

from pegainfer_tpu_torch.ops import quant

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
# the mp8 checkpoint's narrow dtypes, which only SafetensorsReader takes
# (the safetensors package writes neither): F8_E8M0 scales, one uint8 code c
# a value 2^(c - 127) (255 is NaN); packed E2M1 weights, two codes a byte,
# the low nibble first, under a header that gives the logical shape, so a
# tensor has numel / 2 bytes
E8M0 = "F8_E8M0"
F4_DTYPES = ("F4", "F4_E2M1", "F4_E2M1_X2")
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


def _nbytes(dtype: str, numel: int) -> int:
    if dtype in F4_DTYPES:
        return numel // 2
    if dtype == E8M0:
        return numel
    return numel * SAFETENSORS_DTYPES[dtype].itemsize


def _header(path: str, f, size: int, narrow: bool = False) -> tuple:
    """(tensor entries {name: (dtype name, shape, begin, end)}, data start)
    of an open safetensors file, with the narrow mp8 dtypes when
    ``narrow``; raises ValueError on a malformed header or offsets outside
    the file."""
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
    known = set(SAFETENSORS_DTYPES) | ({E8M0, *F4_DTYPES} if narrow else set())
    data_len = size - 8 - n
    entries = {}
    for name, e in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = e["dtype"]
            if dtype not in known:
                raise KeyError(dtype)
            shape = [int(d) for d in e["shape"]]
            begin, end = (int(o) for o in e["data_offsets"])
        except (KeyError, TypeError, ValueError) as err:
            raise ValueError(f"{path}: tensor {name!r} has a malformed entry {e!r}") from err
        numel = int(np.prod(shape, dtype=np.int64))
        if min(shape, default=0) < 0 or not 0 <= begin <= end <= data_len:
            raise ValueError(f"{path}: tensor {name!r} at [{begin}, {end}) lies outside the "
                             f"file's {data_len} data bytes")
        if dtype in F4_DTYPES and (not shape or shape[-1] % 2):
            raise ValueError(f"{path}: packed {dtype} tensor {name!r} of shape {shape} has no "
                             "even last dim")
        if end - begin != _nbytes(dtype, numel):
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} {dtype} has "
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
    for name, (dt, shape, begin, end) in entries.items():
        dtype = SAFETENSORS_DTYPES[dt]
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


class SafetensorsReader:
    """One safetensors file read a tensor at a time (the JAX package's
    ``models/dsv4_weights.py::SafetensorsReader``): the header is parsed
    once, and a tensor's bytes are read with a seek when it is asked for,
    so a rank file of the mp8 checkpoint is never held whole. Takes
    ``load_file``'s dtypes and the narrow ``F8_E8M0`` and packed ``F4``."""

    def __init__(self, path: str):
        self.path = path
        self.bytes_read = 0  # tensor bytes read so far (the header not counted)
        with open(path, "rb") as f:
            self._entries, self._base = _header(path, f, os.fstat(f.fileno()).st_size,
                                                narrow=True)

    def keys(self):
        return self._entries.keys()

    def shape(self, name: str) -> tuple:
        """The header's shape (no data read): a packed-F4 tensor's is its
        logical one, two values a stored byte."""
        return tuple(self._entries[name][1])

    def stored_dtype(self, name: str) -> str:
        return self._entries[name][0]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def read(self, name: str) -> torch.Tensor:
        """The tensor's stored bits as a new CPU tensor: of its dtype for
        ``load_file``'s dtypes, the uint8 codes for ``F8_E8M0``, the packed
        uint8 bytes [..., n / 2] for ``F4``."""
        dtype, shape, begin, end = self._entries[name]
        buf = torch.empty(end - begin, dtype=torch.uint8)
        with open(self.path, "rb") as f:
            f.seek(self._base + begin)
            got = f.readinto(buf.numpy())
        if got != end - begin:
            raise ValueError(f"{self.path}: tensor {name!r} is cut short ({got} of "
                             f"{end - begin} bytes)")
        self.bytes_read += got
        if dtype in F4_DTYPES:
            return buf.reshape(*shape[:-1], shape[-1] // 2)
        if dtype == E8M0:
            return buf.reshape(shape)
        return buf.view(SAFETENSORS_DTYPES[dtype]).reshape(shape)

    def __getitem__(self, name: str) -> torch.Tensor:
        """The tensor's values: ``read`` for ``load_file``'s dtypes, f32 for
        ``F8_E8M0`` and packed ``F4`` (exact; the logical shape)."""
        raw, dtype = self.read(name), self.stored_dtype(name)
        if dtype in F4_DTYPES:
            return quant.unpack_fp4(raw, torch.float32)
        if dtype == E8M0:
            return quant.e8m0_to_float(raw)
        return raw

    def read_f4_packed(self, name: str):
        """The packed bytes [..., n / 2] uint8 of an ``F4`` tensor, or None
        when it is stored otherwise (test fixtures hold E2M1 values in an
        E4M3 container)."""
        return self.read(name) if self.stored_dtype(name) in F4_DTYPES else None


def read_safetensors_raw(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a file by its values (``SafetensorsReader[name]``),
    for tests and tools; loaders read a tensor at a time instead."""
    r = SafetensorsReader(path)
    return {k: r[k] for k in r.keys()}


def load_state_dict(model_path: str) -> Dict[str, object]:
    """All tensors of a checkpoint's safetensors files as host torch
    tensors, in their stored dtypes (bf16 kept as bf16)."""
    sd: Dict[str, object] = {}
    for path in safetensor_files(model_path):
        sd.update(load_file(path))
    return sd
