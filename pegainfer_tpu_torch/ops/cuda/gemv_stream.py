"""bf16 weight streams: ``stream_sum``, ``gemv`` and ``layer_gemv``
(``csrc/gemv_stream.cu``).

Replace the TPU study kernels ``scripts/gemv_stream_study.py::
make_stream_sum`` (sum(W) + s, the read ceiling) and ``make_gemv`` (y = x ·
Wᵀ + s), and ``scripts/gemv_chain_study.py::make_layer_gemv`` (y = x ·
stack[l]ᵀ, the stack read in place). W [N, K] bf16, x [1, K] bf16, s [1, 1]
f32; products of bf16 values summed in f32.

The bulk kernels stream W through a ring in shared memory whose shape is
``Ring``: bytes a stage (whole rows, at least one), stages, blocks an SM.
``stream_sum`` also has the ``ldg`` form (``Ldg``: 16-byte loads in flight
a thread, blocks an SM), the form of the decode GEMVs K3, K4 and K6. The
defaults are the ones ``pegainfer_tpu_torch/studies/gemv_stream_study.py``
chose on an H100.

Each wrapper dispatches on the device of its tensors: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. ``launches``
counts kernel launches by kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pegainfer_tpu_torch.ops.cuda import build

launches = {"stream_sum_bulk": 0, "stream_sum_ldg": 0, "gemv": 0, "layer_gemv": 0}
MAX_SMEM = 232448 - 128  # csrc/common.cuh wring::kMaxSmem


@dataclass(frozen=True)
class Stages:
    """A weight ring's stages (``csrc/common.cuh`` wring::Ring): bytes a
    stage, whole rows of at least one, and stages."""
    stage_bytes: int = 40960
    stages: int = 2

    def rows(self, K: int) -> int:
        """Whole rows of K bf16 a stage: at least one."""
        return max(1, self.stage_bytes // (2 * K))


@dataclass(frozen=True)
class Ring(Stages):
    """The stream kernels' ring: its stages and the grid's blocks an SM."""
    blocks_per_sm: int = 2


@dataclass(frozen=True)
class Ldg:
    unroll: int = 4
    blocks_per_sm: int = 4


RING = Ring()
LDG = Ldg()


def ring_smem(K: int, ring: Stages, gemv: bool) -> int:
    """Dynamic shared memory of a weight ring (csrc/common.cuh
    wring::smem_bytes): barriers, x (the GEMV's and the chain's), the
    stages."""
    def align128(b):
        return (b + 127) // 128 * 128

    return (align128(16 * ring.stages) + (align128(2 * K) if gemv else 0)
            + ring.stages * ring.rows(K) * K * 2)


def stream_sum_plain(W, s):
    return W.float().sum() + s


def gemv_plain(x, W, s):
    return x.float() @ W.float().T + s


def layer_gemv_plain(x, stack, l: int):
    return gemv_plain(x, stack[l], 0)


def stream_sum(W, s, mode: str = "bulk", cfg=None):
    """sum(W) + s as [1, 1] f32; ``mode`` "bulk" (``cfg`` a Ring) or "ldg"
    (``cfg`` an Ldg)."""
    if W.device.type == "cpu":
        return stream_sum_plain(W, s)
    _check_device(W, "stream_sum")
    _check(W, "W", 2, torch.bfloat16)
    _check(s, "s", 2, torch.float32, aligned=False)
    if s.shape != (1, 1) or s.device != W.device:
        raise ValueError("stream_sum takes s [1, 1] f32 on W's device")
    N, K = W.shape
    if K % 8:
        raise ValueError(f"stream_sum kernel takes K as a multiple of 8; got K={K}")
    out = torch.empty((1, 1), dtype=torch.float32, device=W.device)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    sms = _sms(W.device)
    if mode == "bulk":
        ring = cfg or RING
        rows = _fit(K, ring, gemv=False, who="stream_sum")
        blocks = min(-(-N // rows), ring.blocks_per_sm * sms)
        part = torch.empty(blocks, dtype=torch.float32, device=W.device)
        err = build.load("gemv_stream").stream_sum_bulk(
            W.data_ptr(), s.data_ptr(), part.data_ptr(), out.data_ptr(), N, K, rows,
            ring.stages, blocks, stream)
    elif mode == "ldg":
        ldg = cfg or LDG
        n4 = W.numel() // 8
        blocks = min(-(-n4 // 256), ldg.blocks_per_sm * sms)
        part = torch.empty(blocks, dtype=torch.float32, device=W.device)
        err = build.load("gemv_stream").stream_sum_ldg(
            W.data_ptr(), s.data_ptr(), part.data_ptr(), out.data_ptr(), n4, ldg.unroll,
            blocks, stream)
    else:
        raise ValueError(f"stream_sum: mode {mode!r} is neither 'bulk' nor 'ldg'")
    build.check_launch("stream_sum_" + mode, err)
    launches["stream_sum_" + mode] += 1
    return out


def gemv(x, W, s, ring: Ring | None = None):
    """y = x · Wᵀ + s as [1, N] f32."""
    if x.device.type == "cpu":
        return gemv_plain(x, W, s)
    _check_device(x, "gemv")
    _check(W, "W", 2, torch.bfloat16)
    _check(s, "s", 2, torch.float32, aligned=False)
    if s.shape != (1, 1) or s.device != x.device:
        raise ValueError("gemv takes s [1, 1] f32 on x's device")
    y = _gemv(x, W, s, 0, W.shape[0], ring or RING, "gemv")
    launches["gemv"] += 1
    return y


def layer_gemv(x, stack, l: int, ring: Ring | None = None):
    """y = x · stack[l]ᵀ as [1, N] f32, stack [L, N, K] read in place."""
    if x.device.type == "cpu":
        return layer_gemv_plain(x, stack, l)
    _check_device(x, "layer_gemv")
    _check(stack, "stack", 3, torch.bfloat16)
    L = stack.shape[0]
    if not 0 <= l < L:
        raise ValueError(f"layer_gemv: layer {l} outside the stack's {L}")
    y = _gemv(x, stack, None, int(l), stack.shape[1], ring or RING, "layer_gemv")
    launches["layer_gemv"] += 1
    return y


def _gemv(x, w, s, layer, N, ring, who):
    K = w.shape[-1]
    _check(x, "x", 2, torch.bfloat16)
    if x.shape != (1, K) or w.device != x.device:
        raise ValueError(f"{who}: x {tuple(x.shape)} / W {tuple(w.shape)} do not fit, or lie "
                         "on two devices")
    if K % 8:
        raise ValueError(f"{who} kernel takes K as a multiple of 8; got K={K}")
    rows = _fit(K, ring, gemv=True, who=who)
    blocks = min(-(-N // rows), ring.blocks_per_sm * _sms(x.device))
    y = torch.empty((1, N), dtype=torch.float32, device=x.device)
    err = build.load("gemv_stream").gemv_bf16(
        x.data_ptr(), w.data_ptr(), s.data_ptr() if s is not None else None, y.data_ptr(),
        N, K, layer, rows, ring.stages, blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(who, err)
    return y


def _check_device(t, who):
    if t.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {t.device}")


def _check(t, name, dim, dtype, aligned=True):
    if t.dim() != dim or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D {dtype} tensor; got "
                         f"{tuple(t.shape)} {t.dtype}")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _fit(K, ring, gemv, who):
    if ring.stages < 1 or ring.blocks_per_sm < 1:
        raise ValueError(f"{who}: {ring} has no stage or no block")
    if ring_smem(K, ring, gemv) > MAX_SMEM:
        raise ValueError(f"{who}: {ring} at K={K} needs {ring_smem(K, ring, gemv)} bytes of "
                         f"shared memory, above {MAX_SMEM}")
    return ring.rows(K)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
