"""A chain of L dependent bf16 GEMVs in one persistent kernel: ``gemv_chain``
(``csrc/gemv_chain.cu``).

Replaces the TPU study kernel ``scripts/gemv_chain_study.py::make_mega``:
for stack [L, N, K] bf16 (N >= K) and x [1, K] bf16, y_l = x_l ·
stack[l]ᵀ summed in f32 and x_{l+1} = bf16(y_l[:, :K]); returns the last
layer's y [1, N] f32. One cooperative launch streams every layer's weights
through one ring that does not drain at the layer boundaries.

The wrapper dispatches on the device of ``x``: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. ``launches`` counts
kernel launches. The ring's default (bytes a stage, stages) is the one
``pegainfer_tpu_torch/studies/gemv_chain_study.py`` chose on an H100; the
grid is what the occupancy query allows.
"""

from __future__ import annotations

import torch

from pegainfer_tpu_torch.ops.cuda import build
from pegainfer_tpu_torch.ops.cuda.gemv_stream import MAX_SMEM, Stages, ring_smem

launches = 0
RING = Stages(stage_bytes=40960, stages=4)  # the grid: what occupancy allows


def gemv_chain_plain(x, stack, acc=torch.float32):
    """The chain in plain PyTorch, the products summed in ``acc``
    (float32 as the kernel; float64 to measure how far f32 sums drift)."""
    K = stack.shape[2]
    for l in range(stack.shape[0]):
        y = x.to(acc) @ stack[l].to(acc).T
        x = y[:, :K].float().to(torch.bfloat16)
    return y.float()


def gemv_chain(x, stack, ring: Stages | None = None):
    if x.device.type == "cpu":
        return gemv_chain_plain(x, stack)
    if x.device.type != "cuda":
        raise ValueError(f"gemv_chain: no kernel for device {x.device}")
    return _launch(x, stack, ring or RING)


def _launch(x, stack, ring):
    global launches
    if stack.dim() != 3 or x.dim() != 2:
        raise ValueError("gemv_chain takes x [1, K] and stack [L, N, K]")
    L, N, K = stack.shape
    if x.shape != (1, K):
        raise ValueError(f"x {tuple(x.shape)} / stack {tuple(stack.shape)} do not fit")
    if N < K or K % 8:
        raise ValueError(f"gemv_chain kernel takes N >= K and K a multiple of 8; got N={N}, "
                         f"K={K}")
    for t in (x, stack):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != x.device:
            raise ValueError("gemv_chain takes contiguous bf16 x and stack on one device")
        if t.data_ptr() % 16:
            raise ValueError("gemv_chain needs 16-byte aligned x and stack")
    smem = ring_smem(K, ring, gemv=True)  # the same layout as the GEMV's
    if ring.stages < 1 or smem > MAX_SMEM:
        raise ValueError(f"gemv_chain: {ring} at K={K} needs {smem} bytes of shared memory, "
                         f"above {MAX_SMEM}")
    ybuf = torch.empty((2, N), dtype=torch.float32, device=x.device)
    bar = torch.zeros(1, dtype=torch.int32, device=x.device)
    y = torch.empty((1, N), dtype=torch.float32, device=x.device)
    err = build.load("gemv_chain").gemv_chain(
        x.data_ptr(), stack.data_ptr(), ybuf.data_ptr(), y.data_ptr(), bar.data_ptr(),
        L, N, K, ring.rows(K), ring.stages, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("gemv_chain", err)
    launches += 1
    return y
