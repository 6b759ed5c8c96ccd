"""Hand-written CUDA kernels for Hopper (sm_90a), with their wrappers.

| kernel | source | replaces (TPU) |
|---|---|---|
| K1 paged decode attention | csrc/paged_decode.cu | ops/pallas/paged_decode.py::paged_attention_decode |
| K2 flash prefill attention | csrc/flash_prefill.cu | ops/pallas/flash_prefill.py::flash_attention |

Each wrapper takes the plain PyTorch version for CPU tensors and launches
its kernel (or raises) for CUDA tensors; nothing is built at import time.
"""
