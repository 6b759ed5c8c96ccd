"""Hand-written CUDA kernels for Hopper (sm_90a), with their wrappers.

| kernel | source | replaces (TPU) |
|---|---|---|
| K1 paged decode attention (split-KV: the context across blocks) | csrc/paged_decode.cu | ops/pallas/paged_decode.py::paged_attention_decode |
| K2 flash prefill attention | csrc/flash_prefill.cu | ops/pallas/flash_prefill.py::flash_attention |
| K3 fp4 expert GEMV (decode MoE) | csrc/fp4_gemv.cu | ops/pallas/fp4_gemm.py::moe_fp4_gemv |
| K4 fp8 dense GEMV (decode linears) | csrc/fp8_gemv.cu | ops/pallas/fp4_gemm.py::fp8_gemv |
| K5 fp4 grouped GEMM (prefill MoE) | csrc/fp4_grouped.cu | ops/pallas/fp4_gemm.py::moe_fp4_grouped |
| K6 int8 expert GEMV (decode MoE) | csrc/int8_gemv.cu | ops/pallas/fp4_gemm.py::moe_int8_gemv |
| K7 int8 grouped GEMM (prefill MoE) | csrc/int8_grouped.cu | ops/pallas/fp4_gemm.py::moe_int8_grouped |
| K8 int8 routed-expert chain (decode MoE) | csrc/int8_chain.cu | ops/pallas/fp4_gemm.py::moe_int8_chain |
| K9 fp4 routed-expert chain (decode MoE) | csrc/fp4_chain.cu | ops/pallas/fp4_gemm.py::moe_fp4_chain |

Each wrapper takes the plain PyTorch version for CPU tensors and launches
its kernel (or raises) for CUDA tensors; nothing is built at import time.
"""
