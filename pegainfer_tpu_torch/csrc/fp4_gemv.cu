// Packed-fp4 MoE expert GEMV for Hopper (sm_90a):
// y[m] = x[m] · dequant(q[idx[m]], s[idx[m]])ᵀ.
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/fp4_gemm.py, function
// moe_fp4_gemv (body _kernel, decode _decode_pair_swar / _decode_e2m1).
// Same function and numerics: x [M, IN] in bf16; q [E, OUT, IN/2] holds two
// E2M1 codes per byte (low nibble = even element); s [E, OUT, IN/g] bf16
// scales, one per g-wide group (g = 32 in the checkpoint); each weight is
// bf16(f32(code) · scale), products accumulate in f32, y is f32 [M, OUT].
// The TPU's SWAR nibble decode and one-hot scale-expansion matmul exist only
// to satisfy Mosaic and are not carried over.
//
// What bounds it: bytes. Each row m streams its expert's packed rows once:
// OUT·IN/2 bytes plus OUT·IN/g·2 bytes of scales (w1 at OUT 2048, IN 4096:
// 4.7 MB per row, 28.3 MB for the 6 routed rows of one token, 8.4 µs at
// 3.35 TB/s).
//
// Design: a block takes one row m and a tile of 32 output rows; each of its
// 8 warps walks 4 weight rows. A lane reads 16 bytes at a time: 32 fp4
// values, one whole 32-wide scale group, so one scale per load. The nibbles
// decode through a 16-entry table in shared memory (16 distinct words in 16
// banks, so a warp's lookups never conflict). x[m] is staged once per block
// in shared memory with its 16-byte units XOR-swizzled, so the 64-byte x
// slices that neighbouring lanes read fall in distinct banks. A warp shuffle
// reduction ends each row. At B = 1 (M = 6) w1 runs 6 × 2048 / 32 = 384
// blocks on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 32;
constexpr int kUnitsPerChunk = 4;  // 32 bf16 of x (64 B) per 16 packed bytes

__device__ __forceinline__ int swz(int u) {
  return u ^ ((u >> 3) & (kUnitsPerChunk - 1));
}

__global__ void __launch_bounds__(kWarps * 32)
fp4_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ q,
                const __nv_bfloat16* __restrict__ s,
                const int* __restrict__ idx, float* __restrict__ y, int E,
                int OUT, int IN, int S) {
  extern __shared__ uint4 xs[];  // [IN/8] swizzled 16-byte units
  __shared__ float lut[16];
  const int m = blockIdx.y;
  const int units = IN / 8;
  if (threadIdx.x < 16) lut[threadIdx.x] = kE2M1[threadIdx.x];
  const uint4* xrow = reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * IN);
  for (int u = threadIdx.x; u < units; u += blockDim.x) xs[swz(u)] = xrow[u];
  __syncthreads();

  const int e = idx[m];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = IN / 32;
  const int g = IN / S;
  const int o_begin = static_cast<int>(blockIdx.x) * kRowsPerBlock;
  const int o_end = min(OUT, o_begin + kRowsPerBlock);
  for (int o = o_begin + warp; o < o_end; o += kWarps) {
    float acc = 0.f;
    if (e >= 0 && e < E) {
      const size_t row = static_cast<size_t>(e) * OUT + o;
      const uint4* qrow = reinterpret_cast<const uint4*>(q + row * (IN / 2));
      const __nv_bfloat16* srow = s + row * S;
#pragma unroll 4
      for (int c = lane; c < chunks; c += 32) {
        const uint4 raw = __ldg(qrow + c);
        const float sc = __bfloat162float(srow[(c * 32) / g]);
        const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int h = 0; h < kUnitsPerChunk; ++h) {  // word h = x unit h
          float xv[8];
          unpack_bf16x8(xs[swz(c * kUnitsPerChunk + h)], xv);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t byte = (wd[h] >> (8 * b)) & 0xFF;
            acc = fmaf(bf16_round(lut[byte & 0xF] * sc), xv[2 * b], acc);
            acc = fmaf(bf16_round(lut[byte >> 4] * sc), xv[2 * b + 1], acc);
          }
        }
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) y[static_cast<size_t>(m) * OUT + o] = acc;
  }
}

}  // namespace

// x [M, IN] bf16, q [E, OUT, IN/2] uint8, s [E, OUT, S] bf16, idx [M] int32
// -> y [M, OUT] f32. Needs IN % 32 == 0 and (IN/S) % 32 == 0; a row whose
// expert id lies outside [0, E) gives 0. Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for a shape it does
// not take.
extern "C" int fp4_gemv(const void* x, const void* q, const void* s,
                        const void* idx, void* y, int M, int E, int OUT,
                        int IN, int S, void* stream) {
  if (M < 1 || IN % 32 || S < 1 || IN % S || (IN / S) % 32) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(IN) * 2;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fp4_gemv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((OUT + kRowsPerBlock - 1) / kRowsPerBlock, M);
  fp4_gemv_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const __nv_bfloat16*>(s), static_cast<const int*>(idx),
      static_cast<float*>(y), E, OUT, IN, S);
  return cudaGetLastError();
}
