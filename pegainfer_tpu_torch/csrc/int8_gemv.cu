// int8 MoE expert GEMV for Hopper (sm_90a): y[m] = x[m] · q[idx[m]]ᵀ,
// unscaled.
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/fp4_gemm.py, function
// moe_int8_gemv (body _int8_kernel). Same function and numerics: x [M, IN]
// in bf16, q [E, OUT, IN] int8 codes (the int8-experts mode), y f32
// [M, OUT]; each code is an exact float (|q| ≤ 127), each product of a
// code and a bf16 x is exact in f32 and the sums are f32. The caller
// applies the per-output-channel scales to y (M·OUT multiplies).
//
// What bounds it: bytes. Each distinct routed expert streams OUT·IN bytes
// once (w1 at OUT 2048, IN 4096: 8.4 MB an expert, 100.7 MB for the 12
// rows of a B = 2 step, 30 µs at 3.35 TB/s).
//
// Design: K3's (csrc/fp4_gemv.cu) without the decode table. A block takes
// one output tile of 32 rows and one routed row m; rows routed to an
// expert that an earlier row already has are left to that row's block
// (the block returns at once), and the first row's block takes all of them,
// so each 16-byte load of 16 codes is applied to every row routed to that
// expert and an expert's weights cross the bus once per step. The block
// stages those rows of x in shared memory, up to 4 at a time, with their
// 16-byte units XOR-swizzled (the 32-byte x slices that neighbouring lanes
// read fall in distinct banks). Each of its 8 warps walks 4 weight rows; a
// lane turns 16 codes into floats with a byte permute and one subtraction
// each (2^23 + (q + 128) as a float bit pattern, less 2^23 + 128), with no
// integer-to-float conversion instruction, and a warp shuffle ends each
// row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 32;
constexpr int kGroup = 4;           // rows of x staged at once
constexpr int kUnitsPerChunk = 2;   // 16 bf16 of x (32 B) per 16 codes

__device__ __forceinline__ int swz(int u) {
  return u ^ ((u >> 3) & (kUnitsPerChunk - 1));
}

__global__ void __launch_bounds__(kWarps * 32)
int8_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ q, const int* __restrict__ idx,
                 float* __restrict__ y, int M, int E, int OUT, int IN) {
  extern __shared__ uint4 xs[];  // [kGroup][IN/8] swizzled 16-byte units
  const int m = blockIdx.y;
  const int e = idx[m];
  const bool valid = e >= 0 && e < E;
  if (valid) {
    for (int j = 0; j < m; ++j)
      if (idx[j] == e) return;  // an earlier row's block serves this expert
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int units = IN / 8, chunks = IN / 16;
  const int o_begin = static_cast<int>(blockIdx.x) * kRowsPerBlock;
  const int o_end = min(OUT, o_begin + kRowsPerBlock);

  // the rows of this expert from m on, kGroup at a time; every thread scans
  // idx alike, so the loop is uniform over the block (an invalid expert id
  // is a group of its own row and gives 0)
  for (int next = m; next < M;) {
    int rows[kGroup];
    int n = 0, j = next;
    for (; j < M && n < kGroup; ++j)
      if (j == m || (valid && idx[j] == e)) rows[n++] = j;
    next = j;
    if (n == 0) break;
    __syncthreads();  // the previous group's products are done with xs
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      if (r < n) {
        const uint4* xrow = reinterpret_cast<const uint4*>(x + static_cast<size_t>(rows[r]) * IN);
        for (int u = threadIdx.x; u < units; u += blockDim.x) xs[r * units + swz(u)] = xrow[u];
      }
    }
    __syncthreads();
    for (int o = o_begin + warp; o < o_end; o += kWarps) {
      float acc[kGroup] = {0.f, 0.f, 0.f, 0.f};
      if (valid) {
        const uint4* qrow =
            reinterpret_cast<const uint4*>(q + (static_cast<size_t>(e) * OUT + o) * IN);
#pragma unroll 4
        for (int c = lane; c < chunks; c += 32) {
          float w[16];
          decode_s8x16(__ldg(qrow + c), w);
#pragma unroll
          for (int r = 0; r < kGroup; ++r) {
            if (r < n) {
#pragma unroll
              for (int h = 0; h < kUnitsPerChunk; ++h) {
                float xv[8];
                unpack_bf16x8(xs[r * units + swz(c * kUnitsPerChunk + h)], xv);
#pragma unroll
                for (int i = 0; i < 8; ++i) acc[r] = fmaf(w[8 * h + i], xv[i], acc[r]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        if (r < n) {
          const float v = warp_sum(acc[r]);
          if (lane == 0) y[static_cast<size_t>(rows[r]) * OUT + o] = v;
        }
      }
    }
  }
}

}  // namespace

// x [M, IN] bf16, q [E, OUT, IN] int8, idx [M] int32 -> y [M, OUT] f32,
// unscaled. Needs IN % 16 == 0 and 16-byte aligned x and q; a row whose
// expert id lies outside [0, E) gives 0. Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for a shape it does
// not take.
extern "C" int int8_gemv(const void* x, const void* q, const void* idx, void* y,
                         int M, int E, int OUT, int IN, void* stream) {
  if (M < 1 || OUT < 1 || IN < 16 || IN % 16) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kGroup) * IN * 2;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_gemv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((OUT + kRowsPerBlock - 1) / kRowsPerBlock, M);
  int8_gemv_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const int*>(idx), static_cast<float*>(y), M, E, OUT, IN);
  return cudaGetLastError();
}
