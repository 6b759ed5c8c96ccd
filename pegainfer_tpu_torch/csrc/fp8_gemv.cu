// fp8 dense-linear GEMV for Hopper (sm_90a): y = x · dequant(q, s)ᵀ.
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/fp4_gemm.py, function
// fp8_gemv (body _fp8_kernel). Same function and numerics: x [M ≤ 8, IN]
// in bf16; q [OUT, IN] E4M3 with bf16 scales s [OUT/ro, IN/ri] (one per
// ro × ri block, 128 × 128 in the checkpoint); each weight is dequantized
// as bf16(f32(code) · scale), products accumulate in f32, y is f32
// [M, OUT]. The TPU kernel's one-hot scale-expansion matmul and its
// VMEM-sized o-tiles exist for Mosaic and are not carried over.
//
// What bounds it: bytes. The weight is read once, OUT·IN bytes plus the
// scales (wq_b, 32768 × 1024, is 33.5 MB: 10 µs at 3.35 TB/s); x and y are
// small at M ≤ 8.
//
// Design: a block stages all M rows of x in shared memory once, then each
// warp walks weight rows. A lane reads 16 weight bytes at a time (16 E4M3
// values, all under one scale, since ri is a multiple of 16), decodes them
// with the hardware fp8x2 -> half2 conversion and applies each weight to
// all M rows of x, so weight traffic does not grow with M (the TPU grid ran
// m innermost for the same reason). Lanes of a warp read neighbouring 16
// bytes; the row's sums meet in a warp shuffle reduction. The grid is
// capped at a few blocks per SM and each warp strides over rows, so x is
// staged by few blocks. x sits in shared memory with its 16-byte units
// XOR-swizzled, so the 32-byte x slices that neighbouring lanes read fall
// in distinct banks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxRows = 8;
constexpr int kUnitsPerChunk = 2;  // 16 bf16 of x (32 B) per 16 fp8 weights

// physical 16-byte unit of logical unit u in a swizzled x row
__device__ __forceinline__ int swz(int u) {
  return u ^ ((u >> 3) & (kUnitsPerChunk - 1));
}

// 16 E4M3 codes -> 16 floats
__device__ __forceinline__ void decode_e4m3x16(const uint4 raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_fp8x2_storage_t pair =
          static_cast<__nv_fp8x2_storage_t>((w[i] >> (16 * h)) & 0xFFFF);
      const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3);
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&hr));
      out[4 * i + 2 * h] = f.x;
      out[4 * i + 2 * h + 1] = f.y;
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kWarps * 32)
fp8_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ q,
                const __nv_bfloat16* __restrict__ s, float* __restrict__ y,
                int OUT, int IN, int ro, int ri, int Si) {
  extern __shared__ uint4 xs[];  // [M][IN/8] swizzled 16-byte units
  const int units = IN / 8;
  for (int i = threadIdx.x; i < M * units; i += blockDim.x) {
    const int m = i / units, u = i % units;
    xs[m * units + swz(u)] =
        reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * IN)[u];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = IN / 16;
  for (int o = blockIdx.x * kWarps + warp; o < OUT; o += gridDim.x * kWarps) {
    const uint4* qrow = reinterpret_cast<const uint4*>(q + static_cast<size_t>(o) * IN);
    const __nv_bfloat16* srow = s + static_cast<size_t>(o / ro) * Si;
    float acc[M];
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      const uint4 raw = __ldg(qrow + c);
      const float sc = __bfloat162float(srow[(c * 16) / ri]);
      float w[16];
      decode_e4m3x16(raw, w);
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = bf16_round(w[i] * sc);
#pragma unroll
      for (int m = 0; m < M; ++m) {
#pragma unroll
        for (int h = 0; h < kUnitsPerChunk; ++h) {
          float xv[8];
          unpack_bf16x8(xs[m * units + swz(c * kUnitsPerChunk + h)], xv);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[m] = fmaf(w[8 * h + i], xv[i], acc[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float v = warp_sum(acc[m]);
      if (lane == 0) y[static_cast<size_t>(m) * OUT + o] = v;
    }
  }
}

template <int M>
int launch(const void* x, const void* q, const void* s, void* y, int OUT,
           int IN, int ro, int ri, int Si, int blocks, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(M) * IN * 2;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fp8_gemv_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fp8_gemv_kernel<M><<<blocks, kWarps * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const __nv_bfloat16*>(s), static_cast<float*>(y), OUT, IN,
      ro, ri, Si);
  return cudaGetLastError();
}

}  // namespace

// x [M, IN] bf16, q [OUT, IN] e4m3 bytes, s [OUT/ro, IN/ri] bf16 -> y [M, OUT]
// f32. Needs 1 <= M <= 8, IN % 16 == 0, ri % 16 == 0 and 16-byte aligned
// rows. Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int fp8_gemv(const void* x, const void* q, const void* s, void* y,
                        int M, int OUT, int IN, int ro, int ri, int Si,
                        int blocks, void* stream) {
  if (M < 1 || M > kMaxRows || IN % 16 || ri % 16 || blocks < 1)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: return launch<1>(x, q, s, y, OUT, IN, ro, ri, Si, blocks, st);
    case 2: return launch<2>(x, q, s, y, OUT, IN, ro, ri, Si, blocks, st);
    case 3: return launch<3>(x, q, s, y, OUT, IN, ro, ri, Si, blocks, st);
    case 4: return launch<4>(x, q, s, y, OUT, IN, ro, ri, Si, blocks, st);
    case 5: return launch<5>(x, q, s, y, OUT, IN, ro, ri, Si, blocks, st);
    case 6: return launch<6>(x, q, s, y, OUT, IN, ro, ri, Si, blocks, st);
    case 7: return launch<7>(x, q, s, y, OUT, IN, ro, ri, Si, blocks, st);
    default: return launch<8>(x, q, s, y, OUT, IN, ro, ri, Si, blocks, st);
  }
}
