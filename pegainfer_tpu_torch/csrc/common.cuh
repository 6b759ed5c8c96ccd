// Device helpers shared by the kernels in this directory. Each source
// includes this header and builds on its own (one nvcc a source).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// E2M1 (fp4) code -> value; bit 3 is the sign
__constant__ float kE2M1[16] = {0.f,  0.5f,  1.f,  1.5f,  2.f,  3.f,  4.f,  6.f,
                                -0.f, -0.5f, -1.f, -1.5f, -2.f, -3.f, -4.f, -6.f};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 packed bf16 (one 16-byte load) -> 8 floats
__device__ __forceinline__ void unpack_bf16x8(const uint4 raw, float* out) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// int8 code j of a 4-code word -> its exact float value, with no
// integer-to-float conversion instruction: a byte permute puts q + 128 in
// the low mantissa byte of 2^23 (0x4B000000), and a subtraction of
// 2^23 + 128 leaves q
__device__ __forceinline__ float s8_at(uint32_t word, int j) {
  return __uint_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7440 | j)) -
         8388736.f;
}

// 16 int8 codes (one 16-byte load) -> 16 exact floats
__device__ __forceinline__ void decode_s8x16(const uint4 raw, float* w) {
  const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[4 * i + j] = s8_at(wd[i], j);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace
