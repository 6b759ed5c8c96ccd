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

// a 16-byte copy from device to shared memory, zeros where !valid (source
// size 0; src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a · b on the tensor cores: bf16 m16n8k16, A row-major, B
// column-major, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The packed-fp4 decode of K5 (fp4_grouped.cu) and K9 (fp4_chain.cu), with
// no table in memory.
// E2M1 magnitudes 0, 0.5, 1, 1.5, 2, 3, 4, 6 in bf16 are 0x0000, 0x3F00,
// 0x3F80, 0x3FC0, 0x4000, 0x4040, 0x4080, 0x40C0: their low bytes (kLo0 for
// magnitudes 0-3, kLo1 for 4-7) and high bytes (kHi0, kHi1), picked by a
// 3-bit magnitude as a prmt selector
constexpr uint32_t kLo0 = 0xC0800000u, kLo1 = 0xC0804000u;
constexpr uint32_t kHi0 = 0x3F3F3F00u, kHi1 = 0x40404040u;
// prmt selectors (a nibble a result byte; 8 + i replicates byte i's bit 7):
// the signs of codes 0-3 / 4-7 of a word w as 0xFF bytes, from w (odd codes'
// sign bits at bit 7 of their byte) and w << 4 (even codes'); and the
// interleaves of low and high bytes into bf16 pairs
constexpr uint32_t kSelNeg03 = 0x9D8Cu, kSelNeg47 = 0xBFAEu;
constexpr uint32_t kSelPair01 = 0x5140u, kSelPair23 = 0x7362u;

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 8 packed codes (byte j: codes 2j in the low nibble, 2j + 1 in the high)
// -> 4 bf16 pairs r[j] = (code 2j, code 2j + 1) · scale, each rounded once
// from the exact product; sc holds the scale in both halves
__device__ __forceinline__ void e2m1x8_bf16x2(uint32_t w, uint32_t sc, uint32_t* r) {
  const uint32_t m = w & 0x77777777u;  // magnitudes (a prmt reads the low 16 bits)
  const uint32_t w4 = w << 4;
  const uint32_t hi03 = prmt(kHi0, kHi1, m) | (prmt(w, w4, kSelNeg03) & 0x80808080u);
  const uint32_t hi47 = prmt(kHi0, kHi1, m >> 16) | (prmt(w, w4, kSelNeg47) & 0x80808080u);
  const uint32_t lo03 = prmt(kLo0, kLo1, m), lo47 = prmt(kLo0, kLo1, m >> 16);
  r[0] = mul_bf16x2(prmt(lo03, hi03, kSelPair01), sc);
  r[1] = mul_bf16x2(prmt(lo03, hi03, kSelPair23), sc);
  r[2] = mul_bf16x2(prmt(lo47, hi47, kSelPair01), sc);
  r[3] = mul_bf16x2(prmt(lo47, hi47, kSelPair23), sc);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace
