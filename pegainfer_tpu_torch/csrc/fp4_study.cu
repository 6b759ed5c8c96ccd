// Packed-fp4 expert GEMV decode study for Hopper (sm_90a):
// y[m, o] = Σ_j w_lo[o, j] · x[m, 2j] + w_hi[o, j] · x[m, 2j + 1]
// over q[idx[m]] [OUT, IN/2] (byte j: the code of element 2j in the low
// nibble, 2j + 1 in the high), in four variants of the weight w.
//
// Replaces the TPU study kernel scripts/fp4_kernel_study.py:105 build
// (pallas_call :128; body make_kernel :72; decodes decode_arith :44,
// decode_bits :52; expand_scales :64). Same functions: x [M, IN] bf16, q [E,
// OUT, IN/2] uint8, s [E, OUT, S] bf16 scales, one per g = IN/S elements,
// idx [M] int32, y f32 [M, OUT]; products of bf16 values exact in f32, sums
// in f32. The TPU splits x into x_lo / x_hi only for its layout; here nibble
// j's halves pair with x[2j] and x[2j + 1], as in K3.
//
// - floor (kFloor): the code byte 0–255 itself is the weight of both halves
//   (:79-81), the TPU's load + dot floor; a byte becomes a float by a byte
//   permute into 2^23's mantissa and one subtraction.
// - bits_noscale (kBitsNoscale): the bf16 bit-pattern decode, no scale (a
//   cost probe): common.cuh's table-free prmt decode (K5's and K9's), which
//   builds decode_bits's patterns.
// - bits (kBits): that decode × the bf16 scale in bf16 (mul.rn.bf16x2,
//   common.cuh e2m1x8_bf16x2).
// - arith (kArith): decode_arith in f32 (integer fields, converts, selects)
//   × the f32 scale, rounded to bf16. For E2M1 codes and bf16 scales both
//   products are exact before the one rounding, so bits and arith give the
//   same bf16 weight.
//
// floor and bits_noscale still load the scale tile, as the TPU's BlockSpec
// DMAs it whether used or not (:137): each lane folds the scale bits it
// loads into a word that is stored only through a null `sink` pointer, so
// the compiler cannot drop the loads; the study's --sass report counts the
// 16-bit global loads of each instantiation in cuobjdump -sass (the smoke
// fails if a floor or bits_noscale kernel has none).
//
// What bounds it: bytes. M·OUT·IN/2 packed bytes and M·OUT·IN/g·2 scale
// bytes (at M 12, OUT 2048, IN 4096, g 32: 50.3 + 6.3 MB, 16.90 µs at
// 3.35 TB/s) and 2·M·OUT·IN operations. Design: K3's (csrc/fp4_gemv.cu). A
// block takes one routed row m and kRows ∈ {16, 32, 64} output rows (the
// TPU's TO), x[m] staged once in shared memory with its 16-byte units
// XOR-swizzled; each of 8 warps walks kRows/8 weight rows, a lane 16 packed
// bytes a load (32 codes, one scale group at g 32), 4 loads in flight, a
// warp shuffle ends each row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kFloor = 0, kBitsNoscale = 1, kBits = 2, kArith = 3;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnitsPerChunk = 4;  // 32 bf16 of x (64 B) per 16 packed bytes

__device__ __forceinline__ int swz(int u) { return u ^ ((u >> 3) & (kUnitsPerChunk - 1)); }

// decode_arith (fp4_kernel_study.py:44) of one code, × the f32 scale, to bf16
__device__ __forceinline__ float arith_weight(uint32_t code, float sc) {
  const int e = (code >> 1) & 3, m = code & 1;
  const float mag = e == 0 ? 0.5f * static_cast<float>(m)
                           : 0.25f * static_cast<float>((2 + m) << e);
  return bf16_round(mag * (1.f - 2.f * static_cast<float>(code >> 3)) * sc);
}

// the 8 weights of one word of packed codes (elements 2b, 2b + 1 from byte b)
template <int kVariant>
__device__ __forceinline__ void weights8(uint32_t word, uint32_t sbits, float* w) {
  if constexpr (kVariant == kFloor) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      w[2 * b] = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 | b)) - 8388608.f;
      w[2 * b + 1] = w[2 * b];
    }
  } else if constexpr (kVariant == kArith) {
    const float sc = __uint_as_float(sbits << 16);
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = arith_weight((word >> (4 * i)) & 0xF, sc);
  } else {
    uint32_t r[4];
    if constexpr (kVariant == kBits)
      e2m1x8_bf16x2(word, sbits | (sbits << 16), r);
    else
      e2m1x8_bf16x2_unscaled(word, r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[2 * j] = __uint_as_float(r[j] << 16);
      w[2 * j + 1] = __uint_as_float(r[j] & 0xFFFF0000u);
    }
  }
}

template <int kVariant, int kRows>
__global__ void __launch_bounds__(kThreads)
fp4_variant_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                   const uint16_t* __restrict__ s, const int* __restrict__ idx,
                   float* __restrict__ y, uint32_t* sink, int E, int OUT, int IN, int S) {
  extern __shared__ uint4 xs[];  // x[m]: IN/8 swizzled 16-byte units
  const int m = blockIdx.y;
  const uint4* xrow = reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * IN);
  for (int u = threadIdx.x; u < IN / 8; u += kThreads) xs[swz(u)] = xrow[u];
  __syncthreads();

  const int e = idx[m];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = IN / 32, g = IN / S;
  const int o_begin = static_cast<int>(blockIdx.x) * kRows;
  const int o_end = min(OUT, o_begin + kRows);
  uint32_t kept = 0;  // the scale bits floor and bits_noscale load and do not use
  for (int o = o_begin + warp; o < o_end; o += kWarps) {
    float acc = 0.f;
    if (e >= 0 && e < E) {
      const size_t row = static_cast<size_t>(e) * OUT + o;
      const uint4* qrow = reinterpret_cast<const uint4*>(q + row * (IN / 2));
      const uint16_t* srow = s + row * S;
#pragma unroll 4
      for (int c = lane; c < chunks; c += 32) {
        const uint4 raw = __ldg(qrow + c);
        const uint32_t sbits = __ldg(srow + (c * 32) / g);
        if constexpr (kVariant == kFloor || kVariant == kBitsNoscale) kept += sbits;
        const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int h = 0; h < kUnitsPerChunk; ++h) {  // word h = x unit h
          float w[8], xv[8];
          weights8<kVariant>(wd[h], sbits, w);
          unpack_bf16x8(xs[swz(c * kUnitsPerChunk + h)], xv);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc = fmaf(w[i], xv[i], acc);
        }
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) y[static_cast<size_t>(m) * OUT + o] = acc;
  }
  if (sink != nullptr) atomicXor(sink, kept);
}

template <int kVariant, int kRows>
cudaError_t launch(const void* x, const void* q, const void* s, const void* idx, void* y, int M,
                   int E, int OUT, int IN, int S, cudaStream_t stream) {
  static bool allowed[wring::kMaxDevices];
  const cudaError_t err = wring::allow_max_smem(
      reinterpret_cast<const void*>(fp4_variant_kernel<kVariant, kRows>), allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((OUT + kRows - 1) / kRows, M);
  fp4_variant_kernel<kVariant, kRows><<<grid, kThreads, static_cast<size_t>(IN) * 2, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const uint16_t*>(s), static_cast<const int*>(idx), static_cast<float*>(y),
      nullptr, E, OUT, IN, S);
  return cudaGetLastError();
}

template <int kVariant>
cudaError_t launch_rows(int rows, const void* x, const void* q, const void* s, const void* idx,
                        void* y, int M, int E, int OUT, int IN, int S, cudaStream_t stream) {
  if (rows == 16) return launch<kVariant, 16>(x, q, s, idx, y, M, E, OUT, IN, S, stream);
  if (rows == 32) return launch<kVariant, 32>(x, q, s, idx, y, M, E, OUT, IN, S, stream);
  if (rows == 64) return launch<kVariant, 64>(x, q, s, idx, y, M, E, OUT, IN, S, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [M, IN] bf16, q [E, OUT, IN/2] uint8, s [E, OUT, S] bf16, idx [M] int32
// -> y [M, OUT] f32; variant 0 floor, 1 bits_noscale, 2 bits, 3 arith; rows
// ∈ {16, 32, 64}. Needs IN % 32 == 0, (IN/S) % 32 == 0 and 16-byte aligned x
// and q; a row whose expert id lies outside [0, E) gives 0. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int fp4_variant_gemv(const void* x, const void* q, const void* s, const void* idx,
                                void* y, int M, int E, int OUT, int IN, int S, int variant,
                                int rows, void* stream) {
  if (M < 1 || OUT < 1 || IN < 32 || IN % 32 || S < 1 || IN % S || (IN / S) % 32)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFloor: return launch_rows<kFloor>(rows, x, q, s, idx, y, M, E, OUT, IN, S, st);
    case kBitsNoscale:
      return launch_rows<kBitsNoscale>(rows, x, q, s, idx, y, M, E, OUT, IN, S, st);
    case kBits: return launch_rows<kBits>(rows, x, q, s, idx, y, M, E, OUT, IN, S, st);
    case kArith: return launch_rows<kArith>(rows, x, q, s, idx, y, M, E, OUT, IN, S, st);
    default: return cudaErrorInvalidValue;
  }
}
