// Fused packed-fp4 routed-expert chain for DeepSeek-V4 decode on Hopper
// (sm_90a): one launch per layer computes, for every routed row m with
// expert e = idx[m],
//   g = x[m] · dequant(w1[e])ᵀ,  u = x[m] · dequant(w3[e])ᵀ,
//   g = min(g, limit), u = clamp(u, -limit, limit)   (when limit > 0),
//   act = bf16(silu(g) · u),
//   y[m] = act · dequant(w2[e])ᵀ.
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/fp4_gemm.py, function
// moe_fp4_chain (body _fp4_chain_kernel). Same function and numerics as
// three K3 calls (csrc/fp4_gemv.cu) with the SwiGLU between: x [M, D] in
// bf16; w1 / w3 [E, I, D/2] and w2 [E, D, I/2] hold two E2M1 codes a byte
// with bf16 group scales s1 / s3 [E, I, S1] and s2 [E, D, S2]; each weight
// is bf16(f32(code) · scale), f32 sums, act rounded to bf16, y f32 [M, D].
//
// perm13: without it, packed byte k of a w2 row holds act[2k] (low nibble)
// and act[2k + 1]. With it, the caller permuted the rows of w1 / w3 / s1 /
// s3 to evens then odds, so act lands in that order and byte k holds
// act[k] and act[k + I/2]. On this card that is an index map in phase 2;
// the TPU kernel's one-hot de-interleave matmuls have no counterpart.
//
// What bounds it: bytes. Each routed row streams its expert's three packed
// matrices and their scales once: 3 · I · D / 2 bytes plus 3 · I · D / 16
// of bf16 scales at 32-wide groups (14.2 MB at I 2048, D 4096), 84.9 MB
// for the 6 rows of a B = 1 step, 25 µs at 3.35 TB/s.
//
// Design: int8_chain.cu's persistent cooperative grid and two phases, with
// K3's decode. A lane reads 16 packed bytes at a time: 32 values, one whole
// scale group (the group is a multiple of 32), so one scale a load; the
// nibbles decode through a 16-entry table in shared memory. Phase 1 gives
// each warp one (row m, channel o) of w1 and w3 against x[m] (read through
// L1) and writes act[m, o] in bf16 to a scratch buffer; a grid barrier
// follows; phase 2 gives each warp one (row m, channel d) of w2 against
// act[m] (read from L2).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kMaxRows = 16;

// 16 packed bytes under one scale -> lo[b], hi[b]: the low and high nibble
// of byte b, decoded and rounded as K3 does
__device__ __forceinline__ void decode_fp4x32(const uint4 raw, float sc, const float* lut,
                                              float* lo, float* hi) {
  const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t byte = (wd[h] >> (8 * b)) & 0xFF;
      lo[4 * h + b] = bf16_round(lut[byte & 0xF] * sc);
      hi[4 * h + b] = bf16_round(lut[byte >> 4] * sc);
    }
  }
}

template <bool kPerm13>
__global__ void __launch_bounds__(kWarps * 32)
fp4_chain_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ w1, const __nv_bfloat16* __restrict__ s1,
                 const uint8_t* __restrict__ w3, const __nv_bfloat16* __restrict__ s3,
                 const uint8_t* __restrict__ w2, const __nv_bfloat16* __restrict__ s2,
                 const int* __restrict__ idx, __nv_bfloat16* act,
                 float* __restrict__ y, int M, int E, int I, int D, int S1, int S2,
                 float limit) {
  __shared__ float lut[16];
  if (threadIdx.x < 16) lut[threadIdx.x] = kE2M1[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int gwarp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int nwarps = gridDim.x * kWarps;
  const int g1 = D / S1, g2 = I / S2;  // group widths, in values

  // phase 1: act[m, o] for every (m, o)
  for (int t = gwarp; t < M * I; t += nwarps) {
    const int m = t / I, o = t % I;
    const int e = idx[m];
    const bool valid = e >= 0 && e < E;
    float g = 0.f, u = 0.f;
    if (valid) {
      const size_t row = static_cast<size_t>(e) * I + o;
      const uint4* r1 = reinterpret_cast<const uint4*>(w1 + row * (D / 2));
      const uint4* r3 = reinterpret_cast<const uint4*>(w3 + row * (D / 2));
      const __nv_bfloat16* sr1 = s1 + row * S1;
      const __nv_bfloat16* sr3 = s3 + row * S1;
      const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * D);
#pragma unroll 2
      for (int c = lane; c < D / 32; c += 32) {
        float lo1[16], hi1[16], lo3[16], hi3[16];
        decode_fp4x32(__ldg(r1 + c), __bfloat162float(sr1[(32 * c) / g1]), lut, lo1, hi1);
        decode_fp4x32(__ldg(r3 + c), __bfloat162float(sr3[(32 * c) / g1]), lut, lo3, hi3);
#pragma unroll
        for (int h = 0; h < 4; ++h) {  // x values 32c + 8h .. 32c + 8h + 7
          float xv[8];
          unpack_bf16x8(__ldg(xr + 4 * c + h), xv);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            g = fmaf(lo1[4 * h + b], xv[2 * b], g);
            g = fmaf(hi1[4 * h + b], xv[2 * b + 1], g);
            u = fmaf(lo3[4 * h + b], xv[2 * b], u);
            u = fmaf(hi3[4 * h + b], xv[2 * b + 1], u);
          }
        }
      }
    }
    g = warp_sum(g);
    u = warp_sum(u);
    if (lane == 0) {
      float v = 0.f;
      if (valid) {
        if (limit > 0.f) {
          g = fminf(g, limit);
          u = fminf(fmaxf(u, -limit), limit);
        }
        v = 1.f / (1.f + expf(-g)) * g * u;
      }
      act[static_cast<size_t>(m) * I + o] = __float2bfloat16_rn(v);
    }
  }

  cg::this_grid().sync();

  // phase 2: y[m, d] for every (m, d)
  const int I2 = I / 2;
  for (int t = gwarp; t < M * D; t += nwarps) {
    const int m = t / D, d = t % D;
    const int e = idx[m];
    const bool valid = e >= 0 && e < E;
    float acc = 0.f;
    if (valid) {
      const size_t row = static_cast<size_t>(e) * D + d;
      const uint4* r2 = reinterpret_cast<const uint4*>(w2 + row * I2);
      const __nv_bfloat16* sr2 = s2 + row * S2;
      const __nv_bfloat16* am = act + static_cast<size_t>(m) * I;
#pragma unroll 2
      for (int c = lane; c < I / 32; c += 32) {
        float lo[16], hi[16];
        decode_fp4x32(__ldg(r2 + c), __bfloat162float(sr2[(32 * c) / g2]), lut, lo, hi);
        if (kPerm13) {
          // byte 16c + b holds act[16c + b] and act[I/2 + 16c + b]
          const uint4* alo = reinterpret_cast<const uint4*>(am + 16 * c);
          const uint4* ahi = reinterpret_cast<const uint4*>(am + I2 + 16 * c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float av[8], bv[8];
            unpack_bf16x8(__ldcg(alo + h), av);
            unpack_bf16x8(__ldcg(ahi + h), bv);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc = fmaf(lo[8 * h + i], av[i], acc);
              acc = fmaf(hi[8 * h + i], bv[i], acc);
            }
          }
        } else {
          // byte 16c + b holds act[32c + 2b] and act[32c + 2b + 1]
          const uint4* ar = reinterpret_cast<const uint4*>(am + 32 * c);
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            float av[8];
            unpack_bf16x8(__ldcg(ar + h), av);
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              acc = fmaf(lo[4 * h + b], av[2 * b], acc);
              acc = fmaf(hi[4 * h + b], av[2 * b + 1], acc);
            }
          }
        }
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) y[static_cast<size_t>(m) * D + d] = acc;
  }
}

template <bool kPerm13>
int launch(const void* x, const void* w1, const void* s1, const void* w3, const void* s3,
           const void* w2, const void* s2, const void* idx, void* act, void* y, int M,
           int E, int I, int D, int S1, int S2, float limit, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fp4_chain_kernel<kPerm13>, kWarps * 32, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tasks = static_cast<long long>(M) * (I > D ? I : D);
  const long long need = (tasks + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(need < 1LL * sms * per_sm ? need : 1LL * sms * per_sm);

  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* w1p = static_cast<const uint8_t*>(w1);
  const uint8_t* w3p = static_cast<const uint8_t*>(w3);
  const uint8_t* w2p = static_cast<const uint8_t*>(w2);
  const __nv_bfloat16* s1p = static_cast<const __nv_bfloat16*>(s1);
  const __nv_bfloat16* s3p = static_cast<const __nv_bfloat16*>(s3);
  const __nv_bfloat16* s2p = static_cast<const __nv_bfloat16*>(s2);
  const int* idxp = static_cast<const int*>(idx);
  __nv_bfloat16* actp = static_cast<__nv_bfloat16*>(act);
  float* yp = static_cast<float*>(y);
  void* args[] = {&xp, &w1p, &s1p, &w3p, &s3p, &w2p, &s2p, &idxp, &actp, &yp,
                  &M, &E, &I, &D, &S1, &S2, &limit};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fp4_chain_kernel<kPerm13>),
                                    dim3(blocks), dim3(kWarps * 32), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x [M, D] bf16; w1 / w3 [E, I, D/2] and w2 [E, D, I/2] packed uint8; s1 /
// s3 [E, I, S1] and s2 [E, D, S2] bf16; idx [M] int32; act [M, I] bf16
// scratch -> y [M, D] f32. Needs 1 <= M <= 16, D and I multiples of 32,
// scale groups D/S1 and I/S2 multiples of 32, 16-byte aligned x, act and
// weights, and with perm13 I/2 a multiple of 16; a row whose expert id lies
// outside [0, E) gives 0. Returns the cooperative launch's error (0 =
// launched), or cudaErrorInvalidValue for a shape it does not take.
extern "C" int fp4_chain(const void* x, const void* w1, const void* s1, const void* w3,
                         const void* s3, const void* w2, const void* s2, const void* idx,
                         void* act, void* y, int M, int E, int I, int D, int S1, int S2,
                         float limit, int perm13, void* stream) {
  if (M < 1 || M > kMaxRows || I < 32 || D < 32 || I % 32 || D % 32 || S1 < 1 ||
      S2 < 1 || D % S1 || I % S2 || (D / S1) % 32 || (I / S2) % 32)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (perm13)
    return launch<true>(x, w1, s1, w3, s3, w2, s2, idx, act, y, M, E, I, D, S1, S2, limit,
                        st);
  return launch<false>(x, w1, s1, w3, s3, w2, s2, idx, act, y, M, E, I, D, S1, S2, limit,
                       st);
}
