// Fused int8 routed-expert chain for DeepSeek-V4 decode on Hopper (sm_90a):
// one launch per layer computes, for every routed row m with expert
// e = idx[m],
//   g = (x[m] · w1[e]ᵀ) · s1[e],  u = (x[m] · w3[e]ᵀ) · s3[e],
//   g = min(g, limit), u = clamp(u, -limit, limit)   (when limit > 0),
//   act = bf16(silu(g) · u),
//   y[m] = (act · w2[e]ᵀ) · s2[e].
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/fp4_gemm.py, function
// moe_int8_chain (body _int8_chain_kernel). Same function and numerics: x
// [M, D] in bf16, w1 / w3 [E, I, D] and w2 [E, D, I] int8 codes, s1 / s3
// [E, I] and s2 [E, D] f32 per-output-channel scales applied after the
// dots, f32 sums, act rounded to bf16, y f32 [M, D].
//
// What bounds it: bytes. Each routed row streams its expert's three
// matrices once: 3 · I · D bytes (25.2 MB at I 2048, D 4096), 151 MB for
// the 6 rows of a B = 1 step, 45 µs at 3.35 TB/s.
//
// Design, for the card and not the TPU's: the TPU runs the chain as one
// program (grid (1,)) that double-buffers weight tiles through VMEM; on this
// card that would be one block. Here a persistent grid of as many blocks as
// fit on the SMs at once (cudaLaunchCooperativeKernel) spreads the work in
// two phases. Phase 1 gives each warp one (row m, channel o) at a time: a
// lane reads 16 codes of w1's row and 16 of w3's at a time (16-byte loads,
// neighbouring lanes on neighbouring bytes), turns them into floats with a
// byte permute and a subtraction each, and applies both to one 32-byte
// slice of x[m] read through L1; a warp shuffle ends the two sums and lane
// 0 writes act[m, o] in bf16 to a scratch buffer in device memory. A grid
// barrier (cooperative_groups) follows. Phase 2 gives each warp one (row m,
// channel d) of w2 against act[m], read from L2 (written by other SMs in
// phase 1). Consecutive warps take consecutive channels of one row, so the
// grid streams each expert's rows in order. With one warp a weight row
// there is no tile parity to get wrong (the TPU kernel's double-buffer
// parity fault has no counterpart).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kMaxRows = 16;

__global__ void __launch_bounds__(kWarps * 32)
int8_chain_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w1, const int8_t* __restrict__ w3,
                  const int8_t* __restrict__ w2, const float* __restrict__ s1,
                  const float* __restrict__ s3, const float* __restrict__ s2,
                  const int* __restrict__ idx, __nv_bfloat16* act,
                  float* __restrict__ y, int M, int E, int I, int D, float limit) {
  const int lane = threadIdx.x % 32;
  const int gwarp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int nwarps = gridDim.x * kWarps;

  // phase 1: act[m, o] for every (m, o)
  for (int t = gwarp; t < M * I; t += nwarps) {
    const int m = t / I, o = t % I;
    const int e = idx[m];
    const bool valid = e >= 0 && e < E;
    float g = 0.f, u = 0.f;
    if (valid) {
      const size_t row = static_cast<size_t>(e) * I + o;
      const uint4* r1 = reinterpret_cast<const uint4*>(w1 + row * D);
      const uint4* r3 = reinterpret_cast<const uint4*>(w3 + row * D);
      const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * D);
#pragma unroll 4
      for (int c = lane; c < D / 16; c += 32) {
        float a[16], b[16], xv[16];
        decode_s8x16(__ldg(r1 + c), a);
        decode_s8x16(__ldg(r3 + c), b);
        unpack_bf16x8(__ldg(xr + 2 * c), xv);
        unpack_bf16x8(__ldg(xr + 2 * c + 1), xv + 8);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          g = fmaf(a[i], xv[i], g);
          u = fmaf(b[i], xv[i], u);
        }
      }
    }
    g = warp_sum(g);
    u = warp_sum(u);
    if (lane == 0) {
      float v = 0.f;
      if (valid) {
        const size_t row = static_cast<size_t>(e) * I + o;
        g *= s1[row];
        u *= s3[row];
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
  for (int t = gwarp; t < M * D; t += nwarps) {
    const int m = t / D, d = t % D;
    const int e = idx[m];
    const bool valid = e >= 0 && e < E;
    float acc = 0.f;
    if (valid) {
      const size_t row = static_cast<size_t>(e) * D + d;
      const uint4* r2 = reinterpret_cast<const uint4*>(w2 + row * I);
      const uint4* ar = reinterpret_cast<const uint4*>(act + static_cast<size_t>(m) * I);
#pragma unroll 4
      for (int c = lane; c < I / 16; c += 32) {
        float w[16], av[16];
        decode_s8x16(__ldg(r2 + c), w);
        unpack_bf16x8(__ldcg(ar + 2 * c), av);
        unpack_bf16x8(__ldcg(ar + 2 * c + 1), av + 8);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc = fmaf(w[i], av[i], acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0)
      y[static_cast<size_t>(m) * D + d] = valid ? acc * s2[static_cast<size_t>(e) * D + d] : 0.f;
  }
}

}  // namespace

// x [M, D] bf16, w1 / w3 [E, I, D] and w2 [E, D, I] int8, s1 / s3 [E, I]
// and s2 [E, D] f32, idx [M] int32, act [M, I] bf16 scratch -> y [M, D] f32.
// Needs 1 <= M <= 16, D % 16 == 0, I % 16 == 0 and 16-byte aligned x, act
// and weights; a row whose expert id lies outside [0, E) gives 0. Returns
// the cooperative launch's error (0 = launched), or cudaErrorInvalidValue
// for a shape it does not take.
extern "C" int int8_chain(const void* x, const void* w1, const void* w3,
                          const void* w2, const void* s1, const void* s3,
                          const void* s2, const void* idx, void* act, void* y,
                          int M, int E, int I, int D, float limit, void* stream) {
  if (M < 1 || M > kMaxRows || I < 16 || D < 16 || I % 16 || D % 16)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int8_chain_kernel,
                                                        kWarps * 32, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // as many blocks as fit at once, and no more than the larger phase has
  // warp tasks for
  const long long tasks = static_cast<long long>(M) * (I > D ? I : D);
  const long long need = (tasks + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(need < 1LL * sms * per_sm ? need : 1LL * sms * per_sm);

  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const int8_t* w1p = static_cast<const int8_t*>(w1);
  const int8_t* w3p = static_cast<const int8_t*>(w3);
  const int8_t* w2p = static_cast<const int8_t*>(w2);
  const float* s1p = static_cast<const float*>(s1);
  const float* s3p = static_cast<const float*>(s3);
  const float* s2p = static_cast<const float*>(s2);
  const int* idxp = static_cast<const int*>(idx);
  __nv_bfloat16* actp = static_cast<__nv_bfloat16*>(act);
  float* yp = static_cast<float*>(y);
  void* args[] = {&xp, &w1p, &w3p, &w2p, &s1p, &s3p, &s2p, &idxp, &actp, &yp,
                  &M, &E, &I, &D, &limit};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(int8_chain_kernel),
                                    dim3(blocks), dim3(kWarps * 32), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
