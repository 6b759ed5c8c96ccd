// bf16 weight streams for Hopper (sm_90a): sum(W) + s, y = x · Wᵀ + s, and
// one layer of an [L, N, K] stack, y = x · stack[l]ᵀ.
//
// Replaces the TPU study kernels scripts/gemv_stream_study.py:41
// make_stream_sum and :90 make_gemv, and scripts/gemv_chain_study.py:41
// make_layer_gemv. Same functions: W [N, K] bf16 row-major, products of bf16
// values summed in f32, s a [1] f32 added once; the layer form reads
// stack[l] in place (the stack is never sliced or copied).
//
// What bounds them: bytes. Each reads W once (Qwen3-4B's gate_up, 19456 x
// 2560, is 99.6 MB: 29.7 us at 3.35 TB/s) and does 2 flops a weight, far
// below the card's 295 flops a byte. So the design is about keeping enough
// bytes in flight on every SM, and it exists in two forms, both of which
// the study (pegainfer_tpu_torch/studies/gemv_stream_study.py) times:
//
// - bulk (stream_sum_bulk, gemv_bf16): a persistent grid. Each block walks
//   the chunks c = blockIdx.x, blockIdx.x + gridDim.x, ... of `rows` whole
//   rows through the weight ring of common.cuh (wring::Ring: one producer
//   thread's 1-D bulk copies on full / empty mbarriers, kConsumerWarps
//   consumer warps). For the GEMV, x sits in shared memory once a block and
//   a warp takes a row (wring::rows_gemv); y[row] is written once. The
//   TPU's (ck rows, nbuf) do not carry over: a 256-row chunk at K 2560 is
//   1.3 MB and a block has 227 KB, so the axes here are bytes a stage,
//   stages and blocks an SM.
// - ldg (stream_sum_ldg): no shared memory; each thread keeps U 16-byte
//   ld.global.nc loads in flight (grid-strided), the form of the decode
//   GEMVs K3, K4 and K6, so its rate is their ceiling.
//
// The sum forms leave one f32 partial a block (a fixed-order reduction of
// its threads) and a second launch of one warp adds the partials in a fixed
// order, then s: no float atomics, the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using wring::kConsumers;
using wring::kConsumerWarps;
using wring::kThreads;

constexpr int kLdgThreads = kConsumers;  // block_sum's threads

__host__ inline int x_bytes(bool gemv, int K) { return gemv ? wring::align128(2 * K) : 0; }

__device__ __forceinline__ float sum_bf16x8(const uint4 v) {
  float f[8];
  unpack_bf16x8(v, f);
  return ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
}

__device__ __forceinline__ uint4 ld_nc(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// the values of threads 0 to kConsumers - 1, summed in a fixed order, by
// thread 0; `red` holds a float a warp
__device__ __forceinline__ float block_sum(float v, float* red, int tid) {
  v = warp_sum(v);
  if (tid % 32 == 0) red[tid / 32] = v;
  wring::consumer_sync();
  float t = 0.f;
  if (tid == 0)
    for (int i = 0; i < kConsumerWarps; ++i) t += red[i];
  return t;
}

// kGemv: y[row] = x · W[row] + s for every row (out = y); else each block's
// partial of sum(W) (out = partials[gridDim.x]). W is w + layer · N · K;
// x_bytes is x_bytes(kGemv, K).
template <bool kGemv>
__global__ void __launch_bounds__(kThreads) stream_kernel(
    const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ s, float* __restrict__ out, int N, int K, int layer, int rows,
    int stages, int x_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kConsumerWarps];
  const wring::Ring ring(smem, x_bytes, stages, rows * K * 2);
  const uint4* xs = reinterpret_cast<const uint4*>(ring.x);
  const int nchunks = (N + rows - 1) / rows;
  const int k8 = K / 8;  // 16-byte units of a row
  w += static_cast<size_t>(layer) * N * K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) ring.init();
  if (kGemv) {
    uint4* xw = reinterpret_cast<uint4*>(ring.x);
    for (int i = threadIdx.x; i < k8; i += kThreads) xw[i] = reinterpret_cast<const uint4*>(x)[i];
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp: one thread issues every copy
    if (lane == 0) {
      int j = 0;
      for (int c = blockIdx.x; c < nchunks; c += gridDim.x, ++j)
        ring.produce(j, w + static_cast<size_t>(c) * rows * K, wring::chunk_bytes(c, rows, N, K));
    }
    return;
  }

  const float sv = (kGemv && s != nullptr) ? s[0] : 0.f;
  float acc = 0.f;
  int j = 0;
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x, ++j) {
    const uint4* chunk = ring.acquire(j);
    const int r = min(rows, N - c * rows);
    if (kGemv) {
      wring::rows_gemv(chunk, r, k8, xs, sv, out + static_cast<size_t>(c) * rows, warp, lane);
    } else {
      for (int i = threadIdx.x; i < r * k8; i += kConsumers) acc += sum_bf16x8(chunk[i]);
    }
    ring.release(j, lane);
  }
  if (!kGemv) {
    const float t = block_sum(acc, red, threadIdx.x);
    if (threadIdx.x == 0) out[blockIdx.x] = t;
  }
}

// each block's partial of the sum of n4 16-byte units, U loads in flight a thread
template <int U>
__global__ void __launch_bounds__(kLdgThreads) ldg_sum_kernel(const uint4* __restrict__ w,
                                                              long long n4,
                                                              float* __restrict__ partials) {
  __shared__ float red[kConsumerWarps];
  const long long stride = static_cast<long long>(gridDim.x) * kLdgThreads;
  float acc = 0.f;
  for (long long i0 = static_cast<long long>(blockIdx.x) * kLdgThreads + threadIdx.x; i0 < n4;
       i0 += stride * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = i0 + u * stride;
      v[u] = i < n4 ? ld_nc(w + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc += sum_bf16x8(v[u]);
  }
  const float t = block_sum(acc, red, threadIdx.x);
  if (threadIdx.x == 0) partials[blockIdx.x] = t;
}

// out[0] = the n partials, summed in a fixed order, + s[0]
__global__ void __launch_bounds__(32) sum_partials_kernel(const float* __restrict__ partials,
                                                          int n, const float* __restrict__ s,
                                                          float* __restrict__ out) {
  float a = 0.f;
  for (int i = threadIdx.x; i < n; i += 32) a += partials[i];
  a = warp_sum(a);
  if (threadIdx.x == 0) out[0] = a + s[0];
}

template <bool kGemv>
int launch_stream(const void* w, const void* x, const void* s, float* out, int N, int K,
                  int layer, int rows, int stages, int blocks, cudaStream_t stream) {
  static bool allowed[wring::kMaxDevices] = {};
  cudaError_t err =
      wring::allow_max_smem(reinterpret_cast<const void*>(stream_kernel<kGemv>), allowed);
  if (err != cudaSuccess) return err;
  const int xb = x_bytes(kGemv, K);
  stream_kernel<kGemv><<<blocks, kThreads, wring::smem_bytes(xb, rows * K * 2, stages), stream>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(s), out, N, K, layer, rows, stages, xb);
  return cudaGetLastError();
}

bool bad_ring(int N, int K, int rows, int stages, int blocks, bool gemv) {
  return N < 1 || blocks < 1 || wring::bad_ring(K, rows, stages, x_bytes(gemv, K));
}

}  // namespace

// sum(W) + s[0] -> out[0], W [N, K] bf16 (16-byte aligned, K % 8 == 0)
// through the bulk ring: `blocks` blocks, `rows` rows a stage, `stages`
// stages; partials: `blocks` f32 of scratch. Returns the first launch
// error (0 = launched), or cudaErrorInvalidValue for a shape it does not
// take (shared memory above 227 KB included).
extern "C" int stream_sum_bulk(const void* w, const void* s, void* partials, void* out, int N,
                               int K, int rows, int stages, int blocks, void* stream) {
  if (bad_ring(N, K, rows, stages, blocks, false)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  int err = launch_stream<false>(w, nullptr, nullptr, part, N, K, 0, rows, stages, blocks, st);
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, 32, 0, st>>>(part, blocks, static_cast<const float*>(s),
                                        static_cast<float*>(out));
  return cudaGetLastError();
}

// the same through ld.global.nc: n4 16-byte units of W, `unroll` (1, 2, 4
// or 8) loads in flight a thread, `blocks` blocks of 256 threads
extern "C" int stream_sum_ldg(const void* w, const void* s, void* partials, void* out,
                              long long n4, int unroll, int blocks, void* stream) {
  if (n4 < 1 || blocks < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const uint4* wp = static_cast<const uint4*>(w);
  float* part = static_cast<float*>(partials);
  switch (unroll) {
    case 1: ldg_sum_kernel<1><<<blocks, kLdgThreads, 0, st>>>(wp, n4, part); break;
    case 2: ldg_sum_kernel<2><<<blocks, kLdgThreads, 0, st>>>(wp, n4, part); break;
    case 4: ldg_sum_kernel<4><<<blocks, kLdgThreads, 0, st>>>(wp, n4, part); break;
    case 8: ldg_sum_kernel<8><<<blocks, kLdgThreads, 0, st>>>(wp, n4, part); break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, 32, 0, st>>>(part, blocks, static_cast<const float*>(s),
                                        static_cast<float*>(out));
  return cudaGetLastError();
}

// y [N] f32 = x [K] bf16 · W[layer]ᵀ + (s ? s[0] : 0), W[layer] the
// layer-th [N, K] block of w (16-byte aligned x and w, K % 8 == 0); every
// y element written once. Ring as stream_sum_bulk.
extern "C" int gemv_bf16(const void* x, const void* w, const void* s, void* y, int N, int K,
                         int layer, int rows, int stages, int blocks, void* stream) {
  if (bad_ring(N, K, rows, stages, blocks, true) || layer < 0) return cudaErrorInvalidValue;
  return launch_stream<true>(w, x, s, static_cast<float*>(y), N, K, layer, rows, stages, blocks,
                             static_cast<cudaStream_t>(stream));
}
