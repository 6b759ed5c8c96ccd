// A chain of L dependent bf16 GEMVs in one persistent kernel, for Hopper
// (sm_90a): y_l = x_l · stack[l]ᵀ, x_{l+1} = bf16(y_l[:K]), the last y out.
//
// Replaces the TPU study kernel scripts/gemv_chain_study.py:96 make_mega.
// Same function: stack [L, N, K] bf16 (N >= K), x [K] bf16, products of
// bf16 values summed in f32, each next input rounded to bf16 (nearest
// even, as `.astype(bfloat16)`), y_{L-1} [N] f32.
//
// What bounds it: bytes. It reads the stack once (36 layers of Qwen3-4B's
// gate_up, 19456 x 2560, are 3.59 GB: 1.07 ms at 3.35 TB/s). What it adds
// to one GEMV (csrc/gemv_stream.cu) is the layer boundary: layer l+1 needs
// all of y_l, so every block must wait for every other. The study asks
// what that wait costs against launches and CUDA graphs
// (pegainfer_tpu_torch/studies/gemv_chain_study.py). The design keeps the
// weight stream going through it:
//
// - One cooperative launch, as many blocks as the occupancy query allows
//   (at most the chunks of a layer). Each block walks a flat sequence of
//   (layer, chunk) items, chunks c = blockIdx.x, blockIdx.x + gridDim.x,
//   ... of `rows` whole rows in every layer, through the weight ring of
//   common.cuh, as gemv_stream.cu does (wring::Ring: one producer thread's
//   1-D bulk copies on mbarriers, kConsumerWarps consumer warps, a warp a
//   row).
// - The producer runs ahead over that flat sequence and never waits for
//   the grid: weights do not depend on x, so the copies of layer l+1's
//   first chunks are in flight while the consumers wait at the boundary,
//   and the pipeline does not drain.
// - At the boundary the consumer warps alone meet in a grid barrier (the
//   producer may be blocked on a full ring, so cooperative_groups' sync,
//   which needs every thread, would deadlock); then each block restages
//   x_{l+1} = bf16(y_l[:K]) into its shared memory, reading y through L2.
// - y is double-buffered in global scratch [2, N] (the last layer writes
//   y itself): a block writes y_{l+1} only after the barrier that follows
//   every block's restage from y_{l-1}, the buffer it overwrites.
//
// The grid barrier counts arrivals on one word, as cooperative_groups does:
// block 0 adds 2^31 - (G - 1), the others 1, so bit 31 flips when all G
// have arrived and the low bits return to 0; the word must start with its
// low 31 bits 0 (the wrapper zeroes it each call).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using wring::kConsumers;
using wring::kConsumerWarps;
using wring::kThreads;

// every block's consumers meet here; what they wrote before it is visible
// to every block after it
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  wring::consumer_sync();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    for (uint32_t n = 0; ((old ^ *reinterpret_cast<volatile unsigned*>(bar)) & 0x80000000u) == 0;
         ++n)
      if (n == (1u << 24)) __trap();  // a block that never arrives fails the launch
    __threadfence();
  }
  wring::consumer_sync();
}

__global__ void __launch_bounds__(kThreads, 1) gemv_chain_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ stack,
    float* __restrict__ ybuf, float* __restrict__ y, unsigned* __restrict__ bar, int L, int N,
    int K, int rows, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const wring::Ring ring(smem, wring::align128(2 * K), stages, rows * K * 2);
  uint4* xs = reinterpret_cast<uint4*>(ring.x);
  __nv_bfloat16* xh = reinterpret_cast<__nv_bfloat16*>(ring.x);
  const int nchunks = (N + rows - 1) / rows;
  const int k8 = K / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) ring.init();
  for (int i = threadIdx.x; i < k8; i += kThreads) xs[i] = reinterpret_cast<const uint4*>(x)[i];
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer: every layer's chunks, never waiting for the grid
    if (lane == 0) {
      int j = 0;
      for (int l = 0; l < L; ++l) {
        const __nv_bfloat16* w = stack + static_cast<size_t>(l) * N * K;
        for (int c = blockIdx.x; c < nchunks; c += gridDim.x, ++j)
          ring.produce(j, w + static_cast<size_t>(c) * rows * K, wring::chunk_bytes(c, rows, N, K));
      }
    }
    return;
  }

  int j = 0;
  for (int l = 0; l < L; ++l) {
    float* yl = l == L - 1 ? y : ybuf + static_cast<size_t>(l & 1) * N;
    for (int c = blockIdx.x; c < nchunks; c += gridDim.x, ++j) {
      const uint4* chunk = ring.acquire(j);
      const int r = min(rows, N - c * rows);
      wring::rows_gemv(chunk, r, k8, xs, 0.f, yl + static_cast<size_t>(c) * rows, warp, lane);
      ring.release(j, lane);
    }
    if (l + 1 < L) {
      grid_barrier(bar);  // all of y_l is written
      for (int i = threadIdx.x; i < K; i += kConsumers) xh[i] = __float2bfloat16_rn(__ldcg(yl + i));
      wring::consumer_sync();  // x_{l+1} is whole before any warp reads it
    }
  }
}

}  // namespace

// y [N] f32 = the last of L dependent GEMVs over stack [L, N, K] bf16 from
// x [K] bf16; ybuf: [2, N] f32 scratch; bar: one 32-bit word whose low 31
// bits are 0. Needs N >= K, K % 8 == 0, 16-byte aligned x and stack, and
// shared memory for `stages` chunks of `rows` rows. Returns the cooperative
// launch's error (0 = launched), or cudaErrorInvalidValue for a shape it
// does not take.
extern "C" int gemv_chain(const void* x, const void* stack, void* ybuf, void* y, void* bar,
                          int L, int N, int K, int rows, int stages, void* stream) {
  const int xb = wring::align128(2 * K);
  if (L < 1 || N < K || wring::bad_ring(K, rows, stages, xb)) return cudaErrorInvalidValue;
  const size_t smem = wring::smem_bytes(xb, rows * K * 2, stages);
  static bool allowed[wring::kMaxDevices] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      wring::allow_max_smem(reinterpret_cast<const void*>(gemv_chain_kernel), allowed);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemv_chain_kernel, kThreads,
                                                        smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int nchunks = (N + rows - 1) / rows;
  const int blocks = nchunks < sms * per_sm ? nchunks : sms * per_sm;

  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* sp = static_cast<const __nv_bfloat16*>(stack);
  float* bp = static_cast<float*>(ybuf);
  float* yp = static_cast<float*>(y);
  unsigned* barp = static_cast<unsigned*>(bar);
  void* args[] = {&xp, &sp, &bp, &yp, &barp, &L, &N, &K, &rows, &stages};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gemv_chain_kernel),
                                    dim3(blocks), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
