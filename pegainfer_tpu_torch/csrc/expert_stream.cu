// int8 expert GEMV study kernels for Hopper (sm_90a):
// y[m, o] = Σ_d q[idx[m], o, d] · x[m, d].
//
// Replace the TPU study kernels scripts/expert_stream_study.py:123 run_auto
// (pallas_call :148) and :155 run_all_in_flight (:185). Same function: q
// [E, OUT, D] int8 codes, idx [M] int32, y f32 [M, OUT]; each routed row
// streams its own expert (no dedupe, as the TPU grid does; K6,
// csrc/int8_gemv.cu, is the production form that dedupes). A row whose
// expert id lies outside [0, E) gives 0.
//
// - expert_gemv, convert form (run_auto native=False, "production form"):
//   x bf16; each code becomes an exact float by K6's byte permute
//   (common.cuh s8_at), each product of a code and a bf16 x is exact in
//   f32, sums in f32.
// - expert_gemv, native form (run_auto native=True, "w8a8 form"): x int8;
//   __dp4a sums 4 int8 × int8 products at a time into an int32, exact
//   (|Σ| ≤ D · 127², below 2^31 for D ≤ 133,144), and the sum is rounded to
//   f32 once, to nearest even, as the TPU's astype(float32) rounds it.
//
//   A block takes one routed row m (blockIdx.y) and kRows output rows
//   (blockIdx.x), the TPU's grid (I/TO, M) with kRows for TO; kRows ∈
//   {16, 32, 64}. x[m] sits in shared memory (bf16 with its 16-byte units
//   XOR-swizzled as in K6, or int8); each of 8 warps walks kRows/8 weight
//   rows, a lane 16 codes a load, 4 loads in flight, a warp shuffle ends
//   each row.
// - expert_gemv_in_flight (run_all_in_flight), convert form: the TPU tile
//   of M × 128 rows × D codes (6.3 MB at M 12, D 4096) does not fit a
//   block's 227 KB, so a block owns T output rows with M·T·D ≤ 200 KB (T 4
//   at D 4096 and M 12: 196,608 B, one block an SM). One thread issues
//   every one of the block's M·T row copies (1-D bulk copies, D bytes
//   each) before any thread waits, on one mbarrier an m, the counterpart of
//   the TPU's per-m DMA semaphores; then for m in order the block waits on
//   m's barrier, converts and dots (a warp takes one of the T rows and
//   1/(8/T) of its D, partial sums meet in shared memory in a fixed order).
//   With kCopiesOnly (a probe, the TPU study's "dma-only, same blocks, no
//   compute" row; a template parameter, so that the real form's code is
//   its own) the block waits on every barrier and computes nothing: y is 0.
//
// What bounds them: bytes. M·OUT·D code bytes (100.7 MB at M 12, OUT 2048,
// D 4096: 30.05 µs at 3.35 TB/s) and 2·M·OUT·D operations, far below the
// card's rate; the study (pegainfer_tpu_torch/studies/
// expert_stream_study.py) asks whether the convert or the bytes in flight
// hold them below that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// the convert form's x: 2 units (32 B) per 16 codes, swizzled as K6's
__device__ __forceinline__ int swz(int u) { return u ^ ((u >> 3) & 1); }

// acc + the 16 products of 16 codes and 16 bf16 x (2 units of 8)
__device__ __forceinline__ float dot_s8x16_bf16(const uint4 raw, const uint4 x0, const uint4 x1,
                                                float acc) {
  float w[16], xv[8];
  decode_s8x16(raw, w);
  unpack_bf16x8(x0, xv);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = fmaf(w[i], xv[i], acc);
  unpack_bf16x8(x1, xv);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = fmaf(w[8 + i], xv[i], acc);
  return acc;
}

__device__ __forceinline__ int dp4a_x16(const uint4 w, const uint4 x, int acc) {
  acc = __dp4a(static_cast<int>(w.x), static_cast<int>(x.x), acc);
  acc = __dp4a(static_cast<int>(w.y), static_cast<int>(x.y), acc);
  acc = __dp4a(static_cast<int>(w.z), static_cast<int>(x.z), acc);
  return __dp4a(static_cast<int>(w.w), static_cast<int>(x.w), acc);
}

template <bool kNative, int kRows>
__global__ void __launch_bounds__(kThreads)
expert_gemv_kernel(const void* __restrict__ x, const int8_t* __restrict__ q,
                   const int* __restrict__ idx, float* __restrict__ y, int E, int OUT, int D) {
  extern __shared__ uint4 xs[];  // x[m]: D/16 units of int8, or D/8 swizzled units of bf16
  const int m = blockIdx.y;
  const int e = idx[m];
  const int o_begin = static_cast<int>(blockIdx.x) * kRows;
  const int o_end = min(OUT, o_begin + kRows);
  float* yrow = y + static_cast<size_t>(m) * OUT;
  if (e < 0 || e >= E) {
    for (int o = o_begin + static_cast<int>(threadIdx.x); o < o_end; o += kThreads) yrow[o] = 0.f;
    return;
  }
  const int chunks = D / 16;
  const int units = kNative ? chunks : 2 * chunks;
  const uint4* xrow = reinterpret_cast<const uint4*>(
      static_cast<const unsigned char*>(x) + static_cast<size_t>(m) * D * (kNative ? 1 : 2));
  for (int u = threadIdx.x; u < units; u += kThreads) xs[kNative ? u : swz(u)] = xrow[u];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int o = o_begin + warp; o < o_end; o += kWarps) {
    const uint4* qrow = reinterpret_cast<const uint4*>(q + (static_cast<size_t>(e) * OUT + o) * D);
    float v;
    if constexpr (kNative) {
      int acc = 0;
#pragma unroll 4
      for (int c = lane; c < chunks; c += 32) acc = dp4a_x16(__ldg(qrow + c), xs[c], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      v = __int2float_rn(acc);
    } else {
      float acc = 0.f;
#pragma unroll 4
      for (int c = lane; c < chunks; c += 32)
        acc = dot_s8x16_bf16(__ldg(qrow + c), xs[swz(2 * c)], xs[swz(2 * c + 1)], acc);
      v = warp_sum(acc);
    }
    if (lane == 0) yrow[o] = v;
  }
}

// shared memory of the in-flight form: codes [M][T][D], then M mbarriers,
// then the warps' partial sums [M][T][8/T]
__host__ __device__ inline size_t in_flight_smem(int M, int T, int D) {
  return static_cast<size_t>(M) * T * D + 8 * static_cast<size_t>(M) + 4 * M * kWarps;
}

template <bool kCopiesOnly>
__global__ void __launch_bounds__(kThreads)
expert_gemv_in_flight_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                             const int* __restrict__ idx, float* __restrict__ y, int M, int E,
                             int OUT, int D, int T) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* codes = smem;
  const uint32_t bars = smem_u32(smem + static_cast<size_t>(M) * T * D);
  float* part = reinterpret_cast<float*>(smem + static_cast<size_t>(M) * T * D + 8 * M);
  const int o0 = static_cast<int>(blockIdx.x) * T;
  const int rows = min(T, OUT - o0);
  const int parts = kWarps / T;
  if (threadIdx.x == 0) {
    for (int m = 0; m < M; ++m) mbar_init(bars + 8 * m, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // every copy in flight before the first wait
    for (int m = 0; m < M; ++m) {
      const int e = idx[m];
      if (e < 0 || e >= E) continue;
      mbar_expect_tx(bars + 8 * m, static_cast<uint32_t>(rows) * D);
      for (int t = 0; t < rows; ++t)
        bulk_copy_g2s(smem_u32(codes + (static_cast<size_t>(m) * T + t) * D),
                      q + (static_cast<size_t>(e) * OUT + o0 + t) * D, D, bars + 8 * m);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp % T, p = warp / T;
  const int span = D / parts;  // the bytes of a row a warp takes
  for (int m = 0; m < M; ++m) {
    const int e = idx[m];
    float acc = 0.f;
    if (e >= 0 && e < E) {
      mbar_wait(bars + 8 * m, 0);
      if (r < rows && !kCopiesOnly) {
        const uint4* w = reinterpret_cast<const uint4*>(
            codes + (static_cast<size_t>(m) * T + r) * D + static_cast<size_t>(p) * span);
        const uint4* xr = reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(m) * D + static_cast<size_t>(p) * span);
#pragma unroll 4
        for (int c = lane; c < span / 16; c += 32)
          acc = dot_s8x16_bf16(w[c], __ldg(xr + 2 * c), __ldg(xr + 2 * c + 1), acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) part[(m * T + r) * parts + p] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * rows; i += kThreads) {
    const int m = i / rows, rr = i % rows;
    float v = 0.f;
    for (int pp = 0; pp < parts; ++pp) v += part[(m * T + rr) * parts + pp];
    y[static_cast<size_t>(m) * OUT + o0 + rr] = v;
  }
}

template <bool kNative, int kRows>
cudaError_t launch_gemv(const void* x, const void* q, const void* idx, void* y, int M, int E,
                        int OUT, int D, cudaStream_t stream) {
  static bool allowed[wring::kMaxDevices];
  const cudaError_t err = wring::allow_max_smem(
      reinterpret_cast<const void*>(expert_gemv_kernel<kNative, kRows>), allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((OUT + kRows - 1) / kRows, M);
  expert_gemv_kernel<kNative, kRows><<<grid, kThreads, kNative ? D : 2 * D, stream>>>(
      x, static_cast<const int8_t*>(q), static_cast<const int*>(idx), static_cast<float*>(y), E,
      OUT, D);
  return cudaGetLastError();
}

template <bool kCopiesOnly>
cudaError_t launch_in_flight(const void* x, const void* q, const void* idx, void* y, int M, int E,
                             int OUT, int D, int T, cudaStream_t stream) {
  static bool allowed[wring::kMaxDevices];
  const cudaError_t err = wring::allow_max_smem(
      reinterpret_cast<const void*>(expert_gemv_in_flight_kernel<kCopiesOnly>), allowed);
  if (err != cudaSuccess) return err;
  expert_gemv_in_flight_kernel<kCopiesOnly><<<(OUT + T - 1) / T, kThreads,
                                              in_flight_smem(M, T, D), stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const int*>(idx), static_cast<float*>(y), M, E, OUT, D, T);
  return cudaGetLastError();
}

}  // namespace

// x [M, D] (bf16, or int8 when native), q [E, OUT, D] int8, idx [M] int32
// -> y [M, OUT] f32. rows ∈ {16, 32, 64} output rows a block. Needs D % 16
// == 0 (and D ≤ 133,144 when native) and 16-byte aligned x and q. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int expert_gemv(const void* x, const void* q, const void* idx, void* y, int M, int E,
                           int OUT, int D, int native, int rows, void* stream) {
  if (M < 1 || OUT < 1 || D < 16 || D % 16 || (native && D > 133144))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (native) {
    if (rows == 16) return launch_gemv<true, 16>(x, q, idx, y, M, E, OUT, D, s);
    if (rows == 32) return launch_gemv<true, 32>(x, q, idx, y, M, E, OUT, D, s);
    if (rows == 64) return launch_gemv<true, 64>(x, q, idx, y, M, E, OUT, D, s);
  } else {
    if (rows == 16) return launch_gemv<false, 16>(x, q, idx, y, M, E, OUT, D, s);
    if (rows == 32) return launch_gemv<false, 32>(x, q, idx, y, M, E, OUT, D, s);
    if (rows == 64) return launch_gemv<false, 64>(x, q, idx, y, M, E, OUT, D, s);
  }
  return cudaErrorInvalidValue;
}

// x [M, D] bf16, q [E, OUT, D] int8, idx [M] int32 -> y [M, OUT] f32, T ∈
// {1, 2, 4, 8} output rows a block (the caller picks the largest with
// M·T·D ≤ 200 KB). Needs D % (16 · 8/T) == 0, 16-byte aligned x and q, and
// the block's shared memory within 227 KB; copies_only: the probe above.
// Returns as expert_gemv does.
extern "C" int expert_gemv_in_flight(const void* x, const void* q, const void* idx, void* y,
                                     int M, int E, int OUT, int D, int T, int copies_only,
                                     void* stream) {
  if (M < 1 || OUT < 1 || D < 16 || (T != 1 && T != 2 && T != 4 && T != 8) ||
      D % (16 * (kWarps / T)) || in_flight_smem(M, T, D) > static_cast<size_t>(wring::kMaxSmem))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return copies_only ? launch_in_flight<true>(x, q, idx, y, M, E, OUT, D, T, s)
                     : launch_in_flight<false>(x, q, idx, y, M, E, OUT, D, T, s);
}

// Blocks of one form that fit an SM at once (form 0 convert, 1 native, 2 in
// flight; rows as above, or T for form 2), into *out; for the study's
// bytes in flight.
extern "C" int expert_stream_blocks_per_sm(int form, int rows, int M, int D, int* out) {
  const void* k = nullptr;
  size_t smem = form == 1 ? D : 2 * static_cast<size_t>(D);
  if (form == 0) {
    k = rows == 16   ? reinterpret_cast<const void*>(expert_gemv_kernel<false, 16>)
        : rows == 32 ? reinterpret_cast<const void*>(expert_gemv_kernel<false, 32>)
                     : reinterpret_cast<const void*>(expert_gemv_kernel<false, 64>);
  } else if (form == 1) {
    k = rows == 16   ? reinterpret_cast<const void*>(expert_gemv_kernel<true, 16>)
        : rows == 32 ? reinterpret_cast<const void*>(expert_gemv_kernel<true, 32>)
                     : reinterpret_cast<const void*>(expert_gemv_kernel<true, 64>);
  } else {
    k = reinterpret_cast<const void*>(expert_gemv_in_flight_kernel<false>);
    smem = in_flight_smem(M, rows, D);
    const cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 wring::kMaxSmem);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, kThreads, smem);
}
