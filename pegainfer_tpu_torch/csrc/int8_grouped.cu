// int8 grouped expert GEMM for prefill MoE on Hopper (sm_90a), unscaled.
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/fp4_gemm.py, function
// moe_int8_grouped (body _int8_gemm_kernel; segments from tile_segments).
// Same function and numerics: x_sorted [Mp, IN] bf16, rows sorted by expert
// and cut into tiles of tm rows; each tile lists its expert segments
// (seg_expert, seg_lo, seg_hi: rows [lo, hi) of the tile use that expert,
// n_seg of them). y[r] = x_sorted[r] · q[e(r)]ᵀ as f32 [Mp, OUT], with q
// [E, OUT, IN] int8 codes (the int8-experts mode); the caller applies the
// per-output-channel scales. Each code is an exact bf16 value, products are
// bf16 × bf16 with f32 accumulation (tensor cores), rows of no segment give
// 0. Exact at any routing skew: segments come from the true group sizes,
// with no capacity factor. The TPU kernel's manual double-buffered DMA of
// whole [TO, IN] weight slabs is not carried over.
//
// What bounds it: bytes. At 1,024 prompt tokens (6,144 routed rows over 256
// experts) every expert is hit, so one call streams the whole int8 stack:
// 2.15 GB for w1 (OUT 2048, IN 4096), 641 µs at 3.35 TB/s, against 103
// GFLOP (104 µs at the bf16 tensor-core peak).
//
// Design: K5's (csrc/fp4_grouped.cu) with the fp4 decode replaced by a
// conversion. One block per (row tile, 64-wide output tile), 8 warps; warp
// w owns rows [16w, 16w + 16) of the tile and four 16 × 16 f32 accumulator
// fragments. For each segment of the tile and each 64-wide step of IN, the
// block converts the expert's 64 × 64 int8 weight tile to bf16 in shared
// memory (each thread one 16-byte load of 16 codes, turned into floats by a
// byte permute and a subtraction, then packed to bf16 exactly) and loads
// the x rows of the segment, zero outside [lo, hi); only the warps whose
// 16-row strip meets the segment run the wmma products (bf16 16 × 16 × 16).
// Segments cover disjoint rows, so their masked products add into the same
// accumulators. The output goes through a small shared staging tile, so a
// tile whose tm is not a multiple of 16 never writes the next tile's rows.
// Single-buffered: a pipelined ring and wgmma are work for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kTileRows = 128;  // largest tm
constexpr int kTileOut = 64;
constexpr int kStepK = 64;
constexpr int kLd = kStepK + 8;  // padded shared row (bf16 elements)

__global__ void __launch_bounds__(kWarps * 32)
int8_grouped_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ q,
                    const int* __restrict__ seg_expert,
                    const int* __restrict__ seg_lo,
                    const int* __restrict__ seg_hi,
                    const int* __restrict__ n_seg, float* __restrict__ y, int E,
                    int OUT, int IN, int tm) {
  __shared__ __align__(128) __nv_bfloat16 xs[kTileRows * kLd];
  __shared__ __align__(128) __nv_bfloat16 ws[kTileOut * kLd];
  __shared__ __align__(128) float cst[kWarps * 16 * 16];

  const int o0 = blockIdx.x * kTileOut;
  const int t = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row0 = static_cast<size_t>(t) * tm;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);

  const int nseg = n_seg[t];
  for (int i = 0; i < nseg; ++i) {
    const int e = seg_expert[t * tm + i];
    const int lo = seg_lo[t * tm + i], hi = seg_hi[t * tm + i];
    if (e < 0 || e >= E || lo >= hi) continue;  // uniform across the block
    const int strip_lo = lo / 16, strip_hi = (hi + 15) / 16;
    const bool active = warp >= strip_lo && warp < strip_hi;
    // this thread's weight slice: row wr of the tile, 16 values at 16·wp
    const int wr = tid / 4, wp = tid % 4;
    const size_t wrow = static_cast<size_t>(e) * OUT + o0 + wr;
    const int8_t* qrow = q + wrow * IN;

    for (int k0 = 0; k0 < IN; k0 += kStepK) {
      __syncthreads();  // the previous step's products are done with xs/ws
      // x rows of the segment (zero elsewhere in its strips), 16 B per thread
      const int n_units = (strip_hi - strip_lo) * 16 * (kStepK / 8);
      for (int u = tid; u < n_units; u += kWarps * 32) {
        const int r = strip_lo * 16 + u / (kStepK / 8), part = u % (kStepK / 8);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r >= lo && r < hi)
          v = __ldg(reinterpret_cast<const uint4*>(x + (row0 + r) * IN + k0) + part);
        *reinterpret_cast<uint4*>(xs + r * kLd + part * 8) = v;
      }
      // the expert's weight tile, converted to bf16: [64 out][64 k]
      {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(qrow + k0 + wp * 16));
        const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t packed[8];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          packed[2 * h] = pack_bf16x2(s8_at(wd[h], 0), s8_at(wd[h], 1));
          packed[2 * h + 1] = pack_bf16x2(s8_at(wd[h], 2), s8_at(wd[h], 3));
        }
        uint4* dst = reinterpret_cast<uint4*>(ws + wr * kLd + wp * 16);
        dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int kk = 0; kk < kStepK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, xs + warp * 16 * kLd + kk, kLd);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
            wmma::load_matrix_sync(fb, ws + n * 16 * kLd + kk, kLd);
            wmma::mma_sync(acc[n], fa, fb, acc[n]);
          }
        }
      }
    }
  }

  // write the strip's valid rows (rows < tm) through the staging tile
  if (warp * 16 >= tm) return;
  float* c = cst + warp * 256;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::store_matrix_sync(c, acc[n], 16, wmma::mem_row_major);
    __syncwarp();
    for (int j = lane; j < 256; j += 32) {
      const int r = warp * 16 + j / 16, col = o0 + n * 16 + j % 16;
      if (r < tm) y[(row0 + r) * OUT + col] = c[j];
    }
    __syncwarp();
  }
}

}  // namespace

// x_sorted [Mp, IN] bf16, q [E, OUT, IN] int8, seg_expert / seg_lo / seg_hi
// [Mp/tm, tm] int32, n_seg [Mp/tm] int32 -> y [Mp, OUT] f32, unscaled.
// Needs tm % 8 == 0, tm <= 128, OUT % 64 == 0 and IN % 64 == 0. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int int8_grouped(const void* x, const void* q, const void* seg_expert,
                            const void* seg_lo, const void* seg_hi, const void* n_seg,
                            void* y, int Mp, int E, int OUT, int IN, int tm,
                            void* stream) {
  if (tm < 8 || tm > kTileRows || tm % 8 || Mp % tm || OUT % kTileOut || IN % kStepK)
    return cudaErrorInvalidValue;
  const dim3 grid(OUT / kTileOut, Mp / tm);
  int8_grouped_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const int*>(seg_expert), static_cast<const int*>(seg_lo),
      static_cast<const int*>(seg_hi), static_cast<const int*>(n_seg),
      static_cast<float*>(y), E, OUT, IN, tm);
  return cudaGetLastError();
}
