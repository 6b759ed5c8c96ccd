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
// Design (the second; what held the first is in PERF.md):
// - The work is cut from the shapes alone (ops/cuda/fp8_gemv.py::plan):
//   a block takes rt tiles of 8 · R rows (R = 1 or 2) and ks K parts of
//   them, a warp a (tile, K part). K parts are whole units of `unit`
//   columns, the scale block when it is a multiple of 64 (else the whole
//   row). Tiles of 16 rows keep twice the bytes in flight a thread; tiles
//   of 8 put a linear of few rows on twice the SMs.
// - A thread keeps kUnroll × R weight loads of 16 bytes in flight (rows g
//   and g + 8 of its tile), with its x and scales, before it decodes any.
// - A thread's 16 codes of a row lie under one scale; the scale's column
//   advances by a compare a 64 columns, with no division in the loop.
// - The products go to the tensor cores: mma.sync m16n8k16 bf16, A the
//   tile's rows decoded in registers (the hardware e4m3x2 -> f16x2
//   conversion, f32 times the scale, rounded once to bf16: bf16(f32(code) ·
//   scale) exactly; rows 8-15 zero in a tile of 8), B the M rows of x (n =
//   8, rows from M on zero), f32 sums. Within each 64-column chunk the k
//   order is permuted alike in A and B, so that a thread's 16 codes of a row
//   and its 16 values of x are each one contiguous load: mma step st takes
//   columns 16 t + 4 st + {0, 1} as k = 2 t, 2 t + 1 and + {2, 3} as k =
//   2 t + 8, 2 t + 9 (t = lane % 4). A chunk's 4 steps sum into fresh
//   registers, added to the thread's f32 sums after the chunk.
// - A block's K parts meet in a fixed order through shared memory. No
//   atomics and no memory beyond the call's y: the same bits on every run,
//   and nothing kept from one call to the next. (Splitting K across the
//   blocks of a thread-block cluster cost more than it saved: PERF.md.)

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxRows = 8;     // rows of x: the mma's n
constexpr int kMaxWarps = 16;   // warps of a block: rt × ks
constexpr int kMaxTileRows = 16;  // the mma's m
constexpr int kChunk = 64;      // columns a quad of lanes covers: 4 × 16 codes
constexpr int kUnroll = 4;      // chunks a thread loads before it decodes

// 16 codes of one row, read once: not kept in L1, and L2 asked to fetch the
// 256 bytes around them, which the same lanes read next
__device__ __forceinline__ uint4 ld_codes(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// codes 2h and 2h + 1 of a 4-code word, each times sc and rounded once to
// bf16 from the exact f32 product: one bf16 pair (code 2h low)
__device__ __forceinline__ uint32_t e4m3x2_scaled(uint32_t w, int h, float sc) {
  const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> (16 * h)), __NV_E4M3);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&hr));
  return pack_bf16x2(f.x * sc, f.y * sc);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// R: 8-row halves of a tile (rows g and g + 8 of the mma's A)
template <int R>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
fp8_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                const __nv_bfloat16* __restrict__ s, float* __restrict__ y, int M, int OUT,
                int IN, int ro, int ri, int Si, int rt, int ks, int unit) {
  constexpr int kTileRows = 8 * R;
  __shared__ float red[kMaxWarps][kMaxTileRows][kMaxRows];  // each warp's sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warp's tile and K part [k0, k1): part kp of ks, whole units
  const int tile = blockIdx.x * rt + warp % rt;
  const int kp = warp / rt, nu = IN / unit;
  const int k0 = kp * nu / ks * unit, k1 = (kp + 1) * nu / ks * unit;
  const int r0 = tile * kTileRows + g, r1 = r0 + 8;  // r1 in a tile of 16 only
  const bool v0 = r0 < OUT, v1 = R > 1 && r1 < OUT, vx = g < M;
  const uint8_t* q0 = q + static_cast<size_t>(v0 ? r0 : 0) * IN;
  const uint8_t* q1 = q + static_cast<size_t>(v1 ? r1 : 0) * IN;
  const __nv_bfloat16* s0 = s + static_cast<size_t>((v0 ? r0 : 0) / ro) * Si;
  const __nv_bfloat16* s1 = s + static_cast<size_t>((v1 ? r1 : 0) / ro) * Si;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(vx ? g : 0) * IN);
  // the scale column of the thread's first 16 codes, and their offset in it
  int j = (k0 + 16 * t) / ri, off = (k0 + 16 * t) - j * ri;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // rows g, g + 8 × x rows 2t, 2t + 1

  for (int base = k0; base < k1; base += kUnroll * kChunk) {
    uint4 w0[kUnroll], w1[kUnroll], xa[kUnroll], xb[kUnroll];
    float sc0[kUnroll], sc1[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * kChunk + 16 * t;
      const bool in = c < k1;
      w0[u] = in && v0 ? ld_codes(q0 + c) : zero;
      w1[u] = in && v1 ? ld_codes(q1 + c) : zero;
      xa[u] = in && vx ? __ldg(xr + c / 8) : zero;
      xb[u] = in && vx ? __ldg(xr + c / 8 + 1) : zero;
      sc0[u] = in ? __bfloat162float(s0[j]) : 0.f;
      sc1[u] = R > 1 && in ? __bfloat162float(s1[j]) : 0.f;
      for (off += kChunk; off >= ri; off -= ri) ++j;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kChunk >= k1) break;  // the same for the whole warp
      float c4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const uint32_t a0 = word(w0[u], st), a1 = word(w1[u], st);
        const uint32_t a[4] = {e4m3x2_scaled(a0, 0, sc0[u]),
                               R > 1 ? e4m3x2_scaled(a1, 0, sc1[u]) : 0u,
                               e4m3x2_scaled(a0, 1, sc0[u]),
                               R > 1 ? e4m3x2_scaled(a1, 1, sc1[u]) : 0u};
        const uint4& xw = st < 2 ? xa[u] : xb[u];
        mma_bf16(c4, a, word(xw, 2 * (st & 1)), word(xw, 2 * (st & 1) + 1));
      }
#pragma unroll
      for (int i = 0; i < 2 * R; ++i) acc[i] += c4[i];
    }
  }

#pragma unroll
  for (int h = 0; h < R; ++h) {
    red[warp][g + 8 * h][2 * t] = acc[2 * h];
    red[warp][g + 8 * h][2 * t + 1] = acc[2 * h + 1];
  }
  __syncthreads();
  // the block's sums, K parts in order; entry e: x row e / rows, row e % rows
  const int rows = rt * kTileRows;
  for (int e = threadIdx.x; e < rows * M; e += blockDim.x) {
    const int n = e / rows, i = e % rows, row = blockIdx.x * rows + i;
    float v = 0.f;
    for (int p = 0; p < ks; ++p) v += red[p * rt + i / kTileRows][i % kTileRows][n];
    if (row < OUT) y[static_cast<size_t>(n) * OUT + row] = v;
  }
}

template <int R>
int launch(const void* x, const void* q, const void* s, void* y, int M, int OUT, int IN, int ro,
           int ri, int Si, int rt, int ks, int unit, cudaStream_t st) {
  const int blocks = ((OUT + 8 * R - 1) / (8 * R) + rt - 1) / rt;
  fp8_gemv_kernel<R><<<blocks, 32 * rt * ks, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const __nv_bfloat16*>(s), static_cast<float*>(y), M, OUT, IN, ro, ri, Si, rt,
      ks, unit);
  return cudaGetLastError();
}

}  // namespace

// x [M, IN] bf16, q [OUT, IN] e4m3 bytes, s [OUT/ro, IN/ri] bf16 -> y [M, OUT]
// f32, with the launch plan (tile rows 8 or 16, rt, ks, unit) of
// ops/cuda/fp8_gemv.py::plan. Needs 1 <= M <= 8, IN % 16 == 0, ri % 16 == 0,
// 16-byte aligned rows, rt × ks <= 16 warps, unit % 16 == 0 dividing IN into
// at least ks units. Returns the launch's error (0 = launched), or
// cudaErrorInvalidValue for a shape or plan it does not take.
extern "C" int fp8_gemv(const void* x, const void* q, const void* s, void* y, int M, int OUT,
                        int IN, int ro, int ri, int Si, int tile_rows, int rt, int ks, int unit,
                        void* stream) {
  if (M < 1 || M > kMaxRows || OUT < 1 || IN < 16 || IN % 16 || ri < 16 || ri % 16 ||
      ro < 1 || Si < 1 || (tile_rows != 8 && tile_rows != 16) || rt < 1 || ks < 1 ||
      rt * ks > kMaxWarps || unit < 16 || unit % 16 || IN % unit || IN / unit < ks)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return tile_rows == 16 ? launch<2>(x, q, s, y, M, OUT, IN, ro, ri, Si, rt, ks, unit, st)
                         : launch<1>(x, q, s, y, M, OUT, IN, ro, ri, Si, rt, ks, unit, st);
}
