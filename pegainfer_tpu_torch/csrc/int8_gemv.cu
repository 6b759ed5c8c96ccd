// int8 MoE expert GEMV for Hopper (sm_90a): y[m] = x[m] · q[idx[m]]ᵀ,
// unscaled.
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/fp4_gemm.py, function
// moe_int8_gemv (body _int8_kernel). Same function and numerics: x [M, IN]
// in bf16, q [E, OUT, IN] int8 codes (the int8-experts mode), y f32
// [M, OUT]; each code is an exact bf16 value (|q| ≤ 128), each product of a
// code and a bf16 x is exact in f32 and the sums are f32. The caller
// applies the per-output-channel scales to y (M·OUT multiplies). A row
// whose expert id lies outside [0, E) gives 0.
//
// What bounds it: bytes. Each distinct routed expert streams OUT·IN bytes
// once (w1 at OUT 2048, IN 4096: 8.4 MB an expert, 50.3 MB for the 6
// experts of a B = 1 step, 16.1 µs at the measured read ceiling of
// 3.1224 TB/s). The products are nothing to the tensor cores.
//
// Design (the second; what held the first and what holds this one are in
// PERF.md, from studies/k6_study.py), K3's (csrc/fp4_gemv.cu) over int8:
// - Rows grouped by expert on the card (common.cuh slot_group): the grid is
//   (blocks of output tiles) × M expert slots; slot j of a chunk of 16 rows
//   takes the chunk's j-th distinct valid expert with all its rows, so each
//   distinct expert streams from device memory once; slots past the
//   chunk's experts exit; slot 0 of a chunk writes the zero rows of its
//   invalid ids.
// - A dense weight (one expert, every id 0: the int8 weight-only linears of
//   Qwen3 and Qwen3.5 decode, ops/quant.py int8_linear) has work only in
//   slot 0 of each chunk, so its launch asks for slots = ceil(M / 16): grid
//   row j is chunk j's slot 0, and the plan counts those blocks alone.
// - The work is cut from the shapes alone (ops/cuda/int8_gemv.py::plan): a
//   block takes rt warp tiles of 16 output channels and ks K parts of them,
//   a warp a (tile, K part). The K parts of a tile take its steps of kStepK
//   columns in turn: part kp takes steps kp, kp + ks, kp + 2ks, ...
// - The products go to the tensor cores: mma.sync m16n8k16 bf16, A the
//   expert's 16 channels of the warp's tile, B 8 of the group's rows of x
//   (columns past the group's rows zero; a group of more than 8 rows takes
//   a second pass). A thread's run is 16 consecutive codes of its rows g
//   and g + 8, one 16-byte load each, the 4 lanes of a row reading 64
//   contiguous bytes; a step is kRuns runs 64 columns apart, its 2·kRuns
//   loads issued together before its products (loading the next step's
//   codes ahead of this step's products as well streamed slower, PERF.md).
//   Word wi of a run (codes 4wi .. 4wi + 3) becomes two bf16 pairs by a
//   byte permute, two masks and one bf16x2 subtraction a pair
//   (s8x4_to_bf16x2), exact and with no conversion instruction; pair (0, 1)
//   fills mma step wi's k-slots {2t, 2t + 1}, pair (2, 3) its {2t + 8,
//   2t + 9}, and B takes x from the same physical columns (a contraction is
//   unchanged by a permutation of k applied to both operands), 16 bf16 a
//   run from L1.
// - A run's 4 products sum in fresh registers, added to the thread's sums
//   once; a block's K parts meet in a fixed order through shared memory and
//   each y element is written once: no atomics, the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kChunkRows = 16;  // rows of idx grouped together
constexpr int kWarpCh = 16;     // output channels of a warp tile: one m16 tile
constexpr int kRuns = 2;        // 16-code runs a thread a step, 64 columns apart
constexpr int kStepK = 4 * 16 * kRuns;  // columns of a warp step (4 lanes of a row)
constexpr int kMaxWarps = 8;    // warps of a block: rt × ks
constexpr int kBlocksPerSm = 3;  // the registers' budget: blocks of kMaxWarps an SM

// one thread's run of 16 codes: read once, so not kept in L1
__device__ __forceinline__ uint4 ld_codes(const int8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 4 int8 codes (code j in byte j of w) -> bf16 pairs p01 = (code 0, code
// 1) and p23 = (code 2, code 3), exact. A byte b of sign bit s and low
// bits f under a high byte 0x43 is a bf16 of exponent 2^7: 0x43 | f is
// 128 + f, 0x43 | s << 7 is 128 or 256, and their difference is b as a
// signed integer.
__device__ __forceinline__ void s8x4_to_bf16x2(uint32_t w, uint32_t& p01, uint32_t& p23) {
  const uint32_t lo = prmt(w, 0x43434343u, 0x4140u), hi = prmt(w, 0x43434343u, 0x4342u);
  p01 = sub_bf16x2(lo & 0xFF7FFF7Fu, lo & 0xFF80FF80u);
  p23 = sub_bf16x2(hi & 0xFF7FFF7Fu, hi & 0xFF80FF80u);
}

__global__ void __launch_bounds__(kMaxWarps * 32, kBlocksPerSm)
int8_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const int* __restrict__ idx, float* __restrict__ y, int M, int E, int OUT,
                 int IN, int rt, int ks, int slots) {
  extern __shared__ float red[];  // [rt · ks warps][kWarpCh][8]: each warp's sums
  __shared__ int row_of[kChunkRows];  // the group's rows of x, in order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int expert;
  unsigned rows, invalid;
  // the block's expert slot: grid row j for routed rows (slots == M), chunk
  // j's slot 0 for a dense weight (slots == ceil(M / 16))
  const int slot = slots == M ? blockIdx.y : blockIdx.y * kChunkRows;
  slot_group<kChunkRows>(idx, M, E, slot, lane, expert, rows, invalid);
  const int c0 = slot / kChunkRows * kChunkRows;
  const int nb = rt * kWarpCh, o_blk = blockIdx.x * nb;  // the block's channels
  if (slot % kChunkRows == 0) {  // the chunk's rows of invalid ids are 0
    for (unsigned r = invalid; r; r &= r - 1) {
      float* yr = y + static_cast<size_t>(c0 + __ffs(r) - 1) * OUT;
      for (int i = threadIdx.x; i < nb; i += blockDim.x)
        if (o_blk + i < OUT) yr[o_blk + i] = 0.f;
    }
  }
  if (expert < 0) return;  // the same in every warp
  const int cnt = __popc(rows);
  if (threadIdx.x < cnt) row_of[threadIdx.x] = c0 + nth_bit(rows, threadIdx.x);

  // this warp's tile and K part kp: steps kp, kp + ks, ... of its row
  const int tile = blockIdx.x * rt + warp % rt;
  const int kp = warp / rt;
  const int o0 = tile * kWarpCh;
  // the thread's rows g and g + 8 (past OUT: the last row, read and never
  // written)
  const size_t ebase = static_cast<size_t>(expert) * OUT;
  const int8_t* qr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qr[h] = q + (ebase + min(o0 + g + 8 * h, OUT - 1)) * IN;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int nsteps = o0 < OUT ? (IN + kStepK - 1) / kStepK : 0;  // steps of a row
  const int steps = nsteps > kp ? (nsteps - kp + ks - 1) / ks : 0;  // this part's

  // the group's rows in passes of 8, the n8 columns of the mma
  for (int n0 = 0; n0 < cnt; n0 += 8) {
    // the thread's B column: row n0 + g of the group (zero past cnt)
    const bool xv = n0 + g < cnt;
    const __nv_bfloat16* xr = x + static_cast<size_t>(c0 + (xv ? nth_bit(rows, n0 + g) : 0)) * IN;
    float c[4] = {};  // rows g, g + 8 × columns 2t, 2t + 1
    for (int st = 0; st < steps; ++st) {
      const int base = (st * ks + kp) * kStepK;
      // the step's codes, all its loads in flight before its products
      uint4 a[kRuns][2];
#pragma unroll
      for (int u = 0; u < kRuns; ++u) {
        const int col = base + 16 * t + 64 * u;
#pragma unroll
        for (int h = 0; h < 2; ++h) a[u][h] = col < IN ? ld_codes(qr[h] + col) : zero;
      }
#pragma unroll
      for (int u = 0; u < kRuns; ++u) {
        if (base + 64 * u >= IN) break;  // the same for the whole warp
        const int col = base + 16 * t + 64 * u;
        const bool in = col < IN;
        // the run's sums, in fresh registers, added to c once
        float cr[4] = {};
#pragma unroll
        for (int xi = 0; xi < 2; ++xi) {
          // B: x at columns col + 8xi .. col + 8xi + 7, words 2xi and 2xi + 1
          const uint4 xw = xv && in ? __ldg(reinterpret_cast<const uint4*>(xr + col) + xi) : zero;
#pragma unroll
          for (int hw = 0; hw < 2; ++hw) {
            uint32_t af[4];
            s8x4_to_bf16x2(word(a[u][0], 2 * xi + hw), af[0], af[2]);
            s8x4_to_bf16x2(word(a[u][1], 2 * xi + hw), af[1], af[3]);
            mma_bf16(cr, af, word(xw, 2 * hw), word(xw, 2 * hw + 1));
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] += cr[i];
      }
    }

    // c[2h + p]: channel g + 8h, column 2t + p
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[(warp * kWarpCh + g + 8 * (i >> 1)) * 8 + 2 * t + (i & 1)] = c[i];
    __syncthreads();
    // the block's sums, K parts in order; entry e: column e / nb, channel e % nb
    const int cols = min(8, cnt - n0);
    for (int e = threadIdx.x; e < nb * cols; e += blockDim.x) {
      const int col = e / nb, i = e % nb, o = o_blk + i;
      float v = 0.f;
      for (int p = 0; p < ks; ++p)
        v += red[((p * rt + i / kWarpCh) * kWarpCh + i % kWarpCh) * 8 + col];
      if (o < OUT) y[static_cast<size_t>(row_of[n0 + col]) * OUT + o] = v;
    }
    __syncthreads();  // red is free for the next pass
  }
}

}  // namespace

// x [M, IN] bf16, q [E, OUT, IN] int8, idx [M] int32 -> y [M, OUT] f32,
// unscaled, every row written, with the launch plan (rt, ks) of
// ops/cuda/int8_gemv.py::plan and its expert slots: M for routed rows, or
// ceil(M / 16) when every id is the same (a dense weight, E = 1). Needs 1
// <= M <= 65535, IN % 16 == 0, 16-byte aligned x and q, rt × ks <= 8 warps;
// a row whose expert id lies outside [0, E) gives 0. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape or plan it does not take.
extern "C" int int8_gemv(const void* x, const void* q, const void* idx, void* y, int M, int E,
                         int OUT, int IN, int rt, int ks, int slots, void* stream) {
  if (M < 1 || M > 65535 || OUT < 1 || IN < 16 || IN % 16 || rt < 1 || ks < 1 ||
      rt * ks > kMaxWarps || (slots != M && slots != (M + kChunkRows - 1) / kChunkRows))
    return cudaErrorInvalidValue;
  const int tiles = (OUT + kWarpCh - 1) / kWarpCh;
  const dim3 grid((tiles + rt - 1) / rt, slots);
  const size_t smem = static_cast<size_t>(rt) * ks * kWarpCh * 8 * sizeof(float);
  int8_gemv_kernel<<<grid, 32 * rt * ks, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const int*>(idx), static_cast<float*>(y), M, E, OUT, IN, rt, ks, slots);
  return cudaGetLastError();
}
