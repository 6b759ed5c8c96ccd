// Packed-fp4 MoE expert GEMV for Hopper (sm_90a):
// y[m] = x[m] · dequant(q[idx[m]], s[idx[m]])ᵀ.
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/fp4_gemm.py, function
// moe_fp4_gemv (body _kernel, decode _decode_pair_swar / _decode_e2m1).
// Same function and numerics: x [M, IN] in bf16; q [E, OUT, IN/2] holds two
// E2M1 codes per byte (low nibble = even element); s [E, OUT, IN/g] bf16
// scales, one per g-wide group (g = 32 in the checkpoint, any multiple of
// 32 here); each weight is bf16(f32(code) · scale), products accumulate in
// f32, y is f32 [M, OUT]; a row whose expert id lies outside [0, E) gives
// 0. The TPU's SWAR nibble decode and one-hot scale-expansion matmul exist
// only to satisfy Mosaic and are not carried over.
//
// What bounds it: bytes. Each distinct routed expert's packed rows and
// scales are read once: OUT·IN/2 bytes plus OUT·IN/g·2 of scales (w1 at
// OUT 2048, IN 4096: 4.7 MB an expert, 28.3 MB for the 6 experts of a B = 1
// step, 8.4 µs at 3.35 TB/s). The products are nothing to the tensor cores,
// but the decode is not: about 19 instructions a word of 8 codes, 4.6 µs of
// an SM's instruction slots at that shape, to hide behind the stream.
//
// Design (the second; what held the first and what held this one are in
// PERF.md, from studies/k3_study.py):
// - Rows grouped by expert on the card. The grid is (blocks of output
//   tiles) × M expert slots. Every warp reads the 16 ids of its slot's
//   chunk of rows (rows in chunks of 16, each chunk grouped on its own) and
//   finds, with warp votes, the distinct valid experts in order of first
//   appearance; slot j takes the chunk's j-th, with all its rows, so each
//   distinct expert streams from device memory once whatever the number of
//   rows routed to it. Slots past the chunk's experts exit; slot 0 of a
//   chunk writes the zero rows of its invalid ids.
// - The work is cut from the shapes alone (ops/cuda/fp4_gemv.py::plan): a
//   block takes rt warp tiles of 16 output channels and ks K parts of them,
//   a warp a (tile, K part); K parts are whole units of `unit` columns
//   (whole steps and whole scale groups where they divide IN).
// - The products go to the tensor cores: mma.sync m16n8k16 bf16, A the
//   expert's 16 channels of the warp's tile, B 8 of the group's rows of x
//   (columns past the group's rows zero; a group of more than 8 rows takes
//   a second pass, which reads the expert's weights again). A thread's step
//   is one run of 32 consecutive codes of its rows g and g + 8 (one 16-byte
//   load each, under one scale: groups are multiples of 32), the 4 lanes of
//   a row reading 64 contiguous bytes; the next step's codes and scales are
//   loaded before this step's products. The codes decode with K5's
//   table-free e2m1x8_bf16x2 (common.cuh) straight into bf16x2 A registers
//   (bf16(code · scale) rounded once from the exact product). Byte 2s of a
//   run holds mma step s's k-slots {2t, 2t+1}, byte 2s + 1 those of {2t+8,
//   2t+9}; B takes x from the same physical columns, the run's 32
//   consecutive values of x, a word at a time from L1 while the decode runs
//   (a contraction is unchanged by a permutation of k applied to both
//   operands). A run's 8 products sum in fresh registers, added to the
//   thread's sums once, so the tensor cores' f32 sums stay short.
// - Registers are held to three blocks of 8 warps an SM (80 a thread): more
//   warps in flight hid the decode and the scale loads better than more
//   bytes a thread (two tiles or two runs a step spilled or ran slower).
// - The scale's column advances by a compare a run, with no division in the
//   loop. Each weight is used once: nothing is staged in shared memory or
//   kept in L1, and L2 is asked for no more than the load.
// - A block's K parts meet in a fixed order through shared memory and each
//   y element is written once: no atomics, the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kChunkRows = 16;  // rows of idx grouped together
constexpr int kTiles = 1;       // m16 tiles of a warp
constexpr int kWarpCh = 16 * kTiles;  // output channels of a warp tile
constexpr int kRows = 2 * kTiles;     // a thread's rows: g and g + 8 of each tile
constexpr int kRuns = 1;        // 32-code runs a thread a step (128 columns apart)
constexpr int kStepK = 4 * 32 * kRuns;  // columns of a warp step (4 lanes of a row)
constexpr int kMaxWarps = 8;    // warps of a block: rt × ks
constexpr int kBlocksPerSm = 3;  // the registers' budget: blocks of kMaxWarps an SM

// one thread's run of 32 codes: read once, so not kept in L1 (asking L2
// for the 256 bytes around it cost time here, k3_study's l2-256b)
__device__ __forceinline__ uint4 ld_codes(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// one step of a thread: kRuns runs of 32 codes of each of its rows and
// their scales in both halves
struct Step {
  uint4 a[kRuns][kRows];
  uint32_t sc[kRuns][kRows];
};

// (j, rem): a scale column and a run's place in its group of gq runs,
// advanced by a number of runs given as (dj, drem) = (n / gq, n % gq)
__device__ __forceinline__ void advance(int& j, int& rem, int dj, int drem, int gq) {
  j += dj;
  rem += drem;
  if (rem >= gq) rem -= gq, ++j;
}

__global__ void __launch_bounds__(kMaxWarps * 32, kBlocksPerSm)
fp4_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                const uint16_t* __restrict__ s, const int* __restrict__ idx,
                float* __restrict__ y, int M, int E, int OUT, int IN, int S, int rt, int ks,
                int unit) {
  extern __shared__ float red[];  // [rt · ks warps][kWarpCh][8]: each warp's sums
  __shared__ int row_of[kChunkRows];  // the group's rows of x, in order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int expert;
  unsigned rows, invalid;
  slot_group<kChunkRows>(idx, M, E, blockIdx.y, lane, expert, rows, invalid);
  const int c0 = blockIdx.y / kChunkRows * kChunkRows;
  const int nb = rt * kWarpCh, o_blk = blockIdx.x * nb;  // the block's channels
  if (blockIdx.y % kChunkRows == 0) {  // the chunk's rows of invalid ids are 0
    for (unsigned r = invalid; r; r &= r - 1) {
      float* yr = y + static_cast<size_t>(c0 + __ffs(r) - 1) * OUT;
      for (int i = threadIdx.x; i < nb; i += blockDim.x)
        if (o_blk + i < OUT) yr[o_blk + i] = 0.f;
    }
  }
  if (expert < 0) return;  // the same in every warp
  const int cnt = __popc(rows);
  if (threadIdx.x < cnt) row_of[threadIdx.x] = c0 + nth_bit(rows, threadIdx.x);

  // this warp's tile and K part [k0, k1): part kp of ks, whole units
  const int tile = blockIdx.x * rt + warp % rt;
  const int kp = warp / rt, nu = IN / unit;
  const int k0 = kp * nu / ks * unit, k1 = (kp + 1) * nu / ks * unit;
  const int o0 = tile * kWarpCh;
  // the thread's rows: g, g + 8 of tile 0, then of tile 1 (past OUT: the
  // last row, read and never written)
  const size_t ebase = static_cast<size_t>(expert) * OUT;
  const uint8_t* qr[kRows];
  const uint16_t* sr[kRows];
#pragma unroll
  for (int h = 0; h < kRows; ++h) {
    const size_t o = ebase + min(o0 + g + 8 * h, OUT - 1);
    qr[h] = q + o * (IN / 2);
    sr[h] = s + o * S;
  }
  // the scale column of the thread's first run and the run's place in its
  // group of gq runs; a step's runs lie 4 runs apart, its steps 4 · kRuns
  const int gq = IN / S / 32, r0 = (k0 + 32 * t) / 32;
  const int d4j = 4 / gq, d4r = 4 % gq, dsj = 4 * kRuns / gq, dsr = 4 * kRuns % gq;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int steps = o0 < OUT ? (k1 - k0 + kStepK - 1) / kStepK : 0;

  // the codes and scales of the step at `base`, whose first run's scale is
  // (jj, rr)
  auto load = [&](Step& st, int base, int jj, int rr) {
#pragma unroll
    for (int u = 0; u < kRuns; ++u) {
      const int col = base + 32 * t + 128 * u;
      const bool in = col < k1;
#pragma unroll
      for (int h = 0; h < kRows; ++h) {
        st.a[u][h] = in ? ld_codes(qr[h] + col / 2) : zero;
        st.sc[u][h] = in ? __ldg(sr[h] + jj) * 0x10001u : 0u;
      }
      advance(jj, rr, d4j, d4r, gq);
    }
  };

  // the group's rows in passes of 8, the n8 columns of the mma (a second
  // pass, which reads the expert's weights again, only past 8 rows)
  for (int n0 = 0; n0 < cnt; n0 += 8) {
    // the thread's B column: row n0 + g of the group (zero past cnt)
    const bool xv = n0 + g < cnt;
    const __nv_bfloat16* xr = x + static_cast<size_t>(c0 + (xv ? nth_bit(rows, n0 + g) : 0)) * IN;
    float c[kTiles][4] = {};  // tile mt: rows g, g + 8 × columns 2t, 2t + 1
    int j = r0 / gq, rem = r0 % gq;
    Step cur, nxt;
    if (steps > 0) load(cur, k0, j, rem);
    for (int st = 0; st < steps; ++st) {
      const int base = k0 + st * kStepK;
      advance(j, rem, dsj, dsr, gq);  // the next step's first run
      // the next step's codes and scales in flight before this step's products
      if (st + 1 < steps) load(nxt, base + kStepK, j, rem);
#pragma unroll
      for (int u = 0; u < kRuns; ++u) {
        if (base + 128 * u >= k1) break;  // the same for the whole warp
        const int col = base + 32 * t + 128 * u;
        const bool in = col < k1;
        // the run's sums, in fresh registers (the tensor cores' f32 sums
        // stay short), added to c once
        float cr[kTiles][4] = {};
#pragma unroll
        for (int wi = 0; wi < 4; ++wi) {  // word wi of each run: mma steps 2wi, 2wi + 1
          // B: x at columns col + 8wi .. col + 8wi + 7
          const uint4 xw = xv && in ? __ldg(reinterpret_cast<const uint4*>(xr + col) + wi) : zero;
          uint32_t r[kRows][4];
#pragma unroll
          for (int h = 0; h < kRows; ++h)
            e2m1x8_bf16x2(word(cur.a[u][h], wi), cur.sc[u][h], r[h]);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int mt = 0; mt < kTiles; ++mt) {
              const uint32_t af[4] = {r[2 * mt][2 * hh], r[2 * mt + 1][2 * hh],
                                      r[2 * mt][2 * hh + 1], r[2 * mt + 1][2 * hh + 1]};
              mma_bf16(cr[mt], af, word(xw, 2 * hh), word(xw, 2 * hh + 1));
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < kTiles; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[mt][i] += cr[mt][i];
      }
      cur = nxt;
    }

    // c[mt][2h + p]: channel mt · 16 + g + 8h, column 2t + p
#pragma unroll
    for (int mt = 0; mt < kTiles; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(warp * kWarpCh + mt * 16 + g + 8 * (i >> 1)) * 8 + 2 * t + (i & 1)] = c[mt][i];
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

// x [M, IN] bf16, q [E, OUT, IN/2] uint8, s [E, OUT, S] bf16, idx [M] int32
// -> y [M, OUT] f32, every row written, with the launch plan (rt, ks, unit)
// of ops/cuda/fp4_gemv.py::plan. Needs 1 <= M <= 65535, IN % 32 == 0,
// (IN/S) % 32 == 0, rt × ks <= 8 warps, unit % 32 == 0 dividing IN into at
// least ks units; a row whose expert id lies outside [0, E) gives 0.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape or plan it does not take.
extern "C" int fp4_gemv(const void* x, const void* q, const void* s, const void* idx, void* y,
                        int M, int E, int OUT, int IN, int S, int rt, int ks, int unit,
                        void* stream) {
  if (M < 1 || M > 65535 || OUT < 1 || IN < 32 || IN % 32 || S < 1 || IN % S ||
      (IN / S) % 32 || rt < 1 || ks < 1 || rt * ks > kMaxWarps || unit < 32 || unit % 32 ||
      IN % unit || IN / unit < ks)
    return cudaErrorInvalidValue;
  const int tiles = (OUT + kWarpCh - 1) / kWarpCh;
  const dim3 grid((tiles + rt - 1) / rt, M);
  const size_t smem = static_cast<size_t>(rt) * ks * kWarpCh * 8 * sizeof(float);
  fp4_gemv_kernel<<<grid, 32 * rt * ks, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const uint16_t*>(s), static_cast<const int*>(idx), static_cast<float*>(y), M,
      E, OUT, IN, S, rt, ks, unit);
  return cudaGetLastError();
}
