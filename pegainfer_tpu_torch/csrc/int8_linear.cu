// int8 weight-only linears for decode on Hopper (sm_90a): up to kMaxW
// weights that read the same rows, y_w = bf16((x · q_wᵀ) · s_w), in one
// launch.
//
// The JAX package's pegainfer_tpu/ops/quant.py, function int8_linear (an
// XLA op there, which a Pallas kernel never took): x [M, IN] rounded to
// bf16, each weight's int8 codes q [OUT, IN] and f32 scales s [OUT], y
// [M, OUT] = (the f32 sums of x against the exact codes) · s, rounded to
// bf16, or kept f32 (out_f32: f32 rows, and the f32-output form for bf16
// rows, whose partial sums tensor parallelism reduces before one rounding:
// wo and w_down of a rank, models/qwen3.py). Each code is an exact bf16
// value, each product of a code and a bf16 x is exact in f32, the sums are
// f32, and the scale and the rounding are the epilogue's, as (y ·
// s).to(bfloat16) does them. It takes the decode rows of the int8 linears of Qwen3 and Qwen3.5
// (ops/quant.py int8_linear / int8_linears: M <= 64); it replaces K6 at one
// expert (int8_gemv.cu with every id 0), which streamed the codes again for
// each 16 rows and each 8 rows and left the scale and the cast to two more
// launches.
//
// What bounds it: the codes' bytes (Qwen3-4B's decode step streams 4.02 GB,
// 1.29 ms at the measured read ceiling of 3.1224 TB/s), and past about 16
// rows also the products and the rows of x each product reads (a warp that
// loads its own x reads 2M bytes from L2 for every 16 codes, 8 bytes a
// code at 64 rows). So each weight is streamed once for any M, the loads of
// the next step stay in flight while a step's products run, and past 16
// rows a large launch stages x once a step for a warpgroup and runs its
// products on wgmma (PERF.md; studies/int8_linear_study.py).
//
// Design, the warps' form (up to 16 rows, and small launches past them):
// - The grid spans (weight, block of output tiles) pairs, weights in turn
//   (Group.first_block), and no rows: every warp takes all M rows. A block
//   has rt × ks warps; warp (tile, kp) takes 16 output channels and K part
//   kp: the steps kp, kp + ks, kp + 2ks, ... of kStepK columns (the plan,
//   ops/cuda/int8_linear.py::plan, from the shapes alone).
// - Each warp streams its codes through a ring of its own in shared memory,
//   kStages steps deep, by cp.async (16 bytes a lane; rows past OUT
//   and columns past IN filled with zeros by a source size of 0): no
//   registers hold bytes in flight, and a warp waits for no other warp.
// - A step's codes are read once from shared memory (16 bytes a lane a
//   row; an odd row's two runs swapped, so the two rows a phase reads fall
//   in distinct banks) and converted once into mma.sync m16n8k16 A
//   fragments by K6's exact byte permute and bf16x2 subtraction
//   (s8x4_to_bf16x2); each fragment then multiplies all G n8 groups of rows
//   (G = 1, 2, 4, 8: a template parameter the wrapper picks from M). A
//   lane's 16 codes of a row are physical columns 64u + 16t .. + 15 of the
//   step (run u); word k of them fills mma k-step k's k-slots {2t, 2t+1} and
//   {2t+8, 2t+9}, and B takes x from the same physical columns (a
//   contraction is unchanged by one permutation of k on both operands), 16
//   bf16 a lane a group, through L1, up to four groups' at a time.
// - Rows past M take zero B fragments (G is the fewest of 1, 2, 4, 8
//   groups that hold M, so at 17 rows the products of 15 are zero).
// - After the loop the rings become the block's sums: each warp's f32 sums,
//   then the K parts added in their fixed order, times s[o], rounded once,
//   each y element written once. No atomics: the same bits on every run.
// The warpgroup form is described where it begins, below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxW = 4;       // weights of one launch
constexpr int kRuns = 2;       // runs of 16 codes a lane takes of a row a step, 64 columns apart
constexpr int kStepK = 64 * kRuns;  // columns of a step: 4 lanes × kRuns runs
constexpr int kStage = 16 * kStepK;  // bytes of a stage: a warp's 16 rows of codes
constexpr int kMaxWarps = 8;   // warps of a block: rt × ks
constexpr int kMaxDevices = 64;
// row groups from which a plan of rt = 4 and ks <= 2 runs the warpgroup form
constexpr int kWgFromGroups = 4;

// ring stages of a warp (a step in flight while one is read; deeper rings
// measured slower at every row count, PERF.md)
constexpr int kStages = 2;
// blocks of kMaxWarps an SM the registers must allow
__host__ __device__ constexpr int min_blocks(int G) { return G >= 4 ? 2 : 3; }

struct Lin {
  const int8_t* q;  // [out, IN] codes
  const float* s;   // [out] scales
  void* y;          // row m at y + m · ldy elements
  int out, ldy, first_block;
};

struct Group {
  Lin w[kMaxW];
  int n;  // weights in use
};

__device__ __forceinline__ uint4 ld_shared16(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
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
// 1) and p23 = (code 2, code 3), exact (K6's convert). A byte b of sign bit
// s and low bits f under a high byte 0x43 is a bf16 of exponent 2^7: 0x43 |
// f is 128 + f, 0x43 | s << 7 is 128 or 256, and their difference is b as
// a signed integer.
__device__ __forceinline__ void s8x4_to_bf16x2(uint32_t w, uint32_t& p01, uint32_t& p23) {
  const uint32_t lo = prmt(w, 0x43434343u, 0x4140u), hi = prmt(w, 0x43434343u, 0x4342u);
  p01 = sub_bf16x2(lo & 0xFF7FFF7Fu, lo & 0xFF80FF80u);
  p23 = sub_bf16x2(hi & 0xFF7FFF7Fu, hi & 0xFF80FF80u);
}

// a stage row's 16-byte pieces are XORed with this: with two runs a row is
// 128 bytes, and an odd row takes its runs in the other order, so that the
// two rows a phase of 8 lanes reads fall in distinct banks
__device__ __forceinline__ int swizzle(int row) { return kRuns == 2 ? (row & 1) << 2 : 0; }

template <int G>
__global__ void __launch_bounds__(kMaxWarps * 32, min_blocks(G))
int8_linear_kernel(const __grid_constant__ Group grp, const __nv_bfloat16* __restrict__ x, int M,
                   int IN, int rt, int ks, int out_f32) {
  constexpr int S = kStages;
  constexpr int kPieces = kStepK / 16;  // 16-byte pieces of a row in a stage
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // the block's weight: the last whose first block is at or before it
  const int8_t* q = grp.w[0].q;
  const float* sc = grp.w[0].s;
  void* y = grp.w[0].y;
  int OUT = grp.w[0].out, ldy = grp.w[0].ldy, first = 0;
#pragma unroll
  for (int i = 1; i < kMaxW; ++i) {
    if (i < grp.n && grp.w[i].first_block <= static_cast<int>(blockIdx.x)) {
      q = grp.w[i].q;
      sc = grp.w[i].s;
      y = grp.w[i].y;
      OUT = grp.w[i].out;
      ldy = grp.w[i].ldy;
      first = grp.w[i].first_block;
    }
  }
  const int lb = blockIdx.x - first;  // the block within its weight
  const int tile = lb * rt + warp % rt, kp = warp / rt;
  const int o0 = tile * 16;  // the warp's first channel
  const int nsteps = (IN + kStepK - 1) / kStepK;
  const int steps = o0 < OUT && nsteps > kp ? (nsteps - kp + ks - 1) / ks : 0;
  unsigned char* ring = smem + warp * S * kStage;

  // the copies of the warp's step j into its stage j % S, one commit group
  // a step (empty past the last, so that every lane counts groups alike):
  // 16-byte chunk c = (row c / kPieces, piece c % kPieces), rows kStepK
  // bytes apart, a piece at its place in the row XOR the row's swizzle
  auto fetch = [&](int j) {
    if (j < steps) {
      const int col0 = (j * ks + kp) * kStepK;
      unsigned char* dst = ring + (j % S) * kStage;
#pragma unroll
      for (int i = 0; i < 16 * kPieces / 32; ++i) {
        const int c = lane + 32 * i, r = c / kPieces, pc = c % kPieces, col = col0 + 16 * pc;
        const bool ok = o0 + r < OUT && col < IN;
        cp_async16(dst + r * kStepK + 16 * (pc ^ swizzle(r)),
                   ok ? q + static_cast<size_t>(o0 + r) * IN + col : q, ok);
      }
    }
    cp_async_commit();
  };

  // the thread's B column: row 8n + g of x in group n (zero past M)
  const __nv_bfloat16* xr[G];
  bool xv[G];
#pragma unroll
  for (int n = 0; n < G; ++n) {
    xv[n] = 8 * n + g < M;
    xr[n] = x + static_cast<size_t>(xv[n] ? 8 * n + g : 0) * IN;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // acc[j][n][2h + p]: channel g + 8h, row 8n + 2t + p; with one or two
  // groups the k-steps alternate between two sets (j = k mod 2), so that a
  // product does not wait on the one just before it, and the sets are added
  // once at the end
  constexpr int kSets = G <= 2 ? 2 : 1;
  float acc[kSets][G][4];
#pragma unroll
  for (int j = 0; j < kSets; ++j)
#pragma unroll
    for (int n = 0; n < G; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][n][i] = 0.f;

#pragma unroll
  for (int j = 0; j < S - 1; ++j) fetch(j);
  for (int st = 0; st < steps; ++st) {
    __syncwarp();            // every lane is done with the stage the next fetch refills
    fetch(st + S - 1);
    cp_async_wait<S - 1>();  // this lane's copies of step st have landed
    __syncwarp();            // and every lane's
    const unsigned char* stage = ring + (st % S) * kStage;
#pragma unroll
    for (int u = 0; u < kRuns; ++u) {
      const int col = (st * ks + kp) * kStepK + 64 * u + 16 * t;  // the lane's 16 columns
      // the run's A fragments, each code read and converted once
      const int at = 16 * ((4 * u + t) ^ swizzle(g));
      const uint4 c0 = ld_shared16(stage + g * kStepK + at);
      const uint4 c1 = ld_shared16(stage + (g + 8) * kStepK + at);
      uint32_t af[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s8x4_to_bf16x2(word(c0, k), af[k][0], af[k][2]);
        s8x4_to_bf16x2(word(c1, k), af[k][1], af[k][3]);
      }
      const bool in = col < IN;
      // up to four groups at a time (their x in registers): B is x row 8n +
      // g at the lane's 16 columns, words 2k and 2k + 1 for k-step k, each
      // group's loaded before the products; k-step by k-step the groups'
      // products one after another, each following the last one of its own
      // accumulator kGH products back
      constexpr int kGH = G < 4 ? G : 4;
#pragma unroll
      for (int n0 = 0; n0 < G; n0 += kGH) {
        uint4 xw[kGH][2];
#pragma unroll
        for (int n = 0; n < kGH; ++n) {
          const bool ld = xv[n0 + n] && in;
          xw[n][0] = ld ? __ldg(reinterpret_cast<const uint4*>(xr[n0 + n] + col)) : zero;
          xw[n][1] = ld ? __ldg(reinterpret_cast<const uint4*>(xr[n0 + n] + col) + 1) : zero;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int n = 0; n < kGH; ++n)
            mma_bf16(acc[k % kSets][n0 + n], af[k], word(xw[n][k >> 1], 2 * (k & 1)),
                     word(xw[n][k >> 1], 2 * (k & 1) + 1));
      }
    }
  }

  // the block's sums: each warp's in the shared memory the rings held, row
  // m of warp w at red[(w · 8G + m) · kRs], padded so that a lane group's
  // stores fall in distinct banks
  constexpr int kRs = 16 + 4;
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int n = 0; n < G; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[(warp * 8 * G + 8 * n + 2 * t + (i & 1)) * kRs + g + 8 * (i >> 1)] =
          kSets == 2 ? acc[0][n][i] + acc[kSets - 1][n][i] : acc[0][n][i];
  __syncthreads();
  // K parts in order, then the scale and the rounding; entry e: row e / nb,
  // channel e % nb of the block's nb
  const int nb = rt * 16, o_blk = lb * nb;
  for (int e = threadIdx.x; e < M * nb; e += blockDim.x) {
    const int m = e / nb, i = e % nb, o = o_blk + i;
    if (o >= OUT) continue;
    float v = 0.f;
    for (int p = 0; p < ks; ++p) v += red[((p * rt + i / 16) * 8 * G + m) * kRs + i % 16];
    v *= sc[o];
    const size_t at = static_cast<size_t>(m) * ldy + o;
    if (out_f32)
      static_cast<float*>(y)[at] = v;
    else
      static_cast<__nv_bfloat16*>(y)[at] = __float2bfloat16_rn(v);
  }
}

// ---- past 16 rows: a warpgroup's products on wgmma, x staged once a step ----
//
// At 32 and 64 rows a warp's own x (2M bytes from L2 for every 16 codes)
// and its mma.sync products cost more than the codes' bytes (PERF.md). Here
// a block is ks warpgroups of 4 warps, one K part each, on one tile of 64
// channels (rt = 4: the warps' tiles, the same plan formulas). A warpgroup
// streams its step's 64 rows of codes and x's M rows at the step's columns
// into a ring of kWgStages stages; each warp converts its 16 rows of codes
// into A fragments in registers (the natural k order: a lane's bytes 2t,
// 2t+1, 2t+8, 2t+9 of each 16, picked by one byte permute, then K6's
// convert), and the warpgroup's wgmma m64nNk16 (N = 8G) reads B, x's rows,
// from the stage (K-major, 128-byte swizzled, as K2's K tiles): one
// instruction a 16-column block for all 64 channels and all rows. A step's
// products stay in flight while the next step waits for its copies and
// converts (two sets of A registers). The plan takes this form for a large
// launch only: with 64-channel tiles a small weight leaves most SMs idle.
constexpr int kWgStages = 3;  // the stage read, the next one in flight, the last one's products

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the 128 threads of warpgroup `id - 1`
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma and its wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A · B over one k16 block: A [64 x 16] bf16 in registers (a warp's 16
// rows, mma.sync's A layout), B [N x 16] K-major in shared memory. The
// accumulator of a lane holds, for each 8-column chunk j, (row g, columns
// 8j + 2t, +1) in d[4j], d[4j+1] and (row g + 8, the same) in d[4j+2, +3].
template <int N>
struct Wg;

template <>
struct Wg<32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wg<64> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// a warp's A fragments of a step's 8 k16 blocks from its stage rows r0
// and r1 = r0 + 8 of codes: bytes 2t, 2t+1 and 2t+8, 2t+9 of each 16, in
// the natural k order (one byte permute), then K6's convert
__device__ __forceinline__ void wg_convert(const unsigned char* stage, int r0, int r1, int t,
                                           uint32_t sel, uint32_t (&af)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint4 v0 = ld_shared16(stage + r0 * 128 + ((kk ^ (r0 & 7)) << 4));
    const uint4 v1 = ld_shared16(stage + r1 * 128 + ((kk ^ (r1 & 7)) << 4));
    s8x4_to_bf16x2(prmt(t & 2 ? v0.y : v0.x, t & 2 ? v0.w : v0.z, sel), af[kk][0], af[kk][2]);
    s8x4_to_bf16x2(prmt(t & 2 ? v1.y : v1.x, t & 2 ? v1.w : v1.z, sel), af[kk][1], af[kk][3]);
  }
}

// the warpgroup's 8 wgmma of a step, B x's slabs at xs, as one commit group
// left in flight
template <int N>
__device__ __forceinline__ void wg_products(float (&acc)[N / 2], const uint32_t (&af)[8][4],
                                            uint32_t xs, int slab) {
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    Wg<N>::rs(acc, af[kk], sw128_desc(xs + (kk >> 2) * slab + (kk & 3) * 32, 16, 1024));
  wgmma_commit();
}

// bytes of a warpgroup's stage: 64 rows of codes, then x's N rows in two
// 64-column slabs (1024-byte multiples, so each slab's swizzle atoms align)
__host__ __device__ constexpr int wg_stage_bytes(int G) { return 64 * kStepK + 2 * (8 * G) * 128; }

template <int G>
__global__ void __launch_bounds__(256, 1)
int8_linear_wg_kernel(const __grid_constant__ Group grp, const __nv_bfloat16* __restrict__ x,
                      int M, int IN, int ks, int out_f32) {
  constexpr int N = 8 * G, S = kWgStages;
  constexpr int kCodes = 64 * kStepK, kSlab = N * 128, kStageB = wg_stage_bytes(G);
  static_assert(kStepK == 128 && kCodes % 1024 == 0 && kSlab % 1024 == 0, "swizzle atoms");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, kp = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  const int8_t* q = grp.w[0].q;
  const float* sc = grp.w[0].s;
  void* y = grp.w[0].y;
  int OUT = grp.w[0].out, ldy = grp.w[0].ldy, first = 0;
#pragma unroll
  for (int i = 1; i < kMaxW; ++i) {
    if (i < grp.n && grp.w[i].first_block <= static_cast<int>(blockIdx.x)) {
      q = grp.w[i].q;
      sc = grp.w[i].s;
      y = grp.w[i].y;
      OUT = grp.w[i].out;
      ldy = grp.w[i].ldy;
      first = grp.w[i].first_block;
    }
  }
  const int lb = blockIdx.x - first;
  const int o_blk = lb * 64;  // the block's 64 channels
  const int nsteps = (IN + kStepK - 1) / kStepK;
  const int steps = o_blk < OUT && nsteps > kp ? (nsteps - kp + ks - 1) / ks : 0;
  unsigned char* ring = smem + kp * S * kStageB;

  // x's rows past M stay zero in every stage
  for (int i = wt; i < S * 2 * (N - M) * 8; i += 128) {
    const int st = i / (2 * (N - M) * 8), rest = i % (2 * (N - M) * 8);
    const int sl = rest / ((N - M) * 8), r = M + rest % ((N - M) * 8) / 8, c = rest % 8;
    *reinterpret_cast<uint4*>(ring + st * kStageB + kCodes + sl * kSlab + r * 128 +
                              ((c ^ (r & 7)) << 4)) = make_uint4(0u, 0u, 0u, 0u);
  }

  // the copies of the part's step j into stage j % S, a commit group a
  // step: 16-byte chunk c of code row r at r · 128 + (c ^ r mod 8) · 16,
  // and of x row r in slab sl the same within the slab (the 128-byte
  // swizzle)
  auto fetch = [&](int j) {
    if (j < steps) {
      const int col0 = (j * ks + kp) * kStepK;
      unsigned char* dst = ring + (j % S) * kStageB;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = wt + 128 * i, r = c >> 3, pc = c & 7, col = col0 + 16 * pc;
        const bool ok = o_blk + r < OUT && col < IN;
        cp_async16(dst + r * 128 + ((pc ^ (r & 7)) << 4),
                   ok ? q + static_cast<size_t>(o_blk + r) * IN + col : q, ok);
      }
      for (int i = wt; i < M * 16; i += 128) {
        const int r = i >> 4, c16 = i & 15, col = col0 + 8 * c16;
        const bool ok = col < IN;
        cp_async16(dst + kCodes + (c16 >> 3) * kSlab + r * 128 + (((c16 & 7) ^ (r & 7)) << 4),
                   ok ? x + static_cast<size_t>(r) * IN + col : x, ok);
      }
    }
    cp_async_commit();
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // the lane's rows of codes
  const uint32_t sel = t & 1 ? 0x7632u : 0x5410u;

  // one step prefetched; the step's products stay in flight while the next
  // step waits and converts, in the other of two sets of A registers, so a
  // step's stage is refilled two steps later, once its products are done
  uint32_t af0[8][4], af1[8][4];
  fetch(0);
  for (int st = 0; st < steps; ++st) {
    wg_sync(1 + kp);  // every warp is past step st - 2's products: its stage is free
    fetch(st + 1);
    cp_async_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
    wg_sync(1 + kp);  // every thread's copies of step st have landed
    const unsigned char* stage = ring + (st % S) * kStageB;
    const uint32_t xs = smem_u32(stage + kCodes);
    if (st & 1) {
      wg_convert(stage, r0, r1, t, sel, af1);
      wg_products<N>(acc, af1, xs, kSlab);
    } else {
      wg_convert(stage, r0, r1, t, sel, af0);
      wg_products<N>(acc, af0, xs, kSlab);
    }
    wgmma_wait<1>();  // step st - 1's products are done
  }
  wgmma_wait<0>();
  reg_fence(acc);

  // each part's sums, row m of part p at red[(p · N + m) · 68], then the
  // parts in order, the scale and the rounding
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[(kp * N + 8 * j + 2 * t + (i & 1)) * 68 + r0 + 8 * (i >> 1)] = acc[4 * j + i];
  __syncthreads();
  for (int e = tid; e < M * 64; e += blockDim.x) {
    const int m = e >> 6, i = e & 63, o = o_blk + i;
    if (o >= OUT) continue;  // a channel past the weight
    float v = 0.f;
    for (int p = 0; p < ks; ++p) v += red[(p * N + m) * 68 + i];
    v *= sc[o];
    const size_t at = static_cast<size_t>(m) * ldy + o;
    if (out_f32)
      static_cast<float*>(y)[at] = v;
    else
      static_cast<__nv_bfloat16*>(y)[at] = __float2bfloat16_rn(v);
  }
}

template <int G>
cudaError_t launch_wg(const Group& grp, int blocks, const void* x, int M, int IN, int ks,
                      int out_f32, cudaStream_t stream) {
  const size_t ring = static_cast<size_t>(ks) * kWgStages * wg_stage_bytes(G) + 1024;
  const size_t red = static_cast<size_t>(ks) * 8 * G * 68 * sizeof(float) + 1024;
  const size_t smem = ring > red ? ring : red;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(int8_linear_wg_kernel<G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(2 * kWgStages * wg_stage_bytes(G) + 1024));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  int8_linear_wg_kernel<G><<<blocks, 128 * ks, smem, stream>>>(
      grp, static_cast<const __nv_bfloat16*>(x), M, IN, ks, out_f32);
  return cudaGetLastError();
}

template <int G>
size_t smem_bytes(int warps) {
  const size_t ring = static_cast<size_t>(warps) * kStages * kStage;
  const size_t red = static_cast<size_t>(warps) * 8 * G * (16 + 4) * sizeof(float);
  return ring > red ? ring : red;
}

template <int G>
cudaError_t launch(const Group& grp, int blocks, const void* x, int M, int IN, int rt, int ks,
                   int out_f32, cudaStream_t stream) {
  // above 48 KB a kernel must be allowed its dynamic shared memory, once per
  // instance and device (at the most any plan asks)
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(int8_linear_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes<G>(kMaxWarps)));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  int8_linear_kernel<G><<<blocks, 32 * rt * ks, smem_bytes<G>(rt * ks), stream>>>(
      grp, static_cast<const __nv_bfloat16*>(x), M, IN, rt, ks, out_f32);
  return cudaGetLastError();
}

}  // namespace

// x [M, IN] bf16 and n weights w (q[w] int8 [out[w], IN], s[w] f32
// [out[w]]) -> y[w] [M, out[w]] with rows ldy[w] elements apart, bf16, or
// f32 when out_f32: y = (x · qᵀ) · s, each element written once. G row
// groups of 8 (1, 2, 4 or 8, with 8G >= M) and rt × ks warps a block are
// the plan of ops/cuda/int8_linear.py::plan. Needs 1 <= n <= 4, 1 <= M <=
// 64, IN % 16 == 0, 16-byte aligned x and q, rt × ks <= 8. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape or plan it does not take.
extern "C" int int8_linear(const void* x, int n, const void* const* q, const void* const* s,
                           void* const* y, const int* out, const int* ldy, int M, int IN,
                           int out_f32, int G, int rt, int ks, void* stream) {
  if (n < 1 || n > kMaxW || M < 1 || M > 64 || IN < 16 || IN % 16 || rt < 1 || ks < 1 ||
      rt * ks > kMaxWarps || (G != 1 && G != 2 && G != 4 && G != 8) || 8 * G < M ||
      x == nullptr)
    return cudaErrorInvalidValue;
  Group grp{};
  grp.n = n;
  int blocks = 0;
  for (int w = 0; w < n; ++w) {
    if (q[w] == nullptr || s[w] == nullptr || y[w] == nullptr || out[w] < 1 || ldy[w] < out[w])
      return cudaErrorInvalidValue;
    const int tiles = (out[w] + 15) / 16;
    grp.w[w] = Lin{static_cast<const int8_t*>(q[w]), static_cast<const float*>(s[w]), y[w],
                   out[w], ldy[w], blocks};
    blocks += (tiles + rt - 1) / rt;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (G >= kWgFromGroups && rt == 4 && ks <= 2) {  // a warpgroup a K part
    return static_cast<int>(G == 4 ? launch_wg<4>(grp, blocks, x, M, IN, ks, out_f32, st)
                                   : launch_wg<8>(grp, blocks, x, M, IN, ks, out_f32, st));
  }
  switch (G) {
    case 1: err = launch<1>(grp, blocks, x, M, IN, rt, ks, out_f32, st); break;
    case 2: err = launch<2>(grp, blocks, x, M, IN, rt, ks, out_f32, st); break;
    case 4: err = launch<4>(grp, blocks, x, M, IN, rt, ks, out_f32, st); break;
    default: err = launch<8>(grp, blocks, x, M, IN, rt, ks, out_f32, st); break;
  }
  return static_cast<int>(err);
}
