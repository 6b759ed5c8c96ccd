// Packed-fp4 grouped expert GEMM for prefill MoE on Hopper (sm_90a).
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/fp4_gemm.py, function
// moe_fp4_grouped (body _gemm_kernel; segments from tile_segments). Same
// function and numerics: x_sorted [Mp, IN] bf16, rows sorted by expert;
// y[r] = x_sorted[r] · dequant(q[e(r)], s[e(r)])ᵀ as f32 [Mp, OUT], with q
// [E, OUT, IN/2] packed E2M1 codes (the even k in the low nibble) and s
// [E, OUT, IN/g] bf16 group scales. Each weight is bf16(f32(code) · scale),
// products are bf16 × bf16 on the tensor cores with f32 accumulation, rows
// of no segment give 0. Exact at any routing skew: the work comes from the
// true group sizes, with no capacity factor.
//
// What bounds it: bytes. At 1,024 prompt tokens (6,144 routed rows over 256
// experts) every expert is hit, so one call streams the whole packed stack:
// 1.21 GB with scales for w1 (OUT 2048, IN 4096), 361 µs at 3.35 TB/s,
// against 103 GFLOP (104 µs at the bf16 tensor-core peak). So each expert's
// codes are read from device memory once, and the decode has to keep up.
// On an H100 it does not quite: at w1 the ring's copies alone take about
// 56% of the kernel's time, and the scale loads (about 22%) and the decode
// (about 10%) do not hide behind them (scripts/k5_tile_study.py).
//
// Design: int8_grouped.cu's (K7), with the format's three differences. The
// work comes from ops/cuda/fp4_grouped.py::plan, made on the device from the
// segments: items of (expert, a chunk of at most kBN of its rows), and here
// each item times kBM-wide tiles of output channels, the output tile
// fastest, so the blocks of one expert run together and its x rows stay in
// L2. A block streams its expert's packed [kBM, IN/2] codes once and the
// chunk's x rows, kBK columns a stage, through a ring of kStages stages
// filled by cp.async (16 bytes a thread; each x row is masked on its own:
// rows of another expert or of no segment are filled with zeros by a source
// size of 0). The products are mma.sync m16n8k16 bf16 with the operands
// swapped: the decoded weights are A (M = output channels), the rows are B
// (N), so an expert's 24 rows fill 3 n8 columns and empty columns are
// skipped. Each of the 4 warps owns 32 output channels. A thread loads 16
// consecutive codes of a channel (one 8-byte load, inside one scale group
// since g % 16 == 0); byte 2s holds the codes of its k16 step s's k-slots
// {2t, 2t+1}, byte 2s + 1 those of {2t+8, 2t+9}, so each byte decodes to one
// bf16x2 A register, and x's B fragment is loaded from the same physical k
// (a contraction is unchanged by any permutation of k applied to both
// operands). The decode (common.cuh's e2m1x8_bf16x2, shared with K9) has no
// table in memory: two byte permutes pick each E2M1 magnitude's bf16 low
// and high bytes from constants, a third puts the sign bits in place, and one bf16x2 multiply by the group's scale rounds
// the exact product once, as the JAX kernel's f32 product cast to bf16
// does. The scales go straight to registers, one stage ahead (8 loads a
// thread a stage; a stage of a channel needs only kBK/g of them, 8 bytes at
// g 32, below cp.async's 16-byte unit). Shared rows are XOR-swizzled in
// 16-byte units so that the fragment loads are free of bank conflicts.
// K7's tile, 3 stages of 24 KB, with three blocks (12 warps) an SM: on an
// H100 it took 8-15% less time than the same tile two blocks an SM (4
// stages) and than 256 channels of 8 warps, one block an SM, which re-reads
// each row chunk's x half as often (scripts/k5_tile_study.py). Rows are
// written once, by the item of their owner (plan.owner), as f32 straight
// from the accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps, 32 output channels each
constexpr int kMinBlocks = 3;  // blocks an SM (ptxas keeps to 170 registers)
constexpr int kBM = 128;       // output channels of a block (A rows)
constexpr int kBN = 64;        // routed rows of a work item (B columns)
constexpr int kBK = 128;       // k of one stage
constexpr int kStages = 3;
constexpr int kARow = kBK / 2;          // packed codes of a channel in a stage, bytes
constexpr int kAStage = kBM * kARow;    // bytes
constexpr int kBStage = kBN * kBK * 2;  // bf16 x rows, bytes
constexpr int kStage = kAStage + kBStage;
constexpr int kSmem = kStages * kStage;  // 72 KB: three blocks an SM

// the scales of stage kt for this thread's 4 channels (o, o + 8, o + 16,
// o + 24) and the stage's two 64-wide groups (its 16-code run at 16t of
// each), in both halves of sc[4 kg + i]; 0 past OUT or IN
__device__ __forceinline__ void load_scales(uint32_t* sc, const uint16_t* se, int kt, int o,
                                            int OUT, int IN, int S, int grp, int t) {
#pragma unroll
  for (int kg = 0; kg < kBK / 64; ++kg) {
    const int k = kt * kBK + kg * 64 + 16 * t;
    const int j = k / grp;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int oi = o + (i >> 1) * 16 + (i & 1) * 8;
      uint32_t v = 0;
      if (oi < OUT && k < IN) v = __ldg(se + static_cast<size_t>(oi) * S + j);
      sc[4 * kg + i] = v * 0x10001u;
    }
  }
}

// stage kt of a work item into its ring slot: the expert's packed codes for
// channels [o0, o0 + kBM) (row o at byte o·kARow, 16-byte unit c at
// c ^ (o & 2)) and the chunk's x rows that hold data (row n at byte n·2kBK,
// unit c at c ^ (n & 1)); past OUT or IN, and rows not to load, get zeros
__device__ __forceinline__ void load_stage(uint8_t* smem, int kt, const uint8_t* qe,
                                           const uint8_t* q, const __nv_bfloat16* x,
                                           const int* s_load, int o0, int lo, int nt,
                                           int OUT, int IN, int tid) {
  uint8_t* As = smem + (kt % kStages) * kStage;
  uint8_t* Bs = As + kAStage;
  const int k0 = kt * kBK;
#pragma unroll
  for (int i = 0; i < kAStage / 16 / kThreads; ++i) {
    const int c = tid + i * kThreads, row = c / (kARow / 16), u = c % (kARow / 16);
    const bool ok = o0 + row < OUT && k0 + u * 32 < IN;
    const uint8_t* src =
        ok ? qe + static_cast<size_t>(o0 + row) * (IN / 2) + k0 / 2 + u * 16 : q;
    cp_async16(As + row * kARow + ((u ^ (row & 2)) << 4), src, ok);
  }
  for (int c = tid; c < nt * 8 * (kBK / 8); c += kThreads) {
    const int row = c / (kBK / 8), u = c % (kBK / 8);
    const bool ok = s_load[row] && k0 + u * 8 < IN;
    const __nv_bfloat16* src = ok ? x + static_cast<size_t>(lo + row) * IN + k0 + u * 8 : x;
    cp_async16(Bs + row * (2 * kBK) + ((u ^ (row & 1)) << 4), src, ok);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fp4_grouped_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                   const uint16_t* __restrict__ s, const int* __restrict__ row_e,
                   const int* __restrict__ owner, const int* __restrict__ items,
                   const int* __restrict__ n_items, float* __restrict__ y, int OUT, int IN,
                   int S, int n_slots) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_load[kBN], s_write[kBN];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_ot = (OUT + kBM - 1) / kBM;
  const int KT = (IN + kBK - 1) / kBK;
  const int grp = IN / S;
  const int live = min(n_items[0], n_slots) * n_ot;

  // blocks past the live count exit at once; a grid-stride loop, so rows
  // that are not sorted (more items than the grid) still get every item
  for (int w = blockIdx.x; w < live; w += gridDim.x) {
    const int item = w / n_ot, o0 = (w % n_ot) * kBM;
    const int e = items[3 * item], lo = items[3 * item + 1], hi = items[3 * item + 2];
    const int rows = hi - lo;
    if (tid < kBN) {
      s_load[tid] = tid < rows && row_e[lo + tid] == e;
      s_write[tid] = tid < rows && owner[lo + tid] == e;
    }
    __syncthreads();
    const int nt = (rows + 7) >> 3;  // n8 columns that hold rows
    const uint8_t* qe = q + static_cast<size_t>(e) * OUT * (IN / 2);
    const uint16_t* se = s + static_cast<size_t>(e) * OUT * S;
    const int o_thr = o0 + warp * 32 + g;  // this thread's first channel

    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][jn][i] = 0.f;

    uint32_t sc[2 * kBK / 64 * 2], sc_next[2 * kBK / 64 * 2];
    load_scales(sc, se, 0, o_thr, OUT, IN, S, grp, t);
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < KT) load_stage(smem, st, qe, q, x, s_load, o0, lo, nt, OUT, IN, tid);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      // the next stage's scales (0 past IN), loaded before the wait (2% less
      // time on an H100 than after it, scripts/k5_tile_study.py)
      load_scales(sc_next, se, kt + 1, o_thr, OUT, IN, S, grp, t);
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage kt landed for all; slot (kt - 1) % kStages is free
      if (kt + kStages - 1 < KT)
        load_stage(smem, kt + kStages - 1, qe, q, x, s_load, o0, lo, nt, OUT, IN, tid);
      cp_async_commit();
      const uint8_t* As = smem + (kt % kStages) * kStage;
      const uint8_t* Bs = As + kAStage;
#pragma unroll
      for (int kg = 0; kg < kBK / 64; ++kg) {
        // A fragments of the 4 k16 steps of this 64-wide group, both m16 tiles
        uint32_t a[2][4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = warp * 32 + mt * 16 + h * 8 + g;
            const uint2 raw = *reinterpret_cast<const uint2*>(
                As + row * kARow + (((2 * kg + (t >> 1)) ^ (row & 2)) << 4) + (t & 1) * 8);
            uint32_t r[8];
            e2m1x8_bf16x2(raw.x, sc[4 * kg + 2 * mt + h], r);
            e2m1x8_bf16x2(raw.y, sc[4 * kg + 2 * mt + h], r + 4);
#pragma unroll
            for (int st = 0; st < 4; ++st) {
              a[mt][st][h] = r[2 * st];
              a[mt][st][2 + h] = r[2 * st + 1];
            }
          }
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          if (jn < nt) {
            const int n = jn * 8 + g;
            const uint8_t* bp = Bs + n * (2 * kBK);
            const uint4 b0 = *reinterpret_cast<const uint4*>(
                bp + (((kg * 8 + 2 * t) ^ (n & 1)) << 4));
            const uint4 b1 = *reinterpret_cast<const uint4*>(
                bp + (((kg * 8 + 2 * t + 1) ^ (n & 1)) << 4));
            const uint32_t bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int st = 0; st < 4; ++st)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                mma_bf16(acc[mt][jn], a[mt][st], bw[2 * st], bw[2 * st + 1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2 * kBK / 64 * 2; ++i) sc[i] = sc_next[i];
    }

    // acc[mt][jn][2 h + c]: channel o0 + 32 warp + 16 mt + 8 h + g, row
    // lo + 8 jn + 2t + c; the rows this item owns, and channels below OUT
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      if (jn < nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int rr = jn * 8 + 2 * t + c;
          if (!s_write[rr]) continue;
          float* yr = y + static_cast<size_t>(lo + rr) * OUT;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int o = o_thr + mt * 16 + h * 8;
              if (o < OUT) yr[o] = acc[mt][jn][2 * h + c];
            }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring and the row flags are free for the next item
  }
}

}  // namespace

// x_sorted [Mp, IN] bf16, q [E, OUT, IN/2] uint8 packed E2M1, s [E, OUT, S]
// bf16, the plan's row_e / owner [Mp] int32, items [n_slots, 3] int32
// (n_slots = E · ceil(Mp / 64)), n_items [1] int32 -> y [Mp, OUT] f32, every
// row written. Needs OUT % 64 == 0, IN % 64 == 0 and (IN / S) % 16 == 0.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int fp4_grouped(const void* x, const void* q, const void* s, const void* row_e,
                           const void* owner, const void* items, const void* n_items, void* y,
                           int Mp, int E, int OUT, int IN, int S, int n_slots, void* stream) {
  if (Mp <= 0 || E <= 0 || OUT <= 0 || IN <= 0 || OUT % 64 || IN % 64 || S <= 0 ||
      IN % S || (IN / S) % 16 || n_slots != E * ((Mp + kBN - 1) / kBN))
    return cudaErrorInvalidValue;
  // above 48 KB a kernel must be allowed its dynamic shared memory, once per
  // device (the call waits for the device, so not at every launch)
  constexpr int kMaxDevices = 64;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(fp4_grouped_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  // the items of sorted rows number at most E + ceil(Mp / kBN)
  const long long blocks =
      static_cast<long long>((OUT + kBM - 1) / kBM) * (E + (Mp + kBN - 1) / kBN);
  const dim3 grid(static_cast<unsigned>(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL));
  fp4_grouped_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const uint16_t*>(s), static_cast<const int*>(row_e),
      static_cast<const int*>(owner), static_cast<const int*>(items),
      static_cast<const int*>(n_items), static_cast<float*>(y), OUT, IN, S, n_slots);
  return cudaGetLastError();
}
