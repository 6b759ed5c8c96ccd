// int8 grouped expert GEMM for prefill MoE on Hopper (sm_90a), unscaled.
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/fp4_gemm.py, function
// moe_int8_grouped (body _int8_gemm_kernel; segments from tile_segments).
// Same function and numerics: x_sorted [Mp, IN] bf16, rows sorted by
// expert; y[r] = x_sorted[r] · q[e(r)]ᵀ as f32 [Mp, OUT], with q
// [E, OUT, IN] int8 codes (the int8-experts mode); the caller applies the
// per-output-channel scales. Each code is an exact bf16 value, products are
// bf16 × bf16 on the tensor cores with f32 accumulation, rows of no segment
// give 0. Exact at any routing skew: the work comes from the true group
// sizes, with no capacity factor.
//
// What bounds it: bytes. At 1,024 prompt tokens (6,144 routed rows over 256
// experts) every expert is hit, so one call streams the whole int8 stack:
// 2.15 GB for w1 (OUT 2048, IN 4096), 641 µs at 3.35 TB/s, against 103
// GFLOP (104 µs at the bf16 tensor-core peak). So each expert's codes are
// read from device memory once, and the tensor cores may run far below
// their peak.
//
// Design. The work comes from ops/cuda/int8_grouped.py::plan, made on the
// device from the segments: items of (expert, a chunk of at most kBN of its
// rows), and here each item times kBM-wide tiles of output channels, the
// output tile fastest, so the blocks of one expert run together and its x
// rows stay in L2. A block streams its expert's [kBM, IN] codes once and
// the chunk's x rows, kBK columns a stage, through a ring of kStages stages
// filled by cp.async (16 bytes a thread; no tensor map to encode on the
// host, and each x row is masked on its own: rows of another expert or of
// no segment are filled with zeros by a source size of 0). The products
// are mma.sync m16n8k16 bf16 with the operands swapped: the codes are A
// (M = output channels; [OUT, IN] rows are K-major as A wants), the rows
// are B (N), so an expert's 24 rows fill 3 n8 columns and empty columns
// are skipped. Each of the 4 warps owns 32 output channels. A thread loads
// 16 consecutive codes of a row (one 16-byte load) and converts them to
// bf16 pairs in registers (byte permute, subtraction, truncation: exact);
// the 4 codes it uses in one k16 step are physical k 16t + 4s .. + 3, taken
// as its fragment's k-slots {2t, 2t+1, 2t+8, 2t+9}, and it loads x's B
// fragment from the same physical k (a contraction is unchanged by any
// permutation of k applied to both operands). Shared rows are XOR-swizzled
// in 16-byte units so that those fragment loads are free of bank
// conflicts. 3 stages of 32 KB let two blocks share an SM. Rows are written
// once, by the item of their owner (plan.owner), as f32 straight from the
// accumulators (8 consecutive channels a lane group: whole 32-byte
// sectors).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps, 32 output channels each
constexpr int kBM = 128;       // output channels of a block (A rows)
constexpr int kBN = 64;        // routed rows of a work item (B columns)
constexpr int kBK = 128;       // k of one stage
constexpr int kStages = 3;
constexpr int kAStage = kBM * kBK;      // int8 codes, bytes
constexpr int kBStage = kBN * kBK * 2;  // bf16 x rows, bytes
constexpr int kStage = kAStage + kBStage;
constexpr int kSmem = kStages * kStage;  // 96 KB: two blocks an SM

// 4 int8 codes -> two bf16 pairs (codes 0, 1) and (codes 2, 3), exact: an
// integer in [-128, 127] has its f32 mantissa's low 16 bits zero, so the
// high half of each float is its bf16
__device__ __forceinline__ void s8x4_bf16x2(uint32_t w, uint32_t& p01, uint32_t& p23) {
  const uint32_t f0 = __float_as_uint(s8_at(w, 0)), f1 = __float_as_uint(s8_at(w, 1));
  const uint32_t f2 = __float_as_uint(s8_at(w, 2)), f3 = __float_as_uint(s8_at(w, 3));
  p01 = __byte_perm(f0, f1, 0x7632);
  p23 = __byte_perm(f2, f3, 0x7632);
}

// stage kt of a work item into its ring slot: the expert's codes for
// channels [o0, o0 + kBM) (row o at byte o·kBK, 16-byte unit c at c ^ 4(o & 1))
// and the chunk's x rows that hold data (row n at byte n·2kBK, unit c at
// c ^ (n & 1)); past OUT or IN, and rows not to load, get zeros
__device__ __forceinline__ void load_stage(uint8_t* smem, int kt, const int8_t* qe,
                                           const int8_t* q, const __nv_bfloat16* x,
                                           const int* s_load, int o0, int lo, int nt,
                                           int OUT, int IN, int tid) {
  uint8_t* As = smem + (kt % kStages) * kStage;
  uint8_t* Bs = As + kAStage;
  const int k0 = kt * kBK;
#pragma unroll
  for (int i = 0; i < kAStage / 16 / kThreads; ++i) {
    const int c = tid + i * kThreads, row = c >> 3, u = c & 7;
    const bool ok = o0 + row < OUT && k0 + u * 16 < IN;
    const int8_t* src = ok ? qe + static_cast<size_t>(o0 + row) * IN + k0 + u * 16 : q;
    cp_async16(As + row * kBK + ((u ^ ((row & 1) << 2)) << 4), src, ok);
  }
  for (int c = tid; c < nt * 8 * (kBK / 8); c += kThreads) {
    const int row = c / (kBK / 8), u = c % (kBK / 8);
    const bool ok = s_load[row] && k0 + u * 8 < IN;
    const __nv_bfloat16* src = ok ? x + static_cast<size_t>(lo + row) * IN + k0 + u * 8 : x;
    cp_async16(Bs + row * (2 * kBK) + ((u ^ (row & 1)) << 4), src, ok);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
int8_grouped_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                    const int* __restrict__ row_e, const int* __restrict__ owner,
                    const int* __restrict__ items, const int* __restrict__ n_items,
                    float* __restrict__ y, int OUT, int IN, int n_slots) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_load[kBN], s_write[kBN];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_ot = (OUT + kBM - 1) / kBM;
  const int KT = (IN + kBK - 1) / kBK;
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
    const int8_t* qe = q + static_cast<size_t>(e) * OUT * IN;

    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][jn][i] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KT) load_stage(smem, s, qe, q, x, s_load, o0, lo, nt, OUT, IN, tid);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
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
            const uint4 raw = *reinterpret_cast<const uint4*>(
                As + row * kBK + (((kg * 4 + t) ^ ((row & 1) << 2)) << 4));
            const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int s = 0; s < 4; ++s) s8x4_bf16x2(wd[s], a[mt][s][h], a[mt][s][2 + h]);
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
            for (int s = 0; s < 4; ++s)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                mma_bf16(acc[mt][jn], a[mt][s], bw[2 * s], bw[2 * s + 1]);
          }
        }
      }
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
              const int o = o0 + warp * 32 + mt * 16 + h * 8 + g;
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

// x_sorted [Mp, IN] bf16, q [E, OUT, IN] int8, the plan's row_e / owner [Mp]
// int32, items [n_slots, 3] int32 (n_slots = E · ceil(Mp / 64)), n_items [1]
// int32 -> y [Mp, OUT] f32, unscaled, every row written. Needs OUT % 64 == 0
// and IN % 64 == 0. Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for a shape it does not take.
extern "C" int int8_grouped(const void* x, const void* q, const void* row_e,
                            const void* owner, const void* items, const void* n_items,
                            void* y, int Mp, int E, int OUT, int IN, int n_slots,
                            void* stream) {
  if (Mp <= 0 || E <= 0 || OUT <= 0 || IN <= 0 || OUT % 64 || IN % 64 ||
      n_slots != E * ((Mp + kBN - 1) / kBN))
    return cudaErrorInvalidValue;
  // above 48 KB a kernel must be allowed its dynamic shared memory, once per
  // device (the call waits for the device, so not at every launch)
  constexpr int kMaxDevices = 64;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(int8_grouped_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  // the items of sorted rows number at most E + ceil(Mp / kBN)
  const long long blocks =
      static_cast<long long>((OUT + kBM - 1) / kBM) * (E + (Mp + kBN - 1) / kBN);
  const dim3 grid(static_cast<unsigned>(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL));
  int8_grouped_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const int*>(row_e), static_cast<const int*>(owner),
      static_cast<const int*>(items), static_cast<const int*>(n_items),
      static_cast<float*>(y), OUT, IN, n_slots);
  return cudaGetLastError();
}
