// Causal GQA flash attention for prefill on Hopper (sm_90a), bf16 in.
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/flash_prefill.py:114,
// flash_attention (_kernel; flash_prefill is its q_offset = 0 form). Same
// function: queries q[T, Hq, hd] sit at absolute positions q_offset + i and
// attend to keys k/v[S, Hkv, hd] at positions <= their own and below
// kv_valid. q·kᵀ runs in bf16 with f32 accumulation and is then scaled, the
// online softmax runs in f32, and p is rounded to bf16 before P·V. Rows at
// or past kv_valid hold garbage.
//
// What bounds it: operations. At T = S = 1024, Hq 32, hd 128 the causal
// products need 8.6 GFLOP (2 products x 2 x hd x Hq x T(T+1)/2), 8.69 us at
// 989 TFLOP/s, while the inputs and the output are 21 MB, 6.3 us at
// 3.35 TB/s. So the tensor cores have to be kept fed, and only wgmma reaches
// their full rate. The design, written for this card and not carried over
// from the Pallas grid (Hkv, T/tq, S/tk) with scratch carried across it:
//
// - Tiles. One block works on one (query tile, kv head) pair: 128 rows, all
//   G heads of the group for BQ = 128 / G positions (row r = t·G + g), so each
//   K/V tile is read once for the whole group. Two consumer warpgroups own 64
//   rows each; a ninth warp is the producer. Key tiles are BK = 128 keys at
//   hd 64 and 128; at hd 256 the output alone takes 128 registers a thread,
//   so BK = 64 there.
// - Products. S = Q·Kᵀ is wgmma with Q and K both in shared memory, 128-byte
//   swizzled. O += P·V is wgmma with P from registers: the S accumulator,
//   rescaled and rounded to bf16, is reused as the A fragment (its layout is
//   the A layout), and V comes from shared memory through the transposed-B
//   form. O, m and l stay in registers for the whole loop. The two
//   warpgroups take turns on the tensor cores (named barriers), so one's
//   softmax runs while the other's product does; the softmax works in base
//   2, p = 2^(s·scale·log2 e − m) in one FFMA and one ex2.
// - Copies. The producer issues tensor-map TMA loads that complete on
//   mbarriers: Q once, K and V through a ring of STAGES tiles (K and V of a
//   tile on separate barriers, so S can start while V lands), each stage
//   released by the consumer warps through an "empty" barrier. A 3-D map
//   over [T, Hq, hd] with a box of 64 columns x G heads x BQ positions gives
//   the packed (position, head) tile directly; with the 128-byte swizzle a
//   box is at most 64 bf16 wide, so Q, K and V come in hd / 64 slabs and the
//   wgmma descriptors step across them. The maps over K and V end at
//   min(kv_valid, S) rows, so their zero fill replaces the hand masking of
//   ragged edges and keeps garbage past kv_valid out of P·V.
// - Masking and order. Only tiles that cross the block's first row's
//   position or kv_valid are masked, by a second instance of the loop body
//   (a mask tested per element in every tile took half the kernel's time).
//   The grid runs the longest query tiles first, so the last wave holds the
//   short causal rows.
// - Epilogue. O is normalised by l in registers, written as bf16 into Q's
//   shared memory (each warpgroup over its own rows) and stored with TMA,
//   which drops the rows past T.
//
// The host side builds the four CUtensorMaps per call (cuTensorMapEncodeTiled
// through cudaGetDriverEntryPoint, so the library needs no -lcuda) and passes
// them as __grid_constant__ parameters. The launch plan (BQ, BK, the number
// of query tiles) comes from ops/cuda/flash_prefill.py::plan and is checked
// here against the tile sizes this file was built with.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRows = 128;                 // query (position, head) rows of a block
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kSlab = 64;                  // bf16 columns of one 128-byte swizzled row
constexpr int kMaxDevices = 64;

template <int HD>
struct Cfg {
  static constexpr int BK = HD == 256 ? 64 : 128;  // keys a tile
  static constexpr int STAGES = 2;                 // K/V ring depth
  static constexpr int NS = HD / kSlab;            // 64-column slabs of hd
  static constexpr int NO = HD < 128 ? HD : 128;   // O columns of one P·V wgmma
  static constexpr int NC = HD / NO;               // O chunks
  static constexpr int Q_SLAB = kRows * 128;       // bytes
  static constexpr int KV_SLAB = BK * 128;
  static constexpr int Q_BYTES = NS * Q_SLAB;
  static constexpr int KV_BYTES = NS * KV_SLAB;  // one tile of K (or of V)
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // barriers: q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]; and
  // the slack that aligns the tiles to 1024 bytes (the swizzle's period)
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout SW128
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
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// named barrier `id` over the two consumer warpgroups: sync waits for the
// other warpgroup's arrival, arrive does not wait
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <bool B>
struct Masked {
  static constexpr bool value = B;
};

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma and its wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64nNk16 bf16 -> f32. The accumulator of a thread holds, for each 8-column
// chunk j, (row g, cols 8j + 2t, +1) in d[4j], d[4j+1] and (row g + 8, same
// cols) in d[4j+2], d[4j+3], with g = lane / 4 + 16 x warp of the warpgroup
// and t = lane % 4.
template <int N>
struct Mma;

template <>
struct Mma<64> {
  // d (+)= A . B over one k16 step: A [64 x 16] and B [64 x 16] K-major in
  // shared memory; acc = 0 overwrites d
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  // d += A . B over one k16 step: A [64 x 16] in registers, B [16 x 64]
  // MN-major in shared memory (the transposed-B form)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  // d (+)= A . B over one k16 step: A [64 x 16] and B [128 x 16] K-major in
  // shared memory; acc = 0 overwrites d
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
  // d += A . B over one k16 step: A [64 x 16] in registers, B [16 x 128]
  // MN-major in shared memory (the transposed-B form)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap map_q,  // [T, Hq, HD]
                     const __grid_constant__ CUtensorMap map_k,  // [kv rows, Hkv, HD]
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o,  // [T, Hq, HD]
                     int T, int Hkv, int G, int q_tiles, int kv_lim, int q_offset,
                     float scale) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sq = base, sk = base + C::K_OFF, sv = base + C::V_OFF;
  const uint32_t q_full = base + C::BAR_OFF;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + C::STAGES + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * C::STAGES + s); };

  const int BQ = kRows / G;
  const int qt = q_tiles - 1 - static_cast<int>(blockIdx.x) / Hkv;  // longest rows first
  const int h = static_cast<int>(blockIdx.x) % Hkv;
  const int q0 = qt * BQ;
  const int q_lo = q_offset + q0;                   // position of the block's first row
  const int q_hi = q_offset + min(q0 + BQ, T) - 1;  // and of its last row below T
  const int kv_hi = min(kv_lim, q_hi + 1);
  const int n_tiles = kv_hi > 0 ? (kv_hi + BK - 1) / BK : 0;
  // tiles [0, n_full) lie wholly at or below the first row's position and
  // below kv_lim: no mask (tests/test_torch_flash_prefill_plan.py holds the rule)
  const int n_full = max(0, min((q_lo + 1) / BK, kv_lim / BK));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp: one thread issues every copy
    if (lane == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int s = 0; s < C::NS; ++s) tma_load(sq + s * C::Q_SLAB, &map_q, s * kSlab, h * G, q0, q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % C::STAGES;
        if (j >= C::STAGES) mbar_wait(empty(st), (j / C::STAGES - 1) & 1);
        mbar_expect_tx(k_full(st), C::KV_BYTES);
        for (int s = 0; s < C::NS; ++s)
          tma_load(sk + st * C::KV_BYTES + s * C::KV_SLAB, &map_k, s * kSlab, h, j * BK, k_full(st));
        mbar_expect_tx(v_full(st), C::KV_BYTES);
        for (int s = 0; s < C::NS; ++s)
          tma_load(sv + st * C::KV_BYTES + s * C::KV_SLAB, &map_v, s * kSlab, h, j * BK, v_full(st));
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64); this thread rows
  // r0 and r0 + 8, columns 8j + 2t and 8j + 2t + 1 of every 8-column chunk
  const int wg = warp / 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int t4 = lane % 4;
  const int pos0 = q_lo + r0 / G, pos1 = q_lo + (r0 + 8) / G;
  const uint32_t q_rows = sq + wg * 64 * 128;  // this warpgroup's rows of slab 0
  const float sl2 = scale * 1.4426950408889634f;  // scores to the base-2 exponent

  float o[C::NC][C::NO / 2];
#pragma unroll
  for (int c = 0; c < C::NC; ++c)
#pragma unroll
    for (int i = 0; i < C::NO / 2; ++i) o[c][i] = 0.f;
  // running max (of score x scale x log2 e) and this thread's share of the
  // row sums
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  float l0 = 0.f, l1 = 0.f;

  // The warpgroups take turns on the tensor cores: each issues a product
  // only in its turn and passes the turn on right after, so one's softmax
  // runs while the other's product does. Turn w is named barrier 2 + w,
  // synced by warpgroup w and arrived at by the other; warpgroup 1 opens
  // warpgroup 0's first turn and takes no turn after its last product.
  auto my_turn = [&] { named_sync(2 + wg); };
  auto pass_turn = [&] { named_arrive(3 - wg); };
  if (wg == 1 && n_tiles > 0) named_arrive(2);
  mbar_wait(q_full, 0);

  auto step = [&](int j, auto masked) {
    const int st = j % C::STAGES;
    const uint32_t par = (j / C::STAGES) & 1;

    // S = Q · Kᵀ: hd / 16 k-steps, stepping 32 bytes within a slab
    float s[BK / 2];
    mbar_wait(k_full(st), par);
    my_turn();
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < C::NS; ++sl)
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk)
        Mma<BK>::ss(s, sw128_desc(q_rows + sl * C::Q_SLAB + kk * 32, 16, 1024),
                    sw128_desc(sk + st * C::KV_BYTES + sl * C::KV_SLAB + kk * 32, 16, 1024),
                    sl | kk);
    wgmma_commit();
    pass_turn();
    wgmma_wait();
    reg_fence(s);

    // the causal and kv_valid mask, on the tiles that cross them
    if constexpr (decltype(masked)::value) {
      const int k0 = j * BK + 2 * t4;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int key = k0 + (i / 4) * 8 + (i & 1);
        if (key > ((i & 2) ? pos1 : pos0) || key >= kv_lim) s[i] = -CUDART_INF_F;
      }
    }

    // online softmax in base 2: row max over the quad (scale > 0 keeps the
    // order), rescale factors, p = 2^(s x sl2 - m) in one FFMA and one ex2
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if (i & 2)
        mx1 = fmaxf(mx1, s[i]);
      else
        mx0 = fmaxf(mx0, s[i]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
    const float b0 = mn0 == -CUDART_INF_F ? 0.f : mn0;  // no valid key yet: p = 0
    const float b1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float c0 = ex2(m0 - b0), c1 = ex2(m1 - b1);  // 0 while m is -inf
    m0 = mn0;
    m1 = mn1;
    // p as the A fragment of P·V: k16 step kk covers S chunks 2kk and 2kk + 1
    uint32_t p[BK / 16][4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        const float bb = (e & 1) ? b1 : b0;
        const float x = ex2(fmaf(s[i], sl2, -bb)), y = ex2(fmaf(s[i + 1], sl2, -bb));
        if (e & 1)
          sum1 += x + y;
        else
          sum0 += x + y;
        p[kk][e] = pack_bf16x2(x, y);
      }
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
#pragma unroll
      for (int i = 0; i < C::NO / 2; ++i) o[c][i] *= (i & 2) ? c1 : c0;

    // O += P · V: V MN-major, LBO steps across the slabs of a chunk, each
    // k-step 16 keys (2048 bytes) down
    mbar_wait(v_full(st), par);
#pragma unroll
    for (int c = 0; c < C::NC; ++c) reg_fence(o[c]);
    my_turn();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < C::NC; ++c)
        Mma<C::NO>::rs(o[c], p[kk],
                       sw128_desc(sv + st * C::KV_BYTES + c * (C::NO / kSlab) * C::KV_SLAB +
                                      kk * 16 * 128,
                                  C::KV_SLAB, 1024));
    wgmma_commit();
    if (wg == 0 || j + 1 < n_tiles) pass_turn();
    wgmma_wait();
#pragma unroll
    for (int c = 0; c < C::NC; ++c) reg_fence(o[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };
  // the unmasked tiles, then those that cross the diagonal or kv_valid
  const int n_plain = min(n_full, n_tiles);
  for (int j = 0; j < n_plain; ++j) step(j, Masked<false>{});
  for (int j = n_plain; j < n_tiles; ++j) step(j, Masked<true>{});

  // normalise, write bf16 into this warpgroup's rows of Q's shared memory in
  // the swizzled layout of the map, then one TMA store of the block's rows
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int c = 0; c < C::NC; ++c)
#pragma unroll
    for (int i = 0; i < C::NO / 2; i += 2) {
      const int col = c * C::NO + (i / 4) * 8 + 2 * t4;
      const int row = (i & 2) ? r0 + 8 : r0;
      const float inv = (i & 2) ? inv1 : inv0;
      const int x = col % kSlab;
      const int off = (col / kSlab) * C::Q_SLAB + row * 128 + (((x / 8) ^ (row % 8)) * 16) +
                      (x % 8) * 2;
      *reinterpret_cast<uint32_t*>(gbase + off) = pack_bf16x2(o[c][i] * inv, o[c][i + 1] * inv);
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::NS; ++s) tma_store(&map_o, sq + s * C::Q_SLAB, s * kSlab, h * G, q0);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the map of a [rows, heads, HD] bf16 tensor in boxes of 64 columns x
// box_heads heads x box_rows rows, 128-byte swizzled, zero past its rows
cudaError_t encode(CUtensorMap* map, const void* ptr, int rows, int heads, int HD, int box_heads,
                   int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HD) * 2,
                                 static_cast<cuuint64_t>(heads) * HD * 2};
  const cuuint32_t box[3] = {kSlab, static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int T, S, Hkv, G, kv_valid, q_offset, q_tiles;
  float scale;
};

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<HD>;
  static_assert(C::SMEM <= 232448, "shared memory of one block");
  // above 48 KB a kernel must be allowed its dynamic shared memory, once per
  // instance and device
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(flash_prefill_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  const int Hq = a.Hkv * a.G, BQ = kRows / a.G;
  const int kv_lim = a.kv_valid < a.S ? a.kv_valid : a.S;
  const int kv_rows = kv_lim > 1 ? kv_lim : 1;  // a map needs one row
  CUtensorMap mq, mk, mv, mo;
  if ((err = encode(&mq, a.q, a.T, Hq, HD, a.G, BQ)) != cudaSuccess) return err;
  if ((err = encode(&mk, a.k, kv_rows, a.Hkv, HD, 1, C::BK)) != cudaSuccess) return err;
  if ((err = encode(&mv, a.v, kv_rows, a.Hkv, HD, 1, C::BK)) != cudaSuccess) return err;
  if ((err = encode(&mo, a.out, a.T, Hq, HD, a.G, BQ)) != cudaSuccess) return err;
  flash_prefill_kernel<HD><<<a.q_tiles * a.Hkv, kThreads, C::SMEM, stream>>>(
      mq, mk, mv, mo, a.T, a.Hkv, a.G, a.q_tiles, kv_lim, a.q_offset, a.scale);
  return cudaGetLastError();
}

template <int HD>
bool plan_ok(const Args& a, int bq, int bk) {
  return bk == Cfg<HD>::BK && bq * a.G == kRows && a.q_tiles == (a.T + bq - 1) / bq;
}

}  // namespace

// bq, bk and q_tiles are the launch plan of ops/cuda/flash_prefill.py::plan
// (positions a query tile, keys a key tile, query tiles). Returns
// cudaGetLastError() after the launch (0 = launched), cudaErrorInvalidValue
// for a head dim, group size or plan it does not take or a tensor map that
// does not encode, cudaErrorNotSupported without cuTensorMapEncodeTiled.
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v, void* out, int T,
                                  int S, int Hkv, int G, int HD, int kv_valid, int q_offset,
                                  float scale, int bq, int bk, int q_tiles, void* stream) {
  if (T < 1 || S < 1 || Hkv < 1 || G < 1 || kRows % G != 0 || q_offset < 0)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, out, T, S, Hkv, G, kv_valid, q_offset, q_tiles, scale};
  auto st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 64: return plan_ok<64>(a, bq, bk) ? launch<64>(a, st) : cudaErrorInvalidValue;
    case 128: return plan_ok<128>(a, bq, bk) ? launch<128>(a, st) : cudaErrorInvalidValue;
    case 256: return plan_ok<256>(a, bq, bk) ? launch<256>(a, st) : cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}
