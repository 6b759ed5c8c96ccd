// Fused packed-fp4 routed-expert chain for DeepSeek-V4 decode on Hopper
// (sm_90a): one launch per layer computes, for every routed row m with
// expert e = idx[m],
//   g = x[m] · dequant(w1[e])ᵀ,  u = x[m] · dequant(w3[e])ᵀ,
//   g = min(g, limit), u = clamp(u, -limit, limit)   (when limit > 0),
//   act = bf16(silu(g) · u),
//   y[m] = act · dequant(w2[e])ᵀ.
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/fp4_gemm.py, function
// moe_fp4_chain (body _fp4_chain_kernel). Same function and numerics as
// three K3 calls (csrc/fp4_gemv.cu) with the SwiGLU between: x [M, D] in
// bf16; w1 / w3 [E, I, D/2] and w2 [E, D, I/2] hold two E2M1 codes a byte
// with bf16 group scales s1 / s3 [E, I, S1] and s2 [E, D, S2]; each weight
// is bf16(f32(code) · scale), products of bf16 values summed in f32, act
// rounded to bf16, y f32 [M, D]; a row whose expert id lies outside [0, E)
// gives 0.
//
// perm13: without it, packed byte k of a w2 row holds act[2k] (low nibble)
// and act[2k + 1]. With it, the caller permuted the rows of w1 / w3 / s1 /
// s3 to evens then odds, so act lands in that order and byte k holds
// act[k] and act[k + I/2]. On this card that is a pairing of act's two
// halves in phase 2's B fragments; the TPU kernel's one-hot de-interleave
// matmuls have no counterpart.
//
// What bounds it: bytes. Each distinct routed expert's three packed
// matrices and their scales are read once: 3 · I · D / 2 bytes plus
// 3 · I · D / 16 of bf16 scales at 32-wide groups (14.2 MB at I 2048, D
// 4096), 84.9 MB for the 6 experts of a B = 1 step, 25 µs at 3.35 TB/s; the
// products (0.3 GFLOP) are nothing to the tensor cores. On an H100 the
// earlier design (one warp a (row, channel), a table decode, FFMA chains)
// took 162-170 µs at B = 1, and its loads alone 157-160 of them: phase 1
// alone took 48 µs, so phase 2, whose tasks each read 1 KB of w2 against
// the whole 4 KB act row from L2, took about 115; the table and the bf16
// rounding of each weight cost about 12 µs together (scripts/k9_study.py).
// This design takes 56 µs there (45% of the bound): its loads alone take
// 43 µs, phase 1 alone 38 with the barrier's 4, the decode 10 and the
// scale loads 6. More warps do not lift the loads: three blocks an SM
// (80 registers) gain 6% on the loads alone and spill as a whole (76 µs).
// With 128 registers a thread, one step of loads ahead is what fits:
// holding the next step's B fragment as well spilled and gained nothing,
// and a 4-stage cp.async ring in shared memory (which leaves L1 little
// room for x) took 67 µs.
//
// Design: int8_chain.cu's frame (one cooperative launch of as many blocks
// as fit on the SMs at once, two phases, one grid barrier) with
// fp4_grouped.cu's products (K5). Every block reads idx into shared memory
// and groups the rows by expert: the distinct valid experts in order of
// first appearance, each with its rows, so each expert's weights stream
// from device memory once whatever the number of rows routed to it, and
// those rows are the N columns of mma.sync m16n8k16 products with the
// decoded weights as A (a second n8 column only past 8 rows). A work item
// is (expert, one A tile pair): in phase 1 the same 16 channels of w1 and
// of w3 against x, in phase 2 32 channels of w2 (two m16 tiles) against
// act. The block's 8 warps split the contraction into 128-wide steps (warp
// w takes steps w, w + 8, ...), and their partial sums meet in shared
// memory in a fixed order. A step loads, for each of 4 A rows (two tiles,
// rows g and g + 8), a thread's 32 consecutive codes straight into
// registers (one 16-byte load under one scale: groups are multiples of
// 32), with the next step's codes and scales loaded before this step's
// products, so about 32 KB of weights are in flight an SM; each weight is
// used once, so nothing is staged in shared memory or kept in L1. The codes decode with K5's
// table-free e2m1x8_bf16x2 (common.cuh) straight into bf16x2 A registers:
// byte 2s of the run holds k16 step s's k-slots {2t, 2t+1}, byte 2s + 1
// those of {2t+8, 2t+9}, and the B fragment comes from the same physical
// k (a contraction is unchanged by any permutation of k applied to both
// operands): x's or act's 32 consecutive values of the run, or, with
// perm13, act's 16 values of the run paired with the 16 at I/2 by a byte
// permute. Phase 1 ends with the clamped SwiGLU on the summed g and u, and
// act is written once as bf16 to the scratch buffer (read from L2 after
// the barrier); phase 2 writes each y element once, as f32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 16;
constexpr int kCh = 16;  // channels of one A tile (mma m16)
constexpr int kK = 128;  // k of one step: 32 codes (16 bytes) a thread a row

// the distinct valid experts of idx in order of first appearance, each with
// its rows in order
struct Groups {
  int n;
  int expert[kMaxRows];
  int count[kMaxRows];
  int rows[kMaxRows][kMaxRows];
};

// one step of a thread: the 16-byte code runs of A rows g and g + 8 of two
// tiles (a[2 mt + h]: tile mt, row g + 8h) and their scales in both halves
struct Step {
  uint4 a[4];
  uint32_t s[4];
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// c[mt][nt] += tile mt's decoded step · B column tile nt, for the 8 k16
// steps of a 128-wide step; b[nt][2s], b[nt][2s + 1] are step s's B
// registers
__device__ __forceinline__ void mma_step(float (*c)[2][4], const Step& st,
                                         uint32_t (*b)[16], int ntl) {
#pragma unroll
  for (int wi = 0; wi < 4; ++wi) {  // word wi of each run: k16 steps 2wi, 2wi + 1
    uint32_t r[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) e2m1x8_bf16x2(word(st.a[q], wi), st.s[q], r[q]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 2 * wi + h;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t a[4] = {r[2 * mt][2 * h], r[2 * mt + 1][2 * h], r[2 * mt][2 * h + 1],
                               r[2 * mt + 1][2 * h + 1]};
        mma_bf16(c[mt][0], a, b[0][2 * s], b[0][2 * s + 1]);
        if (ntl > 1) mma_bf16(c[mt][1], a, b[1][2 * s], b[1][2 * s + 1]);
      }
    }
  }
}

// the 32 bf16 values at v of one B column as 16 registers
template <bool kCached>
__device__ __forceinline__ void load_b32(uint32_t* b, const __nv_bfloat16* v) {
  const uint4* p = reinterpret_cast<const uint4*>(v);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 w = kCached ? __ldg(p + q) : __ldcg(p + q);
    b[4 * q] = w.x;
    b[4 * q + 1] = w.y;
    b[4 * q + 2] = w.z;
    b[4 * q + 3] = w.w;
  }
}

// perm13: byte j of the run holds act[j] (low nibble) and act[I/2 + j]
// (high) of the run's 16 values lo[0..16) and hi[0..16), so step s's B
// registers pair lo[2s] with hi[2s] and lo[2s + 1] with hi[2s + 1]
__device__ __forceinline__ void load_b_perm13(uint32_t* b, const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  const uint4* pl = reinterpret_cast<const uint4*>(lo);
  const uint4* ph = reinterpret_cast<const uint4*>(hi);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint4 l = __ldcg(pl + q), h = __ldcg(ph + q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * q + i;
      b[2 * s] = prmt(word(l, i), word(h, i), 0x5410u);
      b[2 * s + 1] = prmt(word(l, i), word(h, i), 0x7632u);
    }
  }
}

// one thread's run of 32 codes: read once, so not kept in L1, and L2 asked
// to fetch the 256 bytes around it, which the block's other warps read
// next (about 2% less time on an H100 than __ldg, scripts/k9_study.py)
__device__ __forceinline__ uint4 ld_codes(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// step f of a warp's sequence of the work: item f / nk of the block, step
// warp + kWarps (f % nk) of the contraction. Tile 0 is A rows [r0, r0 + 16)
// of (qa, sa); tile 1 the same rows of (qb, sb) for phase 1 (kItemCh 16),
// the next 16 rows of (qa, sa) for phase 2 (kItemCh 32)
template <int kItemCh>
__device__ __forceinline__ void load_step(Step& st, int f, int nk, int tiles, int OUT,
                                          int rowb, int S, int grp, const Groups& gr,
                                          const uint8_t* __restrict__ qa,
                                          const uint16_t* __restrict__ sa,
                                          const uint8_t* __restrict__ qb,
                                          const uint16_t* __restrict__ sb) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  const int w = blockIdx.x + (f / nk) * gridDim.x;
  const int kb = warp + (f % nk) * kWarps;
  const size_t r0 = static_cast<size_t>(gr.expert[w / tiles]) * OUT + (w % tiles) * kItemCh + g;
  const bool split = kItemCh == 2 * kCh;
  const size_t r1 = split ? r0 + kCh : r0;
  const uint8_t* q1 = split ? qa : qb;
  const uint16_t* s1 = split ? sa : sb;
  const int byte = kb * (kK / 2) + 16 * t, j = (kb * kK + 32 * t) / grp;
  st.a[0] = ld_codes(qa + r0 * rowb + byte);
  st.a[1] = ld_codes(qa + (r0 + 8) * rowb + byte);
  st.a[2] = ld_codes(q1 + r1 * rowb + byte);
  st.a[3] = ld_codes(q1 + (r1 + 8) * rowb + byte);
  st.s[0] = __ldg(sa + r0 * S + j) * 0x10001u;
  st.s[1] = __ldg(sa + (r0 + 8) * S + j) * 0x10001u;
  st.s[2] = __ldg(s1 + r1 * S + j) * 0x10001u;
  st.s[3] = __ldg(s1 + (r1 + 8) * S + j) * 0x10001u;
}

// One phase over the block's work items. Phase 1 (kPhase2 false): A tiles
// the same 16 channels of w1 (qa, sa) and w3 (qb, sb) against x, over D;
// act[row, o] = bf16(silu(g) · u). Phase 2: A tiles two halves of 32
// channels of w2 (qa, sa) against act, over I; y[row, d] in f32.
template <bool kPhase2, bool kPerm13>
__device__ __forceinline__ void run_phase(const Groups& gr, float (*red)[2][kCh][kMaxRows],
                                          const __nv_bfloat16* __restrict__ x,
                                          const uint8_t* __restrict__ qa,
                                          const uint16_t* __restrict__ sa,
                                          const uint8_t* __restrict__ qb,
                                          const uint16_t* __restrict__ sb,
                                          __nv_bfloat16* act, float* __restrict__ y, int I,
                                          int D, int S, float limit) {
  constexpr int kItemCh = kPhase2 ? 2 * kCh : kCh;  // channels of a work item
  const int OUT = kPhase2 ? D : I, K = kPhase2 ? I : D;
  const int tiles = OUT / kItemCh, n_items = gr.n * tiles;
  const int KB = K / kK, grp = K / S, rowb = K / 2;  // steps, group width, row bytes
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nk = warp < KB ? (KB - 1 - warp) / kWarps + 1 : 0;  // this warp's steps an item
  const int mine = blockIdx.x < n_items ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * nk;

  Step cur, nxt;
  if (total > 0) load_step<kItemCh>(cur, 0, nk, tiles, OUT, rowb, S, grp, gr, qa, sa, qb, sb);
  int f = 0;
  for (int it = 0; it < mine; ++it) {
    const int w = blockIdx.x + it * gridDim.x;
    const int ex = w / tiles, o0 = (w % tiles) * kItemCh;
    const int cnt = gr.count[ex], ntl = (cnt + 7) >> 3;
    const int* rows = gr.rows[ex];
    float c[2][2][4] = {};
    for (int i = 0; i < nk; ++i, ++f) {
      if (f + 1 < total)
        load_step<kItemCh>(nxt, f + 1, nk, tiles, OUT, rowb, S, grp, gr, qa, sa, qb, sb);
      const int k0 = (warp + i * kWarps) * kK;
      uint32_t b[2][16];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = nt * 8 + g;  // this thread's B column
        if (n < cnt) {
          if constexpr (!kPhase2) {
            load_b32<true>(b[nt], x + static_cast<size_t>(rows[n]) * D + k0 + 32 * t);
          } else if constexpr (!kPerm13) {
            load_b32<false>(b[nt], act + static_cast<size_t>(rows[n]) * I + k0 + 32 * t);
          } else {
            const __nv_bfloat16* ar = act + static_cast<size_t>(rows[n]) * I + k0 / 2 + 16 * t;
            load_b_perm13(b[nt], ar, ar + I / 2);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 16; ++q) b[nt][q] = 0u;
        }
      }
      mma_step(c, cur, b, ntl);
      cur = nxt;
    }
    // c[mt][nt][2h + p]: channel g + 8h of tile mt, column nt·8 + 2t + p
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[warp][mt][g + 8 * (i >> 1)][nt * 8 + 2 * t + (i & 1)] = c[mt][nt][i];
    __syncthreads();
    for (int o = tid; o < kItemCh * kMaxRows; o += kThreads) {
      const int col = o / kItemCh, ch = o % kItemCh;
      if (col >= cnt) continue;
      if constexpr (!kPhase2) {
        float gs = 0.f, us = 0.f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) {
          gs += red[wp][0][ch][col];
          us += red[wp][1][ch][col];
        }
        if (limit > 0.f) {
          gs = fminf(gs, limit);
          us = fminf(fmaxf(us, -limit), limit);
        }
        act[static_cast<size_t>(rows[col]) * I + o0 + ch] =
            __float2bfloat16_rn(1.f / (1.f + expf(-gs)) * gs * us);
      } else {
        float acc = 0.f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) acc += red[wp][ch / kCh][ch % kCh][col];
        y[static_cast<size_t>(rows[col]) * D + o0 + ch] = acc;
      }
    }
    __syncthreads();  // red is free for the next item
  }
}

template <bool kPerm13>
__global__ void __launch_bounds__(kThreads, 2)
fp4_chain_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ w1, const uint16_t* __restrict__ s1,
                 const uint8_t* __restrict__ w3, const uint16_t* __restrict__ s3,
                 const uint8_t* __restrict__ w2, const uint16_t* __restrict__ s2,
                 const int* __restrict__ idx, __nv_bfloat16* act,
                 float* __restrict__ y, int M, int E, int I, int D, int S1, int S2,
                 float limit) {
  __shared__ Groups gr;
  __shared__ float red[kWarps][2][kCh][kMaxRows];
  __shared__ int ids[kMaxRows], first[kMaxRows];
  // the grouping, a thread a row: row m's column among its expert's rows,
  // and whether it is the expert's first row; then the expert's place
  // among the first rows in order
  const int m = threadIdx.x;
  int e = -1, col = 0;
  if (m < M) ids[m] = e = idx[m];
  __syncthreads();
  const bool valid = m < M && e >= 0 && e < E;
  if (m < M) {
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k)
      if (k < m && ids[k] == e) ++col;
    first[m] = valid && col == 0;
  }
  __syncthreads();
  if (valid) {
    int j = 0, cnt = 0, j_first = 0;
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k) {
      if (k < M && ids[k] == e) {
        if (cnt++ == 0) j_first = j;  // the expert's place: first rows before its own
      }
      if (k < M) j += first[k];
    }
    gr.rows[j_first][col] = m;
    if (col == 0) {
      gr.expert[j_first] = e;
      gr.count[j_first] = cnt;
    }
  }
  if (m == 0) {
    int n = 0;
    for (int k = 0; k < M; ++k) n += first[k];
    gr.n = n;
  }
  __syncthreads();
  // rows of no expert are 0
  for (int r = 0; r < M; ++r) {
    if (ids[r] >= 0 && ids[r] < E) continue;
    for (int d = blockIdx.x * kThreads + threadIdx.x; d < D; d += gridDim.x * kThreads)
      y[static_cast<size_t>(r) * D + d] = 0.f;
  }

  run_phase<false, kPerm13>(gr, red, x, w1, s1, w3, s3, act, y, I, D, S1, limit);
  cg::this_grid().sync();
  run_phase<true, kPerm13>(gr, red, x, w2, s2, nullptr, nullptr, act, y, I, D, S2, limit);
}

template <bool kPerm13>
int launch(const void* x, const void* w1, const void* s1, const void* w3, const void* s3,
           const void* w2, const void* s2, const void* idx, void* act, void* y, int M,
           int E, int I, int D, int S1, int S2, float limit, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fp4_chain_kernel<kPerm13>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // at most every row its own expert: M work items of I / 16 (phase 1) or
  // D / 32 (phase 2) a row; every block reaches the grid barrier
  const long long most = static_cast<long long>(M) * (I / kCh > D / (2 * kCh)
                                                          ? I / kCh : D / (2 * kCh));
  const int blocks = static_cast<int>(most < 1LL * sms * per_sm ? most : 1LL * sms * per_sm);

  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* w1p = static_cast<const uint8_t*>(w1);
  const uint8_t* w3p = static_cast<const uint8_t*>(w3);
  const uint8_t* w2p = static_cast<const uint8_t*>(w2);
  const uint16_t* s1p = static_cast<const uint16_t*>(s1);
  const uint16_t* s3p = static_cast<const uint16_t*>(s3);
  const uint16_t* s2p = static_cast<const uint16_t*>(s2);
  const int* idxp = static_cast<const int*>(idx);
  __nv_bfloat16* actp = static_cast<__nv_bfloat16*>(act);
  float* yp = static_cast<float*>(y);
  void* args[] = {&xp, &w1p, &s1p, &w3p, &s3p, &w2p, &s2p, &idxp, &actp, &yp,
                  &M, &E, &I, &D, &S1, &S2, &limit};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fp4_chain_kernel<kPerm13>),
                                    dim3(blocks), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x [M, D] bf16; w1 / w3 [E, I, D/2] and w2 [E, D, I/2] packed uint8; s1 /
// s3 [E, I, S1] and s2 [E, D, S2] bf16; idx [M] int32; act [M, I] bf16
// scratch -> y [M, D] f32, every row written. Needs 1 <= M <= 16, D and I
// multiples of 128, scale groups D/S1 and I/S2 multiples of 32, 16-byte
// aligned x, act and weights; a row whose expert id lies outside [0, E)
// gives 0. Returns the cooperative launch's error (0 = launched), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int fp4_chain(const void* x, const void* w1, const void* s1, const void* w3,
                         const void* s3, const void* w2, const void* s2, const void* idx,
                         void* act, void* y, int M, int E, int I, int D, int S1, int S2,
                         float limit, int perm13, void* stream) {
  if (M < 1 || M > kMaxRows || I < kK || D < kK || I % kK || D % kK || S1 < 1 ||
      S2 < 1 || D % S1 || I % S2 || (D / S1) % 32 || (I / S2) % 32)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (perm13)
    return launch<true>(x, w1, s1, w3, s3, w2, s2, idx, act, y, M, E, I, D, S1, S2, limit,
                        st);
  return launch<false>(x, w1, s1, w3, s3, w2, s2, idx, act, y, M, E, I, D, S1, S2, limit,
                       st);
}
