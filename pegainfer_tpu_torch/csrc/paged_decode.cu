// Paged GQA decode attention for Hopper (sm_90a), bf16 in, f32 softmax,
// with the context split across blocks (split-KV).
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/paged_decode.py,
// function paged_attention_decode (_kernel / _head). Same function:
// out[b, h*G+g] = softmax(q·Kᵀ·scale)·V over request b's live tokens, read
// through its page-table row; an optional in-flight token (cur_k/cur_v)
// comes last; a row with seq_len 0 is dead and gives 0. The TPU kernel
// sweeps a row's page chunks in order on one core (its "split-KV path");
// here the chunks are blocks that run side by side on the SMs.
//
// What bounds it: bytes and latency. Each live token costs 2·HD·2 bytes
// per kv head (4 KiB per token per layer at Hkv 8, hd 128): at B = 1 and a
// context of about 1.1k one layer reads about 4.7 MB, 1.4 us at 3.35 TB/s.
// That is about 2 FLOP a byte, far below the ~295 at which the tensor
// cores would matter, and with G = 4 query rows per kv head an mma tile of
// 16 rows would be three-quarters empty: no tensor cores. The first design
// ran one block per (request, kv head), 8 blocks on 132 SMs at B = 1, and
// an online softmax token by token (shuffles, two exps and a rescale per
// token and head) that bounded it at 127 us. This design:
//
// - Grid (B, Hkv, S). Split s of row b covers pages [s·pps, (s+1)·pps) of
//   the row's page table; the in-flight token belongs to the split that
//   holds position seq_len - 1 (the last split if the table has no page
//   for it). The wrapper picks S and pps from shapes alone
//   (ops/cuda/paged_decode.py::plan_splits, about two blocks an SM), so it
//   reads no device value. A split past its row's live length writes an
//   empty partial (m = -inf, l = 0).
// - Tiles of kTile tokens of K and V are staged in shared memory by TMA
//   bulk copies (one of K and one of V for each page a tile meets, issued
//   by one thread, completing on an mbarrier), two tiles in a ring, so the
//   next tile is in flight while the current one is used. A first version
//   had every thread compute and issue its own 16-byte cp.async copies:
//   with about one warp per scheduler at B = 1, those dependent address
//   chains (a division by the page size each) held a tile's arrival to
//   about 4.7 us on an H100, against 2.1 us with TMA (per-block
//   %globaltimer stamps at B = 1, a context of 1,152).
// - Softmax once per tile, not once per token: all scores q·k of the tile
//   for the G heads first (TPT threads a token, q pre-scaled in shared
//   memory; row r starts its chunks at r·TPT, so unpadded rows are read
//   without bank conflicts), one max and one sum per head and tile, one
//   rescale of (m, l, acc) per tile, then p·V with each thread owning 8
//   dims of hd for a subset of the tile's tokens; the subsets are summed
//   once at the end. 256 threads a block, for more warps to hide latency.
// - Merge: with S > 1 each split writes f32 (m, l, acc[G][HD]) to scratch
//   and thread 0 takes a ticket on its (b, h) with one acq_rel atomic after
//   the block's barrier (a __threadfence in every thread before the ticket
//   and another in the merging block took 1.4 us of a call against
//   0.75 us, same stamps); the block that takes the last ticket merges the
//   S partials (each thread folds its splits four at a time, their loads in
//   flight together), writes out and resets the ticket to 0 for the next
//   call.
//   Chosen over a second merge kernel, which adds a launch and its gap
//   (about 2 us on this card) to a kernel of about 10 us. With S = 1 the
//   block writes out directly and touches no scratch. The tickets are
//   shared by every call that is given them, so calls sharing a ticket
//   buffer must run in one stream order: the wrapper keeps one buffer per
//   (device, stream).
//
// Numerics follow the TPU kernel: q is pre-scaled in f32 and rounded to
// bf16, dots accumulate in f32, p is rounded to bf16 before it multiplies
// V, and merges are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kMaxSplits = 256;  // ops/cuda/paged_decode.py MAX_SPLITS
constexpr int kMaxPages = 64;    // page-table entries of a split cached in shared memory
constexpr int kMaxDevices = 64;

template <int HD>
struct Cfg {
  static constexpr int kTile = HD <= 128 ? 64 : 32;  // tokens a tile
  static constexpr int TPT = kThreads / kTile;       // threads a token (scores)
  static constexpr int CPR = HD / 8;                 // 16-byte chunks a row
  static constexpr int CPT = CPR / TPT;              // chunks a thread (scores)
  static constexpr int NSUB = kThreads / CPR;        // token subsets (p·V)
  static constexpr int kStageBytes = kTile * HD * 2 * 2;  // K and V of a tile
};

// shared memory: the ring (reused after the tiles for the token subsets'
// sums), then q, the scores and (m, l, corr)
template <int HD, int G>
__host__ __device__ constexpr int ring_bytes() {
  using C = Cfg<HD>;
  constexpr int ring = kStages * C::kStageBytes, red = C::NSUB * G * HD * 4;
  return ring > red ? ring : red;
}

template <int HD, int G>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<HD, G>() + (G * HD + G * Cfg<HD>::kTile + 3 * G) * 4;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}

// the issuing thread's arrival, announcing the bytes its copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// one TMA bulk copy of `bytes` (a multiple of 16) from device memory into
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ticket counter of a (b, h): returns the count before this arrival;
// acq_rel at gpu scope, so it both publishes what the block wrote before it
// and, for the block that arrives last, makes the others' writes visible
__device__ __forceinline__ int ticket(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// folds the partial softmax state (m2, l2, a2) into (m, l, a), each
// relative to its own max; a state with m = -inf is empty and weighs 0
__device__ __forceinline__ void fold(float& m, float& l, float4& a, float m2, float l2,
                                     const float4& a2) {
  const float mn = fmaxf(m, m2);
  const float c1 = m == -CUDART_INF_F ? 0.f : __expf(m - mn);
  const float c2 = m2 == -CUDART_INF_F ? 0.f : __expf(m2 - mn);
  l = l * c1 + l2 * c2;
  a.x = a.x * c1 + a2.x * c2;
  a.y = a.y * c1 + a2.y * c2;
  a.z = a.z * c1 + a2.z * c2;
  a.w = a.w * c1 + a2.w * c2;
  m = mn;
}

template <int HD, int G>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,      // [B, Hkv*G, HD]
                    const __nv_bfloat16* __restrict__ k_base,  // page (0, 0) of k
                    const __nv_bfloat16* __restrict__ v_base,  // page (0, 0) of v
                    const __nv_bfloat16* __restrict__ cur_k,   // [B, Hkv, HD] or null
                    const __nv_bfloat16* __restrict__ cur_v,
                    const int* __restrict__ tables,    // [B, P]
                    const int* __restrict__ seq_lens,  // [B]
                    __nv_bfloat16* __restrict__ out,   // [B, Hkv*G, HD]
                    float* __restrict__ part_acc,      // [B, Hkv, S, G, HD] (S > 1)
                    float* __restrict__ part_ml,       // [B, Hkv, S, G, 2]
                    int* __restrict__ tickets,         // [B*Hkv], 0 between calls
                    int Hkv, int P, int ps, int pps, long long head_stride,
                    long long page_stride, float scale, int has_cur) {
  using C = Cfg<HD>;
  constexpr int kTile = C::kTile, TPT = C::TPT, CPR = C::CPR;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + ring_bytes<HD, G>());  // [G][2][CPR][4]
  float* sc = qs + G * HD;     // [G][kTile] scores, then p
  float* st = sc + G * kTile;  // m[G], l[G], corr[G]
  __shared__ uint64_t bars[kStages];
  __shared__ int pg[kMaxPages];  // the split's page-table entries
  __shared__ int is_last;

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long bh = (long long)b * Hkv + h;
  const int* table = tables + (long long)b * P;
  const int p0 = s * pps, p1 = min(p0 + pps, P);
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the table entries do not wait for seq_len: both loads are in flight at once
  if (tid < min(p1 - p0, kMaxPages)) pg[tid] = table[p0 + tid];
  const int seq_len = seq_lens[b];
  const int past = has_cur ? max(seq_len - 1, 0) : seq_len;
  const int t0 = p0 * ps;
  int t1 = min(p1 * ps, past);
  if (has_cur && seq_len > 0 && s == min(past / ps / pps, S - 1)) t1 = past + 1;
  const int n = max(t1 - t0, 0);  // tokens of this split; t1 - 1 may be the in-flight one
  const int n_tiles = (n + kTile - 1) / kTile;
  __syncthreads();

  // thread 0 brings tile `tile` into its ring slot: one bulk copy of K and
  // one of V for each page the tile meets, and the in-flight token's rows
  auto issue = [&](int tile) {
    uint64_t* bar = &bars[tile % kStages];
    auto* ks = reinterpret_cast<__nv_bfloat16*>(smem + (tile % kStages) * C::kStageBytes);
    __nv_bfloat16* vs = ks + kTile * HD;
    const int base = t0 + tile * kTile;
    const int live = min(kTile, t1 - base);
    mbar_expect_tx(bar, live * HD * 2 * 2);
    const int pool_end = min(base + live, past);
    for (int t = base; t < pool_end;) {
      const int pi = t / ps - p0;
      const int page = pi < kMaxPages ? pg[pi] : table[t / ps];
      const int off = t % ps, cnt = min(ps - off, pool_end - t);
      const long long src = h * head_stride + page * page_stride + (long long)off * HD;
      bulk_g2s(ks + (t - base) * HD, k_base + src, cnt * HD * 2, bar);
      bulk_g2s(vs + (t - base) * HD, v_base + src, cnt * HD * 2, bar);
      t += cnt;
    }
    if (pool_end < base + live) {  // the in-flight token: the split's last row
      bulk_g2s(ks + (past - base) * HD, cur_k + bh * HD, HD * 2, bar);
      bulk_g2s(vs + (past - base) * HD, cur_v + bh * HD, HD * 2, bar);
    }
  };
  if (tid == 0)
    for (int i = 0; i < min(n_tiles, kStages); ++i) issue(i);

  // q pre-scaled in f32 and rounded to bf16; chunk c of a head keeps its two
  // halves at c*4 and HD/2 + c*4, so that 8 threads reading 8 chunks hit
  // distinct banks
  for (int i = tid; i < G * CPR; i += kThreads) {
    const int g = i / CPR, c = i % CPR;
    float raw[8];
    unpack_bf16x8(*reinterpret_cast<const uint4*>(q + (bh * G + g) * HD + c * 8), raw);
    float* dst = qs + g * HD + c * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dst[k] = bf16_round(raw[k] * scale);
      dst[HD / 2 + k] = bf16_round(raw[4 + k] * scale);
    }
  }
  if (tid < G) {
    st[tid] = -CUDART_INF_F;
    st[G + tid] = 0.f;
  }
  __syncthreads();

  const int c_pv = tid % CPR, sub = tid / CPR;  // p·V: 8 dims, a token subset
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    mbar_wait(&bars[tile % kStages], (tile / kStages) & 1);
    const auto* ks =
        reinterpret_cast<const __nv_bfloat16*>(smem + (tile % kStages) * C::kStageBytes);
    const __nv_bfloat16* vs = ks + kTile * HD;
    const int live = min(kTile, n - tile * kTile);

    // 1. scores of the tile for all G heads: TPT threads a token. Row r
    //    starts its chunks at r*TPT, so the 8 threads of a 16-byte access
    //    phase read 8 consecutive chunks: distinct banks without padding
    {
      const int r = tid / TPT, part = tid % TPT;
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
      if (r < live) {
#pragma unroll
        for (int j = 0; j < C::CPT; ++j) {
          const int c = (part + (j + r) * TPT) % CPR;
          float kf[8];
          unpack_bf16x8(*reinterpret_cast<const uint4*>(ks + r * HD + c * 8), kf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 qa = *reinterpret_cast<const float4*>(qs + g * HD + c * 4);
            const float4 qb = *reinterpret_cast<const float4*>(qs + g * HD + HD / 2 + c * 4);
            dot[g] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                      qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int off = TPT / 2; off > 0; off /= 2)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
        if (part == 0) sc[g * kTile + r] = r < live ? dot[g] : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // 2. one max, one sum and one rescale factor per head and tile
    for (int g = warp; g < G; g += kWarps) {
      float v[kTile / 32];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        v[i] = sc[g * kTile + lane + 32 * i];
        mx = fmaxf(mx, v[i]);
      }
      mx = warp_max(mx);
      const float m_old = st[g];
      const float m_new = fmaxf(m_old, mx);  // finite: the tile has a live token
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        const float p = __expf(v[i] - m_new);  // 0 for a masked token
        sum += p;
        sc[g * kTile + lane + 32 * i] = bf16_round(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);  // 0 while m is -inf
        st[g] = m_new;
        st[G + g] = st[G + g] * corr + sum;
        st[2 * G + g] = corr;
      }
    }
    __syncthreads();

    // 3. rescale once, then p·V over this thread's token subset
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float corr = st[2 * G + g];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= corr;
    }
    for (int t = sub; t < live; t += C::NSUB) {
      float vf[8];
      unpack_bf16x8(*reinterpret_cast<const uint4*>(vs + t * HD + c_pv * 8), vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sc[g * kTile + t];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] += p * vf[i];
      }
    }
    __syncthreads();  // the slot and the scores are free again
    if (tid == 0 && tile + kStages < n_tiles) issue(tile + kStages);
  }

  // sum the token subsets: red[sub][g][HD] over the ring's shared memory
  float* red = reinterpret_cast<float*>(smem);
  if (n_tiles > 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float4* dst = reinterpret_cast<float4*>(red + (sub * G + g) * HD + c_pv * 8);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();
  if (S == 1) {
    for (int idx = tid; idx < G * HD; idx += kThreads) {
      const float l = st[G + idx / HD];
      float a = 0.f;
      if (l > 0.f) {
        for (int u = 0; u < C::NSUB; ++u) a += red[u * G * HD + idx];
        a /= l;
      }
      out[bh * G * HD + idx] = __float2bfloat16(a);
    }
    return;
  }

  // S > 1: this split's partial; an empty split writes m = -inf, l = 0 and
  // no acc (the merge gives it weight 0 and does not use it)
  const long long part = bh * S + s;
  if (tid < G) {
    part_ml[(part * G + tid) * 2] = st[tid];
    part_ml[(part * G + tid) * 2 + 1] = st[G + tid];
  }
  if (n_tiles > 0) {
    for (int idx = tid; idx < G * HD; idx += kThreads) {
      float a = 0.f;
      for (int u = 0; u < C::NSUB; ++u) a += red[u * G * HD + idx];
      part_acc[part * G * HD + idx] = a;
    }
  }
  __syncthreads();
  // thread 0's ticket releases the block's partial (ordered before it by
  // the barrier) and, for the last block, acquires the other splits'
  if (tid == 0) is_last = ticket(&tickets[bh]) == S - 1;
  __syncthreads();
  if (!is_last) return;

  // the last split of (b, h) merges. TPS adjacent threads share 4 outputs
  // of one head: each folds its share of the splits four at a time (their
  // (m, l) and acc loaded together, one rescale per four), then the TPS
  // threads fold theirs together. An empty split's acc was never written:
  // it is loaded but weighs 0.
  constexpr int SLOTS = G * HD / 4;
  constexpr int TPS = SLOTS >= kThreads ? 1 : kThreads / SLOTS;
  const float4* accs = reinterpret_cast<const float4*>(part_acc + bh * S * G * HD);
  const float2* mls = reinterpret_cast<const float2*>(part_ml) + bh * S * G;
  for (int v = tid / TPS; v < SLOTS; v += kThreads / TPS) {
    const int g = v * 4 / HD;
    float m = -CUDART_INF_F, l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
    for (int u0 = tid % TPS; u0 < S; u0 += 4 * TPS) {
      float2 ml[4];
      float4 x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int u = u0 + k * TPS;
        ml[k] = u < S ? __ldcg(mls + u * G + g) : make_float2(-CUDART_INF_F, 0.f);
        x[k] = u < S ? __ldcg(accs + (long long)u * SLOTS + v) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float mb = fmaxf(fmaxf(ml[0].x, ml[1].x), fmaxf(ml[2].x, ml[3].x));
      float lb = 0.f;
      float4 ab = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool live = ml[k].x != -CUDART_INF_F;
        const float wk = live ? __expf(ml[k].x - mb) : 0.f;
        lb += wk * ml[k].y;
        ab.x += live ? wk * x[k].x : 0.f;
        ab.y += live ? wk * x[k].y : 0.f;
        ab.z += live ? wk * x[k].z : 0.f;
        ab.w += live ? wk * x[k].w : 0.f;
      }
      fold(m, l, a, mb, lb, ab);
    }
#pragma unroll
    for (int off = TPS / 2; off > 0; off /= 2) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
      float4 a2;
      a2.x = __shfl_xor_sync(0xffffffffu, a.x, off);
      a2.y = __shfl_xor_sync(0xffffffffu, a.y, off);
      a2.z = __shfl_xor_sync(0xffffffffu, a.z, off);
      a2.w = __shfl_xor_sync(0xffffffffu, a.w, off);
      fold(m, l, a, m2, l2, a2);
    }
    if (tid % TPS == 0) {
      const float inv = l > 0.f ? 1.f / l : 0.f;
      __nv_bfloat16* o = out + bh * G * HD + v * 4;
      o[0] = __float2bfloat16(a.x * inv);
      o[1] = __float2bfloat16(a.y * inv);
      o[2] = __float2bfloat16(a.z * inv);
      o[3] = __float2bfloat16(a.w * inv);
    }
  }
  if (tid == 0) tickets[bh] = 0;
}

struct Args {
  const __nv_bfloat16 *q, *kb, *vb, *ck, *cv;
  const int *tables, *seq_lens;
  __nv_bfloat16* out;
  float *part_acc, *part_ml;
  int* tickets;
  int Hkv, P, ps, pps;
  long long hs, pgs;
  float scale;
  int has_cur;
};

template <int HD, int G>
cudaError_t launch(dim3 grid, cudaStream_t stream, const Args& a) {
  constexpr int bytes = smem_bytes<HD, G>();
  // above 48 KB a kernel must be allowed its dynamic shared memory, once
  // per instance and device
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(paged_decode_kernel<HD, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = true;
  }
  paged_decode_kernel<HD, G><<<grid, kThreads, bytes, stream>>>(
      a.q, a.kb, a.vb, a.ck, a.cv, a.tables, a.seq_lens, a.out, a.part_acc, a.part_ml,
      a.tickets, a.Hkv, a.P, a.ps, a.pps, a.hs, a.pgs, a.scale, a.has_cur);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int G, dim3 grid, cudaStream_t stream, const Args& a) {
  switch (G) {
    case 1: return launch<HD, 1>(grid, stream, a);
    case 2: return launch<HD, 2>(grid, stream, a);
    case 4: return launch<HD, 4>(grid, stream, a);
    case 8: return launch<HD, 8>(grid, stream, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// S splits of pps pages each (S = ceil(P / pps)). With S > 1, part_acc /
// part_ml are f32 scratch of B*Hkv*S*G*HD and B*Hkv*S*G*2 values and
// tickets B*Hkv ints that are 0 (the kernel leaves them 0). Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head dim / group size it was not built for
// or a split plan it does not take.
extern "C" int paged_decode_bf16(const void* q, const void* k_base, const void* v_base,
                                 const void* cur_k, const void* cur_v, const void* tables,
                                 const void* seq_lens, void* out, void* part_acc,
                                 void* part_ml, void* tickets, int B, int Hkv, int G, int HD,
                                 int P, int ps, int S, int pps, long long head_stride,
                                 long long page_stride, float scale, int has_cur,
                                 void* stream) {
  if (B < 1 || Hkv < 1 || ps < 1 || pps < 1 || S < 1 || S > kMaxSplits ||
      (S > 1 && ((long long)(S - 1) * pps >= P || !part_acc || !part_ml || !tickets)))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k_base),
               static_cast<const __nv_bfloat16*>(v_base),
               static_cast<const __nv_bfloat16*>(cur_k),
               static_cast<const __nv_bfloat16*>(cur_v),
               static_cast<const int*>(tables),
               static_cast<const int*>(seq_lens),
               static_cast<__nv_bfloat16*>(out),
               static_cast<float*>(part_acc),
               static_cast<float*>(part_ml),
               static_cast<int*>(tickets),
               Hkv, P, ps, pps, head_stride, page_stride, scale, has_cur};
  const dim3 grid(B, Hkv, S);
  auto st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 64: return launch_hd<64>(G, grid, st, a);
    case 128: return launch_hd<128>(G, grid, st, a);
    case 256: return launch_hd<256>(G, grid, st, a);
    default: return cudaErrorInvalidValue;
  }
}
