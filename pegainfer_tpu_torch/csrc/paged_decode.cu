// Paged GQA decode attention for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/paged_decode.py,
// function paged_attention_decode (_kernel / _head). Same function:
// out[b, h*G+g] = softmax(q·Kᵀ·scale)·V over request b's live tokens, read
// through its page-table row; an optional in-flight token (cur_k/cur_v)
// comes last; a row with seq_len 0 is dead and gives 0. The TPU design
// (double-buffered DMA chunks, semaphores, chunk_pages, fold_heads) is not
// carried over.
//
// Design: one block per (request, kv head). The block reads its own
// page-table row and walks the live tokens. A token's K and V rows are read
// once for all G query heads of the group, as 16-byte loads: HD/8 lanes
// share one row, so a warp covers 32/(HD/8) tokens per step. Each such
// "token group" keeps its own online softmax (m, l, acc) in f32; the groups
// merge through shared memory at the end. Numerics follow the TPU kernel:
// q is pre-scaled in f32 and rounded to bf16, dots accumulate in f32, and
// p is rounded to bf16 before it multiplies V.
//
// What bounds it: bytes. Each live token costs 2·HD·2 bytes per kv head
// (4 KiB per token per layer at Hkv 8, hd 128), so at B = 1 and a context
// of about 1.1k one layer reads about 4.5 MB: about 1.4 us at 3.35 TB/s.
// B × Hkv = 8 blocks at batch 1 leave most of the 132 SMs idle, so this
// kernel cannot come near that bound there; splitting the context across
// blocks (split-KV) is the first thing a later change fixes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;  // token rows per lane loaded before use

template <int HD, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,      // [B, Hkv*G, HD]
                    const __nv_bfloat16* __restrict__ k_base,  // page (0, 0) of k
                    const __nv_bfloat16* __restrict__ v_base,  // page (0, 0) of v
                    const __nv_bfloat16* __restrict__ cur_k,   // [B, Hkv, HD] or null
                    const __nv_bfloat16* __restrict__ cur_v,
                    const int* __restrict__ tables,  // [B, P]
                    const int* __restrict__ seq_lens,  // [B]
                    __nv_bfloat16* __restrict__ out,   // [B, Hkv*G, HD]
                    int Hkv, int P, int ps, long long head_stride,
                    long long page_stride, float scale, int has_cur) {
  constexpr int LPT = HD / 8;                // lanes per token row
  constexpr int TPW = 32 / LPT;              // tokens per warp per step
  constexpr int NGROUPS = kWarps * TPW;      // token groups per block
  __shared__ float sm_m[NGROUPS][G];
  __shared__ float sm_l[NGROUPS][G];
  __shared__ float sm_acc[NGROUPS][G][HD];

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp * TPW + lane / LPT;
  const int lead = (lane / LPT) * LPT;  // first lane of this token group
  const int d0 = (lane % LPT) * 8;
  const int seq_len = seq_lens[b];
  const int past = has_cur ? max(seq_len - 1, 0) : seq_len;
  const int n_tok = past + ((has_cur && seq_len > 0) ? 1 : 0);
  const long long qrow = ((long long)b * Hkv + h) * G;

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float raw[8];
    unpack_bf16x8(*reinterpret_cast<const uint4*>(q + (qrow + g) * HD + d0), raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[g][i] = bf16_round(raw[i] * scale);
  }
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  const int* table = tables + (long long)b * P;
  // warp-uniform loop bound: every lane reaches the shuffles below. Each
  // step issues the loads of kUnroll tokens per group before using any, so
  // that many rows are in flight per lane.
  for (int base = warp * TPW; base < n_tok; base += NGROUPS * kUnroll) {
    uint4 kraw[kUnroll], vraw[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * NGROUPS + lane / LPT;
      valid[u] = t < n_tok;
      kraw[u] = vraw[u] = make_uint4(0, 0, 0, 0);
      if (valid[u]) {
        const __nv_bfloat16 *kr, *vr;
        if (t < past) {
          const long long off = h * head_stride +
                                (long long)table[t / ps] * page_stride +
                                (long long)(t % ps) * HD;
          kr = k_base + off;
          vr = v_base + off;
        } else {
          const long long off = ((long long)b * Hkv + h) * HD;
          kr = cur_k + off;
          vr = cur_v + off;
        }
        kraw[u] = *reinterpret_cast<const uint4*>(kr + d0);
        vraw[u] = *reinterpret_cast<const uint4*>(vr + d0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[8], vf[8];
      unpack_bf16x8(kraw[u], kf);
      unpack_bf16x8(vraw[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s += qf[g][i] * kf[i];
#pragma unroll
        for (int off = LPT / 2; off > 0; off /= 2)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        s = __shfl_sync(0xffffffffu, s, lead);  // one value per token group
        if (valid[u]) {
          const float m_new = fmaxf(m[g], s);
          const float corr = __expf(m[g] - m_new);  // 0 while m is -inf
          const float p = __expf(s - m_new);
          const float pb = bf16_round(p);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] = acc[g][i] * corr + pb * vf[i];
          m[g] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == lead) {
      sm_m[grp][g] = m[g];
      sm_l[grp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sm_acc[grp][g][d0 + i] = acc[g][i];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * HD; idx += blockDim.x) {
    const int g = idx / HD, d = idx % HD;
    float mx = -CUDART_INF_F;
    for (int i = 0; i < NGROUPS; ++i) mx = fmaxf(mx, sm_m[i][g]);
    float lsum = 0.f, a = 0.f;
    for (int i = 0; i < NGROUPS; ++i) {
      if (sm_m[i][g] == -CUDART_INF_F) continue;  // group saw no token
      const float w = __expf(sm_m[i][g] - mx);
      lsum += sm_l[i][g] * w;
      a += sm_acc[i][g][d] * w;
    }
    out[(qrow + g) * HD + d] = __float2bfloat16(lsum > 0.f ? a / lsum : 0.f);
  }
}

template <int HD>
cudaError_t launch_hd(int G, dim3 grid, cudaStream_t stream,
                      const __nv_bfloat16* q, const __nv_bfloat16* kb,
                      const __nv_bfloat16* vb, const __nv_bfloat16* ck,
                      const __nv_bfloat16* cv, const int* tables,
                      const int* seq_lens, __nv_bfloat16* out, int Hkv, int P,
                      int ps, long long hs, long long pgs, float scale,
                      int has_cur) {
#define PD_LAUNCH(GG)                                                        \
  paged_decode_kernel<HD, GG><<<grid, kWarps * 32, 0, stream>>>(             \
      q, kb, vb, ck, cv, tables, seq_lens, out, Hkv, P, ps, hs, pgs, scale,  \
      has_cur);                                                              \
  break;
  switch (G) {
    case 1: PD_LAUNCH(1)
    case 2: PD_LAUNCH(2)
    case 4: PD_LAUNCH(4)
    case 8: PD_LAUNCH(8)
    default: return cudaErrorInvalidValue;
  }
#undef PD_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head dim / group size it was not built for.
extern "C" int paged_decode_bf16(const void* q, const void* k_base,
                                 const void* v_base, const void* cur_k,
                                 const void* cur_v, const void* tables,
                                 const void* seq_lens, void* out, int B,
                                 int Hkv, int G, int HD, int P, int ps,
                                 long long head_stride, long long page_stride,
                                 float scale, int has_cur, void* stream) {
  const dim3 grid(B, Hkv);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k_base);
  const auto* vb = static_cast<const __nv_bfloat16*>(v_base);
  const auto* ck = static_cast<const __nv_bfloat16*>(cur_k);
  const auto* cv = static_cast<const __nv_bfloat16*>(cur_v);
  const auto* tb = static_cast<const int*>(tables);
  const auto* sl = static_cast<const int*>(seq_lens);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 64:
      return launch_hd<64>(G, grid, st, qq, kb, vb, ck, cv, tb, sl, o, Hkv, P,
                           ps, head_stride, page_stride, scale, has_cur);
    case 128:
      return launch_hd<128>(G, grid, st, qq, kb, vb, ck, cv, tb, sl, o, Hkv, P,
                            ps, head_stride, page_stride, scale, has_cur);
    case 256:
      return launch_hd<256>(G, grid, st, qq, kb, vb, ck, cv, tb, sl, o, Hkv,
                            P, ps, head_stride, page_stride, scale, has_cur);
    default:
      return cudaErrorInvalidValue;
  }
}
