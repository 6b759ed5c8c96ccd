// Causal GQA flash attention for prefill on Hopper (sm_90a), bf16 in.
//
// Replaces the TPU kernel pegainfer_tpu/ops/pallas/flash_prefill.py,
// function flash_attention (_kernel; flash_prefill is its q_offset = 0
// form). Same function: queries q[T, Hq, hd] sit at absolute positions
// q_offset + i and attend to keys k/v[S, Hkv, hd] at positions <= their
// own and below kv_valid. The TPU tiling (VMEM-driven tq shrink, grid-carried
// scratch) is not carried over.
//
// Design: one block per (q tile, kv head), 4 warps. The block's 64 rows are
// all G query heads of the group times BQ = 64 / G query positions (row
// r = g * BQ + t), so each K/V tile is read once for the whole group. The
// block loops over 64-key tiles only up to the causal diagonal of its last
// row and kv_valid. Products run on the tensor cores through nvcuda::wmma
// (bf16 16x16x16, f32 accumulation); each warp owns 16 rows. The running
// output O stays in shared memory in f32 and is rescaled there, so no
// fragment layout is assumed. Numerics follow the TPU kernel: q·kᵀ in the
// k dtype (bf16) with f32 accumulation times scale, online softmax in f32,
// p rounded to the v dtype (bf16) before P·V. Rows past T and keys past S
// are masked, so any T and S work.
//
// What bounds it: operations. At T = S = 1024, Hq 32, hd 128 the causal
// product needs about 8.6 GFLOP (2 products x 2 x hd x Hq x T(T+1)/2),
// about 8.7 us at 989 TFLOP/s, while its inputs and output are about 21 MB,
// 6.3 us at 3.35 TB/s. wmma through shared memory reaches a small part of
// the tensor-core rate; wgmma with TMA-fed tiles is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kRows = kWarps * 16;  // query rows (head, position) per block
constexpr int kBK = 64;             // keys per tile

// Rows are padded (16 bytes for bf16, 16 for f32) so that neighbouring
// rows start in other shared-memory banks; wmma's alignment rules (32-byte
// tile origins, leading dimension a multiple of 16 bytes) still hold.
template <int HD>
struct Smem {
  static constexpr int QK = HD + 8, O = HD + 4, S = kBK + 4, P = kBK + 8;
  __nv_bfloat16 q[kRows][QK];
  __nv_bfloat16 k[kBK][QK];
  __nv_bfloat16 v[kBK][QK];
  float o[kRows][O];
  float s[kRows][S];
  __nv_bfloat16 p[kRows][P];
};

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,  // [T, Hq, HD]
                     const __nv_bfloat16* __restrict__ k,  // [S, Hkv, HD]
                     const __nv_bfloat16* __restrict__ v,  // [S, Hkv, HD]
                     __nv_bfloat16* __restrict__ out,      // [T, Hq, HD]
                     int T, int S, int Hkv, int G, int kv_valid, int q_offset,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  constexpr int V8 = HD / 8;  // 16-byte vectors per row
  using SM = Smem<HD>;

  const int BQ = kRows / G;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int Hq = Hkv * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // load the q tile (zero rows past T) and clear O
  for (int idx = threadIdx.x; idx < kRows * V8; idx += blockDim.x) {
    const int r = idx / V8, c = (idx % V8) * 8;
    const int t = q0 + r % BQ, g = r / BQ;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < T)
      val = *reinterpret_cast<const uint4*>(
          q + ((long long)t * Hq + h * G + g) * HD + c);
    *reinterpret_cast<uint4*>(&sm.q[r][c]) = val;
  }
  for (int idx = threadIdx.x; idx < kRows * HD; idx += blockDim.x)
    sm.o[idx / HD][idx % HD] = 0.f;
  __syncthreads();

  // each lane owns every other column (c = 2j + half) of one of its
  // warp's 16 rows for the softmax and the O rescale
  const int row = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int qpos = q_offset + q0 + row % BQ;
  float m = -CUDART_INF_F, l = 0.f;

  const int last_q = q_offset + min(q0 + BQ, T) - 1;
  const int kv_end = min(min(kv_valid, S), last_q + 1);

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = threadIdx.x; idx < kBK * V8; idx += blockDim.x) {
      const int r = idx / V8, c = (idx % V8) * 8;
      const int key = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < kv_end) {
        const long long off = ((long long)key * Hkv + h) * HD + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&sm.k[r][c]) = kv;
      *reinterpret_cast<uint4*>(&sm.v[r][c]) = vv;
    }
    __syncthreads();

    // S = Q_w · Kᵀ for this warp's 16 rows
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, &sm.q[warp * 16][kk * 16], SM::QK);
        wmma::load_matrix_sync(bk, &sm.k[n * 16][kk * 16], SM::QK);
        wmma::mma_sync(sf, a, bk, sf);
      }
      wmma::store_matrix_sync(&sm.s[warp * 16][n * 16], sf, SM::S, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile; each lane covers 32 keys of its row
    float sv[kBK / 2];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const int c = 2 * j + half;
      const int key = k0 + c;
      const bool ok = key <= qpos && key < kv_valid;
      sv[j] = ok ? sm.s[row][c] * scale : -CUDART_INF_F;
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float corr = 1.f, rowsum = 0.f;
    if (m_new == -CUDART_INF_F) {  // nothing valid for this row yet
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j)
        sm.p[row][2 * j + half] = __float2bfloat16(0.f);
    } else {
      corr = __expf(m - m_new);  // 0 while m is -inf
#pragma unroll
      for (int j = 0; j < kBK / 2; ++j) {
        const float p = __expf(sv[j] - m_new);  // 0 for masked keys
        rowsum += p;
        sm.p[row][2 * j + half] = __float2bfloat16(p);
      }
    }
    rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
    l = l * corr + rowsum;
    m = m_new;
#pragma unroll 8
    for (int c = half; c < HD; c += 2) sm.o[row][c] *= corr;
    __syncwarp();

    // O_w += P_w · V
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, &sm.o[warp * 16][n * 16], SM::O, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, &sm.p[warp * 16][kk * 16], SM::P);
        wmma::load_matrix_sync(bv, &sm.v[kk * 16][n * 16], SM::QK);
        wmma::mma_sync(of, a, bv, of);
      }
      wmma::store_matrix_sync(&sm.o[warp * 16][n * 16], of, SM::O, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // normalise and write this lane's columns of its row
  const int t = q0 + row % BQ, g = row / BQ;
  if (t < T) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* dst = out + ((long long)t * Hq + h * G + g) * HD;
    for (int c = half; c < HD; c += 2)
      dst[c] = __float2bfloat16(sm.o[row][c] * inv);
  }
}

template <int HD>
cudaError_t launch_hd(const __nv_bfloat16* q, const __nv_bfloat16* k,
                      const __nv_bfloat16* v, __nv_bfloat16* out, int T, int S,
                      int Hkv, int G, int kv_valid, int q_offset, float scale,
                      cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<HD>));
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int BQ = kRows / G;
  const dim3 grid((T + BQ - 1) / BQ, Hkv);
  flash_prefill_kernel<HD><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, out, T, S, Hkv, G, kv_valid, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head dim or group size it does not take.
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  void* out, int T, int S, int Hkv, int G,
                                  int HD, int kv_valid, int q_offset,
                                  float scale, void* stream) {
  if (G < 1 || kRows % G != 0) return cudaErrorInvalidValue;
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 64:
      return launch_hd<64>(qq, kk, vv, o, T, S, Hkv, G, kv_valid, q_offset, scale, st);
    case 128:
      return launch_hd<128>(qq, kk, vv, o, T, S, Hkv, G, kv_valid, q_offset, scale, st);
    case 256:
      return launch_hd<256>(qq, kk, vv, o, T, S, Hkv, G, kv_valid, q_offset, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
