// Device helpers shared by the kernels in this directory. Each source
// includes this header and builds on its own (one nvcc a source).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// E2M1 (fp4) code -> value; bit 3 is the sign
__constant__ float kE2M1[16] = {0.f,  0.5f,  1.f,  1.5f,  2.f,  3.f,  4.f,  6.f,
                                -0.f, -0.5f, -1.f, -1.5f, -2.f, -3.f, -4.f, -6.f};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 packed bf16 (one 16-byte load) -> 8 floats
__device__ __forceinline__ void unpack_bf16x8(const uint4 raw, float* out) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// acc + the 8 products of two 16-byte units of bf16, in order (the bf16
// weight streams)
__device__ __forceinline__ float dot_bf16x8(const uint4 w, const uint4 x, float acc) {
  float a[8], b[8];
  unpack_bf16x8(w, a);
  unpack_bf16x8(x, b);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = fmaf(a[i], b[i], acc);
  return acc;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// int8 code j of a 4-code word -> its exact float value, with no
// integer-to-float conversion instruction: a byte permute puts q + 128 in
// the low mantissa byte of 2^23 (0x4B000000), and a subtraction of
// 2^23 + 128 leaves q
__device__ __forceinline__ float s8_at(uint32_t word, int j) {
  return __uint_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7440 | j)) -
         8388736.f;
}

// 16 int8 codes (one 16-byte load) -> 16 exact floats
__device__ __forceinline__ void decode_s8x16(const uint4 raw, float* w) {
  const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[4 * i + j] = s8_at(wd[i], j);
  }
}

// a 16-byte copy from device to shared memory, zeros where !valid (source
// size 0; src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a · b on the tensor cores: bf16 m16n8k16, A row-major, B
// column-major, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The packed-fp4 decode of K5 (fp4_grouped.cu) and K9 (fp4_chain.cu), with
// no table in memory.
// E2M1 magnitudes 0, 0.5, 1, 1.5, 2, 3, 4, 6 in bf16 are 0x0000, 0x3F00,
// 0x3F80, 0x3FC0, 0x4000, 0x4040, 0x4080, 0x40C0: their low bytes (kLo0 for
// magnitudes 0-3, kLo1 for 4-7) and high bytes (kHi0, kHi1), picked by a
// 3-bit magnitude as a prmt selector
constexpr uint32_t kLo0 = 0xC0800000u, kLo1 = 0xC0804000u;
constexpr uint32_t kHi0 = 0x3F3F3F00u, kHi1 = 0x40404040u;
// prmt selectors (a nibble a result byte; 8 + i replicates byte i's bit 7):
// the signs of codes 0-3 / 4-7 of a word w as 0xFF bytes, from w (odd codes'
// sign bits at bit 7 of their byte) and w << 4 (even codes'); and the
// interleaves of low and high bytes into bf16 pairs
constexpr uint32_t kSelNeg03 = 0x9D8Cu, kSelNeg47 = 0xBFAEu;
constexpr uint32_t kSelPair01 = 0x5140u, kSelPair23 = 0x7362u;

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 8 packed codes (byte j: codes 2j in the low nibble, 2j + 1 in the high)
// -> 4 bf16 pairs r[j] = (code 2j, code 2j + 1) · scale, each rounded once
// from the exact product; sc holds the scale in both halves
__device__ __forceinline__ void e2m1x8_bf16x2(uint32_t w, uint32_t sc, uint32_t* r) {
  const uint32_t m = w & 0x77777777u;  // magnitudes (a prmt reads the low 16 bits)
  const uint32_t w4 = w << 4;
  const uint32_t hi03 = prmt(kHi0, kHi1, m) | (prmt(w, w4, kSelNeg03) & 0x80808080u);
  const uint32_t hi47 = prmt(kHi0, kHi1, m >> 16) | (prmt(w, w4, kSelNeg47) & 0x80808080u);
  const uint32_t lo03 = prmt(kLo0, kLo1, m), lo47 = prmt(kLo0, kLo1, m >> 16);
  r[0] = mul_bf16x2(prmt(lo03, hi03, kSelPair01), sc);
  r[1] = mul_bf16x2(prmt(lo03, hi03, kSelPair23), sc);
  r[2] = mul_bf16x2(prmt(lo47, hi47, kSelPair01), sc);
  r[3] = mul_bf16x2(prmt(lo47, hi47, kSelPair23), sc);
}

// mbarriers (K1, K2 and the bf16 weight streams): each takes the barrier's
// shared-memory address
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// the issuing thread's arrival, announcing the bytes its copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// a wait that never completes (a copy that was never issued) traps, so the
// launch fails instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (n == (1u << 26)) __trap();
  }
}

// one 1-D bulk copy (TMA, no tensor map) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from device memory into shared memory at `dst`,
// completing on `bar`
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The bf16 weight ring of gemv_stream.cu and gemv_chain.cu. A block of
// kConsumerWarps consumer warps and one producer warp streams chunks of
// whole rows through `stages` stages of shared memory: one producer thread
// issues chunk j as one 1-D bulk copy into stage j % stages, completing on
// the stage's full mbarrier with the chunk's bytes (a short last chunk
// announces fewer); the consumers release it through its empty mbarrier,
// one arrival a warp. Dynamic shared memory: full[stages], empty[stages],
// x (`x_bytes`, the GEMV's input), then the stages.
namespace wring {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxStages = 32;
// a block's dynamic shared memory: 227 KB less 128 bytes of static
constexpr int kMaxSmem = 232448 - 128;
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int align128(int b) { return (b + 127) & ~127; }
__host__ __device__ inline int bar_bytes(int stages) { return align128(16 * stages); }
__host__ inline size_t smem_bytes(int x_bytes, int stage_bytes, int stages) {
  return bar_bytes(stages) + x_bytes + static_cast<size_t>(stages) * stage_bytes;
}
__host__ inline bool bad_ring(int K, int rows, int stages, int x_bytes) {
  return K < 8 || K % 8 || rows < 1 || stages < 1 || stages > kMaxStages ||
         smem_bytes(x_bytes, rows * K * 2, stages) > static_cast<size_t>(kMaxSmem);
}

// the kernel's dynamic shared memory allowed up to kMaxSmem, once a device
// (`allowed`: the kernel's flags), so that no attribute is set while a CUDA
// graph captures a launch
__host__ inline cudaError_t allow_max_smem(const void* kernel, bool* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && allowed[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

struct Ring {
  uint32_t bars;         // full[0]'s shared address; empty[0] is stages later
  uint32_t ring;         // the first stage's shared address
  unsigned char* ring_p;
  unsigned char* x;      // x_bytes of x
  int stages, stage_bytes;

  __device__ Ring(unsigned char* smem, int x_bytes, int stages_, int stage_bytes_)
      : bars(smem_u32(smem)),
        ring(smem_u32(smem) + bar_bytes(stages_) + x_bytes),
        ring_p(smem + bar_bytes(stages_) + x_bytes),
        x(smem + bar_bytes(stages_)),
        stages(stages_),
        stage_bytes(stage_bytes_) {}

  __device__ uint32_t full(int st) const { return bars + 8 * st; }
  __device__ uint32_t empty(int st) const { return bars + 8 * (stages + st); }

  // thread 0, before the block's first __syncthreads
  __device__ void init() const {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full(st), 1);                // the producer's arrival
      mbar_init(empty(st), kConsumerWarps);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the producer thread's j-th chunk: `bytes` from src, once the consumers
  // have released what the stage held before
  __device__ void produce(int j, const void* src, uint32_t bytes) const {
    const int st = j % stages;
    if (j >= stages) mbar_wait(empty(st), ((j / stages) & 1) ^ 1);
    mbar_expect_tx(full(st), bytes);
    bulk_copy_g2s(ring + st * stage_bytes, src, bytes, full(st));
  }

  // the consumers' j-th chunk, once it has landed
  __device__ const uint4* acquire(int j) const {
    const int st = j % stages;
    mbar_wait(full(st), (j / stages) & 1);
    return reinterpret_cast<const uint4*>(ring_p + st * stage_bytes);
  }

  // a consumer warp is done with its j-th chunk
  __device__ void release(int j, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(j % stages));
  }
};

// a chunk's bytes: min(rows, N - c · rows) whole rows of K bf16
__device__ __forceinline__ uint32_t chunk_bytes(int c, int rows, int N, int K) {
  return static_cast<uint32_t>(min(rows, N - c * rows)) * K * 2;
}

// consumer warp `warp`: y[rr] = x · row rr of the chunk + add for its rows
// rr = warp, warp + kConsumerWarps, ... < r (lane i reads a row's 16-byte
// units i, i + 32, ..., a shuffle reduction gives the sum, lane 0 writes)
__device__ __forceinline__ void rows_gemv(const uint4* chunk, int r, int k8, const uint4* xs,
                                          float add, float* y, int warp, int lane) {
  for (int rr = warp; rr < r; rr += kConsumerWarps) {
    const uint4* wr = chunk + rr * k8;
    float a = 0.f;
    for (int i = lane; i < k8; i += 32) a = dot_bf16x8(wr[i], xs[i], a);
    a = warp_sum(a);
    if (lane == 0) y[rr] = a + add;
  }
}

}  // namespace wring

}  // namespace
