// Kernel B6: paged decode attention over a head-major KV cache, for Hopper.
//
// Replaces tools/bench_pa_headmajor.py::hm_kernel (:27), launched there by
// pa_headmajor (:66). Same function as B5 (csrc/pa_wide.cu) over another
// layout: the cache is [G, NB*BS, D], so one kv head's block is a contiguous
// [BS, D] tile. Attention of ONE query token per sequence over the keys at
// positions t*BS + i < seq_lens[b] through block_tables[b]; H_q/G query heads
// per kv head; no window, softcap, ALiBi or int8 KV. Logits are
// (q * 1/sqrt(D)) . k with f32 sums; online softmax in f32 from m = -1e30;
// masked keys get probability 0; the probabilities stay f32 (not rounded to
// q's dtype, unlike B2); out = acc / max(l, 1e-30), in q's dtype. Block ids
// outside [0, NB) read block 0, whose keys are masked by position.
//
// What bounds it on the H100: bytes. Each valid K/V row (D values of one kv
// head) is read once: B=8 sequences at 1023 tokens, bf16, move ~33.5 MB
// (~10 us at 3.35 TB/s).
//
// Design (simple and right first): one block of 128 threads per (sequence,
// kv head), the TPU grid's (b, g) axes; its t axis becomes a loop over the
// table. The HPG query heads of the group share every K/V row load: a chunk
// of up to 128 rows of the contiguous [BS, D] tile is copied to shared
// memory in 16-byte words (rows padded by 16 bytes against bank conflicts);
// one thread per key dots the row with the HPG query rows (q in f32 shared
// memory, a broadcast); one warp per head updates the running max and
// denominator; one thread per column accumulates p.v for the HPG heads.
// Known limits, left for later PRs: B*G blocks (64 at B=8 on 132 SMs), no
// split over the sequence, no cp.async/TMA pipelining.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kHeadChunk = 8;            // query heads per pass over a K row
constexpr int kMaxChunk = 128;           // K (and V) rows staged per chunk
constexpr int kChunkBytes = 64 * 1024;   // ... and at most this many bytes each
constexpr size_t kSmemMax = 227 * 1024;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half(v); }

// Eight consecutive values as f32 from a 16-byte aligned address.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __half* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pa_headmajor_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ bt,
                    const int* __restrict__ sl, T* __restrict__ out, int Hq, int G, int D,
                    int BS, int NB, int MB, long long rows, int CH, float scale) {
  const int b = blockIdx.x, g = blockIdx.y;
  const int hpg = Hq / G;
  const int ld = D + 16 / (int)sizeof(T);    // padded row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int nwarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                              // [CH][ld]
  T* v_s = k_s + (size_t)CH * ld;                                   // [CH][ld]
  float* q_s = reinterpret_cast<float*>(v_s + (size_t)CH * ld);     // [hpg][D], scaled
  float* acc = q_s + hpg * D;                                       // [hpg][D]
  float* p_s = acc + hpg * D;                                       // [hpg][CH]
  float* m_s = p_s + hpg * CH;                                      // [hpg] running max
  float* l_s = m_s + hpg;                                           // [hpg] denominator
  float* a_s = l_s + hpg;                                           // [hpg] rescale factor

  const int seq_len = sl[b];
  const T* qb = q + ((size_t)b * Hq + (size_t)g * hpg) * D;
  for (int i = tid; i < hpg * D; i += kThreads) {
    q_s[i] = to_f32<T>(qb[i]) * scale;
    acc[i] = 0.f;
  }
  for (int h = tid; h < hpg; h += kThreads) {
    m_s[h] = -1e30f;
    l_s[h] = 0.f;
  }
  const int per16 = 16 / (int)sizeof(T);
  const int row16 = D / per16;
  const T* kgh = kc + (size_t)g * rows * D;   // this kv head's [rows, D] plane
  const T* vgh = vc + (size_t)g * rows * D;

  for (int t = 0; t < MB && t * BS < seq_len; ++t) {
    int blk = bt[(size_t)b * MB + t];
    if (blk < 0 || blk >= NB) blk = 0;
    for (int s0 = 0; s0 < BS && t * BS + s0 < seq_len; s0 += CH) {
      const int cur = min(CH, BS - s0);
      const size_t base = ((size_t)blk * BS + s0) * D;
      const uint4* kg = reinterpret_cast<const uint4*>(kgh + base);
      const uint4* vg = reinterpret_cast<const uint4*>(vgh + base);
      __syncthreads();                          // previous chunk fully read
      for (int i = tid; i < cur * row16; i += kThreads) {
        const int r = i / row16, c = i - r * row16;
        *reinterpret_cast<uint4*>(k_s + (size_t)r * ld + c * per16) = kg[i];
        *reinterpret_cast<uint4*>(v_s + (size_t)r * ld + c * per16) = vg[i];
      }
      __syncthreads();

      // Phase 1: logits, one thread per key.
      for (int s = tid; s < cur; s += kThreads) {
        const bool valid = t * BS + s0 + s < seq_len;
        const T* krow = k_s + (size_t)s * ld;
        for (int h0 = 0; h0 < hpg; h0 += kHeadChunk) {
          float dot[kHeadChunk];
#pragma unroll
          for (int u = 0; u < kHeadChunk; ++u) dot[u] = 0.f;
          for (int d0 = 0; d0 < D; d0 += 8) {
            float kv[8];
            load8(krow + d0, kv);
#pragma unroll
            for (int u = 0; u < kHeadChunk; ++u) {
              if (h0 + u < hpg) {
                const float* qh = q_s + (h0 + u) * D + d0;
#pragma unroll
                for (int e = 0; e < 8; ++e) dot[u] = fmaf(qh[e], kv[e], dot[u]);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kHeadChunk; ++u)
            if (h0 + u < hpg) p_s[(h0 + u) * CH + s] = valid ? dot[u] : -1e30f;
        }
      }
      __syncthreads();

      // Phase 2: online-softmax update, one warp per head; p stays f32.
      for (int h = warp; h < hpg; h += nwarps) {
        float mx = -3.0e38f;
        for (int s = lane; s < cur; s += 32) mx = fmaxf(mx, p_s[h * CH + s]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = m_s[h];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int s = lane; s < cur; s += 32) {
          const float p = t * BS + s0 + s < seq_len ? expf(p_s[h * CH + s] - m_new) : 0.f;
          sum += p;
          p_s[h * CH + s] = p;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          l_s[h] = l_s[h] * alpha + sum;
          m_s[h] = m_new;
          a_s[h] = alpha;
        }
      }
      __syncthreads();

      // Phase 3: acc = acc * alpha + p @ v, one thread per column, each V
      // value read once for the HPG heads.
      for (int d = tid; d < D; d += kThreads) {
        for (int h0 = 0; h0 < hpg; h0 += kHeadChunk) {
          float a[kHeadChunk];
#pragma unroll
          for (int u = 0; u < kHeadChunk; ++u) a[u] = 0.f;
          for (int s = 0; s < cur; ++s) {
            const float vv = to_f32<T>(v_s[(size_t)s * ld + d]);
#pragma unroll
            for (int u = 0; u < kHeadChunk; ++u)
              if (h0 + u < hpg) a[u] = fmaf(p_s[(h0 + u) * CH + s], vv, a[u]);
          }
#pragma unroll
          for (int u = 0; u < kHeadChunk; ++u)
            if (h0 + u < hpg)
              acc[(h0 + u) * D + d] = acc[(h0 + u) * D + d] * a_s[h0 + u] + a[u];
        }
      }
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * Hq + (size_t)g * hpg) * D;
  for (int i = tid; i < hpg * D; i += kThreads)
    ob[i] = from_f32<T>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bt, const void* sl,
           void* out, int B, int Hq, int G, int D, int BS, int NB, int MB, long long rows,
           float scale, cudaStream_t stream) {
  const int hpg = Hq / G;
  const int ld = D + 16 / (int)sizeof(T);
  int CH = kChunkBytes / (D * (int)sizeof(T));
  if (CH > kMaxChunk) CH = kMaxChunk;
  if (CH > BS) CH = BS;
  if (CH < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)CH * ld * sizeof(T) +
                      (size_t)(2 * hpg * D + hpg * CH + 3 * hpg) * sizeof(float);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kern = pa_headmajor_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B, G), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(bt), static_cast<const int*>(sl), static_cast<T*>(out), Hq, G,
      D, BS, NB, MB, rows, CH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,Hq,D], k/v [G, rows, D] head-major with rows >= NB*BS, out [B,Hq,D],
// all in dtype (0 = bfloat16, 1 = float32, 2 = float16); bt int32 [B,MB], sl
// int32 [B]. D a multiple of 8; k and v 16-byte aligned. Returns a
// cudaError_t code.
extern "C" int pa_headmajor_launch(const void* q, const void* k, const void* v,
                                   const void* bt, const void* sl, void* out, int B, int Hq,
                                   int G, int D, int BS, int NB, int MB, long long rows,
                                   float scale, int dtype, void* stream) {
  if (B <= 0 || G <= 0 || Hq % G != 0 || D <= 0 || D % 8 != 0 || BS <= 0 || NB <= 0 ||
      MB <= 0 || rows < (long long)NB * BS || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, k, v, bt, sl, out, B, Hq, G, D, BS, NB, MB, rows, scale,
                                 st);
  if (dtype == 1)
    return launch<float>(q, k, v, bt, sl, out, B, Hq, G, D, BS, NB, MB, rows, scale, st);
  if (dtype == 2)
    return launch<__half>(q, k, v, bt, sl, out, B, Hq, G, D, BS, NB, MB, rows, scale, st);
  return (int)cudaErrorInvalidValue;
}
