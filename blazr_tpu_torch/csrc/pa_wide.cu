// Kernel B5: paged decode attention over the wide KV view, for Hopper.
//
// Replaces tools/bench_pa_wide.py::wide_kernel (:31), launched there by
// pa_wide (:82). Same function: attention of ONE query token per sequence
// over the keys at positions t*BS + i < seq_lens[b], read through
// block_tables[b] from the flat paged cache [NB*BS(+1 trash), G, D], with
// H_q/G query heads per kv head (GQA) and no window, softcap, ALiBi or int8
// KV. Logits are (q * 1/sqrt(D)) . k with f32 sums; online softmax in f32
// starting from m = -1e30; masked keys get probability 0; the probabilities
// stay f32 (unlike B2, they are not rounded to q's dtype before the PV
// product); out = acc / max(l, 1e-30), in q's dtype. Block ids outside
// [0, NB) read block 0, whose keys are masked by position.
//
// The TPU kernel views one KV block as [BS, G*D] (its natural HBM order) and
// does QK^T as one wide product against a block-diagonal query [H_q, G*D],
// then PV as one [H_q, BS] x [BS, G*D] product folded back per group. The
// block-diagonal zeros add nothing on this card but work, so here each query
// head dots only its own group's D columns of the wide row: the same sums,
// without the exact zeros. What stays is the layout idea: one sequence's
// block is read as contiguous G*D-element rows (2 KB in bf16 at G=8, D=128)
// that serve all H_q query heads.
//
// What bounds it on the H100: bytes. Each valid K/V row (G*D values) is read
// once: B=8 sequences at 1023 tokens, bf16, move ~33.5 MB (~10 us at
// 3.35 TB/s).
//
// Design (simple and right first): one block of 256 threads per sequence
// (the TPU grid's b axis; its t axis becomes a loop over the table). A whole
// block does not fit in shared memory at BS=128 (2 x 256 KB in bf16 against
// 227 KB), so K and V rows are staged in chunks of CH rows, CH * G*D values
// of at most 64 KB each, with rows padded by 16 bytes so that threads
// reading neighbouring rows hit different banks. Per chunk: one thread per
// (key, group) dots the key's D columns with the group's query heads (q in
// f32 shared memory, a broadcast); one warp per head updates the running
// max and denominator; one thread per (group, 4 columns) accumulates p.v for
// the group's heads, reading each V value once for all of them. Known
// limits, left for later PRs: only B blocks (8 at B=8, on 132 SMs), the
// loads are not pipelined (no cp.async/TMA), and three barriers per chunk.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeadChunk = 8;            // query heads per pass over a K row / V column
constexpr int kChunkBytes = 64 * 1024;   // K (and V) bytes staged per chunk
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

// Four consecutive values as f32 (8-byte aligned for 2-byte types, 16 for f32).
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ void load4(const __half* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&v);
  const float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pa_wide_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
               const int* __restrict__ bt, const int* __restrict__ sl, T* __restrict__ out,
               int Hq, int G, int D, int BS, int NB, int MB, int CH, float scale) {
  const int b = blockIdx.x;
  const int hpg = Hq / G;
  const int GD = G * D;
  const int ld = GD + 16 / (int)sizeof(T);   // padded row: neighbours 16 bytes apart in banks
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int nwarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                              // [CH][ld]
  T* v_s = k_s + (size_t)CH * ld;                                   // [CH][ld]
  float* q_s = reinterpret_cast<float*>(v_s + (size_t)CH * ld);     // [Hq][D], scaled
  float* acc = q_s + Hq * D;                                        // [Hq][D]
  float* p_s = acc + Hq * D;                                        // [Hq][CH]
  float* m_s = p_s + Hq * CH;                                       // [Hq] running max
  float* l_s = m_s + Hq;                                            // [Hq] denominator
  float* a_s = l_s + Hq;                                            // [Hq] rescale factor

  const int seq_len = sl[b];
  const T* qb = q + (size_t)b * Hq * D;
  for (int i = tid; i < Hq * D; i += kThreads) {
    q_s[i] = to_f32<T>(qb[i]) * scale;
    acc[i] = 0.f;
  }
  for (int h = tid; h < Hq; h += kThreads) {
    m_s[h] = -1e30f;
    l_s[h] = 0.f;
  }
  const int per16 = 16 / (int)sizeof(T);      // values per 16-byte word
  const int row16 = GD / per16;               // 16-byte words per wide row

  for (int t = 0; t < MB && t * BS < seq_len; ++t) {
    int blk = bt[(size_t)b * MB + t];
    if (blk < 0 || blk >= NB) blk = 0;
    for (int s0 = 0; s0 < BS && t * BS + s0 < seq_len; s0 += CH) {
      const int cur = min(CH, BS - s0);
      // Stage rows s0 .. s0+cur of the block: one contiguous run of cur*G*D
      // values in the flat cache.
      const size_t base = ((size_t)blk * BS + s0) * GD;
      const uint4* kg = reinterpret_cast<const uint4*>(kc + base);
      const uint4* vg = reinterpret_cast<const uint4*>(vc + base);
      __syncthreads();                          // previous chunk fully read
      for (int i = tid; i < cur * row16; i += kThreads) {
        const int r = i / row16, c = i - r * row16;
        *reinterpret_cast<uint4*>(k_s + (size_t)r * ld + c * per16) = kg[i];
        *reinterpret_cast<uint4*>(v_s + (size_t)r * ld + c * per16) = vg[i];
      }
      __syncthreads();

      // Phase 1: logits, one thread per (key, group); lanes take neighbouring
      // keys of one group, so the query rows are broadcasts.
      for (int i = tid; i < cur * G; i += kThreads) {
        const int s = i % cur, g = i / cur;
        const bool valid = t * BS + s0 + s < seq_len;
        const T* krow = k_s + (size_t)s * ld + g * D;
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
                const float* qh = q_s + (g * hpg + h0 + u) * D + d0;
#pragma unroll
                for (int e = 0; e < 8; ++e) dot[u] = fmaf(qh[e], kv[e], dot[u]);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kHeadChunk; ++u)
            if (h0 + u < hpg) p_s[(g * hpg + h0 + u) * CH + s] = valid ? dot[u] : -1e30f;
        }
      }
      __syncthreads();

      // Phase 2: online-softmax update, one warp per head; p stays f32.
      for (int h = warp; h < Hq; h += nwarps) {
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

      // Phase 3: acc = acc * alpha + p @ v, one thread per (group, 4 columns),
      // each V value read once for the group's heads.
      const int dq = D / 4;
      for (int i = tid; i < G * dq; i += kThreads) {
        const int g = i / dq, d = (i - g * dq) * 4;
        const T* vcol = v_s + g * D + d;
        for (int h0 = 0; h0 < hpg; h0 += kHeadChunk) {
          float a[kHeadChunk][4];
#pragma unroll
          for (int u = 0; u < kHeadChunk; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) a[u][e] = 0.f;
          for (int s = 0; s < cur; ++s) {
            float vv[4];
            load4(vcol + (size_t)s * ld, vv);
#pragma unroll
            for (int u = 0; u < kHeadChunk; ++u) {
              if (h0 + u < hpg) {
                const float p = p_s[(g * hpg + h0 + u) * CH + s];
#pragma unroll
                for (int e = 0; e < 4; ++e) a[u][e] = fmaf(p, vv[e], a[u][e]);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kHeadChunk; ++u) {
            if (h0 + u < hpg) {
              const int h = g * hpg + h0 + u;
              float* ah = acc + h * D + d;
#pragma unroll
              for (int e = 0; e < 4; ++e) ah[e] = ah[e] * a_s[h] + a[u][e];
            }
          }
        }
      }
    }
  }
  __syncthreads();

  T* ob = out + (size_t)b * Hq * D;
  for (int i = tid; i < Hq * D; i += kThreads)
    ob[i] = from_f32<T>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bt, const void* sl,
           void* out, int B, int Hq, int G, int D, int BS, int NB, int MB, float scale,
           cudaStream_t stream) {
  const int ld = G * D + 16 / (int)sizeof(T);
  int CH = kChunkBytes / (G * D * (int)sizeof(T));
  if (CH > BS) CH = BS;
  if (CH < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)CH * ld * sizeof(T) +
                      (size_t)(2 * Hq * D + Hq * CH + 3 * Hq) * sizeof(float);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kern = pa_wide_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(bt), static_cast<const int*>(sl), static_cast<T*>(out), Hq, G,
      D, BS, NB, MB, CH, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,Hq,D], k/v [>= NB*BS, G, D] (flat paged cache), out [B,Hq,D], all in
// dtype (0 = bfloat16, 1 = float32, 2 = float16); bt int32 [B,MB], sl int32
// [B]. D a multiple of 8; k and v 16-byte aligned. Returns a cudaError_t code.
extern "C" int pa_wide_launch(const void* q, const void* k, const void* v, const void* bt,
                              const void* sl, void* out, int B, int Hq, int G, int D, int BS,
                              int NB, int MB, float scale, int dtype, void* stream) {
  if (B <= 0 || G <= 0 || Hq % G != 0 || D <= 0 || D % 8 != 0 || BS <= 0 || NB <= 0 ||
      MB <= 0 || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, k, v, bt, sl, out, B, Hq, G, D, BS, NB, MB, scale, st);
  if (dtype == 1)
    return launch<float>(q, k, v, bt, sl, out, B, Hq, G, D, BS, NB, MB, scale, st);
  if (dtype == 2)
    return launch<__half>(q, k, v, bt, sl, out, B, Hq, G, D, BS, NB, MB, scale, st);
  return (int)cudaErrorInvalidValue;
}
