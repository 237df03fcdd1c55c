// Kernel B2: paged decode attention for Hopper.
//
// Replaces blazr_tpu/attention/paged_attention.py::_pa_kernel (:34) with
// _pa_attend_block (:115), launched there by paged_attention_decode (:204).
// Same function: attention of ONE query token per sequence over the keys at
// positions < seq_lens[b], read through block_tables[b] from the flat paged
// cache [NB*BS(+1 trash), H_kv, D]. GQA (H_q/H_kv query heads per kv head),
// sliding window (keys at or below seq_len-1-W are masked and the walk starts
// at the first in-window block; at most min(MB, W/BS+2) table slots),
// softcap tanh(l/c)*c after the 1/sqrt(D) scale, ALiBi slope*(pos-(seq_len-1)),
// int8 KV with per-slot-per-head scales (the k-scale multiplies the logits
// before softcap/ALiBi/mask; the v-scale multiplies the probabilities before
// they drop to the compute dtype). Compute in q's dtype with f32 sums:
// logits and the AV product take f32 sums of exact products; online softmax
// in f32, masked logits -1e30, out = acc / max(l, 1e-30), so a row with no
// valid key gives 0. PAD_BLOCK (and any id outside [0, NB)) reads block 0,
// whose keys are masked by position.
//
// What bounds it on the H100: bytes — each in-window K/V row (H_kv*D values
// per slot, plus the two f32 scales in int8 mode) must be read once, at
// 3.35 TB/s. B=8 sequences at 1024 tokens move ~33.5 MB per layer (~10 us).
//
// Design (simple and right first): one block of 128 threads per (sequence,
// kv head). The block loads its own block-table row and seq_len (there is no
// scalar prefetch), keeps the H_q/H_kv query rows in shared memory, and walks
// only the in-window block slots. Per KV block: one thread per key reads the
// key's row in 16-byte vectors (rows lie H_kv*D apart) and dots it with the
// query rows; one warp per head updates the running max and denominator;
// each thread then owns head dimensions d and accumulates p·v in f32,
// reading 16 V rows per batch so their loads are in flight together. The ``fan``
// knob of the TPU kernel amortised grid steps and changes no result, so it
// has no counterpart. Known limits, left for later PRs: only B*H_kv blocks
// (64 at B=8 on Mistral), no split over the sequence (flash-decoding), and
// three barriers per KV block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHeadDim = 256;
constexpr int kHeadChunk = 8;      // query heads per pass over a K row / V column
constexpr int kKeyBatch = 16;      // V rows loaded together

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) { return (float)v; }

// Round an f32 value to the compute dtype (the probabilities' cast).
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Eight consecutive cache elements as f32 (one 16/8/32-byte vector read;
// rows start on 16-byte boundaries because D is a multiple of 32).
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
__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = (float)b[i];
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ bool key_valid(int pos, int seq_len, int window) {
  return pos < seq_len && (window <= 0 || pos > seq_len - 1 - window);
}

// TQ: query / compute / output dtype. TKV: cache dtype (TQ or int8).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
pa_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                 const TKV* __restrict__ vc, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ bt,
                 const int* __restrict__ sl, const float* __restrict__ alibi,
                 TQ* __restrict__ out, int Hq, int Hkv, int D, int BS, int NB,
                 int MB, int window, float softcap, float scale) {
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int hpg = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int nwarps = kThreads / 32;
  extern __shared__ float sm[];
  float* q_s = sm;                   // [hpg][D]
  float* acc = q_s + hpg * D;        // [hpg][D]
  float* p_s = acc + hpg * D;        // [hpg][BS] logits, then probabilities
  float* m_s = p_s + hpg * BS;       // [hpg] running max
  float* l_s = m_s + hpg;            // [hpg] running denominator
  float* a_s = l_s + hpg;            // [hpg] this block's rescale factor

  const int seq_len = sl[b];
  const TQ* qb = q + ((size_t)b * Hq + (size_t)kvh * hpg) * D;
  for (int i = tid; i < hpg * D; i += kThreads) {
    q_s[i] = to_f32<TQ>(qb[i]);
    acc[i] = 0.f;
  }
  for (int h = tid; h < hpg; h += kThreads) {
    m_s[h] = -1e30f;
    l_s[h] = 0.f;
  }
  __syncthreads();

  int lo = 0, mb_eff = MB;
  if (window > 0) {
    lo = max(seq_len - window, 0) / BS;   // first slot holding an in-window key
    mb_eff = min(MB, window / BS + 2);
  }
  const size_t row_stride = (size_t)Hkv * D;

  for (int t = 0; t < mb_eff; ++t) {
    const int tt = lo + t;
    if (tt * BS >= seq_len) break;        // this and every later slot is empty
    int blk = bt[(size_t)b * MB + min(tt, MB - 1)];
    if (blk < 0 || blk >= NB) blk = 0;
    const size_t slot0 = (size_t)blk * BS;

    // Phase 1: logits for every (head, key) of this block, one thread per
    // key: the key's row is read in 8-element vectors and dotted with the
    // query rows (shared-memory broadcasts), kHeadChunk heads at a time.
    for (int s = tid; s < BS; s += kThreads) {
      const TKV* krow = kc + (slot0 + s) * row_stride + (size_t)kvh * D;
      const int pos = tt * BS + s;
      const bool valid = key_valid(pos, seq_len, window);
      const float kscale = ks ? ks[(slot0 + s) * Hkv + kvh] : 1.f;
      for (int h0 = 0; h0 < hpg; h0 += kHeadChunk) {
        float dot[kHeadChunk];
#pragma unroll
        for (int u = 0; u < kHeadChunk; ++u) dot[u] = 0.f;
#pragma unroll 4
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
        for (int u = 0; u < kHeadChunk; ++u) {
          const int h = h0 + u;
          if (h < hpg) {
            float l = dot[u] * scale;
            if (ks) l *= kscale;
            if (softcap > 0.f) l = tanhf(l / softcap) * softcap;
            if (alibi) l += alibi[kvh * hpg + h] * (float)(pos - (seq_len - 1));
            p_s[h * BS + s] = valid ? l : -1e30f;
          }
        }
      }
    }
    __syncthreads();

    // Phase 2: online-softmax update, one warp per head.
    for (int h = warp; h < hpg; h += nwarps) {
      float mx = -3.0e38f;
      for (int s = lane; s < BS; s += 32) mx = fmaxf(mx, p_s[h * BS + s]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < BS; s += 32) {
        const int pos = tt * BS + s;
        float p = key_valid(pos, seq_len, window) ? expf(p_s[h * BS + s] - m_new) : 0.f;
        sum += p;
        if (vs) p *= vs[(slot0 + s) * Hkv + kvh];
        p_s[h * BS + s] = round_to<TQ>(p);   // probabilities in the compute dtype
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

    // Phase 3: acc = acc * alpha + p @ v, each thread owning dimensions d;
    // the V column is read kKeyBatch keys at a time, all loads in flight.
    for (int d = tid; d < D; d += kThreads) {
      const TKV* vcol = vc + slot0 * row_stride + (size_t)kvh * D + d;
      for (int h0 = 0; h0 < hpg; h0 += kHeadChunk) {
        float a[kHeadChunk];
#pragma unroll
        for (int u = 0; u < kHeadChunk; ++u) a[u] = 0.f;
        for (int s0 = 0; s0 < BS; s0 += kKeyBatch) {
          float vv[kKeyBatch];
#pragma unroll
          for (int e = 0; e < kKeyBatch; ++e)
            vv[e] = s0 + e < BS ? to_f32<TKV>(vcol[(size_t)(s0 + e) * row_stride]) : 0.f;
#pragma unroll
          for (int e = 0; e < kKeyBatch; ++e) {
            if (s0 + e < BS) {
#pragma unroll
              for (int u = 0; u < kHeadChunk; ++u)
                if (h0 + u < hpg) a[u] = fmaf(p_s[(h0 + u) * BS + s0 + e], vv[e], a[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kHeadChunk; ++u)
          if (h0 + u < hpg)
            acc[(h0 + u) * D + d] = acc[(h0 + u) * D + d] * a_s[h0 + u] + a[u];
      }
    }
    __syncthreads();
  }

  TQ* ob = out + ((size_t)b * Hq + (size_t)kvh * hpg) * D;
  for (int i = tid; i < hpg * D; i += kThreads)
    ob[i] = from_f32<TQ>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* bt, const void* sl, const void* alibi, void* out, int B, int Hq,
           int Hkv, int D, int BS, int NB, int MB, int window, float softcap, float scale,
           cudaStream_t stream) {
  const int hpg = Hq / Hkv;
  const size_t smem = (size_t)(2 * hpg * D + hpg * BS + 3 * hpg) * sizeof(float);
  auto kern = pa_decode_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, Hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(bt), static_cast<const int*>(sl),
      static_cast<const float*>(alibi), static_cast<TQ*>(out), Hq, Hkv, D, BS, NB, MB,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype: 0 = bfloat16, 1 = float32 (q, out, and the cache unless kv_int8).
// ks/vs (int8 KV scales) and alibi may be null. window <= 0: no window;
// softcap <= 0: no softcap. Returns a cudaError_t code.
extern "C" int pa_decode_launch(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs, const void* bt,
                                const void* sl, const void* alibi, void* out, int B,
                                int Hq, int Hkv, int D, int BS, int NB, int MB,
                                int window, float softcap, float scale, int q_dtype,
                                int kv_int8, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D % 32 != 0 || D > kMaxHeadDim ||
      BS <= 0 || MB <= 0 || NB <= 0 || (kv_int8 && (ks == nullptr || vs == nullptr)) ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 || reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) {
    if (kv_int8)
      return launch<__nv_bfloat16, int8_t>(q, k, v, ks, vs, bt, sl, alibi, out, B, Hq,
                                           Hkv, D, BS, NB, MB, window, softcap, scale, st);
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, nullptr, nullptr, bt, sl, alibi,
                                                 out, B, Hq, Hkv, D, BS, NB, MB, window,
                                                 softcap, scale, st);
  }
  if (q_dtype == 1) {
    if (kv_int8)
      return launch<float, int8_t>(q, k, v, ks, vs, bt, sl, alibi, out, B, Hq, Hkv, D,
                                   BS, NB, MB, window, softcap, scale, st);
    return launch<float, float>(q, k, v, nullptr, nullptr, bt, sl, alibi, out, B, Hq,
                                Hkv, D, BS, NB, MB, window, softcap, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
