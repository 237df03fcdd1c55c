// Kernel B2: paged decode attention for Hopper, split over the sequence.
//
// Replaces blazr_tpu/attention/paged_attention.py::_pa_kernel (:34) with
// _pa_attend_block (:115), launched there by paged_attention_decode (:204).
// Same function: attention of ONE query token per sequence over the keys at
// positions < seq_lens[b], read through block_tables[b] from the flat paged
// cache [NB*BS(+1 trash), H_kv, D]. GQA (H_q/H_kv query heads per kv head),
// sliding window (keys at or below seq_len-1-W are masked and the walk starts
// at the first in-window block: slot lo = max(seq_len-W, 0)/BS, at most
// mb_eff = min(MB, W/BS+2) table slots, the table index clamped to MB-1),
// softcap tanh(l/c)*c after the score scale (the caller's: 1/sqrt(D), or
// Gemma2's query_pre_attn_scalar^-0.5), ALiBi slope*(pos-(seq_len-1)),
// int8 KV with per-slot-per-head scales. The logits take, in this order, the
// score scale, the k-scale, softcap, ALiBi and the mask (-1e30); the
// v-scale multiplies the probabilities before they are rounded to q's dtype.
// Compute in q's dtype with f32 sums: logits and the AV product take f32 sums
// of exact products; online softmax in f32; out = acc / max(l, 1e-30), so a
// row with no valid key gives 0. Block ids outside [0, NB) read block 0,
// whose keys are masked by position.
//
// What bounds it on the H100: bytes. Each in-window K/V row (D values of one
// kv head per slot, plus the two f32 scales in int8 mode) must be read once:
// B=8 sequences at 1024 tokens, Mistral's 8 kv heads of 128, bf16, move
// 33.7 MB per layer, 0.010 ms at 3.35 TB/s.
//
// Design:
//   * Flash-decoding. The grid is (B, H_kv, splits): the wrapper fixes only
//     the split count (attention/paged_attention.py::split_plan), from the
//     batch, the kv heads and the walk cap (the table width, or the window's
//     slots): as many splits as one wave of two blocks a SM holds (B=8: 4
//     splits, 256 blocks; a partial second wave costs more than it saves).
//     Each block derives its own span on the device from seq_lens[b]: the
//     sequence walks walk_b = min(mb_eff, ceil(seq_len/BS) - lo) slots, cut
//     into used_b = max(1, min(splits, walk_b / min_slots)) runs of
//     floor-balanced length (min_slots: the slots of 128 keys), so a split
//     takes at least 128 keys where the walk has them, and every split below
//     used_b holds slots. A table as wide as max_blocks_per_seq (the decode
//     graphs' tables) therefore splits the same as one trimmed to the
//     longest sequence (split_spans in the wrapper is the host model). Each
//     split keeps its own running max m, denominator l and f32 acc; with more
//     than one split it writes them as partials and a second small kernel
//     combines the splits of each (sequence, head) in a fixed order:
//     out = sum_z e^{m_z-M} acc_z / max(sum_z e^{m_z-M} l_z, 1e-30), M the
//     largest m_z. A split with no valid key ends with m = -1e30, l = 0 and
//     acc = 0, so it is weighted by 0 (by 1 when every split is empty, which
//     still gives 0): exp(-1e30 - (-1e30)) is 1, not NaN.
//   * The probabilities rounded to q's dtype are relative to the split's
//     running max (as they were relative to the running max of the walk
//     before): the rounding differs from the unsplit kernel's, within the
//     same 1e-2 bf16 tolerance.
//   * The K and V rows of the block's kv head stream in chunks of CH keys
//     (the launcher's chunk_rows: CH divides BS, at most 64, and the padded
//     K and V rows fit 36 KB) through a 3-stage ring (2 where shared
//     memory is short) of 16-byte cp.async copies: the next chunks land while
//     this one is used. Rows are padded by 16 bytes so that the lanes of a
//     warp, one key each, read distinct banks. All query heads of the group
//     read the staged rows (as B6 does).
//   * One warp per query head takes a chunk's logits (a lane per key) and its
//     online-softmax update in registers and warp shuffles; then every thread
//     accumulates p.v for a pair of head dimensions. Two barriers per chunk.
// Known limits: splits past used_b exit empty (short sequences in a wide
// grid); the dot products run on CUDA cores.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxChunk = 64;
constexpr size_t kChunkBytes = 36 * 1024;  // K and V rows of one staged chunk
constexpr size_t kSmemMax = 227 * 1024;
constexpr size_t kTwoPerSm = 112 * 1024;   // two blocks a SM below this

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) { return (float)v; }

// Round an f32 value to the compute dtype (the probabilities' cast).
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
template <> __device__ __forceinline__ float round_to<__half>(float v) {
  return __half2float(__float2half(v));
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half(v); }

// Eight consecutive staged elements as f32 (16-byte aligned rows; int8: 8).
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

// Two consecutive staged elements as f32.
template <typename T> __device__ __forceinline__ float2 load2(const T* p) {
  return make_float2(to_f32<T>(p[0]), to_f32<T>(p[1]));
}
template <> __device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <> __device__ __forceinline__ float2 load2<__half>(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n committed groups are pending (n is 0 or 1 here).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n == 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ bool key_valid(int pos, int seq_len, int window) {
  return pos < seq_len && (window <= 0 || pos > seq_len - 1 - window);
}

struct Layout {
  int ld;                 // staged row pitch, elements
  size_t kv_bytes;        // one of K or V per stage
  size_t stage;           // K, V, k-scales, v-scales
  size_t fixed_off;       // q, acc, p, m, l, alpha after the ring
  size_t total;
};

template <typename TKV>
__host__ __device__ __forceinline__ Layout layout(int hpg, int D, int CH, int nstage) {
  Layout l;
  l.ld = D + 16 / (int)sizeof(TKV);
  l.kv_bytes = (size_t)CH * l.ld * sizeof(TKV);
  l.stage = 2 * l.kv_bytes + (((size_t)CH * 8 + 15) & ~(size_t)15);   // + k/v scales
  l.fixed_off = (size_t)nstage * l.stage;
  l.total = l.fixed_off + (size_t)(2 * hpg * D + hpg * CH + 3 * hpg) * 4;
  return l;
}

// Keys per staged chunk: the largest divisor of BS, at most kMaxChunk, whose
// padded K and V rows fit kChunkBytes.
template <typename TKV>
int chunk_rows(int BS, int D) {
  for (int ch = BS < kMaxChunk ? BS : kMaxChunk; ch > 1; --ch)
    if (BS % ch == 0 && 2 * layout<TKV>(1, D, ch, 1).kv_bytes <= kChunkBytes) return ch;
  return 1;
}

// TQ: query / compute / output dtype. TKV: cache dtype (TQ or int8).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
pa_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                const TKV* __restrict__ vc, const float* __restrict__ ks,
                const float* __restrict__ vs, const int* __restrict__ bt,
                const int* __restrict__ sl, const float* __restrict__ alibi,
                TQ* __restrict__ out, float* __restrict__ part_acc,
                float* __restrict__ part_ml, int Hq, int Hkv, int D, int BS, int NB,
                int MB, int window, float softcap, float scale, int CH, int min_slots,
                int nstage) {
  const int b = blockIdx.x, kvh = blockIdx.y, z = blockIdx.z, splits = gridDim.z;
  const int hpg = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<TKV>(hpg, D, CH, nstage);
  float* q_s = reinterpret_cast<float*>(smem + L.fixed_off);   // [hpg][D]
  float* acc = q_s + hpg * D;                                  // [hpg][D]
  float* p_s = acc + hpg * D;                                  // [hpg][CH]
  float* m_s = p_s + hpg * CH;                                 // [hpg] running max
  float* l_s = m_s + hpg;                                      // [hpg] denominator
  float* a_s = l_s + hpg;                                      // [hpg] rescale factor

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

  int lo = 0, mb_eff = MB;
  if (window > 0) {
    lo = max(seq_len - window, 0) / BS;   // first slot holding an in-window key
    mb_eff = min(MB, window / BS + 2);
  }
  // This split's slots t in [t0, t1) of the walk tt = lo + t: the sequence's
  // walk_b slots (up to the first slot past seq_len) in used_b balanced runs.
  const int walk = max(0, min(mb_eff, (seq_len + BS - 1) / BS - lo));
  const int used = max(1, min(splits, walk / min_slots));
  const int t0 = z < used ? (int)((long long)z * walk / used) : walk;
  const int t1 = z < used ? (int)((long long)(z + 1) * walk / used) : walk;
  const int cps = BS / CH;                      // chunks per slot
  const int nch = t1 > t0 ? (t1 - t0) * cps : 0;
  const size_t row_stride = (size_t)Hkv * D;
  const int row16 = D * (int)sizeof(TKV) / 16;  // 16-byte copies per row

  auto chunk_slot0 = [&](int c) -> size_t {     // first cache slot of chunk c
    const int tt = lo + t0 + c / cps;
    int blk = bt[(size_t)b * MB + min(tt, MB - 1)];
    if (blk < 0 || blk >= NB) blk = 0;
    return (size_t)blk * BS + (size_t)(c % cps) * CH;
  };
  auto load = [&](int c, int s) {
    const size_t slot0 = chunk_slot0(c);
    unsigned char* base = smem + (size_t)s * L.stage;
    TKV* k_s = reinterpret_cast<TKV*>(base);
    TKV* v_s = reinterpret_cast<TKV*>(base + L.kv_bytes);
    for (int i = tid; i < CH * row16; i += kThreads) {
      const int r = i / row16, c16 = i - r * row16;
      const size_t src = (slot0 + r) * row_stride + (size_t)kvh * D;
      cp_async16(reinterpret_cast<unsigned char*>(k_s + (size_t)r * L.ld) + c16 * 16,
                 reinterpret_cast<const unsigned char*>(kc + src) + c16 * 16);
      cp_async16(reinterpret_cast<unsigned char*>(v_s + (size_t)r * L.ld) + c16 * 16,
                 reinterpret_cast<const unsigned char*>(vc + src) + c16 * 16);
    }
    if (ks != nullptr) {
      float* ks_s = reinterpret_cast<float*>(base + 2 * L.kv_bytes);
      float* vs_s = ks_s + CH;
      for (int i = tid; i < CH; i += kThreads) {
        cp_async4(ks_s + i, ks + (slot0 + i) * Hkv + kvh);
        cp_async4(vs_s + i, vs + (slot0 + i) * Hkv + kvh);
      }
    }
  };

  for (int s = 0; s < nstage - 1; ++s) {
    if (s < nch) load(s, s);
    cp_async_commit();
  }
  const int dpairs = D / 2;
  const int ngrp = kThreads / dpairs;           // head groups in the AV phase
  const int dp = tid % dpairs, hg = tid / dpairs;
  for (int c = 0; c < nch; ++c) {
    cp_async_wait_pending(nstage - 2);          // chunk c has landed (own copies)
    __syncthreads();                            // ... everyone's; chunk c-1 fully used
    if (c + nstage - 1 < nch) load(c + nstage - 1, (c + nstage - 1) % nstage);
    cp_async_commit();

    const int pos0 = (lo + t0 + c / cps) * BS + (c % cps) * CH;
    const unsigned char* base = smem + (size_t)(c % nstage) * L.stage;
    const TKV* k_s = reinterpret_cast<const TKV*>(base);
    const TKV* v_s = reinterpret_cast<const TKV*>(base + L.kv_bytes);
    const float* ks_s = reinterpret_cast<const float*>(base + 2 * L.kv_bytes);
    const float* vs_s = ks_s + CH;

    // Logits and the online-softmax update: one warp per head, a lane per key.
    for (int h = warp; h < hpg; h += kWarps) {
      const float* qh = q_s + h * D;
      float lg[2];
      float mx = -3.0e38f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = lane + 32 * u;
        lg[u] = -3.0e38f;
        if (s < CH) {
          const TKV* krow = k_s + (size_t)s * L.ld;
          float dot = 0.f;
#pragma unroll 4
          for (int d0 = 0; d0 < D; d0 += 8) {
            float kv[8];
            load8(krow + d0, kv);
            const float4 qa = *reinterpret_cast<const float4*>(qh + d0);
            const float4 qc = *reinterpret_cast<const float4*>(qh + d0 + 4);
            dot = fmaf(qa.x, kv[0], dot);
            dot = fmaf(qa.y, kv[1], dot);
            dot = fmaf(qa.z, kv[2], dot);
            dot = fmaf(qa.w, kv[3], dot);
            dot = fmaf(qc.x, kv[4], dot);
            dot = fmaf(qc.y, kv[5], dot);
            dot = fmaf(qc.z, kv[6], dot);
            dot = fmaf(qc.w, kv[7], dot);
          }
          const int pos = pos0 + s;
          float l = dot * scale;
          if (ks != nullptr) l *= ks_s[s];
          if (softcap > 0.f) l = tanhf(l / softcap) * softcap;
          if (alibi != nullptr) l += alibi[kvh * hpg + h] * (float)(pos - (seq_len - 1));
          lg[u] = key_valid(pos, seq_len, window) ? l : -1e30f;
        }
        mx = fmaxf(mx, lg[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = lane + 32 * u;
        if (s < CH) {
          float p = key_valid(pos0 + s, seq_len, window) ? expf(lg[u] - m_new) : 0.f;
          sum += p;
          if (vs != nullptr) p *= vs_s[s];
          p_s[h * CH + s] = round_to<TQ>(p);   // probabilities in the compute dtype
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
        a_s[h] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v: each thread owns dimensions 2dp, 2dp+1 of
    // the heads hg, hg + ngrp, ..., four at a time.
    if (hg < ngrp) {
      for (int hb = hg; hb < hpg; hb += 4 * ngrp) {
        float a[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u][0] = a[u][1] = 0.f;
        for (int s = 0; s < CH; ++s) {
          const float2 v = load2<TKV>(v_s + (size_t)s * L.ld + 2 * dp);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int h = hb + u * ngrp;
            if (h < hpg) {
              const float p = p_s[h * CH + s];
              a[u][0] = fmaf(p, v.x, a[u][0]);
              a[u][1] = fmaf(p, v.y, a[u][1]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int h = hb + u * ngrp;
          if (h < hpg) {
            float* ah = acc + h * D + 2 * dp;
            ah[0] = ah[0] * a_s[h] + a[u][0];
            ah[1] = ah[1] * a_s[h] + a[u][1];
          }
        }
      }
    }
  }
  cp_async_wait_pending(0);
  __syncthreads();

  if (splits == 1) {
    TQ* ob = out + ((size_t)b * Hq + (size_t)kvh * hpg) * D;
    for (int i = tid; i < hpg * D; i += kThreads)
      ob[i] = from_f32<TQ>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
    return;
  }
  for (int i = tid; i < hpg * D; i += kThreads) {
    const int h = i / D, d = i - h * D;
    const size_t row = ((size_t)b * Hq + (size_t)kvh * hpg + h) * splits + z;
    part_acc[row * D + d] = acc[i];
    if (d == 0) {
      part_ml[row * 2] = m_s[h];
      part_ml[row * 2 + 1] = l_s[h];
    }
  }
}

// Combine the splits of one (sequence, query head) in order z = 0, 1, ...
template <typename TQ>
__global__ void pa_combine_kernel(const float* __restrict__ part_acc,
                                  const float* __restrict__ part_ml, TQ* __restrict__ out,
                                  int Hq, int D, int splits) {
  const size_t row = (size_t)blockIdx.x * Hq + blockIdx.y;
  const float* ml = part_ml + row * splits * 2;
  float mx = -3.0e38f;
  for (int z = 0; z < splits; ++z) mx = fmaxf(mx, ml[2 * z]);
  float l = 0.f;
  for (int z = 0; z < splits; ++z) l += expf(ml[2 * z] - mx) * ml[2 * z + 1];
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int z = 0; z < splits; ++z)
      a += expf(ml[2 * z] - mx) * part_acc[(row * splits + z) * D + d];
    out[row * D + d] = from_f32<TQ>(a * inv);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* bt, const void* sl, const void* alibi, void* out, void* part_acc,
           void* part_ml, int B, int Hq, int Hkv, int D, int BS, int NB, int MB, int window,
           float softcap, float scale, int splits, int min_slots, cudaStream_t stream) {
  const int hpg = Hq / Hkv;
  const int CH = chunk_rows<TKV>(BS, D);
  int nstage = 3;
  Layout l = layout<TKV>(hpg, D, CH, nstage);
  if (l.total > kTwoPerSm) {
    nstage = 2;
    l = layout<TKV>(hpg, D, CH, nstage);
  }
  if (l.total > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kern = pa_split_kernel<TQ, TKV>;
  static size_t allowed = 48 * 1024;   // the attribute is set once per size
  if (l.total > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.total);
    if (e != cudaSuccess) return (int)e;
    allowed = l.total;
  }
  kern<<<dim3(B, Hkv, splits), kThreads, l.total, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(bt), static_cast<const int*>(sl),
      static_cast<const float*>(alibi), static_cast<TQ*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), Hq, Hkv, D, BS, NB, MB,
      window, softcap, scale, CH, min_slots, nstage);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const int threads = D < kThreads ? D : kThreads;
  pa_combine_kernel<TQ><<<dim3(B, Hq), threads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<TQ*>(out), Hq, D, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype: 0 = bfloat16, 1 = float32, 2 = float16 (q, out, and the cache
// unless kv_int8). ks/vs (int8 KV scales) and alibi may be null. window <= 0:
// no window; softcap <= 0: no softcap. splits: the grid's split count;
// min_slots: the fewest table slots a split takes where the walk has them
// (each block derives its span from seq_lens). part_acc f32 [B, Hq, splits,
// D] and part_ml f32 [B, Hq, splits, 2] scratch (unused when splits == 1).
// Returns a cudaError_t.
extern "C" int pa_decode_launch(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs, const void* bt,
                                const void* sl, const void* alibi, void* out,
                                void* part_acc, void* part_ml, int B, int Hq, int Hkv,
                                int D, int BS, int NB, int MB, int window, float softcap,
                                float scale, int splits, int min_slots, int q_dtype,
                                int kv_int8, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D % 32 != 0 || D > kMaxHeadDim ||
      BS <= 0 || MB <= 0 || NB <= 0 ||
      splits <= 0 || min_slots <= 0 || (splits > 1 && (part_acc == nullptr || part_ml == nullptr)) ||
      (kv_int8 && (ks == nullptr || vs == nullptr)) ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 || reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto by_kv = [&](auto tag) {
    using TQ = decltype(tag);
    if (kv_int8)
      return launch<TQ, int8_t>(q, k, v, ks, vs, bt, sl, alibi, out, part_acc, part_ml, B,
                                Hq, Hkv, D, BS, NB, MB, window, softcap, scale, splits,
                                min_slots, st);
    return launch<TQ, TQ>(q, k, v, nullptr, nullptr, bt, sl, alibi, out, part_acc, part_ml,
                          B, Hq, Hkv, D, BS, NB, MB, window, softcap, scale, splits,
                          min_slots, st);
  };
  if (q_dtype == 0) return by_kv(__nv_bfloat16());
  if (q_dtype == 1) return by_kv(float());
  if (q_dtype == 2) return by_kv(__half());
  return (int)cudaErrorInvalidValue;
}
