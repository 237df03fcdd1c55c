// The split-and-combine decode attention shared by kernels B5 (pa_wide.cu,
// the wide KV view) and B6 (pa_headmajor.cu, the head-major KV cache).
//
// Both compute the function of the TPU layout tools' kernels: attention of
// ONE query token per sequence over the keys at positions
// t*BS + i < seq_lens[b], read through block_tables[b]; GQA with hpg = H_q/G
// query heads per kv head; no window, softcap, ALiBi or int8 KV. Logits are
// (q * 1/sqrt(D) in f32) . k with f32 sums; online softmax in f32 from
// m = -1e30; masked keys get probability 0; the probabilities stay f32 (they
// are not rounded to q's dtype before the PV product, unlike B2);
// out = acc / max(l, 1e-30) in q's dtype, so a sequence with seq_len 0 gives
// 0. Block ids outside [0, NB) read block 0, whose keys are masked by
// position. The two layouts differ only in where a kv head's row of a cache
// slot lies: slot * row_stride + kv_head * head_stride elements in (B5:
// G*D and D, so the G heads of a slot are one wide row; B6: D and rows*D).
//
// Dot products run on CUDA cores in f32. Tensor cores would change the
// function: a bf16 mma/wgmma rounds q * 1/sqrt(D) and p to bf16, and TF32
// rounds both too. At 4 flops a byte of bf16 K/V the f32 CUDA cores keep up
// with the byte bound, but not by much (2 us of FMAs against 10 us of bytes
// at B=8, ctx 1024), so the loops below issue few instructions besides the
// FMAs: the copy loop steps its indices without division, and the loops
// over a lane's 16-byte pieces and a warp's keys are unrolled.
//
// The plan (tools/bench_pa_*.py::*_split_plan): the grid is (B, group blocks,
// splits); split z walks table slots [z*per, min(MB, z*per+per)), stopping at
// the last key below seq_len. The launcher here picks the rest:
//   * a block covers `ng` kv heads (B5: all G, so it reads whole wide rows;
//     B6: one) and all their query heads;
//   * its keys come in chunks of `ch` rows (a divisor of BS, at most 32); a
//     chunk lies in one slot;
//   * chunks stream through a ring of `nstage` (3 or 2) stages of 16-byte
//     cp.async copies: the next chunks land while this one is used. Rows
//     past seq_len are not read (zero-filled);
//   * of the (ch, nstage) that fit 227 KB and 16 warps, the one that keeps
//     the most warps on a SM for this grid (the runtime's occupancy, at most
//     the grid's blocks a SM), then the deeper ring, then the longer chunk;
//   * a warp carries up to kHeads query heads of one kv head over
//     kKeysPerWarp keys of every chunk; `kw` warps split a chunk's keys, each
//     with its own running max m, denominator l and f32 acc in registers.
//     At the end the kw warps of a head quad merge in a fixed order, as the
//     splits do;
//   * one barrier a chunk: after it, chunk c has landed for every thread and
//     chunk c-1 is used up, so its stage takes chunk c+nstage-1.
//
// A warp's chunk: logits with kLanesPerKey lanes a key, each taking every
// kLanesPerKey-th 16-byte piece of the key's D columns (q in f32 shared
// memory, a broadcast to the 8 lanes of a quarter warp), summed by two
// shuffles a head. Bank conflicts: K rows are padded by 16 bytes, so the 8
// keys of a quarter warp read 8 different bank groups (one bulk copy of an
// unpadded run would put them on the same banks; the per-row cp.async keeps
// the padding). The online-softmax update runs in registers and shuffles,
// p goes to the warp's own float4 a key, and the PV product maps lanes
// across D (4 columns each: a warp reads 256 contiguous bytes of an unpadded
// V row) with acc in registers.
//
// With more than one split, each (sequence, query head, split) writes its
// m, l and acc as partials and pa_combine_kernel combines the splits in
// order z = 0, 1, ...: out = sum_z e^{m_z-M} acc_z / max(sum_z e^{m_z-M} l_z,
// 1e-30), M the largest m_z. A split with no valid key ends with m = -1e30,
// l = 0, acc = 0: it weighs 0, or 1 when every split is empty (which still
// gives 0; exp(-1e30 - (-1e30)) is 1, not NaN).

#pragma once

#include <algorithm>
#include <array>
#include <map>
#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int kKeysPerWarp = 8;                     // keys of a chunk a warp takes
constexpr int kLanesPerKey = 32 / kKeysPerWarp;     // lanes sharing one key's dot
constexpr int kHeads = 4;                           // query heads a warp carries
constexpr int kMaxWarps = 16;
constexpr int kMaxChunkRows = 32;
constexpr size_t kSmemLimit = 227 * 1024;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

// Eight consecutive staged values as f32 (16-byte aligned).
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

// Four consecutive staged values as f32 (8-byte aligned; f32 16-byte).
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

// The block's geometry, the same on the host and in the kernel.
struct SplitGeom {
  int ng;            // kv heads a block covers
  int hpg;           // query heads per kv head
  int nq;            // head quads per kv head: ceil(hpg / kHeads)
  int ch;            // keys per chunk
  int kw;            // warps splitting a chunk's keys: ceil(ch / kKeysPerWarp)
  int nstage;        // ring stages
  int D;
  int W;             // staged row: ng * D values
  int ldk;           // K row pitch: W + 16 bytes
  size_t k_bytes, stage, ring, q_off, p_off, total;

  __host__ __device__ int warps() const { return ng * nq * kw; }
};

template <typename T>
__host__ __device__ inline SplitGeom split_geom(int ng, int hpg, int D, int ch, int nstage) {
  SplitGeom g;
  g.ng = ng;
  g.hpg = hpg;
  g.nq = (hpg + kHeads - 1) / kHeads;
  g.ch = ch;
  g.kw = (ch + kKeysPerWarp - 1) / kKeysPerWarp;
  g.nstage = nstage;
  g.D = D;
  g.W = ng * D;
  g.ldk = g.W + 16 / (int)sizeof(T);
  g.k_bytes = (size_t)ch * g.ldk * sizeof(T);
  g.stage = g.k_bytes + (size_t)ch * g.W * sizeof(T);
  const size_t merge = (size_t)g.warps() * kHeads * (D + 2) * sizeof(float);
  g.ring = (size_t)nstage * g.stage > merge ? (size_t)nstage * g.stage : merge;
  g.q_off = g.ring;
  g.p_off = g.q_off + (size_t)ng * hpg * D * sizeof(float);
  g.total = g.p_off + (size_t)g.warps() * kKeysPerWarp * sizeof(float4);
  return g;
}

// grid (B, group blocks, splits); block warps() * 32 threads. PIECES: the
// 4-column pieces of D a lane owns in the PV product (1: D <= 128, 2: <= 256).
template <typename T, int NSTAGE, int PIECES>
__global__ void __launch_bounds__(kMaxWarps * 32)
pa_split_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                const int* __restrict__ bt, const int* __restrict__ sl, T* __restrict__ out,
                float* __restrict__ part_acc, float* __restrict__ part_ml, SplitGeom G,
                int Hq, int BS, int NB, int MB, int per, long long row_stride,
                long long plane_stride, float scale) {
  constexpr int kSegs = 4 * PIECES;              // 16-byte pieces of a K row a lane takes
  const int b = blockIdx.x, gb = blockIdx.y, z = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x;
  const int D = G.D, W = G.W, ch = G.ch, hpg = G.hpg;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + G.q_off);       // [ng*hpg][D], scaled
  float4* p_s = reinterpret_cast<float4*>(smem + G.p_off);     // [warps][kKeysPerWarp]

  const int seq_len = sl[b];
  const int t0 = z * per;
  const int t1 = min(MB, t0 + per);
  const int P0 = t0 * BS;
  const int P1 = min(t1 * BS, seq_len);                        // this split's keys: [P0, P1)
  const int nch = P1 > P0 ? (P1 - P0 + ch - 1) / ch : 0;

  // Copies: this thread's 16-byte pieces of a chunk are (r, c16), (r + dr,
  // c16 + dc), ... over rows of row16 pieces.
  const int row16 = W * (int)sizeof(T) / 16;
  const int r_first = tid / row16, c_first = tid - r_first * row16;
  const int dr = nthreads / row16, dc = nthreads - dr * row16;
  const size_t rs_bytes = (size_t)row_stride * sizeof(T);
  const int ldk_bytes = G.ldk * (int)sizeof(T), ldv_bytes = W * (int)sizeof(T);
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(kc + (size_t)gb * plane_stride);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(vc + (size_t)gb * plane_stride);

  auto load_chunk = [&](int c, int st) {
    const int pos0 = P0 + c * ch;
    const int t = pos0 / BS;
    int blk = bt[(size_t)b * MB + t];
    if (blk < 0 || blk >= NB) blk = 0;
    const size_t src0 = ((size_t)blk * BS + (pos0 - t * BS)) * rs_bytes;
    const int rows = min(ch, P1 - pos0);                       // rows below seq_len
    unsigned char* k_dst = smem + (size_t)st * G.stage;
    unsigned char* v_dst = k_dst + G.k_bytes;
    int r = r_first, c16 = c_first;
    for (int i = tid; i < ch * row16; i += nthreads) {
      const bool ok = r < rows;
      const size_t src = src0 + (ok ? (size_t)r * rs_bytes : 0) + c16 * 16;
      cp_async<16>(k_dst + r * ldk_bytes + c16 * 16, kg + src, ok);
      cp_async<16>(v_dst + r * ldv_bytes + c16 * 16, vg + src, ok);
      r += dr;
      c16 += dc;
      if (c16 >= row16) {
        c16 -= row16;
        ++r;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nch) load_chunk(s, s);
    cp_async_commit();
  }
  const T* qb = q + ((size_t)b * Hq + (size_t)gb * G.ng * hpg) * D;
  for (int i = tid; i < G.ng * hpg * D; i += nthreads) q_s[i] = to_f32<T>(qb[i]) * scale;

  // This warp: kv head gi of the block, heads hb .. hb+nh-1 (block-local),
  // keys kb .. kb+nk-1 of every chunk.
  const int unit = warp / G.kw, kwi = warp - unit * G.kw;
  const int gi = unit / G.nq, qi = unit - gi * G.nq;
  const int hb = gi * hpg + qi * kHeads;
  const int nh = min(kHeads, hpg - qi * kHeads);
  const int kb = kwi * kKeysPerWarp;
  const int nk = max(0, min(kKeysPerWarp, ch - kb));
  const int ks = lane % kKeysPerWarp, sub = lane / kKeysPerWarp;
  const int nseg = D / 8;
  float m[kHeads], l[kHeads], acc[PIECES][kHeads][4];
#pragma unroll
  for (int u = 0; u < kHeads; ++u) {
    m[u] = -1e30f;
    l[u] = 0.f;
#pragma unroll
    for (int pc = 0; pc < PIECES; ++pc)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[pc][u][e] = 0.f;
  }
  float4* p_w = p_s + warp * kKeysPerWarp;
  const float* q_w = q_s + hb * D;

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<NSTAGE - 2>();      // chunk c has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; chunk c-1 is used up
    if (c + NSTAGE - 1 < nch) load_chunk(c + NSTAGE - 1, (c + NSTAGE - 1) % NSTAGE);
    cp_async_commit();

    const unsigned char* base = smem + (size_t)(c % NSTAGE) * G.stage;
    const T* k_s = reinterpret_cast<const T*>(base);
    const T* v_s = reinterpret_cast<const T*>(base + G.k_bytes);
    const int key = kb + ks;
    const bool valid = ks < nk && P0 + c * ch + key < P1;

    // Logits: kLanesPerKey lanes a key, then two shuffles a head.
    float dot[kHeads];
#pragma unroll
    for (int u = 0; u < kHeads; ++u) dot[u] = 0.f;
    if (ks < nk) {
      const T* krow = k_s + (size_t)key * G.ldk + gi * D;
#pragma unroll
      for (int i = 0; i < kSegs; ++i) {
        const int seg = sub + kLanesPerKey * i;
        if (seg < nseg) {
          float kv[8];
          load8(krow + seg * 8, kv);
#pragma unroll
          for (int u = 0; u < kHeads; ++u) {
            if (u < nh) {
              const float* qh = q_w + u * D + seg * 8;
              const float4 qa = *reinterpret_cast<const float4*>(qh);
              const float4 qc = *reinterpret_cast<const float4*>(qh + 4);
              float d = dot[u];
              d = fmaf(qa.x, kv[0], d);
              d = fmaf(qa.y, kv[1], d);
              d = fmaf(qa.z, kv[2], d);
              d = fmaf(qa.w, kv[3], d);
              d = fmaf(qc.x, kv[4], d);
              d = fmaf(qc.y, kv[5], d);
              d = fmaf(qc.z, kv[6], d);
              d = fmaf(qc.w, kv[7], d);
              dot[u] = d;
            }
          }
        }
      }
    }
    // Online softmax over this warp's keys; every lane ends with the same
    // m, l and alpha of each head.
    float p[kHeads];
#pragma unroll
    for (int u = 0; u < kHeads; ++u) {
#pragma unroll
      for (int o = kKeysPerWarp; o < 32; o <<= 1)
        dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], o);
      const float lg = valid ? dot[u] : -1e30f;
      float mx = lg;
#pragma unroll
      for (int o = 1; o < kKeysPerWarp; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[u], mx);
      p[u] = valid ? expf(lg - m_new) : 0.f;
      float sum = p[u];
#pragma unroll
      for (int o = 1; o < kKeysPerWarp; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[u] - m_new);
      l[u] = l[u] * alpha + sum;
      m[u] = m_new;
#pragma unroll
      for (int pc = 0; pc < PIECES; ++pc)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pc][u][e] *= alpha;
    }
    if (sub == 0) p_w[ks] = make_float4(p[0], p[1], p[2], p[3]);
    __syncwarp();

    // acc += p @ v: lane owns columns 4*c4 .. 4*c4+3 for c4 = lane, lane+32.
#pragma unroll
    for (int pc = 0; pc < PIECES; ++pc) {
      const int c4 = lane + 32 * pc;
      if (c4 < D / 4) {
        const T* vcol = v_s + (size_t)kb * W + gi * D + 4 * c4;
#pragma unroll
        for (int s = 0; s < kKeysPerWarp; ++s) {
          if (s < nk) {
            float vv[4];
            load4(vcol + (size_t)s * W, vv);
            const float4 pp = p_w[s];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[pc][0][e] = fmaf(pp.x, vv[e], acc[pc][0][e]);
              acc[pc][1][e] = fmaf(pp.y, vv[e], acc[pc][1][e]);
              acc[pc][2][e] = fmaf(pp.z, vv[e], acc[pc][2][e]);
              acc[pc][3][e] = fmaf(pp.w, vv[e], acc[pc][3][e]);
            }
          }
        }
      }
    }
    __syncwarp();                     // p_w is rewritten by the next chunk
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free: it holds the merge now

  // Merge the kw warps of each head quad in order, then write the output
  // (one split) or this split's partials.
  float* mg = reinterpret_cast<float*>(smem);                 // [warps][kHeads][D + 2]
  const int mrow = D + 2;
  float* mine = mg + (size_t)warp * kHeads * mrow;
#pragma unroll
  for (int u = 0; u < kHeads; ++u) {
#pragma unroll
    for (int pc = 0; pc < PIECES; ++pc) {
      const int c4 = lane + 32 * pc;
      if (c4 < D / 4)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[u * mrow + 4 * c4 + e] = acc[pc][u][e];
    }
    if (lane == 0) {
      mine[u * mrow + D] = m[u];
      mine[u * mrow + D + 1] = l[u];
    }
  }
  __syncthreads();
  const int nout = G.ng * hpg * D;
  for (int i = tid; i < nout; i += nthreads) {
    const int h = i / D, d = i - h * D;                      // block-local head
    const int g = h / hpg, hh = h - g * hpg;
    const int w0 = (g * G.nq + hh / kHeads) * G.kw, u = hh % kHeads;
    float mx = -3.0e38f;
    for (int k = 0; k < G.kw; ++k) mx = fmaxf(mx, mg[((size_t)(w0 + k) * kHeads + u) * mrow + D]);
    float lsum = 0.f, a = 0.f;
    for (int k = 0; k < G.kw; ++k) {
      const float* r = mg + ((size_t)(w0 + k) * kHeads + u) * mrow;
      const float wgt = expf(r[D] - mx);
      lsum += wgt * r[D + 1];
      a += wgt * r[d];
    }
    const size_t hq = (size_t)b * Hq + (size_t)gb * G.ng * hpg + h;
    if (splits == 1) {
      out[hq * D + d] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
    } else {
      const size_t row = hq * splits + z;
      part_acc[row * D + d] = a;
      if (d == 0) {
        part_ml[row * 2] = mx;
        part_ml[row * 2 + 1] = lsum;
      }
    }
  }
}

// Combine the splits of one (sequence, query head) in order z = 0, 1, ...
template <typename T>
__global__ void pa_combine_kernel(const float* __restrict__ part_acc,
                                  const float* __restrict__ part_ml, T* __restrict__ out,
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
    out[row * D + d] = from_f32<T>(a * inv);
  }
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <typename T, int NSTAGE, int PIECES>
const void* split_kernel_ptr() {
  static bool allowed = false;         // the most shared memory, set once
  const void* kern = reinterpret_cast<const void*>(pa_split_kernel<T, NSTAGE, PIECES>);
  if (!allowed && cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemLimit) == cudaSuccess)
    allowed = true;
  return allowed ? kern : nullptr;
}

template <typename T>
const void* split_kernel(int nstage, int pieces) {
  if (nstage == 3) return pieces == 1 ? split_kernel_ptr<T, 3, 1>() : split_kernel_ptr<T, 3, 2>();
  return pieces == 1 ? split_kernel_ptr<T, 2, 1>() : split_kernel_ptr<T, 2, 2>();
}

// The block geometry: the most kv heads a block (a divisor of ng_max: G for
// B5, 1 for B6) that fit kMaxWarps warps; then, over the chunk lengths (the
// divisors of BS up to kMaxChunkRows) and ring depths (3 or 2), the one that
// keeps the most warps on a SM for this grid (the runtime's occupancy of the
// kernel, at most the grid's blocks a SM), then the deeper ring, then the
// longer chunk. Cached by shape; false when nothing fits.
template <typename T>
bool pick_geom(int ng_max, int hpg, int D, int BS, long long full_row_blocks,
               SplitGeom* out) {
  static std::mutex mu;
  static std::map<std::array<long long, 5>, SplitGeom> cache;
  const std::array<long long, 5> key = {ng_max, hpg, D, BS, full_row_blocks};
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return true;
  }
  const int pieces = D <= 128 ? 1 : 2;
  for (int ng = ng_max; ng >= 1; --ng) {
    if (ng_max % ng) continue;
    const long long blocks = full_row_blocks * (ng_max / ng);
    const long long per_sm = (blocks + sm_count() - 1) / sm_count();
    bool found = false;
    long long best[3] = {0, 0, 0};
    for (int ch = BS < kMaxChunkRows ? BS : kMaxChunkRows; ch >= 1; --ch) {
      if (BS % ch) continue;
      for (int nstage = 3; nstage >= 2; --nstage) {
        const SplitGeom g = split_geom<T>(ng, hpg, D, ch, nstage);
        if (g.warps() > kMaxWarps || g.total > kSmemLimit) continue;
        const void* kern = split_kernel<T>(nstage, pieces);
        int fit = 0;
        if (kern == nullptr ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kern, g.warps() * 32,
                                                          g.total) != cudaSuccess ||
            fit < 1)
          continue;
        const long long score[3] = {(fit < per_sm ? fit : per_sm) * g.warps(), nstage, ch};
        if (!found || std::lexicographical_compare(best, best + 3, score, score + 3)) {
          found = true;
          std::copy(score, score + 3, best);
          *out = g;
        }
      }
    }
    if (found) {
      cache[key] = *out;
      return true;
    }
  }
  return false;
}

// One launch of the split kernel (and, with splits > 1, the combine).
// row_stride: elements from a kv head's row of one cache slot to the next
// slot's; head_stride: from one kv head's row to the next head's at the same
// slot. part_acc f32 [B, Hq, splits, D] and part_ml f32 [B, Hq, splits,
// 2] (unused with splits == 1). Returns a cudaError_t.
template <typename T>
int pa_split_launch(const void* q, const void* k, const void* v, const void* bt,
                    const void* sl, void* out, void* part_acc, void* part_ml, int B, int Hq,
                    int G, int ng_max, int D, int BS, int NB, int MB, int splits, int per,
                    long long row_stride, long long head_stride, float scale,
                    cudaStream_t stream) {
  const int hpg = Hq / G;
  SplitGeom g;
  if (!pick_geom<T>(ng_max, hpg, D, BS, (long long)B * (G / ng_max) * splits, &g))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, G / g.ng, splits);
  const int threads = g.warps() * 32;
  const long long ps = head_stride * g.ng;     // one group block to the next
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* btp = static_cast<const int*>(bt);
  const int* slp = static_cast<const int*>(sl);
  T* o = static_cast<T*>(out);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (D <= 128) {
    if (g.nstage == 3)
      pa_split_kernel<T, 3, 1><<<grid, threads, g.total, stream>>>(
          qt, kt, vt, btp, slp, o, pa, pm, g, Hq, BS, NB, MB, per, row_stride, ps, scale);
    else
      pa_split_kernel<T, 2, 1><<<grid, threads, g.total, stream>>>(
          qt, kt, vt, btp, slp, o, pa, pm, g, Hq, BS, NB, MB, per, row_stride, ps, scale);
  } else {
    if (g.nstage == 3)
      pa_split_kernel<T, 3, 2><<<grid, threads, g.total, stream>>>(
          qt, kt, vt, btp, slp, o, pa, pm, g, Hq, BS, NB, MB, per, row_stride, ps, scale);
    else
      pa_split_kernel<T, 2, 2><<<grid, threads, g.total, stream>>>(
          qt, kt, vt, btp, slp, o, pa, pm, g, Hq, BS, NB, MB, per, row_stride, ps, scale);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  pa_combine_kernel<T><<<dim3(B, Hq), D < 128 ? D : 128, 0, stream>>>(pa, pm, o, Hq, D, splits);
  return (int)cudaGetLastError();
}

// The checks both layouts share; returns false for arguments the kernel does
// not take.
inline bool split_args_ok(int B, int Hq, int G, int D, int BS, int NB, int MB, int splits,
                          int per, const void* k, const void* v, const void* part_acc,
                          const void* part_ml) {
  return B > 0 && G > 0 && Hq % G == 0 && D > 0 && D % 8 == 0 && D <= 256 &&
         BS > 0 && NB > 0 && MB > 0 && splits > 0 && per > 0 &&
         (long long)splits * per >= MB && (long long)(splits - 1) * per < MB &&
         (splits == 1 || (part_acc != nullptr && part_ml != nullptr)) &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

}  // namespace
