// Kernel B1: fused grouped-affine dequant + matmul, W{2,4,8}A16, for Hopper.
//
// Replaces blazr_tpu/quant/pallas/int_matmul.py::_qmm_kernel (:69), launched
// there by _qmm (:121) behind quant_matmul_pallas (:454). Same function:
//
//     y[m,n] = sum_g  s[g,n] * (x_g . q_g)[m,n]  -  (sum_{k in g} x[m,k]) * mins[g,n]
//
// with f32 sums and the output in x's dtype; f16 x is rounded to bf16 first,
// as the TPU kernel rounds x (:94). The weight is the canonical K-packed
// layout of quant/qtensor.py: word row w of qweight [K*bits/32, N] holds
// logical rows w*r+j in bits [bits*j, bits*j+bits), r = 32/bits. Signed
// payloads are two's complement in their field (4-bit AWQ/GPTQ are
// sign-biased at load). Both variants below compute the sum in its folded
// form, sum_k x[m,k] * (q[k,n]*s[g,n] - mins[g,n]): the same function.
//
// What bounds it on the H100, at the Mistral-7B shapes:
//   * prefill (m = 512): the 2*m*K*N multiply-adds at 989 TFLOP/s bf16
//     (gate+up K=4096 N=28672: 120 GFLOP, 0.122 ms);
//   * decode (m <= 8): the weight stream, K*N/2 bytes of int4 words plus
//     2*(K/gs)*N*4 bytes of scale/min planes at 3.35 TB/s (gate+up 66.6 MB,
//     0.020 ms; o 9.5 MB, 0.003 ms).
//
// Two variants, chosen by the wrapper from the row count (quant/kernels.py,
// TC_MIN_ROWS) and dtype:
//
// Tensor-core variant (qmm_wgmma_kernel; bf16 or f16 x, m >= TC_MIN_ROWS,
// K % 64 == 0, a group size that is a multiple of 8 and that 64 divides or
// that divides 64):
//   * wgmma (sm_90a, m64nNk16, bf16 in, f32 sums in registers): two consumer
//     warpgroups own a 128x128 output tile (each 64 rows x 128 columns), or
//     64x128 for m <= 64 (each 64 x 64). K steps of 64.
//   * One producer warp keeps a 3-stage ring full: the x tile by TMA (one
//     thread, a 64 x BM box of a tensor map, rows 128-byte swizzled, rows past
//     M zero-filled by the copy engine), the packed weight words and the
//     tile's scale/min rows by 16-byte cp.async (columns past N zero-filled).
//     Each stage has two mbarriers: full (the producer's copies and the x
//     tile's bytes have landed) and empty (all 8 consumer warps are done with
//     it). The consumers never issue a copy and never wait for one in flight.
//     The x tile comes by TMA because one warp's 16-byte copies of it could
//     not keep the ring full (17-25% slower at 512 rows than 256 threads
//     issuing them, PERF.md); the weight words and planes are 4x fewer.
//   * The consumers dequantize the int4 words of step kt into a bf16 B tile
//     (K-major no-swizzle core matrices, double-buffered) while the products
//     of step kt-1 run: the fields go to f32 exactly by the magic-number trick
//     (0x4B000000 | v), then q*s - m in f32, then one bf16 rounding. That
//     rounding of each weight element is the one rounding this variant adds
//     to the function (2^-9 relative per element, unbiased); the kernel-vs-
//     plain tolerance of 8e-3 x max|y| holds it (chip_smoke.py). One barrier
//     of the 256 consumer threads per step.
//   * When the output tiles give too few blocks, K is split across blocks
//     (grid z); each split writes f32 partials and a second kernel sums them
//     in a fixed order (no atomics: a run repeats bit for bit).
//   * f16 x is first rounded to bf16 into a scratch buffer by a small kernel.
//
// Split-K CUDA-core variant (qmm_splitk_kernel; every other case: decode rows,
// f32 x, groups that are not a multiple of 8, K % 64 != 0):
//   * one output column per thread, 128 columns per block; K split across
//     blocks (the N/128 column tiles alone give 32 blocks for o and down;
//     the wrapper's decode_plan aims at several waves); fixed-order split
//     reduction as above;
//   * each block streams its K slab of packed words, scale/min rows and x
//     through a 4-stage cp.async ring of 128 K rows (16-byte copies; 4-byte
//     copies when N % 4 != 0);
//   * x goes to f32 k-major in shared memory, so one K row of all BM rows is
//     a broadcast float4 read; each weight is dequantized once in f32 (no
//     bf16 rounding) and multiplied into BM f32 accumulators.
//
// Known limits: the x tile is still read from L2 once per 128-column tile
// (no cluster multicast), the dequantized B tile goes through shared memory
// (no register-sourced operand), and there is no persistent schedule. Rows
// below TC_MIN_ROWS run on CUDA cores (the swapped-operand tensor-core
// decode is not written).

#include "hopper.cuh"

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// f16 x is rounded to bf16 first, as the TPU kernel rounds x (:94).
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __bfloat162float(__float2bfloat16(__half2float(v)));
}

template <int BITS> struct Pack {
  static constexpr int R = 32 / BITS;                 // K rows per word
  static constexpr uint32_t MASK = (1u << BITS) - 1u;
  static constexpr int HALF = 1 << (BITS - 1);
  // XOR with this turns every two's-complement field into field + HALF.
  static constexpr uint32_t SIGN =
      BITS == 2 ? 0xAAAAAAAAu : (BITS == 4 ? 0x88888888u : 0x80808080u);
};

// Field j of a word (already XORed with SIGN for signed payloads) as an exact
// f32: 0x4B000000 | v is 2^23 + v; off is 2^23 (+ HALF when signed).
template <int BITS>
__device__ __forceinline__ float field(uint32_t w, int j, float off) {
  return __int_as_float(0x4B000000u | ((w >> (BITS * j)) & Pack<BITS>::MASK)) - off;
}

// ---------------------------------------------------------------------------
// Split-K CUDA-core variant
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;   // one output column per thread
constexpr int kDecBN = 128;
constexpr int kDecKst = 128;       // K rows per pipeline stage
constexpr int kDecStages = 4;
constexpr size_t kSmemMax = 227 * 1024;

struct DecLayout {
  size_t w_bytes, x_ld, x_bytes, sm_bytes, stage, xf_off, total;
};

template <int BITS, int BM, typename T>
__host__ __device__ __forceinline__ DecLayout dec_layout(int ng) {
  DecLayout l;
  l.w_bytes = (size_t)(kDecKst / Pack<BITS>::R) * kDecBN * 4;
  l.x_ld = (size_t)kDecKst * sizeof(T) + 16;          // padded x row, bytes
  l.x_bytes = (size_t)BM * l.x_ld;
  l.sm_bytes = (size_t)ng * kDecBN * 4;               // one plane: scales or mins
  l.stage = l.w_bytes + l.x_bytes + 2 * l.sm_bytes;
  l.xf_off = kDecStages * l.stage;
  l.total = l.xf_off + (size_t)kDecKst * BM * 4;
  return l;
}

template <int BITS, int BM, typename T>
__global__ void __launch_bounds__(kDecThreads)
qmm_splitk_kernel(const T* __restrict__ x, const uint32_t* __restrict__ qw,
                  const float* __restrict__ scales, const float* __restrict__ mins,
                  float* __restrict__ part, T* __restrict__ y, int M, int K, int N,
                  int gs, int per, int ng, int is_signed) {
  using P = Pack<BITS>;
  constexpr int R = P::R;
  constexpr int X4 = 4 * (int)sizeof(T);        // bytes of one 4-element x copy
  extern __shared__ __align__(128) unsigned char smem[];
  const DecLayout l = dec_layout<BITS, BM, T>(ng);
  float* xf = reinterpret_cast<float*>(smem + l.xf_off);   // [kst][BM]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kDecBN, n = n0 + tid;
  const int z = blockIdx.y;
  const int m0 = blockIdx.z * BM;
  const int kb = z * per, ke = min(K, kb + per);
  const int nst = (ke - kb + kDecKst - 1) / kDecKst;
  const bool vec = (N & 3) == 0;
  const uint32_t xmask = is_signed ? P::SIGN : 0u;
  const float off = 8388608.f + (is_signed ? (float)P::HALF : 0.f);

  auto load = [&](int c, int s) {
    unsigned char* base = smem + (size_t)s * l.stage;
    uint32_t* w_s = reinterpret_cast<uint32_t*>(base);
    unsigned char* x_s = base + l.w_bytes;
    float* s_s = reinterpret_cast<float*>(x_s + l.x_bytes);
    float* m_s = s_s + (size_t)ng * kDecBN;
    const int k0 = kb + c * kDecKst;
    const int krows = min(kDecKst, ke - k0);
    const int wrows = krows / R;
    const int g_lo = k0 / gs;
    const int nrow = (k0 + krows - 1) / gs - g_lo + 1;
    if (vec) {
      for (int i = tid; i < wrows * (kDecBN / 4); i += kDecThreads) {
        const int r = i / (kDecBN / 4), c4 = (i % (kDecBN / 4)) * 4;
        const bool ok = n0 + c4 < N;
        cp_async<16>(w_s + r * kDecBN + c4,
                     qw + (size_t)(k0 / R + r) * N + (ok ? n0 + c4 : 0), ok);
      }
      for (int i = tid; i < nrow * (kDecBN / 4); i += kDecThreads) {
        const int r = i / (kDecBN / 4), c4 = (i % (kDecBN / 4)) * 4;
        const bool ok = n0 + c4 < N;
        const size_t src = (size_t)(g_lo + r) * N + (ok ? n0 + c4 : 0);
        cp_async<16>(s_s + r * kDecBN + c4, scales + src, ok);
        cp_async<16>(m_s + r * kDecBN + c4, mins + src, ok);
      }
    } else {
      for (int i = tid; i < wrows * kDecBN; i += kDecThreads) {
        const int r = i / kDecBN, c = i % kDecBN;
        const bool ok = n0 + c < N;
        cp_async<4>(w_s + i, qw + (size_t)(k0 / R + r) * N + (ok ? n0 + c : 0), ok);
      }
      for (int i = tid; i < nrow * kDecBN; i += kDecThreads) {
        const int r = i / kDecBN, c = i % kDecBN;
        const bool ok = n0 + c < N;
        const size_t src = (size_t)(g_lo + r) * N + (ok ? n0 + c : 0);
        cp_async<4>(s_s + i, scales + src, ok);
        cp_async<4>(m_s + i, mins + src, ok);
      }
    }
    const int xc = krows / 4;
    for (int i = tid; i < BM * xc; i += kDecThreads) {
      const int r = i / xc, c = i - r * xc;
      const bool ok = m0 + r < M;
      cp_async<X4>(x_s + r * l.x_ld + c * X4,
                   x + (size_t)(ok ? m0 + r : 0) * K + k0 + 4 * c, ok);
    }
  };

  float acc[BM];
  float acc1 = 0.f;                  // BM == 1: the odd K rows' partial sum
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < nst) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nst; ++c) {
    if (c + kDecStages - 1 < nst) load(c + kDecStages - 1, (c + kDecStages - 1) % kDecStages);
    cp_async_commit();
    cp_async_wait<kDecStages - 1>();
    __syncthreads();
    const unsigned char* base = smem + (size_t)(c % kDecStages) * l.stage;
    const uint32_t* w_s = reinterpret_cast<const uint32_t*>(base);
    const unsigned char* x_s = base + l.w_bytes;
    const float* s_s = reinterpret_cast<const float*>(x_s + l.x_bytes);
    const float* m_s = s_s + (size_t)ng * kDecBN;
    const int k0 = kb + c * kDecKst;
    const int krows = min(kDecKst, ke - k0);
    const int wrows = krows / R;

    // x -> f32, k-major (f16 rounded to bf16); rows past M were zero-filled.
    for (int i = tid; i < BM * krows; i += kDecThreads) {
      const int r = i % BM, kk = i / BM;
      xf[kk * BM + r] = to_f32<T>(reinterpret_cast<const T*>(x_s + r * l.x_ld)[kk]);
    }
    __syncthreads();

    if (n < N) {
      // Walk the groups without a division per word: `left` words remain in
      // the current group, whose scale/min row of this stage is `g`.
      const int wpg = gs / R;
      int g = 0, left = (gs - k0 % gs) / R;
      float sc = s_s[tid], mn = m_s[tid];
      for (int w = 0; w < wrows; ++w) {
        if (left == 0) {
          ++g;
          left = wpg;
          sc = s_s[g * kDecBN + tid];
          mn = m_s[g * kDecBN + tid];
        }
        --left;
        const uint32_t word = w_s[w * kDecBN + tid] ^ xmask;
        const float* xk = xf + (size_t)w * R * BM;
        if constexpr (BM == 1) {         // one row: x of 4 consecutive K rows at once
#pragma unroll
          for (int j = 0; j < R; j += 4) {
            const float4 xv = *reinterpret_cast<const float4*>(xk + j);
            acc[0] = fmaf(xv.x, fmaf(field<BITS>(word, j, off), sc, -mn), acc[0]);
            acc1 = fmaf(xv.y, fmaf(field<BITS>(word, j + 1, off), sc, -mn), acc1);
            acc[0] = fmaf(xv.z, fmaf(field<BITS>(word, j + 2, off), sc, -mn), acc[0]);
            acc1 = fmaf(xv.w, fmaf(field<BITS>(word, j + 3, off), sc, -mn), acc1);
          }
        } else {
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const float wv = fmaf(field<BITS>(word, j, off), sc, -mn);
            if constexpr (BM % 4 == 0) {
              const float4* x4 = reinterpret_cast<const float4*>(xk + j * BM);
#pragma unroll
              for (int i4 = 0; i4 < BM / 4; ++i4) {
                const float4 xv = x4[i4];
                acc[4 * i4] = fmaf(xv.x, wv, acc[4 * i4]);
                acc[4 * i4 + 1] = fmaf(xv.y, wv, acc[4 * i4 + 1]);
                acc[4 * i4 + 2] = fmaf(xv.z, wv, acc[4 * i4 + 2]);
                acc[4 * i4 + 3] = fmaf(xv.w, wv, acc[4 * i4 + 3]);
              }
            } else {
#pragma unroll
              for (int i = 0; i < BM; ++i) acc[i] = fmaf(xk[j * BM + i], wv, acc[i]);
            }
          }
        }
      }
    }
    __syncthreads();                 // stage and xf fully read before reuse
  }
  if (n >= N) return;
  acc[0] += acc1;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int row = m0 + i;
    if (row >= M) continue;
    if (gridDim.y == 1)
      y[(size_t)row * N + n] = from_f32<T>(acc[i]);
    else
      part[((size_t)z * M + row) * N + n] = acc[i];
  }
}

template <int BITS, int BM, typename T>
int launch_dec(const void* x, const void* qw, const void* s, const void* mn, void* part,
               void* y, int M, int K, int N, int gs, int splits, int per, int sg,
               cudaStream_t st) {
  const int ng = (kDecKst - 1) / gs + 2;     // most group rows one stage spans
  const DecLayout l = dec_layout<BITS, BM, T>(ng);
  if (l.total > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kern = qmm_splitk_kernel<BITS, BM, T>;
  static size_t allowed = 48 * 1024;
  const cudaError_t ea = allow_smem(reinterpret_cast<const void*>(kern), l.total, allowed);
  if (ea != cudaSuccess) return (int)ea;
  const dim3 grid((N + kDecBN - 1) / kDecBN, splits, (M + BM - 1) / BM);
  kern<<<grid, kDecThreads, l.total, st>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(s), static_cast<const float*>(mn),
      static_cast<float*>(part), static_cast<T*>(y), M, K, N, gs, per, ng, sg);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return launch_reduce<T>(part, y, splits, (size_t)M * N, st);
}

template <int BITS, typename T>
int launch_dec_bm(const void* x, const void* qw, const void* s, const void* mn, void* part,
                  void* y, int M, int K, int N, int gs, int bm, int splits, int per,
                  int sg, cudaStream_t st) {
  switch (bm) {
    case 1: return launch_dec<BITS, 1, T>(x, qw, s, mn, part, y, M, K, N, gs, splits, per, sg, st);
    case 4: return launch_dec<BITS, 4, T>(x, qw, s, mn, part, y, M, K, N, gs, splits, per, sg, st);
    case 8: return launch_dec<BITS, 8, T>(x, qw, s, mn, part, y, M, K, N, gs, splits, per, sg, st);
    case 16:   // 16 rows, unless their stages overflow shared memory (8-bit, gs 4)
      if (dec_layout<BITS, 16, T>((kDecKst - 1) / gs + 2).total <= kSmemMax)
        return launch_dec<BITS, 16, T>(x, qw, s, mn, part, y, M, K, N, gs, splits, per, sg, st);
      return launch_dec<BITS, 8, T>(x, qw, s, mn, part, y, M, K, N, gs, splits, per, sg, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core (wgmma) variant
// ---------------------------------------------------------------------------

constexpr int kTcConsumers = 256;            // two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 32; // ... and one producer warp
constexpr int kTcBN = 128;
constexpr int kTcBK = 64;
constexpr int kTcChunk = 8;                   // K rows dequantized under one scale
constexpr int kTcStages = 3;
constexpr int kBTile = kTcBN * kTcBK * 2;     // one dequantized bf16 B tile, bytes
constexpr int kBarBytes = 128;                // the ring's mbarriers, padded
constexpr int kAlign = 1024;                  // a 128-byte-swizzled tile's alignment

struct TcLayout {
  int x_bytes, w_bytes, sm_bytes, stage, b_off, bar_off, total;
};

// From a 1024-byte aligned base: the ring (each stage the x tile, the packed
// words and the scale/min rows of one K step; every part a multiple of 1024
// bytes), two dequantized B tiles, the mbarriers; plus the alignment slack.
template <int BITS, int BM>
__host__ __device__ __forceinline__ TcLayout tc_layout(int ngt) {
  TcLayout l;
  l.x_bytes = BM * kTcBK * 2;
  l.w_bytes = (kTcBK / Pack<BITS>::R) * kTcBN * 4;
  l.sm_bytes = ngt * kTcBN * 4;
  l.stage = l.x_bytes + l.w_bytes + 2 * l.sm_bytes;
  l.b_off = kTcStages * l.stage;
  l.bar_off = l.b_off + 2 * kBTile;
  l.total = kAlign + l.bar_off + kBarBytes;
  return l;
}

#define D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64 x N] += A[64 x 16] * B[16 x N], bf16 in, f32 sums; A and B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(a), "l"(b), "r"(1));
}
#undef D8

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared-memory tiles are K-major no-swizzle core matrices: element (r, k) of
// a tile with RT rows sits at ((k/8)*(RT/8) + r/8)*128 + (r%8)*16 + (k%8)*2.
//
// Warp roles: warps 0-7 are the two consumer warpgroups, warp 8 the producer.
// Stage s of the ring is guarded by two mbarriers: full[s] (the producer's 32
// lanes arrive once their copies into s have landed) and empty[s] (the 8
// consumer warps arrive once their products on s are done).
template <int BITS, int BM, typename TO>
__global__ void __launch_bounds__(kTcThreads, 2)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const uint32_t* __restrict__ qw,
                 const float* __restrict__ scales, const float* __restrict__ mins,
                 float* __restrict__ part, TO* __restrict__ y, int M, int K, int N,
                 int gs, int per, int ngt, int is_signed) {
  using P = Pack<BITS>;
  constexpr int R = P::R;
  constexpr int NW = BM == 128 ? 128 : 64;    // output columns per warpgroup
  constexpr int NACC = NW / 2;                // f32 accumulators per thread
  extern __shared__ __align__(128) unsigned char smem[];
  const TcLayout l = tc_layout<BITS, BM>(ngt);
  unsigned char* ring = smem + ((kAlign - (smem_u32(smem) & (kAlign - 1))) & (kAlign - 1));
  unsigned char* b_s = ring + l.b_off;        // [2][kBTile] dequantized weights
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + l.bar_off);
  uint64_t* empty = full + kTcStages;

  const int tid = threadIdx.x, warp_id = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kTcBN, z = blockIdx.z;
  const int kb = z * per, ke = min(K, kb + per);
  const int KT = (ke - kb) / kTcBK;

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + s, 33);      // 32 lanes' copies and the x tile's bytes
      mbar_init(empty + s, kTcConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp_id == kTcConsumers / 32) {
    // Producer: x tile (TMA), packed words and scale/min rows (cp.async) of
    // step kt into stage kt % kTcStages, once the consumers have released it.
    const bool vec = (N & 3) == 0;
    constexpr int WROWS = kTcBK / R;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % kTcStages;
      if (kt >= kTcStages) mbar_wait(empty + s, ((kt / kTcStages) + 1) & 1);
      unsigned char* x_s = ring + s * l.stage;
      uint32_t* w_s = reinterpret_cast<uint32_t*>(x_s + l.x_bytes);
      float* s_s = reinterpret_cast<float*>(x_s + l.x_bytes + l.w_bytes);
      float* m_s = s_s + ngt * kTcBN;
      const int k0 = kb + kt * kTcBK;
      // x: BM rows of 128 bytes, 128-byte swizzled; rows past M read as 0.
      if (lane == 0) {
        mbar_arrive_expect(full + s, l.x_bytes);
        tma_load_2d(x_s, &xmap, k0, m0, full + s);
      }
      const int g0 = k0 / gs;
      if (vec) {
        for (int i = lane; i < WROWS * 32; i += 32) {
          const int r = i >> 5, c4 = (i & 31) * 4;
          const bool ok = n0 + c4 < N;
          cp_async<16>(w_s + r * kTcBN + c4,
                       qw + (size_t)(k0 / R + r) * N + (ok ? n0 + c4 : 0), ok);
        }
        for (int i = lane; i < ngt * 32; i += 32) {
          const int r = i >> 5, c4 = (i & 31) * 4;
          const bool ok = n0 + c4 < N;
          const size_t src = (size_t)(g0 + r) * N + (ok ? n0 + c4 : 0);
          cp_async<16>(s_s + r * kTcBN + c4, scales + src, ok);
          cp_async<16>(m_s + r * kTcBN + c4, mins + src, ok);
        }
      } else {
        for (int i = lane; i < WROWS * kTcBN; i += 32) {
          const int r = i >> 7, c = i & 127;
          const bool ok = n0 + c < N;
          cp_async<4>(w_s + i, qw + (size_t)(k0 / R + r) * N + (ok ? n0 + c : 0), ok);
        }
        for (int i = lane; i < ngt * kTcBN; i += 32) {
          const int r = i >> 7, c = i & 127;
          const bool ok = n0 + c < N;
          const size_t src = (size_t)(g0 + r) * N + (ok ? n0 + c : 0);
          cp_async<4>(s_s + i, scales + src, ok);
          cp_async<4>(m_s + i, mins + src, ok);
        }
      }
      cp_async_arrive(full + s);
    }
    cp_async_commit();
    cp_async_wait<0>();
    return;
  }

  // Consumers. Each thread dequantizes 4 chunks of 8 K rows of one column n
  // into a B tile: bf16(q*s - m). An 8-thread phase writes 8 consecutive
  // columns of one chunk: one 128-byte core matrix.
  const uint32_t xmask = is_signed ? P::SIGN : 0u;
  const float off = 8388608.f + (is_signed ? (float)P::HALF : 0.f);
  auto dequant = [&](int s, unsigned char* bt) {
    const unsigned char* base = ring + s * l.stage;
    const uint32_t* w_s = reinterpret_cast<const uint32_t*>(base + l.x_bytes);
    const float* s_s = reinterpret_cast<const float*>(base + l.x_bytes + l.w_bytes);
    const float* m_s = s_s + ngt * kTcBN;
    const int n = tid & 127;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = (tid >> 7) + 2 * j;
      const int gr = gs >= kTcBK ? 0 : (kc * kTcChunk) / gs;   // gs % 8 == 0
      const float sc = s_s[gr * kTcBN + n], mn = m_s[gr * kTcBN + n];
      float v[8];
      if constexpr (BITS == 4) {
        const uint32_t w = w_s[kc * kTcBN + n] ^ xmask;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = field<4>(w, e, off);
      } else if constexpr (BITS == 8) {
        const uint32_t w0 = w_s[(2 * kc) * kTcBN + n] ^ xmask;
        const uint32_t w1 = w_s[(2 * kc + 1) * kTcBN + n] ^ xmask;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = field<8>(w0, e, off);
          v[4 + e] = field<8>(w1, e, off);
        }
      } else {                                 // 2-bit: this chunk is half a word
        const uint32_t w = (w_s[(kc >> 1) * kTcBN + n] ^ xmask) >> ((kc & 1) * 16);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = field<2>(w, e, off);
      }
      uint4 out;
      out.x = pack_bf16x2(fmaf(v[0], sc, -mn), fmaf(v[1], sc, -mn));
      out.y = pack_bf16x2(fmaf(v[2], sc, -mn), fmaf(v[3], sc, -mn));
      out.z = pack_bf16x2(fmaf(v[4], sc, -mn), fmaf(v[5], sc, -mn));
      out.w = pack_bf16x2(fmaf(v[6], sc, -mn), fmaf(v[7], sc, -mn));
      *reinterpret_cast<uint4*>(bt + (kc * (kTcBN / 8) + (n >> 3)) * 128 + (n & 7) * 16) = out;
    }
  };

  const int wg = tid >> 7;
  float d[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) d[i] = 0.f;
  const uint32_t ring_a = smem_u32(ring), b_a = smem_u32(b_s);

  // Step kt: wait for its stage, dequantize its weights while the products
  // of step kt-1 run, then issue its products and release step kt-1's stage.
  // B tile kt & 1 was last read by step kt-2, whose stage release (by all 8
  // consumer warps) says that both warpgroups' products on it are done.
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kTcStages;
    mbar_wait(full + s, (kt / kTcStages) & 1);
    if (kt >= 2) mbar_wait(empty + (kt - 2) % kTcStages, ((kt - 2) / kTcStages) & 1);
    dequant(s, b_s + (kt & 1) * kBTile);
    fence_async_smem();                // the B tile, to wgmma
    consumers_sync<kTcConsumers>();
    const uint32_t xa = ring_a + s * l.stage;
    const uint32_t ba = b_a + (kt & 1) * kBTile;
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      // A: this warpgroup's 64 rows (128-byte swizzled rows, 8-row groups
      // 1024 bytes apart), K bytes 32ks..32ks+31; B: its columns.
      const uint64_t da =
          gmma_desc(xa + (BM == 128 ? 8192 * wg : 0) + 32 * ks, 16, 1024, 1);
      const uint64_t db = gmma_desc(
          ba + (2 * ks * (kTcBN / 8) + (BM == 128 ? 0 : 8 * wg)) * 128, kTcBN * 16, 128, 0);
      if constexpr (BM == 128) wgmma_n128(d, da, db);
      else wgmma_n64(d, da, db);
    }
    wgmma_commit();
    fence_regs(d);
    wgmma_wait<1>();                   // step kt-1's products are done
    fence_regs(d);
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (kt - 1) % kTcStages);
    }
  }
  wgmma_wait<0>();
  fence_regs(d);

  // Accumulator layout (per warpgroup, per n8 block j): d[4j + 2h + c] is row
  // 16*warp + lane/4 + 8h, column 8j + 2*(lane%4) + c.
  const int warp = warp_id & 3;
  const int row0 = m0 + (BM == 128 ? 64 * wg : 0) + 16 * warp + (lane >> 2);
  const int col0 = n0 + (BM == 128 ? 0 : 64 * wg) + 2 * (lane & 3);
  const bool split = gridDim.z > 1;
  const bool pair = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h, col = col0 + 8 * j;
      if (row >= M || col >= N) continue;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (split) {
        float* p = part + ((size_t)z * M + row) * N + col;
        if (pair) {
          store2(p, v0, v1);
        } else {
          p[0] = v0;
          if (col + 1 < N) p[1] = v1;
        }
      } else {
        TO* p = y + (size_t)row * N + col;
        if (pair) {
          store2(p, v0, v1);
        } else {
          p[0] = from_f32<TO>(v0);
          if (col + 1 < N) p[1] = from_f32<TO>(v1);
        }
      }
    }
  }
}

// f16 x rounded to bf16, 8 values a thread (n % 8 == 0, 16-byte aligned).
__global__ void round_to_bf16(const __half* __restrict__ x, __nv_bfloat16* __restrict__ xb,
                              size_t n8) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint4 v = reinterpret_cast<const uint4*>(x)[i];
    const __half2* h = reinterpret_cast<const __half2*>(&v);
    uint4 o;
    __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) b[e] = __float22bfloat162_rn(__half22float2(h[e]));
    reinterpret_cast<uint4*>(xb)[i] = o;
  }
}

template <int BITS, int BM, typename TO>
int launch_tc(const __nv_bfloat16* xb, const void* qw, const void* s, const void* mn,
              void* part, void* y, int M, int K, int N, int gs, int splits, int per,
              int sg, cudaStream_t st) {
  const int ngt = gs >= kTcBK ? 1 : kTcBK / gs;
  const TcLayout l = tc_layout<BITS, BM>(ngt);
  if ((size_t)l.total > kSmemMax) return (int)cudaErrorInvalidValue;
  // x [M, K] bf16 as a TMA map of 64 x BM boxes (128-byte rows, swizzled).
  CUtensorMap xmap;
  const int ee = encode_rows_128b(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xb, M, K,
                                  kTcBK, BM);
  if (ee != 0) return ee;
  auto kern = qmm_wgmma_kernel<BITS, BM, TO>;
  static size_t allowed = 48 * 1024;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), l.total, allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM, (N + kTcBN - 1) / kTcBN, splits);
  kern<<<grid, kTcThreads, l.total, st>>>(
      xmap, static_cast<const uint32_t*>(qw), static_cast<const float*>(s),
      static_cast<const float*>(mn), static_cast<float*>(part), static_cast<TO*>(y),
      M, K, N, gs, per, ngt, sg);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return launch_reduce<TO>(part, y, splits, (size_t)M * N, st);
}

template <typename TO>
int launch_tc_bits(const __nv_bfloat16* xb, const void* qw, const void* s, const void* mn,
                   void* part, void* y, int M, int K, int N, int bits, int gs, int bm,
                   int splits, int per, int sg, cudaStream_t st) {
#define QMM_TC(B, BMV) \
  launch_tc<B, BMV, TO>(xb, qw, s, mn, part, y, M, K, N, gs, splits, per, sg, st)
  if (bm == 64) {
    if (bits == 2) return QMM_TC(2, 64);
    if (bits == 4) return QMM_TC(4, 64);
    if (bits == 8) return QMM_TC(8, 64);
  } else if (bm == 128) {
    if (bits == 2) return QMM_TC(2, 128);
    if (bits == 4) return QMM_TC(4, 128);
    if (bits == 8) return QMM_TC(8, 128);
  }
#undef QMM_TC
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Split-K CUDA-core variant. x [M,K] and y [M,N] in dtype (0 = bfloat16,
// 1 = float32, 2 = float16; f16 x is rounded to bf16), x 16-byte aligned;
// qweight u32 [K*bits/32, N]; scales, mins f32 [K/gs, N]; part f32
// [splits, M, N] scratch (unused when splits == 1); bm in {1, 4, 8, 16} rows
// per block; per: K rows per split, a multiple of 128. Returns a cudaError_t.
extern "C" int qmm_launch(const void* x, const void* qweight, const void* scales,
                          const void* mins, void* part, void* y, int M, int K, int N,
                          int bits, int is_signed, int group_size, int bm, int splits,
                          int per, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (bits != 2 && bits != 4 && bits != 8) ||
      group_size <= 0 || K % group_size != 0 || group_size % (32 / bits) != 0 ||
      !split_ok(K, splits, per, kDecKst) || (splits > 1 && part == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto by_bits = [&](auto tag) {
    using T = decltype(tag);
    if (bits == 2)
      return launch_dec_bm<2, T>(x, qweight, scales, mins, part, y, M, K, N, group_size, bm,
                                 splits, per, is_signed, st);
    if (bits == 4)
      return launch_dec_bm<4, T>(x, qweight, scales, mins, part, y, M, K, N, group_size, bm,
                                 splits, per, is_signed, st);
    return launch_dec_bm<8, T>(x, qweight, scales, mins, part, y, M, K, N, group_size, bm,
                               splits, per, is_signed, st);
  };
  if (dtype == 0) return by_bits(__nv_bfloat16());
  if (dtype == 1) return by_bits(float());
  if (dtype == 2) return by_bits(__half());
  return (int)cudaErrorInvalidValue;
}

// Tensor-core variant. x [M,K] and y [M,N] in dtype (0 = bfloat16,
// 2 = float16), x 16-byte aligned; xbf: bf16 [M,K] scratch for f16 x (null
// for bf16); K % 64 == 0; a group size that is a multiple of 8 and that 64
// divides or that divides 64; bm in {64, 128}; per: K rows per split, a multiple of 64; part as above.
extern "C" int qmm_tc_launch(const void* x, const void* qweight, const void* scales,
                             const void* mins, void* xbf, void* part, void* y, int M,
                             int K, int N, int bits, int is_signed, int group_size, int bm,
                             int splits, int per, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kTcBK != 0 ||
      (bits != 2 && bits != 4 && bits != 8) || group_size <= 0 ||
      K % group_size != 0 || group_size % kTcChunk != 0 ||
      (group_size % kTcBK != 0 && kTcBK % group_size != 0) ||
      !split_ok(K, splits, per, kTcBK) || (splits > 1 && part == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tc_bits<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x), qweight,
                                         scales, mins, part, y, M, K, N, bits, group_size,
                                         bm, splits, per, is_signed, st);
  if (dtype == 2) {
    if (xbf == nullptr || reinterpret_cast<uintptr_t>(xbf) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const size_t n8 = (size_t)M * K / 8;
    const int blocks = (int)((n8 + 255) / 256 < 4096 ? (n8 + 255) / 256 : 4096);
    round_to_bf16<<<blocks, 256, 0, st>>>(static_cast<const __half*>(x),
                                          static_cast<__nv_bfloat16*>(xbf), n8);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return launch_tc_bits<__half>(static_cast<const __nv_bfloat16*>(xbf), qweight, scales,
                                  mins, part, y, M, K, N, bits, group_size, bm, splits, per,
                                  is_signed, st);
  }
  return (int)cudaErrorInvalidValue;
}
