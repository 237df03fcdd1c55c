// Kernel B1: fused grouped-affine dequant + matmul, W{2,4,8}A16, for Hopper.
//
// Replaces blazr_tpu/quant/pallas/int_matmul.py::_qmm_kernel (:69), launched
// there by _qmm (:121) behind quant_matmul_pallas (:454). Same function:
//
//     y[m,n] = sum_g  s[g,n] * (x_g . q_g)[m,n]  -  (sum_{k in g} x[m,k]) * mins[g,n]
//
// with the per-group partial x_g . q_g and the group sums of x in f32, the
// output in x's dtype. The weight is the canonical K-packed layout of
// quant/qtensor.py: word row w of qweight [K*bits/32, N] holds logical rows
// w*r+j in bits [bits*j, bits*j+bits), r = 32/bits. Signed payloads are
// two's complement in their field (4-bit AWQ/GPTQ are sign-biased at load).
//
// What bounds it on the H100: at decode (m <= 8) the weight stream — K*N/2
// bytes of int4 words plus 2*(K/gs)*N*4 bytes of scale/min planes — against
// 3.35 TB/s; at prefill the 2*m*K*N multiply-adds.
//
// Design (simple and right first):
//   * one block of 64 threads per (m-tile of BM rows, 64 output columns);
//     each thread owns one column n and BM f32 accumulators;
//   * x for the tile is staged in shared memory in chunks of kc rows of K
//     (a multiple of the group size; the last chunk may be short, so K need
//     not be a multiple of any tile), converted to f32 and stored k-major so
//     one k reads the BM values of a thread's rows as a broadcast;
//   * each thread reads whole u32 words of its column straight from device
//     memory: neighbouring threads read neighbouring words, 8 words of a
//     group are loaded before any is used so several loads are in flight;
//   * unpack by shift and mask, sign-extend signed payloads, FMA in f32;
//     at the end of each group the partial is scaled by s[g,n] and the
//     group sum of x times mins[g,n] is subtracted;
//   * m-tiles vary fastest over the grid, so blocks resident together read
//     the same weight columns and the other m-tiles find them in L2.
// Ragged N and ragged m are masked.
//
// Two variants of the same function, chosen by the wrapper from the row
// count (quant/kernels.py, TC_MIN_ROWS): below 16 rows (decode) the CUDA-core
// kernel above; from 16 rows (prefill) and bf16 x, a WMMA tensor-core kernel
// (below) that stages the dequantized integer tile in shared memory.
// Known limits, left for later PRs: the grid has only ceil(N/64) blocks at
// decode (64 for o_proj's N=4096, fewer than 132 SMs x a few) and there is
// no split-K; the tensor-core variant uses mma.sync-class WMMA, not wgmma,
// and neither variant pipelines its loads (no cp.async/TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kWordBatch = 16;     // one 4-bit group of 128 rows

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int BITS, int BM, typename T>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const T* __restrict__ x, const uint32_t* __restrict__ qw,
           const float* __restrict__ scales, const float* __restrict__ mins,
           T* __restrict__ y, int M, int K, int N, int gs, int kc,
           int is_signed) {
  constexpr int R = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr int HALF = 1 << (BITS - 1);
  extern __shared__ float smem[];
  float* xs = smem;                  // [kc][BM]   x chunk, k-major, f32
  float* gsum = smem + kc * BM;      // [kc/gs][BM] group sums of x

  const int m0 = blockIdx.x * BM;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  const bool live = n < N;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wpg = gs / R;            // words per group

  float acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kc) {
    const int kcur = min(kc, K - k0);          // a multiple of gs
    const int groups = kcur / gs;
    __syncthreads();                           // previous chunk fully read
    for (int i = threadIdx.x; i < kcur * BM; i += kThreads) {
      const int m = i / kcur, kk = i - m * kcur;   // row-major read: coalesced
      const int row = m0 + m;
      xs[kk * BM + m] = row < M ? to_f32<T>(x[(size_t)row * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    for (int p = warp; p < groups * BM; p += kThreads / 32) {
      const int g = p / BM, m = p - g * BM;
      float s = 0.f;
      for (int i = lane; i < gs; i += 32) s += xs[(g * gs + i) * BM + m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) gsum[p] = s;
    }
    __syncthreads();
    if (!live) continue;

    // The column's words of this chunk, in batches of kWordBatch: batch b+1
    // is loaded before batch b is unpacked, so its loads are in flight
    // while this one computes. A group spans `batches` batches.
    const int batches = (wpg + kWordBatch - 1) / kWordBatch;
    const int nbatch = groups * batches;
    auto load_batch = [&](int b, uint32_t* dst) {
      const int g = b / batches, w0 = (b - g * batches) * kWordBatch;
      const uint32_t* wp = qw + (size_t)((k0 + g * gs) / R + w0) * N + n;
#pragma unroll
      for (int u = 0; u < kWordBatch; ++u)
        dst[u] = (w0 + u < wpg) ? __ldg(wp + (size_t)u * N) : 0u;
    };
    uint32_t next[kWordBatch];
    load_batch(0, next);
    float gacc[BM];
#pragma unroll
    for (int m = 0; m < BM; ++m) gacc[m] = 0.f;
    float s = 0.f, mn = 0.f;
    for (int b = 0; b < nbatch; ++b) {
      uint32_t words[kWordBatch];
#pragma unroll
      for (int u = 0; u < kWordBatch; ++u) words[u] = next[u];
      if (b + 1 < nbatch) load_batch(b + 1, next);
      const int g = b / batches, w0 = (b - g * batches) * kWordBatch;
      const int gg = k0 / gs + g;
      if (w0 == 0) {                   // needed at the group's end
        s = scales[(size_t)gg * N + n];
        mn = mins[(size_t)gg * N + n];
      }
      const float* xg = xs + (g * gs + w0 * R) * BM;
#pragma unroll
      for (int u = 0; u < kWordBatch; ++u) {
        if (w0 + u < wpg) {
          const float* xw = xg + u * R * BM;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            int v = (int)((words[u] >> (BITS * j)) & MASK);
            if (is_signed) v = (v ^ HALF) - HALF;      // sign-extend the field
            const float q = (float)v;
#pragma unroll
            for (int m = 0; m < BM; ++m) gacc[m] = fmaf(xw[j * BM + m], q, gacc[m]);
          }
        }
      }
      if (w0 + kWordBatch >= wpg) {     // last batch of group g
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          acc[m] += s * gacc[m] - gsum[g * BM + m] * mn;
          gacc[m] = 0.f;
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int m = 0; m < BM; ++m)
    if (m0 + m < M) y[(size_t)(m0 + m) * N + n] = from_f32<T>(acc[m]);
}

template <int BITS, int BM, typename T>
int launch_bm(const void* x, const void* qw, const void* scales, const void* mins,
              void* y, int M, int K, int N, int gs, int is_signed, cudaStream_t stream) {
  // Chunk of K staged per pass: 1024 rows, or one group when groups are larger.
  int kc = gs >= 1024 ? gs : (1024 / gs) * gs;
  if (kc > K) kc = K;
  const size_t smem = (size_t)(kc * BM + (kc / gs) * BM) * sizeof(float);
  auto kern = qmm_kernel<BITS, BM, T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((M + BM - 1) / BM, (N + kThreads - 1) / kThreads);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(scales), static_cast<const float*>(mins),
      static_cast<T*>(y), M, K, N, gs, kc, is_signed);
  return (int)cudaGetLastError();
}

template <int BITS, typename T>
int launch_bits(const void* x, const void* qw, const void* s, const void* mn, void* y,
                int M, int K, int N, int gs, int sg, cudaStream_t st) {
  // Decode row counts; more rows (f32 x, or groups the tensor-core variant
  // does not tile) take several m-tiles of 8.
  if (M <= 1) return launch_bm<BITS, 1, T>(x, qw, s, mn, y, M, K, N, gs, sg, st);
  if (M <= 4) return launch_bm<BITS, 4, T>(x, qw, s, mn, y, M, K, N, gs, sg, st);
  return launch_bm<BITS, 8, T>(x, qw, s, mn, y, M, K, N, gs, sg, st);
}

template <typename T>
int launch_dtype(const void* x, const void* qw, const void* s, const void* mn, void* y,
                 int M, int K, int N, int bits, int gs, int sg, cudaStream_t st) {
  switch (bits) {
    case 2: return launch_bits<2, T>(x, qw, s, mn, y, M, K, N, gs, sg, st);
    case 4: return launch_bits<4, T>(x, qw, s, mn, y, M, K, N, gs, sg, st);
    case 8: return launch_bits<8, T>(x, qw, s, mn, y, M, K, N, gs, sg, st);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// Tensor-core variant (bf16 activations, 2 <= m): the same function with the
// per-group partials x_g . q_g taken by WMMA 16x16x16 bf16 products with f32
// sums. The integer payload is exact in bf16, so only the order of the f32
// sums differs from the CUDA-core path. Per chunk of kc rows of K (one group,
// or 128 rows of a larger group): the x tile and the dequantized integer tile
// are staged in shared memory, the four warps take their 16x16 fragments, and
// at the end of each group the fragments go through shared memory so each
// thread can scale its elements by s[g,n] and subtract xsum*mins[g,n].
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;
constexpr int kTcBN = 64;

template <int BITS, int BM>
__global__ void __launch_bounds__(kTcThreads)
qmm_tc_kernel(const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ qw,
              const float* __restrict__ scales, const float* __restrict__ mins,
              __nv_bfloat16* __restrict__ y, int M, int K, int N, int gs, int kc,
              int is_signed) {
  using namespace nvcuda;
  constexpr int R = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr int HALF = 1 << (BITS - 1);
  constexpr int WM = BM == 64 ? 2 : 1;        // warps along m
  constexpr int WN = 4 / WM;                  // warps along n
  constexpr int FM = BM / WM / 16;            // fragments per warp along m
  constexpr int FN = kTcBN / WN / 16;         // fragments per warp along n
  constexpr int LDB = kTcBN + 8;              // padded leading dims (bank spread)
  constexpr int LDC = kTcBN + 4;
  constexpr int PER_THREAD = BM * kTcBN / kTcThreads;
  const int lda = kc + 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);   // [BM][lda]
  __nv_bfloat16* b_s = a_s + BM * lda;                                // [kc][LDB]
  float* c_s = reinterpret_cast<float*>(b_s + kc * LDB);              // [BM][LDC]
  float* xsum = c_s + BM * LDC;                                       // [BM]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kTcBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> gacc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(gacc[i][j], 0.f);
  float acc[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kc) {
    __syncthreads();                           // previous chunk fully read
    for (int i = tid; i < BM * (kc / 8); i += kTcThreads) {
      const int r = i / (kc / 8), c8 = i - r * (kc / 8);
      const int row = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < M) v = *reinterpret_cast<const uint4*>(x + (size_t)row * K + k0 + c8 * 8);
      *reinterpret_cast<uint4*>(a_s + r * lda + c8 * 8) = v;
    }
    for (int i = tid; i < (kc / R) * kTcBN; i += kTcThreads) {
      const int wr = i / kTcBN, c = i - wr * kTcBN;
      const int n = n0 + c;
      const uint32_t w = n < N ? __ldg(qw + (size_t)(k0 / R + wr) * N + n) : 0u;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        int v = (int)((w >> (BITS * j)) & MASK);
        if (is_signed) v = (v ^ HALF) - HALF;
        b_s[(wr * R + j) * LDB + c] = __int2bfloat16_rn(v);
      }
    }
    __syncthreads();
    if (tid < BM) {                            // group sums of x, f32
      float s = 0.f;
      for (int c = 0; c < kc; ++c) s += __bfloat162float(a_s[tid * lda + c]);
      xsum[tid] = (k0 % gs == 0) ? s : xsum[tid] + s;
    }
#pragma unroll
    for (int kk = 0; kk < kc; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], a_s + ((wm * FM + i) * 16) * lda + kk, lda);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], b_s + kk * LDB + (wn * FN + j) * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(gacc[i][j], af[i], bf[j], gacc[i][j]);
    }
    if ((k0 + kc) % gs == 0) {                 // the group ends here: apply its affine
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          wmma::store_matrix_sync(c_s + ((wm * FM + i) * 16) * LDC + (wn * FN + j) * 16,
                                  gacc[i][j], LDC, wmma::mem_row_major);
          wmma::fill_fragment(gacc[i][j], 0.f);
        }
      __syncthreads();
      const int g = (k0 + kc) / gs - 1;
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        const int e = tid + i * kTcThreads;
        const int r = e / kTcBN, c = e - r * kTcBN;
        const int n = n0 + c;
        if (n < N)
          acc[i] += scales[(size_t)g * N + n] * c_s[r * LDC + c] -
                    xsum[r] * mins[(size_t)g * N + n];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = tid + i * kTcThreads;
    const int r = e / kTcBN, c = e - r * kTcBN;
    if (m0 + r < M && n0 + c < N)
      y[(size_t)(m0 + r) * N + n0 + c] = __float2bfloat16(acc[i]);
  }
}

template <int BITS, int BM>
int launch_tc_bm(const void* x, const void* qw, const void* scales, const void* mins,
                 void* y, int M, int K, int N, int gs, int is_signed, cudaStream_t stream) {
  const int kc = gs <= 128 ? gs : 128;
  const size_t smem = (size_t)BM * (kc + 8) * 2 + (size_t)kc * (kTcBN + 8) * 2 +
                      (size_t)BM * (kTcBN + 4) * 4 + (size_t)BM * 4;
  auto kern = qmm_tc_kernel<BITS, BM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((M + BM - 1) / BM, (N + kTcBN - 1) / kTcBN);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(scales), static_cast<const float*>(mins),
      static_cast<__nv_bfloat16*>(y), M, K, N, gs, kc, is_signed);
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_tc_bits(const void* x, const void* qw, const void* s, const void* mn, void* y,
                   int M, int K, int N, int gs, int sg, cudaStream_t st) {
  if (M <= 16) return launch_tc_bm<BITS, 16>(x, qw, s, mn, y, M, K, N, gs, sg, st);
  return launch_tc_bm<BITS, 64>(x, qw, s, mn, y, M, K, N, gs, sg, st);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (x and y). Returns a cudaError_t code.
extern "C" int qmm_launch(const void* x, const void* qweight, const void* scales,
                          const void* mins, void* y, int M, int K, int N, int bits,
                          int is_signed, int group_size, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group_size <= 0 || K % group_size != 0 ||
      group_size % (32 / (bits > 0 ? bits : 32)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<__nv_bfloat16>(x, qweight, scales, mins, y, M, K, N, bits,
                                       group_size, is_signed, st);
  if (dtype == 1)
    return launch_dtype<float>(x, qweight, scales, mins, y, M, K, N, bits, group_size,
                               is_signed, st);
  return (int)cudaErrorInvalidValue;
}

// Tensor-core path: bfloat16 x and y only; x 16-byte aligned; group size a
// multiple of 16 that is at most 128 or a multiple of 128.
extern "C" int qmm_tc_launch(const void* x, const void* qweight, const void* scales,
                             const void* mins, void* y, int M, int K, int N, int bits,
                             int is_signed, int group_size, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group_size % 16 != 0 || K % group_size != 0 ||
      (group_size > 128 && group_size % 128 != 0) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch_tc_bits<2>(x, qweight, scales, mins, y, M, K, N, group_size, is_signed, st);
    case 4: return launch_tc_bits<4>(x, qweight, scales, mins, y, M, K, N, group_size, is_signed, st);
    case 8: return launch_tc_bits<8>(x, qweight, scales, mins, y, M, K, N, group_size, is_signed, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
