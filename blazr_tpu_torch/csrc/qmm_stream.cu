// Kernel B4: streaming decode variant of B1 (fused grouped-affine dequant +
// matmul) for signed 4- and 8-bit weights at m <= 32, for Hopper.
//
// Replaces blazr_tpu/quant/pallas/int_matmul.py::_qmm_stream_kernel (:170),
// launched there by _qmm_stream (:244) from the opt-in branch of
// quant_matmul_pallas (:478-496, BLAZR_TPU_STREAM_KERNEL=1). Same function as
// B1 (csrc/qmm.cu), with x rounded to bf16 before the products as the TPU
// kernel rounds it (:215):
//
//   y[m,n] = sum_g s[g,n] * (bf16(x)_g . q_g)[m,n] - (sum_{k in g} bf16(x)[m,k]) * mins[g,n]
//
// with f32 sums and the output in x's dtype.
//
// What bounds it on the H100: the weight stream. At decode every K-packed word
// is read once: gateup (K=4096, N=28672, int4, gs 128) moves 66.6 MB with its
// scale and min planes, 0.0199 ms at 3.35 TB/s.
//
// The TPU kernel walks the whole of K on one core and copies whole-N row slabs
// through an nbuf-deep DMA ring. On the card the same idea has to fill 132
// SMs, so the design:
//   * splits K across blocks (grid y) as well as N (grid x, 128 columns a
//     block, one column a thread): the wrapper picks the splits so that about
//     264 blocks run;
//   * each block streams its contiguous K slab of the packed weight, and the
//     matching x columns, through a cp.async ring of nbuf stages (4, as the
//     TPU kernel; fewer only if a large group would not fit) of max(128, gs)
//     K rows: 16-byte copies, neighbouring threads on neighbouring words;
//   * after a stage lands, x is rounded to bf16 and stored k-major in f32 so
//     that one K row's values of every m row are read as a broadcast vector;
//     the group sums of the rounded x are taken in a fixed order;
//   * each thread keeps per-group f32 partials for its column, scales them by
//     s[g,n] at the group's end and subtracts the group sum times mins[g,n];
//   * each split writes f32 partials [splits, m, N]; a second kernel sums the
//     splits in a fixed order and casts: no atomics, a run repeats bit for bit.
// Requires N % 128 == 0 and K a multiple of max(128, gs); the wrapper checks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // one output column per thread
constexpr int kBN = 128;
constexpr int kMaxNbuf = 4;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n of the committed groups are pending (n < kMaxNbuf).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

struct Layout {
  int kst, wrows;
  size_t w_bytes, x_ld, x_bytes, stage;
};

template <int BITS, int BM, typename T>
__host__ __device__ __forceinline__ Layout layout(int gs) {
  Layout l;
  l.kst = gs > 128 ? gs : 128;                      // K rows per stage
  l.wrows = l.kst / (32 / BITS);
  l.w_bytes = (size_t)l.wrows * kBN * 4;
  l.x_ld = (size_t)l.kst * sizeof(T) + 16;           // padded x row, bytes
  l.x_bytes = (size_t)BM * l.x_ld;
  l.stage = l.w_bytes + l.x_bytes;
  return l;
}

template <int BITS, int BM, typename T>
__global__ void __launch_bounds__(kThreads)
qmm_stream_kernel(const T* __restrict__ x, const uint32_t* __restrict__ qw,
                  const float* __restrict__ scales, const float* __restrict__ mins,
                  float* __restrict__ part, int M, int K, int N, int gs, int per,
                  int nbuf) {
  constexpr int R = 32 / BITS;
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr int HALF = 1 << (BITS - 1);
  constexpr int PER16 = 16 / (int)sizeof(T);        // x values per 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout<BITS, BM, T>(gs);
  const int kst = l.kst;
  float* xf = reinterpret_cast<float*>(smem + nbuf * l.stage);   // [kst][BM]
  float* gsum = xf + (size_t)kst * BM;                            // [kst/gs][BM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, n = n0 + tid;
  const int z = blockIdx.y;
  const int kb = z * per;
  const int nst = (min(K, kb + per) - kb) / kst;
  const int ng = kst / gs;                 // groups per stage
  const int wpg = gs / R;                  // words per group

  auto load = [&](int c, int s) {
    unsigned char* base = smem + s * l.stage;
    uint32_t* w_s = reinterpret_cast<uint32_t*>(base);
    unsigned char* x_s = base + l.w_bytes;
    const int k0 = kb + c * kst;
    for (int i = tid; i < l.wrows * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4), c4 = i - r * (kBN / 4);
      cp_async16(w_s + r * kBN + c4 * 4, qw + (size_t)(k0 / R + r) * N + n0 + c4 * 4);
    }
    const int chunks = kst / PER16;
    for (int i = tid; i < M * chunks; i += kThreads) {
      const int r = i / chunks, c16 = i - r * chunks;
      cp_async16(x_s + r * l.x_ld + c16 * 16, x + (size_t)r * K + k0 + c16 * PER16);
    }
  };

  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  for (int s = 0; s < nbuf - 1; ++s) {
    if (s < nst) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nst; ++c) {
    if (c + nbuf - 1 < nst) load(c + nbuf - 1, (c + nbuf - 1) % nbuf);
    cp_async_commit();
    cp_async_wait_pending(nbuf - 1);
    __syncthreads();
    const unsigned char* base = smem + (c % nbuf) * l.stage;
    const uint32_t* w_s = reinterpret_cast<const uint32_t*>(base);
    const unsigned char* x_s = base + l.w_bytes;

    // x -> bf16-rounded f32, k-major; rows past M are zero.
    for (int i = tid; i < BM * (kst / PER16); i += kThreads) {
      const int r = i % BM, seg = i / BM;
      const T* src = reinterpret_cast<const T*>(x_s + r * l.x_ld) + seg * PER16;
#pragma unroll
      for (int j = 0; j < PER16; ++j) {
        const float v = r < M ? __bfloat162float(__float2bfloat16(to_f32<T>(src[j]))) : 0.f;
        xf[(seg * PER16 + j) * BM + r] = v;
      }
    }
    __syncthreads();
    // Group sums of the rounded x, in a fixed order.
    if constexpr (BM >= 32) {
      for (int p = tid; p < ng * BM; p += kThreads) {
        const int gi = p / BM, r = p - gi * BM;
        float sum = 0.f;
        for (int i = 0; i < gs; ++i) sum += xf[(gi * gs + i) * BM + r];
        gsum[p] = sum;
      }
    } else {
      for (int p = warp; p < ng * BM; p += kThreads / 32) {
        const int gi = p / BM, r = p - gi * BM;
        float sum = 0.f;
        for (int i = lane; i < gs; i += 32) sum += xf[(gi * gs + i) * BM + r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) gsum[p] = sum;
      }
    }
    __syncthreads();

    const int g0 = (kb + c * kst) / gs;
    for (int gi = 0; gi < ng; ++gi) {
      float gacc[BM];
#pragma unroll
      for (int i = 0; i < BM; ++i) gacc[i] = 0.f;
      const float sc = scales[(size_t)(g0 + gi) * N + n];
      const float mn = mins[(size_t)(g0 + gi) * N + n];
      for (int w = 0; w < wpg; ++w) {
        const uint32_t word = w_s[(gi * wpg + w) * kBN + tid];
        const float* xk = xf + (size_t)(gi * gs + w * R) * BM;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int v = ((int)((word >> (BITS * j)) & MASK) ^ HALF) - HALF;
          const float q = (float)v;
          if constexpr (BM % 4 == 0) {
            const float4* x4 = reinterpret_cast<const float4*>(xk + j * BM);
#pragma unroll
            for (int i4 = 0; i4 < BM / 4; ++i4) {
              const float4 xv = x4[i4];
              gacc[4 * i4] = fmaf(xv.x, q, gacc[4 * i4]);
              gacc[4 * i4 + 1] = fmaf(xv.y, q, gacc[4 * i4 + 1]);
              gacc[4 * i4 + 2] = fmaf(xv.z, q, gacc[4 * i4 + 2]);
              gacc[4 * i4 + 3] = fmaf(xv.w, q, gacc[4 * i4 + 3]);
            }
          } else {
#pragma unroll
            for (int i = 0; i < BM; ++i) gacc[i] = fmaf(xk[j * BM + i], q, gacc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < BM; ++i) acc[i] += sc * gacc[i] - gsum[gi * BM + i] * mn;
    }
    __syncthreads();                 // stage and xf fully read before reuse
  }
#pragma unroll
  for (int i = 0; i < BM; ++i)
    if (i < M) part[((size_t)z * M + i) * N + n] = acc[i];
}

// Sum the K splits in order (z = 0, 1, ...) and cast: deterministic.
template <typename T>
__global__ void reduce_splits(const float* __restrict__ part, T* __restrict__ y,
                              int splits, size_t mn) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * mn + i];
    y[i] = from_f32<T>(s);
  }
}

template <int BITS, int BM, typename T>
int launch(const void* x, const void* qw, const void* s, const void* mn, void* part,
           void* y, int M, int K, int N, int gs, int splits, int per, cudaStream_t st) {
  const Layout l = layout<BITS, BM, T>(gs);
  if (K % l.kst != 0 || per % l.kst != 0 || l.kst % gs != 0)
    return (int)cudaErrorInvalidValue;
  const size_t fixed = (size_t)l.kst * BM * 4 + (size_t)(l.kst / gs) * BM * 4;
  int nbuf = kMaxNbuf;
  while (nbuf > 2 && nbuf * l.stage + fixed > kSmemMax) --nbuf;
  const size_t smem = nbuf * l.stage + fixed;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kern = qmm_stream_kernel<BITS, BM, T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(N / kBN, splits), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(s), static_cast<const float*>(mn),
      static_cast<float*>(part), M, K, N, gs, per, nbuf);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  reduce_splits<T><<<blocks, 256, 0, st>>>(static_cast<const float*>(part),
                                           static_cast<T*>(y), splits, total);
  return (int)cudaGetLastError();
}

template <int BITS, typename T>
int launch_bits(const void* x, const void* qw, const void* s, const void* mn, void* part,
                void* y, int M, int K, int N, int gs, int splits, int per, cudaStream_t st) {
  if (M <= 1) return launch<BITS, 1, T>(x, qw, s, mn, part, y, M, K, N, gs, splits, per, st);
  if (M <= 8) return launch<BITS, 8, T>(x, qw, s, mn, part, y, M, K, N, gs, splits, per, st);
  if (M <= 16) return launch<BITS, 16, T>(x, qw, s, mn, part, y, M, K, N, gs, splits, per, st);
  return launch<BITS, 32, T>(x, qw, s, mn, part, y, M, K, N, gs, splits, per, st);
}

}  // namespace

// x [M,K] in dtype (0 = bfloat16, 1 = float32, 2 = float16), 16-byte aligned; qweight u32
// [K*bits/32, N] signed 4- or 8-bit; scales, mins f32 [K/gs, N]; part f32
// [splits, M, N] scratch; y [M,N] in dtype. per: K rows per split, a multiple
// of max(128, gs). Returns a cudaError_t code.
extern "C" int qmm_stream_launch(const void* x, const void* qweight, const void* scales,
                                 const void* mins, void* part, void* y, int M, int K,
                                 int N, int bits, int group_size, int splits, int per,
                                 int dtype, void* stream) {
  if (M <= 0 || M > 32 || N <= 0 || K <= 0 || N % kBN != 0 || group_size <= 0 ||
      K % group_size != 0 || splits <= 0 || per <= 0 ||
      (long long)splits * per < K || (long long)(splits - 1) * per >= K ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto by_bits = [&](auto tag) {
    using T = decltype(tag);
    if (bits == 4)
      return launch_bits<4, T>(x, qweight, scales, mins, part, y, M, K, N, group_size,
                               splits, per, st);
    if (bits == 8)
      return launch_bits<8, T>(x, qweight, scales, mins, part, y, M, K, N, group_size,
                               splits, per, st);
    return (int)cudaErrorInvalidValue;
  };
  if (dtype == 0) return by_bits(__nv_bfloat16());
  if (dtype == 1) return by_bits(float());
  if (dtype == 2) return by_bits(__half());
  return (int)cudaErrorInvalidValue;
}
