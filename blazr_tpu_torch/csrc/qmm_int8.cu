// Kernel B3: int8-activation grouped-affine quantized matmul (W4A8 / W8A8)
// on the H100's int8 tensor cores.
//
// Replaces blazr_tpu/quant/pallas/int_matmul.py::_qmm_int8_kernel (:276),
// launched there by _qmm_int8 (:329) behind quant_matmul_int8mxu (:374).
// Same function:
//
//   y[i,n] = xs[i] * sum_g ( s[g,n] * sum_{k in g} xq[i,k]*q[k,n]
//                            - (sum_{k in g} xq[i,k]) * m[g,n] )
//
// xq int8 [M,K] and xs f32 [M] are the per-row activation quant, done by the
// wrapper in plain PyTorch (quant/int8.py) as the JAX package does it outside
// its pallas_call. q is the canonical K-packed signed 4- or 8-bit weight of
// quant/qtensor.py: word row w of qweight [K*bits/32, N] holds logical rows
// w*r+j in bits [bits*j, bits*j+bits), r = 32/bits. The inner sums are exact
// int32 sums; the offset term uses the group sums of the quantized
// activations, as the TPU kernel does. The output is in x's dtype.
//
// What bounds it on the H100: at prefill the 2*M*K*N int8 operations against
// 1,979 TOP/s (gateup, m=512: 0.0608 ms); at decode the weight stream (w4a8
// gateup 66.1 MB, 0.0197 ms; w8a8 124.8 MB, 0.0372 ms at 3.35 TB/s).
//
// Design (simple and right first):
//   * mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (m16n8k16 for groups
//     that are an odd multiple of 16). A block of 4 warps owns BM rows x 128
//     columns; each warp 32 columns (4 n8 tiles) x BM rows (BM/16 m16 tiles).
//   * The K dimension of one mma step may be permuted freely as long as A and
//     B agree. Thread t of a quad takes the 8 K-consecutive rows 8t..8t+7 of
//     the step: for 8-bit weights those are two whole K-packed words (each
//     word is 4 K-consecutive int8 values of one column, one B register); a
//     4-bit word is split into its even and odd nibbles, sign-extended into
//     two B registers, and the A bytes are permuted (prmt) to the same order.
//   * The accumulator layout is documented (thread t holds rows t/4, t/4+8,
//     columns 2(t%4), 2(t%4)+1), so the per-group affine is applied in
//     registers at each group's end. The group sums of xq come from dp4a on
//     the A registers and two quad shuffles: no trip through shared memory.
//   * xq and weight tiles of 64 K rows stream through a 4-stage cp.async ring
//     in shared memory (16-byte copies, rows past M zero-filled, padded rows
//     so the fragment loads hit distinct banks).
//   * When the (m, n) tiles give fewer than 264 blocks (decode) the wrapper
//     splits K across blocks (grid z); each split writes xs-scaled f32
//     partials and a second kernel sums the splits in a fixed order and casts
//     (no atomics: a run repeats bit for bit).
// Requires N % 128 == 0, K % 64 == 0 and a group size that is a multiple of
// 16; the wrapper checks. wgmma, TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kBN = 128;        // columns per block, 32 per warp
constexpr int kKC = 64;         // K rows per pipeline stage
constexpr int kStages = 4;
constexpr int kLDA = kKC + 32;  // bytes per staged xq row (bank spread)

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half(v); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma_k32(int (&c)[4], uint32_t a0, uint32_t a1,
                                        uint32_t a2, uint32_t a3, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k16(int (&c)[4], uint32_t a0, uint32_t a1,
                                        uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Four 4-bit fields, one in the low nibble of each byte, sign-extended to
// four int8 bytes (0x08 * 0x1E = 0xF0 stays inside its byte).
__device__ __forceinline__ uint32_t sext4(uint32_t v) {
  return v | ((v & 0x08080808u) * 0x1Eu);
}

template <int BITS, int BM, int KS>
struct Tile {
  static constexpr int R = 32 / BITS;              // K rows per word
  static constexpr int WROWS = kKC / R;            // word rows per stage
  static constexpr int LDW = kBN + (BITS == 4 ? 8 : 4);   // words per row
  static constexpr int A_BYTES = BM * kLDA;
  static constexpr int W_BYTES = WROWS * LDW * 4;
  static constexpr int STAGE = A_BYTES + W_BYTES;
  static constexpr size_t SMEM = (size_t)kStages * STAGE;
};

template <int BITS, int BM, int KS, typename T>
__global__ void __launch_bounds__(kThreads)
qmm_int8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                const uint32_t* __restrict__ qw, const float* __restrict__ scales,
                const float* __restrict__ mins, float* __restrict__ part,
                T* __restrict__ y, int M, int K, int N, int gs, int per, int splits) {
  using L = Tile<BITS, BM, KS>;
  constexpr int MS = BM / 16;          // m16 tiles per warp
  constexpr int NS = 4;                // n8 tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int z = blockIdx.z;
  const int kb = z * per;
  const int ke = min(K, kb + per);
  const int nchunks = (ke - kb) / kKC;

  auto load = [&](int c, int s) {
    unsigned char* a_s = smem + s * L::STAGE;
    uint32_t* w_s = reinterpret_cast<uint32_t*>(a_s + L::A_BYTES);
    const int k0 = kb + c * kKC;
    for (int i = tid; i < BM * (kKC / 16); i += kThreads) {
      const int r = i / (kKC / 16), c16 = i - r * (kKC / 16);
      const bool ok = m0 + r < M;
      const int8_t* src = xq + (size_t)(ok ? m0 + r : 0) * K + k0 + c16 * 16;
      cp_async16(a_s + r * kLDA + c16 * 16, src, ok);
    }
    for (int i = tid; i < L::WROWS * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4), c4 = i - r * (kBN / 4);
      const uint32_t* src = qw + (size_t)(k0 / L::R + r) * N + n0 + c4 * 4;
      cp_async16(w_s + r * L::LDW + c4 * 4, src, true);
    }
  };

  int acc[MS][NS][4];
  float out[MS][NS][4];
  int rs[MS][2];                        // running sums of xq, rows g and g+8
#pragma unroll
  for (int a = 0; a < MS; ++a) {
    rs[a][0] = rs[a][1] = 0;
#pragma unroll
    for (int b = 0; b < NS; ++b)
#pragma unroll
      for (int r = 0; r < 4; ++r) { acc[a][b][r] = 0; out[a][b][r] = 0.f; }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    if (c + kStages - 1 < nchunks) load(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const unsigned char* a_s = smem + (c % kStages) * L::STAGE;
    const uint32_t* w_s = reinterpret_cast<const uint32_t*>(a_s + L::A_BYTES);
    const int k0 = kb + c * kKC;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += KS) {
      uint32_t b[NS][KS / 16];
#pragma unroll
      for (int ns = 0; ns < NS; ++ns) {
        const int col = warp * 32 + ns * 8 + g;
        if constexpr (KS == 32) {
          if constexpr (BITS == 8) {
            b[ns][0] = w_s[(kk / 4 + 2 * t) * L::LDW + col];
            b[ns][1] = w_s[(kk / 4 + 2 * t + 1) * L::LDW + col];
          } else {
            const uint32_t w = w_s[(kk / 8 + t) * L::LDW + col];
            b[ns][0] = sext4(w & 0x0F0F0F0Fu);           // k 8t + 0,2,4,6
            b[ns][1] = sext4((w >> 4) & 0x0F0F0F0Fu);    // k 8t + 1,3,5,7
          }
        } else {
          if constexpr (BITS == 8) {
            b[ns][0] = w_s[(kk / 4 + t) * L::LDW + col];
          } else {
            const uint32_t w = w_s[(kk / 8 + (t >> 1)) * L::LDW + col];
            b[ns][0] = sext4(((t & 1) ? (w >> 4) : w) & 0x0F0F0F0Fu);
          }
        }
      }
#pragma unroll
      for (int ms = 0; ms < MS; ++ms) {
        const unsigned char* ar0 = a_s + (ms * 16 + g) * kLDA + kk;
        const unsigned char* ar1 = ar0 + 8 * kLDA;
        if constexpr (KS == 32) {
          const uint2 v0 = *reinterpret_cast<const uint2*>(ar0 + 8 * t);
          const uint2 v1 = *reinterpret_cast<const uint2*>(ar1 + 8 * t);
          uint32_t a0, a1, a2, a3;
          if constexpr (BITS == 8) {
            a0 = v0.x; a2 = v0.y; a1 = v1.x; a3 = v1.y;
          } else {                                        // even / odd bytes
            a0 = __byte_perm(v0.x, v0.y, 0x6420); a2 = __byte_perm(v0.x, v0.y, 0x7531);
            a1 = __byte_perm(v1.x, v1.y, 0x6420); a3 = __byte_perm(v1.x, v1.y, 0x7531);
          }
          rs[ms][0] = __dp4a((int)a2, 0x01010101, __dp4a((int)a0, 0x01010101, rs[ms][0]));
          rs[ms][1] = __dp4a((int)a3, 0x01010101, __dp4a((int)a1, 0x01010101, rs[ms][1]));
#pragma unroll
          for (int ns = 0; ns < NS; ++ns) mma_k32(acc[ms][ns], a0, a1, a2, a3, b[ns][0], b[ns][1]);
        } else {
          uint32_t a0, a1;
          if constexpr (BITS == 8) {
            a0 = *reinterpret_cast<const uint32_t*>(ar0 + 4 * t);
            a1 = *reinterpret_cast<const uint32_t*>(ar1 + 4 * t);
          } else {
            const uint2 v0 = *reinterpret_cast<const uint2*>(ar0 + 8 * (t >> 1));
            const uint2 v1 = *reinterpret_cast<const uint2*>(ar1 + 8 * (t >> 1));
            const uint32_t sel = (t & 1) ? 0x7531 : 0x6420;
            a0 = __byte_perm(v0.x, v0.y, sel);
            a1 = __byte_perm(v1.x, v1.y, sel);
          }
          rs[ms][0] = __dp4a((int)a0, 0x01010101, rs[ms][0]);
          rs[ms][1] = __dp4a((int)a1, 0x01010101, rs[ms][1]);
#pragma unroll
          for (int ns = 0; ns < NS; ++ns) mma_k16(acc[ms][ns], a0, a1, b[ns][0]);
        }
      }
      if ((k0 + kk + KS) % gs == 0) {       // group ends: apply its affine
        const int gi = (k0 + kk + KS) / gs - 1;
        float gsum[MS][2];
#pragma unroll
        for (int ms = 0; ms < MS; ++ms)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int v = rs[ms][h];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            gsum[ms][h] = (float)v;
            rs[ms][h] = 0;
          }
#pragma unroll
        for (int ns = 0; ns < NS; ++ns) {
          const int col = n0 + warp * 32 + ns * 8 + 2 * t;
          const float2 sv = *reinterpret_cast<const float2*>(scales + (size_t)gi * N + col);
          const float2 mv = *reinterpret_cast<const float2*>(mins + (size_t)gi * N + col);
#pragma unroll
          for (int ms = 0; ms < MS; ++ms) {
            out[ms][ns][0] += sv.x * (float)acc[ms][ns][0] - gsum[ms][0] * mv.x;
            out[ms][ns][1] += sv.y * (float)acc[ms][ns][1] - gsum[ms][0] * mv.y;
            out[ms][ns][2] += sv.x * (float)acc[ms][ns][2] - gsum[ms][1] * mv.x;
            out[ms][ns][3] += sv.y * (float)acc[ms][ns][3] - gsum[ms][1] * mv.y;
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[ms][ns][r] = 0;
          }
        }
      }
    }
    __syncthreads();                        // slot fully read before reuse
  }

#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + ms * 16 + g + 8 * h;
      if (row >= M) continue;
      const float sc = xs[row];
#pragma unroll
      for (int ns = 0; ns < NS; ++ns) {
        const int col = n0 + warp * 32 + ns * 8 + 2 * t;
        const float v0 = out[ms][ns][2 * h] * sc, v1 = out[ms][ns][2 * h + 1] * sc;
        if (splits == 1) {
          y[(size_t)row * N + col] = from_f32<T>(v0);
          y[(size_t)row * N + col + 1] = from_f32<T>(v1);
        } else {
          float* p = part + ((size_t)z * M + row) * N + col;
          p[0] = v0;
          p[1] = v1;
        }
      }
    }
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

template <int BITS, int BM, int KS, typename T>
int launch(const void* xq, const void* xs, const void* qw, const void* s, const void* mn,
           void* part, void* y, int M, int K, int N, int gs, int splits, int per,
           cudaStream_t st) {
  using L = Tile<BITS, BM, KS>;
  auto kern = qmm_int8_kernel<BITS, BM, KS, T>;
  if (L::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((M + BM - 1) / BM, N / kBN, splits);
  kern<<<grid, kThreads, L::SMEM, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const uint32_t*>(qw), static_cast<const float*>(s),
      static_cast<const float*>(mn), static_cast<float*>(part), static_cast<T*>(y),
      M, K, N, gs, per, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t total = (size_t)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  reduce_splits<T><<<blocks, 256, 0, st>>>(static_cast<const float*>(part),
                                           static_cast<T*>(y), splits, total);
  return (int)cudaGetLastError();
}

template <int BITS, typename T>
int launch_bits(const void* xq, const void* xs, const void* qw, const void* s,
                const void* mn, void* part, void* y, int M, int K, int N, int gs,
                int splits, int per, cudaStream_t st) {
  const bool k32 = gs % 32 == 0;
  if (M <= 16)
    return k32 ? launch<BITS, 16, 32, T>(xq, xs, qw, s, mn, part, y, M, K, N, gs, splits, per, st)
               : launch<BITS, 16, 16, T>(xq, xs, qw, s, mn, part, y, M, K, N, gs, splits, per, st);
  return k32 ? launch<BITS, 64, 32, T>(xq, xs, qw, s, mn, part, y, M, K, N, gs, splits, per, st)
             : launch<BITS, 64, 16, T>(xq, xs, qw, s, mn, part, y, M, K, N, gs, splits, per, st);
}

}  // namespace

// xq int8 [M,K]; xs f32 [M]; qweight u32 [K*bits/32, N]; scales, mins f32
// [K/gs, N]; part f32 [splits, M, N] scratch (unused when splits == 1); y
// [M,N] in dtype (0 = bfloat16, 1 = float32, 2 = float16). per: K rows per split, a
// multiple of max(gs, 64). Returns a cudaError_t code.
extern "C" int qmm_int8_launch(const void* xq, const void* xs, const void* qweight,
                               const void* scales, const void* mins, void* part,
                               void* y, int M, int K, int N, int bits, int group_size,
                               int splits, int per, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % kBN != 0 || K % kKC != 0 ||
      group_size <= 0 || group_size % 16 != 0 || K % group_size != 0 ||
      splits <= 0 || per <= 0 || per % kKC != 0 || per % group_size != 0 ||
      (long long)splits * per < K || (long long)(splits - 1) * per >= K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto by_bits = [&](auto tag) {
    using T = decltype(tag);
    if (bits == 4)
      return launch_bits<4, T>(xq, xs, qweight, scales, mins, part, y, M, K, N, group_size,
                               splits, per, st);
    if (bits == 8)
      return launch_bits<8, T>(xq, xs, qweight, scales, mins, part, y, M, K, N, group_size,
                               splits, per, st);
    return (int)cudaErrorInvalidValue;
  };
  if (dtype == 0) return by_bits(__nv_bfloat16());
  if (dtype == 1) return by_bits(float());
  if (dtype == 2) return by_bits(__half());
  return (int)cudaErrorInvalidValue;
}
