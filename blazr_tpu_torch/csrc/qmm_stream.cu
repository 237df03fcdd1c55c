// Kernel B4: streaming decode variant of B1 (fused grouped-affine dequant +
// matmul) for signed 4- and 8-bit weights at m <= 32, on the H100's bf16
// tensor cores.
//
// Replaces blazr_tpu/quant/pallas/int_matmul.py::_qmm_stream_kernel (:170),
// launched there by _qmm_stream (:244) from the opt-in branch of
// quant_matmul_pallas (:478-496, BLAZR_TPU_STREAM_KERNEL=1). Same function,
// in the TPU kernel's formulation (:211-225): x is rounded to bf16 once, the
// int weights (exact in bf16) are multiplied with it in bf16 into f32 group
// partials, and each partial is scaled by s[g,n] minus the group sum of the
// rounded x times mins[g,n]:
//
//   y[m,n] = sum_g s[g,n] * (bf16(x)_g . q_g)[m,n] - (sum_{k in g} bf16(x)[m,k]) * mins[g,n]
//
// with f32 sums and the output in x's dtype.
//
// What bounds it on the H100: the weight stream. At decode every K-packed word
// is read once: gate+up (K=4096, N=28672, int4, gs 128) moves 66.6 MB with its
// scale and min planes, 0.0199 ms at 3.35 TB/s.
//
// Design:
//   * round_rows_kernel, once per call: x -> bf16 [M, K] and the f32 group
//     sums of the rounded x [M, K/gs], each sum taken by one warp in a fixed
//     order. No block of the product redoes either.
//   * qmm_stream_kernel: mma.sync m16n8k16 bf16 -> f32 with swapped operands.
//     The weights are the 16-row A operand, converted in registers from their
//     packed words by exponent tricks (no trip through shared memory as bf16,
//     no int-to-float instruction); the <= 32 x rows
//     are the n8 tiles of B. Within a k16 step thread t takes four K-adjacent
//     weights of one word (8-bit: the whole word; 4-bit: half a word) and the
//     matching four bf16 values of x, so A and B agree on one K order and x
//     needs no transpose.
//   * A producer warp streams each K split's contiguous word slab and the
//     rounded x columns through a 4-stage cp.async ring with mbarriers; the
//     four consumer warps (32 columns each) never meet at a barrier.
//   * Groups of 4 or 8 rows (SMALL) end inside a k16 step: thread t's four
//     rows lie in group t / (gs/4) of the step, so each group's products run
//     as one more mma with the other threads' x zeroed, folded at once.
//   * K is split across blocks so that about two waves fill 132 SMs; each
//     split writes f32 partials [splits, m, N] and a second kernel sums them
//     in a fixed order and casts: no atomics, a run repeats bit for bit.
// Requires N % 128 == 0, a group size of 4, 8 or a multiple of 16 dividing K,
// and K rows per split a multiple of the group and of 16; the wrapper checks.

#include "hopper.cuh"

namespace {

constexpr int kBN = 128;
constexpr int kBK = 128;                   // K rows per ring stage
constexpr int kConsumers = 128;            // four warps, 32 columns each
constexpr int kThreads = kConsumers + 32;  // ... and one producer warp
constexpr int kStages = 4;
constexpr int kLDW = kBN + 8;              // words per staged row (bank spread)
constexpr int kLDX = kBK * 2 + 16;         // bytes per staged bf16 x row

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

// One warp per (row, group): the group's values rounded to bf16, written out,
// and their f32 sum in a fixed order (lane strides, then a shuffle tree).
template <typename T>
__global__ void __launch_bounds__(256)
round_rows_kernel(const T* __restrict__ x, __nv_bfloat16* __restrict__ xb,
                  float* __restrict__ xsum, int M, int K, int gs) {
  const int ng = K / gs;
  const int item = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (item >= M * ng) return;
  const int row = item / ng, g = item - row * ng;
  const size_t base = (size_t)row * K + (size_t)g * gs;
  float sum = 0.f;
  for (int i = lane; i < gs; i += 32) {
    const __nv_bfloat16 b = __float2bfloat16(to_f32<T>(x[base + i]));
    xb[base + i] = b;
    sum += __bfloat162float(b);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) xsum[item] = sum;
}

template <int BITS, int NT>
struct Layout {
  static constexpr int W_BYTES = (kBK * BITS / 32) * kLDW * 4;
  static constexpr int X_BYTES = 8 * NT * kLDX;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int BAR_OFF = kStages * STAGE;
  static constexpr int TOTAL = BAR_OFF + 2 * kStages * 8;
};

// Signed fields j and j+1 of a word as a bf16x2 (field j in the low half),
// exact, without the int-to-float instruction (a sixteenth of the FMA rate).
// 4-bit: the biased field u = v + 8 in the mantissa of bf16 128 (bits 0x4300
// | u are 128 + u), minus 136. 8-bit: u = v + 128 in the mantissa of f32 2^23,
// minus 2^23 + 128; the integer is exact in bf16, so its f32's upper half is
// its bf16.
template <int BITS>
__device__ __forceinline__ uint32_t pair_bf16(uint32_t w, int j) {
  if constexpr (BITS == 4) {
    const uint32_t y = (w ^ 0x88888888u) >> (4 * j);
    uint32_t h = (y & 0xFu) | ((y << 12) & 0xF0000u) | 0x43004300u;
    __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&h);
    v = __hsub2(v, __float2bfloat162_rn(136.f));
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const uint32_t y = w ^ 0x80808080u;
    const float lo = __int_as_float(__byte_perm(y, 0x4B000000u, 0x7640 | j)) - 8388736.f;
    const float hi = __int_as_float(__byte_perm(y, 0x4B000000u, 0x7640 | (j + 1))) - 8388736.f;
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Block: 128 columns x one K split (grid y), all M <= 8*NT rows. Warp w's A
// rows are columns 32w + 16ms + {g, g+8} (ms = 0, 1); its C tile (ms, nt)
// holds c0,c1 = column 32w+16ms+g, x rows 8nt+2t, +1 and c2,c3 the same rows
// of column +8 (g = lane/4, t = lane%4). Stage s is guarded by full[s] (the
// producer's 32 lanes' copies have landed) and empty[s] (the 4 consumer warps
// are done with it).
template <int BITS, int NT, bool SMALL>
__global__ void __launch_bounds__(kThreads)
qmm_stream_kernel(const __nv_bfloat16* __restrict__ xb, const float* __restrict__ xsum,
                  const uint32_t* __restrict__ qw, const float* __restrict__ scales,
                  const float* __restrict__ mins, float* __restrict__ part, int M, int K,
                  int N, int gs, int per) {
  using L = Layout<BITS, NT>;
  constexpr int R = 32 / BITS;
  constexpr int XR = 8 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, z = blockIdx.y;
  const int kb = z * per, ke = min(K, kb + per);
  const int KT = (ke - kb + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % kStages;
      if (kt >= kStages) mbar_wait(empty + s, ((kt / kStages) + 1) & 1);
      uint32_t* w_s = reinterpret_cast<uint32_t*>(smem + s * L::STAGE);
      unsigned char* x_s = smem + s * L::STAGE + L::W_BYTES;
      const int k0 = kb + kt * kBK;
      const int krows = min(kBK, ke - k0);
      for (int i = lane; i < (krows / R) * (kBN / 4); i += 32) {
        const int r = i / (kBN / 4), c4 = (i % (kBN / 4)) * 4;
        cp_async<16>(w_s + r * kLDW + c4, qw + (size_t)(k0 / R + r) * N + n0 + c4, true);
      }
      const int xc = krows / 8;                          // 16-byte chunks a row
      for (int i = lane; i < XR * xc; i += 32) {
        const int r = i / xc, c = i - r * xc;
        const bool ok = r < M;
        cp_async<16>(x_s + r * kLDX + 16 * c, xb + (size_t)(ok ? r : 0) * K + k0 + 8 * c, ok);
      }
      cp_async_arrive(full + s);
    }
    cp_async_commit();
    cp_async_wait<0>();
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int cb = 32 * warp + g;
  const int ng = K / gs;
  float acc[2][NT][4], out[2][NT][4];
#pragma unroll
  for (int ms = 0; ms < 2; ++ms)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) { acc[ms][nt][r] = 0.f; out[ms][nt][r] = 0.f; }

  // The scale, min and x group sums of group gi, loaded a group ahead.
  float sv[2][2], mv[2][2], xg[NT][2];
  auto load_group = [&](int gi) {
#pragma unroll
    for (int ms = 0; ms < 2; ++ms)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t o = (size_t)gi * N + n0 + cb + 16 * ms + 8 * h;
        sv[ms][h] = __ldg(scales + o);
        mv[ms][h] = __ldg(mins + o);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        xg[nt][c] = __ldg(xsum + (size_t)min(8 * nt + 2 * t + c, M - 1) * ng + gi);
  };
  load_group(kb / gs);

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + s, (kt / kStages) & 1);
    const uint32_t* w_s = reinterpret_cast<const uint32_t*>(smem + s * L::STAGE);
    const unsigned char* x_s = smem + s * L::STAGE + L::W_BYTES;
    const int k0 = kb + kt * kBK;
    const int krows = min(kBK, ke - k0);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      if (kk >= krows) break;
      // Thread t's K rows in this step: kk+4t .. kk+4t+3 (A slots 2t, 2t+1
      // and 2t+8, 2t+9; the same slots of B).
      uint32_t a[2][4];
#pragma unroll
      for (int ms = 0; ms < 2; ++ms) {
        const int c0 = cb + 16 * ms;
        uint32_t w0, w1;
        int j;
        if constexpr (BITS == 8) {
          w0 = w_s[(kk / 4 + t) * kLDW + c0];
          w1 = w_s[(kk / 4 + t) * kLDW + c0 + 8];
          j = 0;
        } else {
          w0 = w_s[(kk / 8 + (t >> 1)) * kLDW + c0];
          w1 = w_s[(kk / 8 + (t >> 1)) * kLDW + c0 + 8];
          j = 4 * (t & 1);
        }
        a[ms][0] = pair_bf16<BITS>(w0, j);
        a[ms][1] = pair_bf16<BITS>(w1, j);
        a[ms][2] = pair_bf16<BITS>(w0, j + 2);
        a[ms][3] = pair_bf16<BITS>(w1, j + 2);
      }
      if constexpr (SMALL) {                             // groups of 4 or 8 rows
        const int gk = (k0 + kk) / gs;
        for (int j = 0; j < 16 / gs; ++j) {
          load_group(gk + j);
          const bool mine = t / (gs / 4) == j;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint2 v = *reinterpret_cast<const uint2*>(x_s + (8 * nt + g) * kLDX +
                                                            2 * (kk + 4 * t));
            const uint32_t b0 = mine ? v.x : 0u, b1 = mine ? v.y : 0u;
#pragma unroll
            for (int ms = 0; ms < 2; ++ms) {
              float c[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(c, a[ms][0], a[ms][1], a[ms][2], a[ms][3], b0, b1);
#pragma unroll
              for (int r = 0; r < 4; ++r)
                out[ms][nt][r] += sv[ms][r >> 1] * c[r] - xg[nt][r & 1] * mv[ms][r >> 1];
            }
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 v = *reinterpret_cast<const uint2*>(x_s + (8 * nt + g) * kLDX +
                                                          2 * (kk + 4 * t));
#pragma unroll
          for (int ms = 0; ms < 2; ++ms)
            mma_bf16(acc[ms][nt], a[ms][0], a[ms][1], a[ms][2], a[ms][3], v.x, v.y);
        }
        const int k = k0 + kk + 16;
        if (k % gs == 0) {                                 // group k/gs - 1 ends
#pragma unroll
          for (int ms = 0; ms < 2; ++ms)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int h = r >> 1, c = r & 1;
                out[ms][nt][r] += sv[ms][h] * acc[ms][nt][r] - xg[nt][c] * mv[ms][h];
                acc[ms][nt][r] = 0.f;
              }
          if (k < ke) load_group(k / gs);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = 8 * nt + 2 * t + c;
      if (row >= M) continue;
#pragma unroll
      for (int ms = 0; ms < 2; ++ms)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          part[((size_t)z * M + row) * N + n0 + cb + 16 * ms + 8 * h] = out[ms][nt][2 * h + c];
    }
}

template <int BITS, int NT, bool SMALL, typename T>
int launch(const void* xb, const void* xsum, const void* qw, const void* s, const void* mn,
           void* part, void* y, int M, int K, int N, int gs, int splits, int per,
           cudaStream_t st) {
  using L = Layout<BITS, NT>;
  auto kern = qmm_stream_kernel<BITS, NT, SMALL>;
  static size_t allowed = 48 * 1024;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), L::TOTAL, allowed);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(N / kBN, splits), kThreads, L::TOTAL, st>>>(
      static_cast<const __nv_bfloat16*>(xb), static_cast<const float*>(xsum),
      static_cast<const uint32_t*>(qw), static_cast<const float*>(s),
      static_cast<const float*>(mn), static_cast<float*>(part), M, K, N, gs, per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_reduce<T>(part, y, splits, (size_t)M * N, st);
}

template <int BITS, bool SMALL, typename T>
int launch_rows(const void* xb, const void* xsum, const void* qw, const void* s,
                const void* mn, void* part, void* y, int M, int K, int N, int gs, int splits,
                int per, cudaStream_t st) {
#define B4_ARGS xb, xsum, qw, s, mn, part, y, M, K, N, gs, splits, per, st
  if (M <= 8) return launch<BITS, 1, SMALL, T>(B4_ARGS);
  if (M <= 16) return launch<BITS, 2, SMALL, T>(B4_ARGS);
  return launch<BITS, 4, SMALL, T>(B4_ARGS);
}

template <int BITS, typename T>
int launch_bits(const void* xb, const void* xsum, const void* qw, const void* s,
                const void* mn, void* part, void* y, int M, int K, int N, int gs, int splits,
                int per, cudaStream_t st) {
  if (gs < 16) return launch_rows<BITS, true, T>(B4_ARGS);
  return launch_rows<BITS, false, T>(B4_ARGS);
#undef B4_ARGS
}

template <typename T>
int launch_round(const void* x, void* xb, void* xsum, int M, int K, int gs, cudaStream_t st) {
  const int items = M * (K / gs);
  round_rows_kernel<T><<<(items + 7) / 8, 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<__nv_bfloat16*>(xb), static_cast<float*>(xsum),
      M, K, gs);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M,K] in dtype (0 = bfloat16, 1 = float32, 2 = float16); xb bf16 [M,K]
// and xsum f32 [M, K/gs] scratch (16-byte aligned); qweight u32 [K*bits/32, N]
// signed 4- or 8-bit; scales, mins f32 [K/gs, N]; part f32 [splits, M, N]
// scratch; y [M,N] in dtype. per: K rows per split, a multiple of the group
// and of 16. Returns a cudaError_t code.
extern "C" int qmm_stream_launch(const void* x, const void* qweight, const void* scales,
                                 const void* mins, void* xb, void* xsum, void* part, void* y,
                                 int M, int K, int N, int bits, int group_size, int splits,
                                 int per, int dtype, void* stream) {
  if (M <= 0 || M > 32 || N <= 0 || K <= 0 || N % kBN != 0 ||
      (group_size != 4 && group_size != 8 && (group_size <= 0 || group_size % 16 != 0)) ||
      K % group_size != 0 || per % group_size != 0 || !split_ok(K, splits, per, 16) || reinterpret_cast<uintptr_t>(xb) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto by_bits = [&](auto tag) {
    using T = decltype(tag);
    int e = launch_round<T>(x, xb, xsum, M, K, group_size, st);
    if (e != 0) return e;
    if (bits == 4)
      return launch_bits<4, T>(xb, xsum, qweight, scales, mins, part, y, M, K, N, group_size,
                               splits, per, st);
    if (bits == 8)
      return launch_bits<8, T>(xb, xsum, qweight, scales, mins, part, y, M, K, N, group_size,
                               splits, per, st);
    return (int)cudaErrorInvalidValue;
  };
  if (bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return by_bits(__nv_bfloat16());
  if (dtype == 1) return by_bits(float());
  if (dtype == 2) return by_bits(__half());
  return (int)cudaErrorInvalidValue;
}
