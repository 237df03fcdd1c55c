// Kernel B3: int8-activation grouped-affine quantized matmul (W4A8 / W8A8)
// on the H100's int8 tensor cores, with its activation quant.
//
// Replaces blazr_tpu/quant/pallas/int_matmul.py::_qmm_int8_kernel (:276),
// launched there by _qmm_int8 (:329) behind quant_matmul_int8mxu (:374).
// Same function:
//
//   y[i,n] = xs[i] * sum_g ( s[g,n] * sum_{k in g} xq[i,k]*q[k,n]
//                            - (sum_{k in g} xq[i,k]) * m[g,n] )
//
// with the per-row activation quant of int_matmul.py:391-394,
//
//   xs[i] = max(max_k |x[i,k]|, 1e-30) / 127,  xq = clip(rint(x / xs), -127, 127),
//
// q the canonical K-packed signed 4- or 8-bit weight of quant/qtensor.py
// (word row w of qweight [K*bits/32, N] holds logical rows w*r+j in bits
// [bits*j, bits*j+bits), r = 32/bits), exact int32 inner sums and the output
// in x's dtype.
//
// What bounds it on the H100: at prefill the 2*M*K*N int8 operations against
// 1,979 TOP/s (gate+up, m=512: 0.0608 ms); at decode the weight stream (w4a8
// gate+up 66.1 MB, 0.0197 ms; w8a8 124.8 MB, 0.0372 ms at 3.35 TB/s). A call
// launches at most three kernels: the quant, one of the two products below,
// and the split reduction when K is split.
//
// act_quant_kernel: one block per row reads x (bf16, f16 or f32) twice and
// writes xq, xs and the int32 group sums of xq [M, K/gs] in one launch. The
// integers equal quantize_rows' on the CPU: an f32 absmax, IEEE divisions
// (__fdiv_rn) and round half to even (rintf). The products read the group
// sums in their affine instead of summing xq again.
//
// qmm_int8_wgmma_kernel (prefill rows; K and the group multiples of 128):
//   * wgmma m64nNk32 s8 x s8 -> s32 (sm_90a). Two consumer warpgroups own a
//     128x128 output tile (64 rows x 128 columns each), or 64x128 (64 x 64
//     each). With 8-bit types wgmma takes both operands K-major only.
//   * A producer warp keeps a 4-stage mbarrier ring of 128 K rows full: the
//     xq tile by TMA (int8, 128 K values a row, 128-byte swizzle, rows past M
//     zero-filled), the K-packed weight words and the stage's scale/min row
//     by 16-byte cp.async. The consumers turn the words into a K-major int8 B
//     tile (no-swizzle core matrices, three in flight): a transpose of 4-byte
//     words for 8-bit, nibble sign extension (sext4) and a byte interleave
//     for 4-bit; stage kt+1's tile is built while stage kt's products run.
//   * A group's s32 sums sit in registers; at its end they are folded into
//     f32 outputs, out += s*acc - gsum*m (the s32 -> f32 by an exponent
//     trick: the conversion instruction runs at a sixteenth of the rate).
//     A stage that ends a group drains the tensor cores (wait_group 0) and
//     folds it; other stages keep one stage of products in flight
//     (wait_group 1). A second bank of sums, stage kt's products running
//     while stage kt-1's group is folded, was slower on the card: ptxas
//     serializes every wgmma while the other bank is read (C7514; PERF.md).
//     64 sums and 64 outputs a thread: the producer's warpgroup gives its
//     registers to the consumers (setmaxnreg 40 / 232). A stage's four
//     products are issued without a branch: a wgmma in a branch is
//     serialized behind a fence that the compiler inserts. xs scales the
//     outputs in the epilogue.
//
// qmm_int8_dec_kernel (decode rows, and every geometry the wgmma variant does
// not take): swapped operands on mma.sync m16n8k32 (m16n8k16 for groups that
// are an odd multiple of 16). The weight is the 16-row A operand, read from
// shared memory as its packed words (8-bit words are A registers as they
// are; 4-bit words are sign-extended nibbles, even and odd, with the xq bytes
// permuted to the same K order); the x rows are the n8 tiles of B, 8, 16 or
// 32 of them, so no row is padded to 16. A producer warp streams the word
// slab and the xq columns of the block's K split through a 4-stage cp.async
// ring; the four consumer warps (32 columns each) never meet at a barrier.
//
// Both split K across blocks when the output tiles do not fill the card;
// each split writes xs-scaled f32 partials and a second kernel sums them in a
// fixed order (no atomics: a run repeats bit for bit).
// Requires N % 128 == 0, K % 64 == 0 and a group size that is a multiple of
// 16 dividing K; the wrapper checks.

#include "hopper.cuh"

namespace {

constexpr int kBN = 128;        // output columns per block
constexpr int kBK = 128;        // K rows per ring stage
constexpr size_t kSmemMax = 227 * 1024;

// Four 4-bit fields, one in the low nibble of each byte, sign-extended to
// four int8 bytes (0x08 * 0x1E = 0xF0 stays inside its byte).
__device__ __forceinline__ uint32_t sext4(uint32_t v) {
  return v | ((v & 0x08080808u) * 0x1Eu);
}

// A group's s32 sum as an exact f32. Below 2^22 in magnitude (groups of up
// to 256 rows: 256 * 128 * 127 < 2^22) by two full-rate operations: the bits
// of 2^23 + 2^22 plus v are the f32 2^23 + 2^22 + v. Larger groups take the
// conversion instruction, which runs at a sixteenth of the rate.
__device__ __forceinline__ float s32_to_f32(int v, bool small) {
  return small ? __int_as_float(v + 0x4B400000) - 12582912.f : (float)v;
}

// ---------------------------------------------------------------------------
// The activation quant
// ---------------------------------------------------------------------------

constexpr int kQuantThreads = 256;

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __half* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __half22float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
act_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
                 int* __restrict__ gsum, int K, int gs) {
  extern __shared__ int gsum_s[];                 // [K/gs]
  __shared__ float wmax[kQuantThreads / 32];
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int ng = K / gs, chunks = K / 8;
  const T* xr = x + (size_t)row * K;
  for (int i = tid; i < ng; i += kQuantThreads) gsum_s[i] = 0;

  float amax = 0.f;
  for (int c = tid; c < chunks; c += kQuantThreads) {
    float v[8];
    load8(xr + 8 * c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) wmax[tid >> 5] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, wmax[w]);
  const float sc = __fdiv_rn(fmaxf(amax, 1e-30f), 127.f);
  if (tid == 0) xs[row] = sc;

  int8_t* qr = xq + (size_t)row * K;
  for (int c = tid; c < chunks; c += kQuantThreads) {
    float v[8];
    load8(xr + 8 * c, v);
    uint32_t packed[2] = {0u, 0u};
    int sum = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int q = (int)fminf(fmaxf(rintf(__fdiv_rn(v[e], sc)), -127.f), 127.f);
      sum += q;
      packed[e >> 2] |= ((uint32_t)q & 0xFFu) << (8 * (e & 3));
    }
    *reinterpret_cast<uint2*>(qr + 8 * c) = make_uint2(packed[0], packed[1]);
    atomicAdd(gsum_s + (8 * c) / gs, sum);      // integers: any order is exact
  }
  __syncthreads();
  for (int i = tid; i < ng; i += kQuantThreads) gsum[(size_t)row * ng + i] = gsum_s[i];
}

template <typename T>
int launch_quant(const void* x, void* xq, void* xs, void* gsum, int M, int K, int gs,
                 cudaStream_t st) {
  const size_t smem = (size_t)(K / gs) * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  act_quant_kernel<T><<<M, kQuantThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs),
      static_cast<int*>(gsum), K, gs);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Prefill rows: warp-specialized wgmma
// ---------------------------------------------------------------------------

constexpr int kTcConsumers = 256;             // two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 128; // ... and the producer's warpgroup
constexpr int kTcStages = 4;
constexpr int kBTiles = 3;                    // B tiles in flight (see the loop)
constexpr int kBTile = kBN * kBK;             // one K-major int8 B tile, bytes
constexpr int kBarBytes = 128;
constexpr int kAlign = 1024;                  // a 128-byte-swizzled tile's alignment

struct TcLayout {
  int a_bytes, w_bytes, sm_bytes, stage, b_off, bar_off, total;
};

// From a 1024-byte aligned base: the ring (each stage the xq tile, the
// packed words and the scale/min rows of 128 K rows; every part a multiple
// of 512 bytes, the xq tile of 1024), three B tiles, the mbarriers; plus the
// alignment slack.
template <int BITS, int BM>
__host__ __device__ __forceinline__ TcLayout tc_layout(int ngs) {
  TcLayout l;
  l.a_bytes = BM * kBK;
  l.w_bytes = (kBK * BITS / 32) * kBN * 4;
  l.sm_bytes = ngs * kBN * 4;
  l.stage = l.a_bytes + l.w_bytes + 2 * l.sm_bytes;
  l.b_off = kTcStages * l.stage;
  l.bar_off = l.b_off + kBTiles * kBTile;
  l.total = kAlign + l.bar_off + kBarBytes;
  return l;
}

#define R8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
              "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// D[64 x N] (+)= A[64 x 32] * B[32 x N], s8 in, s32 sums; both K-major in
// shared memory; accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}
#undef R8

// B tiles are K-major no-swizzle core matrices: byte k of column n sits at
// ((k/16)*(kBN/8) + n/8)*128 + (n%8)*16 + k%16.
//
// Warp roles: warpgroups 0 and 1 consume, warpgroup 2 produces (its first
// warp loads; the other three leave at once). The producer gives up
// registers (setmaxnreg 40) so that the consumers can hold 64 s32 sums and
// 64 f32 outputs (setmaxnreg 232; 168 a thread otherwise).
// Stage s is guarded by full[s] (the producer's 32 lanes' copies and the xq
// tile's bytes have landed) and empty[s] (the 8 consumer warps are done with
// it, products and folds included).
//
// Groups are whole stages (gs a multiple of 128): every wgmma of a stage is
// issued without a branch, so none is serialized behind a compiler-inserted
// warpgroup fence. A stage that ends a group drains the tensor cores
// (wait_group 0) and folds it.
template <int BITS, int BM, typename TO>
__global__ void __launch_bounds__(kTcThreads, 1)
qmm_int8_wgmma_kernel(const __grid_constant__ CUtensorMap amap, const float* __restrict__ xs,
                      const int* __restrict__ gsum, const uint32_t* __restrict__ qw,
                      const float* __restrict__ scales, const float* __restrict__ mins,
                      float* __restrict__ part, TO* __restrict__ y, int M, int K, int N,
                      int gs, int per) {
  constexpr int R = 32 / BITS;
  constexpr int NW = BM == 128 ? 128 : 64;    // output columns per warpgroup
  constexpr int NACC = NW / 2;                // s32 sums per thread
  extern __shared__ __align__(128) unsigned char smem[];
  const TcLayout l = tc_layout<BITS, BM>(1);
  unsigned char* ring = smem + ((kAlign - (smem_u32(smem) & (kAlign - 1))) & (kAlign - 1));
  unsigned char* b_s = ring + l.b_off;        // [kBTiles][kBTile]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + l.bar_off);
  uint64_t* empty = full + kTcStages;

  const int tid = threadIdx.x, warp_id = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN, z = blockIdx.z;
  const int kb = z * per, ke = min(K, kb + per);
  const int KT = (ke - kb) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + s, 33);      // 32 lanes' copies and the xq tile's bytes
      mbar_init(empty + s, kTcConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp_id != kTcConsumers / 32) return;
    // Producer: the xq tile (TMA), the packed words and the scale/min row of
    // stage kt, once the consumers have released its slot.
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % kTcStages;
      if (kt >= kTcStages) mbar_wait(empty + s, ((kt / kTcStages) + 1) & 1);
      unsigned char* a_s = ring + s * l.stage;
      uint32_t* w_s = reinterpret_cast<uint32_t*>(a_s + l.a_bytes);
      float* s_s = reinterpret_cast<float*>(a_s + l.a_bytes + l.w_bytes);
      float* m_s = s_s + kBN;
      const int k0 = kb + kt * kBK;
      if (lane == 0) {
        mbar_arrive_expect(full + s, l.a_bytes);
        tma_load_2d(a_s, &amap, k0, m0, full + s);
      }
      for (int i = lane; i < (kBK / R) * (kBN / 4); i += 32) {
        const int r = i / (kBN / 4), c4 = (i % (kBN / 4)) * 4;
        cp_async<16>(w_s + r * kBN + c4, qw + (size_t)(k0 / R + r) * N + n0 + c4, true);
      }
      const size_t src = (size_t)(k0 / gs) * N + n0 + lane * 4;
      cp_async<16>(s_s + lane * 4, scales + src, true);
      cp_async<16>(m_s + lane * 4, mins + src, true);
      cp_async_arrive(full + s);
    }
    cp_async_commit();
    cp_async_wait<0>();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // Consumers. Each thread turns 4 chunks of 16 K rows of one column into
  // K-major int8: one 16-byte store each; 8 threads fill one core matrix.
  // (A B tile for each warpgroup, built by its own threads so that the two
  // never meet at a barrier, took longer: gate+up at 512 rows 0.55 against
  // 0.39 ms, PERF.md.)
  const int wg = tid >> 7, warp = warp_id & 3;
  const int cw0 = BM == 128 ? 0 : 64 * wg;      // the warpgroup's first column
  auto convert = [&](int s, unsigned char* bt) {
    const uint32_t* w_s =
        reinterpret_cast<const uint32_t*>(ring + s * l.stage + l.a_bytes);
    const int n = tid & (kBN - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = (tid >> 7) + 2 * j;         // 16 K rows: 4 8-bit words, 2 4-bit
      uint4 o;
      if constexpr (BITS == 8) {
        o.x = w_s[(4 * kc) * kBN + n];
        o.y = w_s[(4 * kc + 1) * kBN + n];
        o.z = w_s[(4 * kc + 2) * kBN + n];
        o.w = w_s[(4 * kc + 3) * kBN + n];
      } else {
        const uint32_t w0 = w_s[(2 * kc) * kBN + n], w1 = w_s[(2 * kc + 1) * kBN + n];
        const uint32_t e0 = sext4(w0 & 0x0F0F0F0Fu), d0 = sext4((w0 >> 4) & 0x0F0F0F0Fu);
        const uint32_t e1 = sext4(w1 & 0x0F0F0F0Fu), d1 = sext4((w1 >> 4) & 0x0F0F0F0Fu);
        o.x = __byte_perm(e0, d0, 0x5140);       // k 0, 1, 2, 3 of the word
        o.y = __byte_perm(e0, d0, 0x7362);       // k 4 .. 7
        o.z = __byte_perm(e1, d1, 0x5140);
        o.w = __byte_perm(e1, d1, 0x7362);
      }
      *reinterpret_cast<uint4*>(bt + (kc * (kBN / 8) + (n >> 3)) * 128 + (n & 7) * 16) = o;
    }
  };

  // Accumulator layout (per warpgroup, per n8 block j): d[4j + 2h + c] is row
  // 16*warp + lane/4 + 8h, column 8j + 2*(lane%4) + c of its 64 x NW tile.
  const int row0 = m0 + (BM == 128 ? 64 * wg : 0) + 16 * warp + (lane >> 2);
  const int colw = cw0 + 2 * (lane & 3);        // within the block
  const int ng = K / gs;
  const int* gq0 = gsum + (size_t)min(row0, M - 1) * ng;
  const int* gq1 = gsum + (size_t)min(row0 + 8, M - 1) * ng;
  const bool small = gs <= 256;

  int acc[NACC];
  float gq[2] = {0.f, 0.f};              // xq group sums of rows row0, row0 + 8
  float out[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) out[i] = 0.f;
  const uint32_t ring_a = smem_u32(ring), b_a = smem_u32(b_s);

  // Fold the group whose scale/min row stage s holds.
  auto fold = [&](int s) {
    fence_regs(acc);
    const float* s_s = reinterpret_cast<const float*>(ring + s * l.stage + l.a_bytes +
                                                      l.w_bytes);
    const float* m_s = s_s + kBN;
    const float q0 = gq[0], q1 = gq[1];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const float2 sv = *reinterpret_cast<const float2*>(s_s + colw + 8 * j);
      const float2 mv = *reinterpret_cast<const float2*>(m_s + colw + 8 * j);
      out[4 * j] += sv.x * s32_to_f32(acc[4 * j], small) - q0 * mv.x;
      out[4 * j + 1] += sv.y * s32_to_f32(acc[4 * j + 1], small) - q0 * mv.y;
      out[4 * j + 2] += sv.x * s32_to_f32(acc[4 * j + 2], small) - q1 * mv.x;
      out[4 * j + 3] += sv.y * s32_to_f32(acc[4 * j + 3], small) - q1 * mv.y;
    }
  };

  mbar_wait(full, 0);
  convert(0, b_s);
  fence_async_smem();
  consumers_sync<kTcConsumers>();
  // Stage kt: issue its four k32 products, then turn stage kt+1's words into
  // B tile (kt+1) % 3 while they run, fold a group that ends here and
  // release stage kt-1. Tile (kt+1) % 3 was last read by stage kt-2, whose
  // products every warpgroup saw finish (wait_group 1) before the last
  // barrier.
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kTcStages;
    const int k0 = kb + kt * kBK;
    const int first = k0 % gs == 0;       // the stage starts group k0 / gs
    if (first) {                           // its xq group sums
      gq[0] = (float)__ldg(gq0 + k0 / gs);
      gq[1] = (float)__ldg(gq1 + k0 / gs);
    }
    const uint32_t xa = ring_a + s * l.stage + (BM == 128 ? 8192 * wg : 0);
    const uint32_t ba = b_a + (kt % kBTiles) * kBTile + (BM == 128 ? 0 : 8 * wg) * 128;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      // A: 128-byte swizzled rows, 8-row groups 1024 bytes apart, K bytes
      // 32ks..32ks+31; B: K chunks 2ks and 2ks+1 of its columns.
      const uint64_t da = gmma_desc(xa + 32 * ks, 16, 1024, 1);
      const uint64_t db = gmma_desc(ba + 2 * ks * (kBN / 8) * 128, kBN * 16, 128, 0);
      if constexpr (BM == 128) wgmma_s8_n128(acc, da, db, ks > 0 || !first);
      else wgmma_s8_n64(acc, da, db, ks > 0 || !first);
    }
    wgmma_commit();
    if (kt + 1 < KT) {
      mbar_wait(full + (kt + 1) % kTcStages, ((kt + 1) / kTcStages) & 1);
      convert((kt + 1) % kTcStages, b_s + ((kt + 1) % kBTiles) * kBTile);
    }
    if ((k0 + kBK) % gs == 0) {
      wgmma_wait<0>();
      fold(s);
    } else {
      wgmma_wait<1>();
    }
    if (kt > 0) {                          // stage kt-1: products and folds done
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (kt - 1) % kTcStages);
    }
    fence_async_smem();                    // the converted B tile, to wgmma
    consumers_sync<kTcConsumers>();
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= M) continue;
    const float sc = xs[row];
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = n0 + colw + 8 * j;
      const float v0 = out[4 * j + 2 * h] * sc, v1 = out[4 * j + 2 * h + 1] * sc;
      if (split) store2(part + ((size_t)z * M + row) * N + col, v0, v1);
      else store2(y + (size_t)row * N + col, v0, v1);
    }
  }
}

template <int BITS, int BM, typename TO>
int launch_tc(const void* xq, const void* xs, const void* gsum, const void* qw, const void* s,
              const void* mn, void* part, void* y, int M, int K, int N, int gs, int splits,
              int per, cudaStream_t st) {
  const TcLayout l = tc_layout<BITS, BM>(1);
  if ((size_t)l.total > kSmemMax) return (int)cudaErrorInvalidValue;
  CUtensorMap amap;                      // xq [M, K] int8 in 128 x BM boxes
  const int ee = encode_rows_128b(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, M, K, kBK, BM);
  if (ee != 0) return ee;
  auto kern = qmm_int8_wgmma_kernel<BITS, BM, TO>;
  // setmaxnreg moves registers between the warpgroups of the block; it
  // needs the block launched with 40*128 + 232*256 of them, or it waits.
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes a;
    const cudaError_t ea = cudaFuncGetAttributes(&a, kern);
    if (ea != cudaSuccess) return (int)ea;
    regs = a.numRegs;
  }
  if (regs * kTcThreads < 40 * 128 + 232 * kTcConsumers) return (int)cudaErrorInvalidConfiguration;
  static size_t allowed = 48 * 1024;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), l.total, allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM, N / kBN, splits);
  kern<<<grid, kTcThreads, l.total, st>>>(
      amap, static_cast<const float*>(xs), static_cast<const int*>(gsum),
      static_cast<const uint32_t*>(qw), static_cast<const float*>(s),
      static_cast<const float*>(mn), static_cast<float*>(part), static_cast<TO*>(y), M, K, N,
      gs, per);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return launch_reduce<TO>(part, y, splits, (size_t)M * N, st);
}

// ---------------------------------------------------------------------------
// Decode rows: swapped operands on mma.sync
// ---------------------------------------------------------------------------

constexpr int kDecConsumers = 128;            // four warps, 32 columns each
constexpr int kDecThreads = kDecConsumers + 32;
constexpr int kDecStages = 4;
constexpr int kLDW = kBN + 8;                 // words per staged row (bank spread)
constexpr int kLDX = kBK + 16;                // bytes per staged xq row

template <int BITS, int NT>
struct DecLayout {
  static constexpr int W_BYTES = (kBK * BITS / 32) * kLDW * 4;
  static constexpr int X_BYTES = 8 * NT * kLDX;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int BAR_OFF = kDecStages * STAGE;
  static constexpr int TOTAL = BAR_OFF + 2 * kDecStages * 8;
};

__device__ __forceinline__ void mma_k32(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_k16(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The block owns 128 columns x 8*NT x rows (grid z) x one K split (grid y).
// Warp w's A rows are columns 32w + 16ms + {g, g+8} (ms = 0, 1); its C tile
// (ms, nt) holds c0,c1 = column 32w+16ms+g, x rows 8nt+2t, +1 and c2,c3 the
// same rows of column +8 (g = lane/4, t = lane%4).
template <int BITS, int NT, int KS, typename TO>
__global__ void __launch_bounds__(kDecThreads)
qmm_int8_dec_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                    const int* __restrict__ gsum, const uint32_t* __restrict__ qw,
                    const float* __restrict__ scales, const float* __restrict__ mins,
                    float* __restrict__ part, TO* __restrict__ y, int M, int K, int N,
                    int gs, int per) {
  using L = DecLayout<BITS, NT>;
  constexpr int R = 32 / BITS;
  constexpr int XR = 8 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + kDecStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, z = blockIdx.y, m0 = blockIdx.z * XR;
  const int kb = z * per, ke = min(K, kb + per);
  const int KT = (ke - kb + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kDecStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, kDecConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kDecConsumers / 32) {
    // Producer: the word slab and the xq columns of stage kt.
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % kDecStages;
      if (kt >= kDecStages) mbar_wait(empty + s, ((kt / kDecStages) + 1) & 1);
      uint32_t* w_s = reinterpret_cast<uint32_t*>(smem + s * L::STAGE);
      unsigned char* x_s = smem + s * L::STAGE + L::W_BYTES;
      const int k0 = kb + kt * kBK;
      const int krows = min(kBK, ke - k0);
      for (int i = lane; i < (krows / R) * (kBN / 4); i += 32) {
        const int r = i / (kBN / 4), c4 = (i % (kBN / 4)) * 4;
        cp_async<16>(w_s + r * kLDW + c4, qw + (size_t)(k0 / R + r) * N + n0 + c4, true);
      }
      const int xc = krows / 16;
      for (int i = lane; i < XR * xc; i += 32) {
        const int r = i / xc, c = i - r * xc;
        const bool ok = m0 + r < M;
        cp_async<16>(x_s + r * kLDX + 16 * c,
                     xq + (size_t)(ok ? m0 + r : 0) * K + k0 + 16 * c, ok);
      }
      cp_async_arrive(full + s);
    }
    cp_async_commit();
    cp_async_wait<0>();
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int cb = 32 * warp + g;                       // A row g of m16 tile 0
  const int ng = K / gs;
  const bool small = gs <= 256;
  int acc[2][NT][4];
  float out[2][NT][4];
#pragma unroll
  for (int ms = 0; ms < 2; ++ms)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) { acc[ms][nt][r] = 0; out[ms][nt][r] = 0.f; }

  // The scale, min and xq group sums of group gi, loaded a group ahead.
  float sv[2][2], mv[2][2], gq[NT][2];
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
      for (int c = 0; c < 2; ++c) {
        const int row = min(m0 + 8 * nt + 2 * t + c, M - 1);
        gq[nt][c] = (float)__ldg(gsum + (size_t)row * ng + gi);
      }
  };
  load_group(kb / gs);

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kDecStages;
    mbar_wait(full + s, (kt / kDecStages) & 1);
    const uint32_t* w_s = reinterpret_cast<const uint32_t*>(smem + s * L::STAGE);
    const unsigned char* x_s = smem + s * L::STAGE + L::W_BYTES;
    const int k0 = kb + kt * kBK;
    const int krows = min(kBK, ke - k0);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += KS) {
      if (kk >= krows) break;
      uint32_t a[2][KS / 8];                           // [m16 tile][A register]
#pragma unroll
      for (int ms = 0; ms < 2; ++ms) {
        const int c0 = cb + 16 * ms;
        if constexpr (KS == 32) {
          if constexpr (BITS == 8) {
            a[ms][0] = w_s[(kk / 4 + t) * kLDW + c0];
            a[ms][1] = w_s[(kk / 4 + t) * kLDW + c0 + 8];
            a[ms][2] = w_s[(kk / 4 + 4 + t) * kLDW + c0];
            a[ms][3] = w_s[(kk / 4 + 4 + t) * kLDW + c0 + 8];
          } else {                                     // even nibbles, then odd
            const uint32_t w0 = w_s[(kk / 8 + t) * kLDW + c0];
            const uint32_t w1 = w_s[(kk / 8 + t) * kLDW + c0 + 8];
            a[ms][0] = sext4(w0 & 0x0F0F0F0Fu);
            a[ms][1] = sext4(w1 & 0x0F0F0F0Fu);
            a[ms][2] = sext4((w0 >> 4) & 0x0F0F0F0Fu);
            a[ms][3] = sext4((w1 >> 4) & 0x0F0F0F0Fu);
          }
        } else {
          if constexpr (BITS == 8) {
            a[ms][0] = w_s[(kk / 4 + t) * kLDW + c0];
            a[ms][1] = w_s[(kk / 4 + t) * kLDW + c0 + 8];
          } else {
            const int sh = (t & 1) * 4;
            a[ms][0] = sext4((w_s[(kk / 8 + (t >> 1)) * kLDW + c0] >> sh) & 0x0F0F0F0Fu);
            a[ms][1] = sext4((w_s[(kk / 8 + (t >> 1)) * kLDW + c0 + 8] >> sh) & 0x0F0F0F0Fu);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned char* xr = x_s + (8 * nt + g) * kLDX + kk;
        if constexpr (KS == 32) {
          uint32_t b0, b1;
          if constexpr (BITS == 8) {
            b0 = *reinterpret_cast<const uint32_t*>(xr + 4 * t);
            b1 = *reinterpret_cast<const uint32_t*>(xr + 16 + 4 * t);
          } else {                                     // the same K order as A
            const uint2 v = *reinterpret_cast<const uint2*>(xr + 8 * t);
            b0 = __byte_perm(v.x, v.y, 0x6420);
            b1 = __byte_perm(v.x, v.y, 0x7531);
          }
#pragma unroll
          for (int ms = 0; ms < 2; ++ms)
            mma_k32(acc[ms][nt], a[ms][0], a[ms][1], a[ms][2], a[ms][3], b0, b1);
        } else {
          uint32_t b0;
          if constexpr (BITS == 8) {
            b0 = *reinterpret_cast<const uint32_t*>(xr + 4 * t);
          } else {
            const uint2 v = *reinterpret_cast<const uint2*>(xr + 8 * (t >> 1));
            b0 = __byte_perm(v.x, v.y, (t & 1) ? 0x7531 : 0x6420);
          }
#pragma unroll
          for (int ms = 0; ms < 2; ++ms) mma_k16(acc[ms][nt], a[ms][0], a[ms][1], b0);
        }
      }
      const int k = k0 + kk + KS;
      if (k % gs == 0) {                               // group k/gs - 1 ends
#pragma unroll
        for (int ms = 0; ms < 2; ++ms)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int h = r >> 1, c = r & 1;
              out[ms][nt][r] += sv[ms][h] * s32_to_f32(acc[ms][nt][r], small) -
                                gq[nt][c] * mv[ms][h];
              acc[ms][nt][r] = 0;
            }
        if (k < ke) load_group(k / gs);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

  const bool split = gridDim.y > 1;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = m0 + 8 * nt + 2 * t + c;
      if (row >= M) continue;
      const float sc = xs[row];
#pragma unroll
      for (int ms = 0; ms < 2; ++ms)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + cb + 16 * ms + 8 * h;
          const float v = out[ms][nt][2 * h + c] * sc;
          if (split) part[((size_t)z * M + row) * N + col] = v;
          else y[(size_t)row * N + col] = from_f32<TO>(v);
        }
    }
}

template <int BITS, int NT, int KS, typename TO>
int launch_dec(const void* xq, const void* xs, const void* gsum, const void* qw, const void* s,
               const void* mn, void* part, void* y, int M, int K, int N, int gs, int splits,
               int per, cudaStream_t st) {
  using L = DecLayout<BITS, NT>;
  auto kern = qmm_int8_dec_kernel<BITS, NT, KS, TO>;
  static size_t allowed = 48 * 1024;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), L::TOTAL, allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / kBN, splits, (M + 8 * NT - 1) / (8 * NT));
  kern<<<grid, kDecThreads, L::TOTAL, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int*>(gsum), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(s), static_cast<const float*>(mn), static_cast<float*>(part),
      static_cast<TO*>(y), M, K, N, gs, per);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return launch_reduce<TO>(part, y, splits, (size_t)M * N, st);
}

template <int BITS, typename TO>
int launch_variant(int variant, int rows, const void* xq, const void* xs, const void* gsum,
                   const void* qw, const void* s, const void* mn, void* part, void* y, int M,
                   int K, int N, int gs, int splits, int per, cudaStream_t st) {
#define B3_ARGS xq, xs, gsum, qw, s, mn, part, y, M, K, N, gs, splits, per, st
  if (variant == 1) {                    // wgmma: rows per block 64 or 128
    // whole groups of whole stages
    if (gs % kBK != 0 || K % kBK != 0 || per % gs != 0) return (int)cudaErrorInvalidValue;
    if (rows == 64) return launch_tc<BITS, 64, TO>(B3_ARGS);
    if (rows == 128) return launch_tc<BITS, 128, TO>(B3_ARGS);
    return (int)cudaErrorInvalidValue;
  }
  const bool k32 = gs % 32 == 0;         // decode: x rows per block 8, 16 or 32
  switch (rows) {
    case 8: return k32 ? launch_dec<BITS, 1, 32, TO>(B3_ARGS) : launch_dec<BITS, 1, 16, TO>(B3_ARGS);
    case 16: return k32 ? launch_dec<BITS, 2, 32, TO>(B3_ARGS) : launch_dec<BITS, 2, 16, TO>(B3_ARGS);
    case 32: return k32 ? launch_dec<BITS, 4, 32, TO>(B3_ARGS) : launch_dec<BITS, 4, 16, TO>(B3_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef B3_ARGS
}

}  // namespace

// The activation quant: x [M,K] in dtype (0 = bfloat16, 1 = float32,
// 2 = float16), 16-byte aligned, K % 8 == 0, gs % 8 == 0 dividing K; xq int8
// [M,K]; xs f32 [M]; gsum int32 [M, K/gs]. Returns a cudaError_t code.
extern "C" int act_quant_launch(const void* x, void* xq, void* xs, void* gsum, int M, int K,
                                int group_size, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0 || group_size <= 0 || group_size % 8 != 0 ||
      K % group_size != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_quant<__nv_bfloat16>(x, xq, xs, gsum, M, K, group_size, st);
  if (dtype == 1) return launch_quant<float>(x, xq, xs, gsum, M, K, group_size, st);
  if (dtype == 2) return launch_quant<__half>(x, xq, xs, gsum, M, K, group_size, st);
  return (int)cudaErrorInvalidValue;
}

// The products: xq, xs, gsum as act_quant_launch writes them; qweight u32
// [K*bits/32, N]; scales, mins f32 [K/gs, N]; part f32 [splits, M, N] scratch
// (unused when splits == 1); y [M,N] in dtype. variant 0: decode (rows =
// x rows per block, 8/16/32), 1: wgmma (rows = 64 or 128 per block). per: K
// rows per split, a multiple of the group size and of 64 (of 128 for wgmma).
// Returns a cudaError_t code.
extern "C" int qmm_int8_launch(const void* xq, const void* xs, const void* gsum,
                               const void* qweight, const void* scales, const void* mins,
                               void* part, void* y, int M, int K, int N, int bits,
                               int group_size, int variant, int rows, int splits, int per,
                               int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % kBN != 0 || K % 64 != 0 || group_size <= 0 ||
      group_size % 16 != 0 || K % group_size != 0 || per % group_size != 0 ||
      !split_ok(K, splits, per, 64) || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto by_bits = [&](auto tag) {
    using T = decltype(tag);
    if (bits == 4)
      return launch_variant<4, T>(variant, rows, xq, xs, gsum, qweight, scales, mins, part, y,
                                  M, K, N, group_size, splits, per, st);
    if (bits == 8)
      return launch_variant<8, T>(variant, rows, xq, xs, gsum, qweight, scales, mins, part, y,
                                  M, K, N, group_size, splits, per, st);
    return (int)cudaErrorInvalidValue;
  };
  if (dtype == 0) return by_bits(__nv_bfloat16());
  if (dtype == 1) return by_bits(float());
  if (dtype == 2) return by_bits(__half());
  return (int)cudaErrorInvalidValue;
}
