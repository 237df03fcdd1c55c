// Kernel B6: paged decode attention over a head-major KV cache, for Hopper.
//
// Replaces tools/bench_pa_headmajor.py::hm_kernel (:27), launched there by
// pa_headmajor (:66) through pl.pallas_call (:100). Same function as B5
// (pa_split.cuh states it) over another layout: the cache is
// [G, rows >= NB*BS, D], so one kv head's block is a contiguous [BS, D]
// tile. One query token per sequence over the keys at positions
// t*BS + i < seq_lens[b] through block_tables[b]; (q * 1/sqrt(D) in f32) . k
// with f32 sums; online softmax in f32 from m = -1e30; p stays f32;
// out = acc / max(l, 1e-30) in q's dtype (0 for seq_len 0); block ids outside
// [0, NB) read block 0.
//
// What bounds it on the H100: bytes. Each valid K/V row (D values of one kv
// head) is read once: B=8 sequences at 1023 tokens, G=8, D=128, bf16 move
// 33.5 MB, 0.0100 ms at 3.35 TB/s. The dot products stay on the f32 CUDA
// cores (~2 us for the 134 MFLOP): a bf16 mma/wgmma would round
// q * 1/sqrt(D) and the f32 probabilities to bf16, and TF32 rounds both too.
//
// Design (the kernel is pa_split.cuh's, with a block over one kv head):
//   * Flash-decoding: the grid is (B, G, splits). The plan
//     (tools/bench_pa_headmajor.py::headmajor_split_plan) aims at one wave of
//     four blocks a SM (528) with at least 64 KB of K+V a split (128 keys in
//     bf16): B=8 at ctx 1024, bs 64 takes 8 splits of 2 slots (512 blocks),
//     as do (8, 4096) (8 of 8) and (32, 1024) (2 of 8); the fastest counts
//     of phase 8's sweep at all three.
//   * A block is 4 warps at BS >= 32: each carries the H_q/G (<= 4) query
//     heads over 8 of a chunk's 32 keys, with its own m, l and acc, merged in
//     order at the end. Chunks of 32 rows (K padded by 16 bytes a row, V not)
//     stream through a 3-stage ring of cp.async copies: 32*272 + 32*256 =
//     16,896 bytes a stage in bf16, 53,248 bytes a block with q and p: four
//     blocks (16 warps) a SM.
//   * One barrier a chunk; softmax in registers and shuffles; acc in
//     registers; a fixed-order combine kernel over the splits.
// Known limits: the plan comes from the table width MB (the host knows no
// seq_len), so a table much wider than its sequences leaves splits empty
// (they cost a block and a partial each, and read nothing); the query heads
// of a kv head beyond 4 take more warps and, past 16 warps, shorter chunks
// (H_q/G <= 64); D <= 256.

#include "pa_split.cuh"

// q [B,Hq,D], k/v [G, rows, D] head-major with rows >= NB*BS, out [B,Hq,D],
// all in dtype (0 = bfloat16, 1 = float32, 2 = float16); bt int32 [B,MB], sl
// int32 [B]; splits, per: the split plan; part_acc f32 [B,Hq,splits,D] and
// part_ml f32 [B,Hq,splits,2] scratch (unused with one split). D a multiple
// of 8 up to 256; k and v 16-byte aligned. Returns a cudaError_t code.
extern "C" int pa_headmajor_launch(const void* q, const void* k, const void* v,
                                   const void* bt, const void* sl, void* out, void* part_acc,
                                   void* part_ml, int B, int Hq, int G, int D, int BS, int NB,
                                   int MB, long long rows, int splits, int per, float scale,
                                   int dtype, void* stream) {
  if (!split_args_ok(B, Hq, G, D, BS, NB, MB, splits, per, k, v, part_acc, part_ml) ||
      rows < (long long)NB * BS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long row_stride = D, head_stride = rows * D;
  if (dtype == 0)
    return pa_split_launch<__nv_bfloat16>(q, k, v, bt, sl, out, part_acc, part_ml, B, Hq, G,
                                          1, D, BS, NB, MB, splits, per, row_stride,
                                          head_stride, scale, st);
  if (dtype == 1)
    return pa_split_launch<float>(q, k, v, bt, sl, out, part_acc, part_ml, B, Hq, G, 1, D, BS,
                                  NB, MB, splits, per, row_stride, head_stride, scale, st);
  if (dtype == 2)
    return pa_split_launch<__half>(q, k, v, bt, sl, out, part_acc, part_ml, B, Hq, G, 1, D,
                                   BS, NB, MB, splits, per, row_stride, head_stride, scale,
                                   st);
  return (int)cudaErrorInvalidValue;
}
