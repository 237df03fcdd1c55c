// Kernel B5: paged decode attention over the wide KV view, for Hopper.
//
// Replaces tools/bench_pa_wide.py::wide_kernel (:31), launched there by
// pa_wide (:82) through pl.pallas_call (:119). Same function (pa_split.cuh
// states it): one query token per sequence over the keys at positions
// t*BS + i < seq_lens[b] of the flat paged cache [NB*BS(+1 trash), G, D]
// through block_tables[b]; (q * 1/sqrt(D) in f32) . k with f32 sums; online
// softmax in f32 from m = -1e30; p stays f32; out = acc / max(l, 1e-30) in
// q's dtype (0 for seq_len 0); block ids outside [0, NB) read block 0.
//
// The TPU kernel views one KV block as [BS, G*D] and does QK^T as one wide
// product against a block-diagonal query [H_q, G*D], then PV as one
// [H_q, BS] x [BS, G*D] product folded back per group. The block-diagonal
// zeros are only work here, so each query head dots its own kv head's D
// columns of the wide row: the same sums without the exact zeros. What
// stays is the layout idea: a block reads a cache slot as one contiguous
// G*D row (2 KB in bf16 at G=8, D=128) that serves all H_q query heads.
//
// What bounds it on the H100: bytes. Each valid K/V row is read once: B=8
// sequences at 1023 tokens, G=8, D=128, bf16 move 33.5 MB, 0.0100 ms at
// 3.35 TB/s. The 4*B*H_q*ctx*D = 134 MFLOP take ~2 us on the f32 CUDA cores
// (67 TFLOP/s), so the dot products stay there: a bf16 mma/wgmma would round
// q * 1/sqrt(D) and the f32 probabilities to bf16, and TF32 rounds both too.
//
// Design (the kernel is pa_split.cuh's, with a block over all G kv heads):
//   * Flash-decoding: the grid is (B, 1, splits), so every block reads whole
//     wide rows. The plan (tools/bench_pa_wide.py::wide_split_plan) aims at
//     one wave of one block a SM (132), with at least 64 KB of K+V a split:
//     16 wide keys in bf16, so any whole slot. B=8 at ctx 1024, bs 64 takes
//     16 splits of one slot; (8, 4096) 16 of 4 and (32, 1024) 4 of 4: 128
//     blocks each. Twice the splits, at two blocks a SM of half the warps,
//     are slower where the table allows them (chip_smoke.py phase 8).
//   * A block is G * 2 warps at G=8, H_q/G <= 4: one pair a kv head, each
//     warp 8 of a chunk's 16 keys for the head's query heads. Chunks of 16
//     wide rows (K padded by 16 bytes a row, V not) stream through a 3-stage
//     ring of cp.async copies: 16*2064 + 16*2048 = 65,792 bytes a stage in
//     bf16, 215,808 bytes with q (16 KB in f32) and p: one block (16 warps,
//     512 threads) a SM.
//   * One barrier a chunk; softmax in registers and shuffles; acc in
//     registers; a fixed-order combine kernel over the splits.
// Known limits: the plan comes from the table width MB (the host knows no
// seq_len), so a table much wider than its sequences leaves splits empty
// (they cost a block and a partial each, and read nothing); splits are
// whole slots, so a short table gives few blocks (8 at B=8 over one slot);
// a block carries at most 16 warps, so G * ceil(H_q/G / 4) > 16 splits the
// kv heads over blocks that read part of the wide row; D <= 256.

#include "pa_split.cuh"

// q [B,Hq,D], k/v [>= NB*BS, G, D] (flat paged cache), out [B,Hq,D], all in
// dtype (0 = bfloat16, 1 = float32, 2 = float16); bt int32 [B,MB], sl int32
// [B]; splits, per: the split plan; part_acc f32 [B,Hq,splits,D] and part_ml
// f32 [B,Hq,splits,2] scratch (unused with one split). D a multiple of 8 up
// to 256; k and v 16-byte aligned. Returns a cudaError_t code.
extern "C" int pa_wide_launch(const void* q, const void* k, const void* v, const void* bt,
                              const void* sl, void* out, void* part_acc, void* part_ml, int B,
                              int Hq, int G, int D, int BS, int NB, int MB, int splits,
                              int per, float scale, int dtype, void* stream) {
  if (!split_args_ok(B, Hq, G, D, BS, NB, MB, splits, per, k, v, part_acc, part_ml))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long row_stride = (long long)G * D, head_stride = D;
  if (dtype == 0)
    return pa_split_launch<__nv_bfloat16>(q, k, v, bt, sl, out, part_acc, part_ml, B, Hq, G,
                                          G, D, BS, NB, MB, splits, per, row_stride,
                                          head_stride, scale, st);
  if (dtype == 1)
    return pa_split_launch<float>(q, k, v, bt, sl, out, part_acc, part_ml, B, Hq, G, G, D, BS,
                                  NB, MB, splits, per, row_stride, head_stride, scale, st);
  if (dtype == 2)
    return pa_split_launch<__half>(q, k, v, bt, sl, out, part_acc, part_ml, B, Hq, G, G, D,
                                   BS, NB, MB, splits, per, row_stride, head_stride, scale,
                                   st);
  return (int)cudaErrorInvalidValue;
}
