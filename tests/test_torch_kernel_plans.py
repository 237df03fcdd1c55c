"""The launch plans of kernels B1-B6 (pure Python), and the split-and-
combine rule of B2, B5 and B6 emulated in plain PyTorch on the CPU.

B1, B3 and B4 split K across blocks and B2, B5 and B6 split each sequence's
walk of table slots across blocks; the planners decide how (B3 also its
variant). The emulation follows
``csrc/paged_attention.cu`` step for step in f32: each split runs the online
softmax over its own slots and ends with (m, l, acc), and the splits of a
(sequence, head) combine as sum_z e^{m_z-M} acc_z / max(sum_z e^{m_z-M} l_z,
1e-30). It must equal the unsplit plain version (1e-5 in f32: the same sums
in another order) and JAX's dense reference on the same numpy inputs, for
every split plan, including splits that hold no valid key."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blazr_tpu.attention.paged_attention import \
    paged_attention_reference as jax_reference
from blazr_tpu.kvcache import paged as jpaged
from blazr_tpu_torch.attention.paged_attention import (
    paged_attention_reference, split_plan, split_spans, walk_slots)
from blazr_tpu_torch.quant import int8 as b3
from blazr_tpu_torch.quant.int8 import b3_plan
from blazr_tpu_torch.quant.kernels import (TC_MIN_ROWS, decode_plan, stream_splits, tc_plan,
                                           tensor_core_path)
from blazr_tpu_torch.tools.bench_pa_headmajor import (HEADMAJOR_TARGET_BLOCKS,
                                                      headmajor_split_plan)
from blazr_tpu_torch.tools.bench_pa_wide import (MIN_SPLIT_BYTES, WIDE_TARGET_BLOCKS,
                                                 pa_wide_reference, wide_split_plan)

MISTRAL = {"qkv": (4096, 6144), "o": (4096, 4096), "gateup": (4096, 28672),
           "down": (14336, 4096)}


# ---------------------------------------------------------------------------
# B1's plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan,unit", [(decode_plan, 128), (tc_plan, 64)])
@pytest.mark.parametrize("m", [1, 4, 5, 8, 16, 64, 65, 512, 4096])
@pytest.mark.parametrize("proj", sorted(MISTRAL))
def test_b1_plan_covers_k(plan, unit, m, proj):
    k, n = MISTRAL[proj]
    bm, splits, per = plan(m, k, n)
    assert per % unit == 0 and splits * per >= k and (splits - 1) * per < k
    assert splits <= 16
    if splits > 1:     # the f32 partials move no more bytes than the weight
        assert 8 * m * n * splits <= k * n / 2 or bm == 128


def test_b1_plans_fill_the_card_at_decode():
    """o and down have 32 column tiles: K is split into many blocks."""
    for proj in ("o", "down"):
        k, n = MISTRAL[proj]
        _, splits, _ = decode_plan(1, k, n)
        assert splits == 16
        _, splits, per = tc_plan(8, k, n)
        assert 32 * splits >= 256 and per >= 8 * 64
    assert tc_plan(8, 4096, 28672)[1] == 4             # 224 tiles: 896 blocks
    assert tc_plan(64, 4096, 28672)[1] == 4            # the partials' cap
    assert tc_plan(512, 4096, 28672) == (128, 1, 4096)   # 896 tiles: no split
    assert tc_plan(512, 4096, 4096)[1] == 3                # 128 tiles: 3 splits
    assert tc_plan(64, 4096, 4096)[0] == 64 and tc_plan(65, 4096, 4096)[0] == 128
    assert [decode_plan(m, 4096, 4096)[0] for m in (1, 3, 4, 8, 9, 40)] == \
        [1, 4, 4, 8, 16, 16]


@pytest.mark.parametrize("dtype,m,k,gs,want", [
    (torch.bfloat16, TC_MIN_ROWS, 4096, 128, True),
    (torch.bfloat16, TC_MIN_ROWS - 1, 4096, 128, False),
    (torch.float16, 512, 4096, 128, True),
    (torch.float32, 512, 4096, 128, False),      # f32 x keeps f32 products
    (torch.bfloat16, 512, 416, 32, False),       # 64 must divide K
    (torch.bfloat16, 512, 512, 16, True),        # groups that divide 64
    (torch.bfloat16, 512, 480, 48, False),       # ... or that 64 divides
    (torch.bfloat16, 512, 1024, 256, True),
    (torch.bfloat16, 512, 512, 8, True),         # one group per 8-row chunk
    (torch.bfloat16, 512, 512, 4, False),        # 8-bit groups of 4 split a chunk
    (torch.float16, 64, 512, 4, False),
])
def test_b1_routes_by_rows_dtype_and_group(dtype, m, k, gs, want):
    assert tensor_core_path(dtype, m, k, gs) is want


# ---------------------------------------------------------------------------
# B2's plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,mb,bs,window", [
    (8, 16, 64, 4096), (8, 64, 64, 4096), (32, 16, 64, None), (1, 64, 64, None),
    (8, 2, 64, None), (8, 64, 16, 100), (3, 513, 16, None), (64, 16, 64, None),
    (2, 64, 16, 4096), (16, 128, 64, None), (1, 1, 64, None), (5, 33, 16, 700),
])
def test_b2_split_plan_covers_the_walk(b, mb, bs, window):
    """The grid's split count keeps the blocks within one wave and no split
    shorter than 128 keys at the walk cap; a full-length sequence's spans
    then tile the walk."""
    splits = split_plan(b, 8, mb, bs, window)
    walk = walk_slots(mb, bs, window)
    assert splits >= 1
    if splits > 1:
        assert b * 8 * splits <= 264 and (walk // splits) * bs >= 128
    spans = split_spans(mb * bs, splits, mb, bs, None)
    assert spans[0][0] == 0 and spans[-1][1] == mb
    assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))


def test_b2_split_plan_mistral_points():
    assert split_plan(8, 8, 16, 64, 4096) == 4           # 256 blocks, 256 keys each
    assert split_plan(32, 8, 16, 64, 4096) == 1          # 256 blocks already
    assert split_plan(1, 8, 64, 64, None) == 32          # one sequence of 4096
    assert split_plan(8, 8, 2, 64, None) == 1            # short walks: one split
    assert walk_slots(64, 64, 4096) == 64 and walk_slots(64, 16, 100) == 8
    # The decode graphs' full-width tables (max_blocks_per_seq 64 at 4096
    # tokens, block 64) split a short sequence as its trimmed table does.
    assert split_plan(8, 8, 64, 64, 4096) == 4
    assert split_spans(576, 4, 64, 64, 4096) == split_spans(576, 4, 9, 64, 4096) == \
        [(0, 2), (2, 4), (4, 6), (6, 9)]
    assert split_spans(1024, 4, 64, 64, 4096) == [(0, 4), (4, 8), (8, 12), (12, 16)]


@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("mb", [1, 9, 64, 512])
@pytest.mark.parametrize("window", [None, 100, 700, 4096])
def test_b2_split_spans_cover_exactly_the_valid_slots(bs, mb, window):
    """The host model of each block's span: for every seq_len up to the
    table's keys and every split count, the spans are contiguous, cover
    exactly the slots that hold a valid key (from the first in-window slot
    to the last slot below seq_len, within the walk cap), no split is empty
    while the sequence has keys for it, and each takes 128 keys or more
    unless the walk is shorter than two such runs."""
    min_slots = -(-128 // bs)
    cap = walk_slots(mb, bs, window)
    for seq_len in sorted({0, 1, 2, bs - 1, bs, bs + 1, 127, 128, 129, 288, 289, 575,
                           576, 700, 701, 1023, 1024, 4095, mb * bs - 1, mb * bs}):
        if seq_len > mb * bs:
            continue
        lo = max(seq_len - window, 0) // bs if window else 0
        valid = [t for t in range(cap) if lo + t < -(-seq_len // bs)]
        for splits in (1, 2, 3, 4, 5, 8, 32):
            spans = split_spans(seq_len, splits, mb, bs, window)
            assert len(spans) == splits
            covered = [t for t0, t1 in spans for t in range(t0, t1)]
            assert covered == valid, (seq_len, splits)
            used = [s for s in spans if s[1] > s[0]]
            assert spans[:len(used)] == used       # the empty splits come last
            want = max(1, min(splits, len(valid) // min_slots)) if valid else 0
            assert len(used) == want, (seq_len, splits, spans)
            if len(used) > 1:
                assert min(t1 - t0 for t0, t1 in used) >= min_slots


# ---------------------------------------------------------------------------
# B2's split-and-combine rule
# ---------------------------------------------------------------------------

def split_combine(q, kc, vc, bt, sl, *, block_size, num_blocks, splits, per=None,
                  window=None, k_scale=None, v_scale=None, softcap=None, alibi=None):
    """csrc/paged_attention.cu's function in plain f32 PyTorch: each split
    walks its table slots with an online softmax, then the splits combine.
    ``per`` gives split z the slots [z*per, (z+1)*per); without it each
    split takes its span from the sequence's length (``split_spans``), as
    the kernel does."""
    b_n, h_q, d = q.shape
    h_kv = kc.shape[1]
    hpg = h_q // h_kv
    mb = bt.shape[1]
    bs = block_size
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros((b_n, h_q, d))
    for b in range(b_n):
        seq = int(sl[b])
        lo, walk = 0, mb
        if window:
            lo = max(seq - window, 0) // bs
            walk = min(mb, window // bs + 2)
        stop = -(-seq // bs) - lo
        spans = (split_spans(seq, splits, mb, bs, window) if per is None else
                 [(z * per, min(walk, z * per + per, stop)) for z in range(splits)])
        parts = []
        for t0, t1 in spans:
            m = torch.full((h_q,), -1e30)
            l = torch.zeros(h_q)
            acc = torch.zeros((h_q, d))
            for t in range(t0, t1):
                tt = lo + t
                blk = int(bt[b, min(tt, mb - 1)])
                blk = blk if 0 <= blk < num_blocks else 0
                slots = blk * bs + torch.arange(bs)
                pos = tt * bs + torch.arange(bs)
                k = kc[slots].float().repeat_interleave(hpg, dim=1)     # [BS, Hq, D]
                v = vc[slots].float().repeat_interleave(hpg, dim=1)
                logits = torch.einsum("hd,shd->hs", q[b].float(), k) * scale
                if k_scale is not None:
                    logits = logits * k_scale[slots].repeat_interleave(hpg, dim=1).T
                if softcap:
                    logits = torch.tanh(logits / softcap) * softcap
                if alibi is not None:
                    logits = logits + alibi[:, None] * (pos - (seq - 1)).float()[None]
                valid = pos < seq
                if window:
                    valid &= pos > seq - 1 - window
                logits = torch.where(valid[None], logits, torch.tensor(-1e30))
                m_new = torch.maximum(m, logits.max(-1).values)
                p = torch.where(valid[None], torch.exp(logits - m_new[:, None]),
                                torch.tensor(0.0))
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                if v_scale is not None:
                    p = p * v_scale[slots].repeat_interleave(hpg, dim=1).T
                acc = acc * alpha[:, None] + torch.einsum("hs,shd->hd", p, v)
                m = m_new
            parts.append((m, l, acc))
        big = torch.stack([p[0] for p in parts]).max(0).values
        w = [torch.exp(m - big) for m, _, _ in parts]
        denom = sum(wz * lz for wz, (_, lz, _) in zip(w, parts))
        num = sum(wz[:, None] * az for wz, (_, _, az) in zip(w, parts))
        out[b] = num / torch.clamp(denom, min=1e-30)[:, None]
    return out


def _inputs(seed, *, seq_lens, bs=8, mb=8, h_q=8, h_kv=2, d=64, int8=False):
    rng = np.random.default_rng(seed)
    b = len(seq_lens)
    nb = b * mb + 2
    shape = (nb * bs + 1, h_kv, d)
    if int8:
        kc = rng.integers(-127, 128, shape).astype(np.int8)
        vc = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, shape[:2]).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, shape[:2]).astype(np.float32)
    else:
        kc = rng.standard_normal(shape).astype(np.float32)
        vc = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    q = rng.standard_normal((b, h_q, d)).astype(np.float32)
    bt = rng.permutation(nb)[: b * mb].reshape(b, mb).astype(np.int32)
    bt[-1, -1] = jpaged.PAD_BLOCK                      # a padded table entry
    sl = np.asarray(seq_lens, dtype=np.int32)
    return dict(q=q, kc=kc, vc=vc, ks=ks, vs=vs, bt=bt, sl=sl, bs=bs, nb=nb)


# (seq_lens, block size, table width, window, split plans (splits, per))
_SPLIT_CASES = {
    # seq_len 1; exactly at a split edge (16 = 2 slots of 8) and one past it
    "edges": ([1, 16, 17, 33], 8, 8, None, [(1, 8), (4, 2), (8, 1), (3, 3)]),
    # a window that starts inside a split; whole splits empty under it
    "window_inside": ([61, 40, 9, 64], 8, 8, 20, [(1, 4), (2, 2), (4, 1)]),
    # short sequences in a long table: most splits hold no valid key
    "mostly_empty": ([3, 1, 12, 64], 8, 8, None, [(8, 1), (2, 4)]),
    # one sequence over many slots (as B=1 at 4096 tokens, cut to size)
    "one_long": ([256], 16, 16, None, [(16, 1), (4, 4), (1, 16)]),
}


@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_split_combine_matches_unsplit_and_jax(case):
    seq_lens, bs, mb, window, plans = _SPLIT_CASES[case]
    s = _inputs(sorted(_SPLIT_CASES).index(case), seq_lens=seq_lens, bs=bs, mb=mb)
    t = {k: torch.from_numpy(s[k]) for k in ("q", "kc", "vc", "bt", "sl")}
    ref = paged_attention_reference(t["q"], t["kc"], t["vc"], t["bt"], t["sl"],
                                    block_size=bs, sliding_window=window)
    jref = np.asarray(jax_reference(jnp.asarray(s["q"]), jnp.asarray(s["kc"]),
                                    jnp.asarray(s["vc"]), jnp.asarray(s["bt"]),
                                    jnp.asarray(s["sl"]), block_size=bs,
                                    sliding_window=window))
    for splits, per in plans:
        got = split_combine(t["q"], t["kc"], t["vc"], t["bt"], t["sl"], block_size=bs,
                            num_blocks=s["nb"], splits=splits, per=per, window=window)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), jref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 150])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_combine_with_device_spans_matches_unsplit(window, splits):
    """The spans each block derives from seq_len, over a table far wider than
    the sequences (the decode graphs' tables): equal to the unsplit plain
    version, with seq_len 1, short rows, rows over several 128-key runs and
    a row of no key (0)."""
    s = _inputs(21 + splits, seq_lens=[0, 1, 9, 200, 300], mb=64)
    t = {k: torch.from_numpy(s[k]) for k in ("q", "kc", "vc", "bt", "sl")}
    ref = paged_attention_reference(t["q"], t["kc"], t["vc"], t["bt"], t["sl"],
                                    block_size=8, sliding_window=window)
    got = split_combine(t["q"], t["kc"], t["vc"], t["bt"], t["sl"], block_size=8,
                        num_blocks=s["nb"], splits=splits, window=window)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(got[1:].numpy(), ref[1:].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opts", ["int8", "softcap_alibi"])
def test_split_combine_with_scales_softcap_alibi(opts):
    s = _inputs(11, seq_lens=[1, 30, 17, 64], int8=opts == "int8")
    t = {k: (None if s[k] is None else torch.from_numpy(s[k]))
         for k in ("q", "kc", "vc", "ks", "vs", "bt", "sl")}
    kw = dict(k_scale=t["ks"], v_scale=t["vs"])
    if opts == "softcap_alibi":
        kw = dict(softcap=20.0, alibi=torch.tensor([2.0 ** -(i + 1) for i in range(8)]))
    ref = paged_attention_reference(
        t["q"], t["kc"], t["vc"], t["bt"], t["sl"], block_size=8, k_scale=t["ks"],
        v_scale=t["vs"], logit_softcap=kw.get("softcap"), alibi=kw.get("alibi"))
    for splits, per in ((1, 8), (4, 2), (8, 1)):
        got = split_combine(t["q"], t["kc"], t["vc"], t["bt"], t["sl"], block_size=8,
                            num_blocks=s["nb"], splits=splits, per=per, **kw)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_split_combine_all_empty_gives_zero():
    """A row whose every split is empty (m = -1e30, l = 0 in each) combines
    to 0 without NaN: every weight is exp(0) = 1 and every acc is 0."""
    s = _inputs(5, seq_lens=[0, 20])
    t = {k: torch.from_numpy(s[k]) for k in ("q", "kc", "vc", "bt", "sl")}
    got = split_combine(t["q"], t["kc"], t["vc"], t["bt"], t["sl"], block_size=8,
                        num_blocks=s["nb"], splits=4, per=2)
    assert torch.isfinite(got).all() and torch.equal(got[0], torch.zeros_like(got[0]))
    ref = paged_attention_reference(t["q"], t["kc"], t["vc"], t["bt"], t["sl"],
                                    block_size=8)
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# B5's and B6's plans (G=8 kv heads of D=128, bf16 unless stated)
# ---------------------------------------------------------------------------

# layout: (plan, blocks of one split, bytes of K+V a key, target)
_LAYOUTS = {
    "wide": (wide_split_plan, lambda b, g: b, lambda g, d, i: 2 * g * d * i,
             WIDE_TARGET_BLOCKS),
    "headmajor": (headmajor_split_plan, lambda b, g: b * g, lambda g, d, i: 2 * d * i,
                  HEADMAJOR_TARGET_BLOCKS),
}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("bs", [64, 128])
@pytest.mark.parametrize("mb", [1, 2, 3, 8, 16, 17, 32, 63, 64])
def test_layout_split_plan_covers_the_walk_within_the_target(layout, b, bs, mb):
    """The splits cover the table exactly (the last one non-empty), every
    split reads at least MIN_SPLIT_BYTES of K+V when there are several, and
    the blocks stay within one wave's target."""
    plan, units, key_bytes, target = _LAYOUTS[layout]
    splits, per = plan(b, 8, mb, bs, 128, 2)
    assert splits * per >= mb and (splits - 1) * per < mb
    if splits > 1:
        assert units(b, 8) * splits <= target
        assert per * bs * key_bytes(8, 128, 2) >= MIN_SPLIT_BYTES


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("bs,mb,itemsize", [(64, 1, 2), (128, 1, 2), (8, 3, 2), (2, 7, 4)])
def test_layout_split_plan_keeps_short_walks_whole(layout, bs, mb, itemsize):
    """One table slot, or a walk shorter than two splits' byte floor, takes
    one split."""
    plan, _, key_bytes, _ = _LAYOUTS[layout]
    assert mb == 1 or mb * bs * key_bytes(8, 128, itemsize) < 2 * MIN_SPLIT_BYTES
    assert plan(8, 8, mb, bs, 128, itemsize) == (1, mb)


def test_wide_plan_byte_floor_and_tool_points():
    """B5's floor is in bytes: a wide key of 8 kv heads is 4 KB of K+V in
    bf16, so a split may be one slot of 16 keys; B6's key is 512 bytes, so
    its splits are 128 keys at least. The points of the tools' sweep and of
    B2's timing shapes."""
    assert wide_split_plan(8, 8, 16, 64) == (16, 1)        # 128 blocks, one slot each
    assert wide_split_plan(8, 8, 64, 64) == (16, 4)        # 128 blocks
    assert wide_split_plan(32, 8, 16, 64) == (4, 4)        # 128 blocks
    assert wide_split_plan(1, 8, 64, 16) == (64, 1)        # 16 keys = 64 KB a split
    assert wide_split_plan(1, 8, 64, 16, 128, 4) == (64, 1)
    assert wide_split_plan(1, 2, 64, 16) == (16, 4)         # 2 kv heads: 4 slots a split
    assert headmajor_split_plan(8, 8, 16, 64) == (8, 2)    # 512 blocks, 128 keys each
    assert headmajor_split_plan(8, 8, 64, 64) == (8, 8)
    assert headmajor_split_plan(32, 8, 16, 64) == (2, 8)
    assert headmajor_split_plan(1, 8, 64, 64) == (32, 2)
    assert headmajor_split_plan(8, 8, 16, 64, 128, 4) == (8, 2)   # f32: 64 keys of 1 KB


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("case", ["ragged", "wide_table"])
def test_layout_plans_through_the_combine_equal_the_plain_version(layout, case):
    """B5's and B6's function is B2's with f32 probabilities and no
    options, so the f32 emulation of the split-and-combine rule, run with
    each layout's own plan, equals the plain version; a sequence with
    seq_len 0 gives exact zeros (the TPU kernels' result; the plain version
    gives the uniform mean there)."""
    plan = _LAYOUTS[layout][0]
    bs, mb = (8, 8) if case == "ragged" else (8, 32)
    lens = [1, 16, 17, 64, 0, 33] if case == "ragged" else [0, 3, 20, 9, 0, 1]
    s = _inputs(29, seq_lens=lens, bs=bs, mb=mb, h_q=8, h_kv=2, d=64)
    t = {k: torch.from_numpy(s[k]) for k in ("q", "kc", "vc", "bt", "sl")}
    splits, per = plan(len(lens), 2, mb, bs, 64, 4)
    if case == "wide_table":
        splits, per = mb, 1                                 # most splits empty
    got = split_combine(t["q"], t["kc"], t["vc"], t["bt"], t["sl"], block_size=bs,
                        num_blocks=s["nb"], splits=splits, per=per)
    ref = pa_wide_reference(t["q"], t["kc"], t["vc"], t["bt"], t["sl"], block_size=bs)
    empty = t["sl"] == 0
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))
    np.testing.assert_allclose(got[~empty].numpy(), ref[~empty].numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# B3's and B4's plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("m", [1, 5, 8, 9, 16, 17, 32, 33, 64, 65, 512, 4096])
@pytest.mark.parametrize("proj", sorted(MISTRAL))
def test_b3_plan_covers_k(proj, m, gs):
    """Every split is a whole number of lcm(group, 128) K rows (a ring stage
    never holds two splits, a group never spans two) and the splits cover K
    exactly; the variant and its tile follow the row count."""
    k, n = MISTRAL[proj]
    variant, rows, splits, per = b3_plan(m, k, n, gs, 8)
    assert per % math.lcm(gs, 128) == 0 and splits <= 16
    assert splits * per >= k and (splits - 1) * per < k
    if m > b3.DEC_MAX_ROWS and gs % 128 == 0:
        assert (variant, rows) == ("wgmma", 64 if m <= 64 else 128)
        assert splits == 1 or per >= 4 * 128                # a split: at least 4 stages
    else:
        assert (variant, rows) == ("mma", 8 if m <= 8 else 16 if m <= 16 else 32)


@pytest.mark.parametrize("gs,variant", [(16, "mma"), (48, "mma"), (96, "mma"), (32, "mma"),
                                        (64, "mma"), (128, "wgmma"), (256, "wgmma"),
                                        (512, "wgmma")])
def test_b3_variant_by_group(gs, variant):
    """wgmma folds groups at the ends of its 128-row stages: groups that are
    a multiple of 128 (and K too); every other group takes the decode
    variant at every row count, tiled over M. A wgmma split holds whole
    groups, an odd number of stages included."""
    assert b3.wgmma_takes(3072, gs) is (variant == "wgmma")
    assert b3_plan(512, 3072, 256, gs, 4)[0] == variant
    assert b3_plan(1, 3072, 256, gs, 4)[0] == "mma"
    assert b3_plan(512, 3136, 256, 64, 4)[0] == "mma"             # K % 128 != 0
    if variant == "wgmma":
        assert b3.wgmma_plan(64, 3072, 256, gs)[2] % gs == 0
    assert b3.wgmma_plan(64, 3200, 128, 128)[1:] == (5, 640)      # 25 stages, 5 a split


@pytest.mark.parametrize("m", [1, 8, 16, 32])
@pytest.mark.parametrize("proj", sorted(MISTRAL))
def test_b3_plan_fills_the_card_at_decode(proj, m):
    """At decode rows the column tiles times the K splits give at least 256
    blocks, unless the tiles alone fill a wave of the H100's 132 SMs (then K
    is not split) or the partials' byte cap stops it."""
    k, n = MISTRAL[proj]
    _, rows, splits, per = b3_plan(m, k, n, 128, 8)
    tiles = -(-m // rows) * (n // 128)
    cap = max(1, k * 8 // (64 * m))
    if tiles >= 132:
        assert splits == 1
    else:
        assert tiles * splits >= 256 or splits == min(16, cap, -(-k // 128))
    if splits > 1:             # the f32 partials move no more bytes than the weight
        assert 8 * m * n * splits <= k * n


def test_b3_plan_mistral_points():
    assert b3_plan(512, 4096, 28672, 128, 8) == ("wgmma", 128, 1, 4096)   # 896 tiles
    assert b3_plan(4096, 14336, 4096, 128, 8)[2] == 1
    assert b3_plan(1, 4096, 4096, 128, 8) == ("mma", 8, 8, 512)            # 32 tiles
    assert b3_plan(1, 4096, 28672, 128, 8) == ("mma", 8, 1, 4096)          # 224 tiles
    assert b3_plan(64, 4096, 4096, 128, 8)[:2] == ("wgmma", 64)


@pytest.mark.parametrize("gs", [4, 8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("proj", sorted(MISTRAL))
def test_b4_split_plan_covers_k_and_fills_the_card(proj, gs):
    k, n = MISTRAL[proj]
    splits, per = stream_splits(k, n, gs)
    unit = max(128, gs)
    assert per % unit == 0 and per % gs == 0 and splits <= 16
    assert splits * per >= k and (splits - 1) * per < k
    assert (n // 128) * splits >= 896 or per // unit == -(-(k // unit) // 16)   # capped at 16
