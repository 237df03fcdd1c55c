"""Port parity: paged decode attention (B2's plain version) of
blazr_tpu_torch against the JAX Pallas kernel B2 in interpret mode, over the
case grid of test_paged_attention_kernel.py, plus the paged KV cache
helpers. f32 throughout; 2e-5 is the tolerance the JAX suite holds its own
kernel to against its reference (online vs one-shot softmax)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blazr_tpu.attention.paged_attention import paged_attention_decode as jax_pa
from blazr_tpu.kvcache import paged as jpaged
from blazr_tpu.models.layers import alibi_slopes as jax_alibi
from blazr_tpu_torch.attention.paged_attention import (
    paged_attention_decode, paged_attention_reference)
from blazr_tpu_torch.kvcache import paged as tpaged

CPU = "cpu"


def _setup(seed, h_q=8, h_kv=2, d=128, nb=16, bs=8, mb=6, int8=False):
    rng = np.random.default_rng(seed)
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
    q = rng.standard_normal((2, h_q, d)).astype(np.float32)
    tables = np.stack([jpaged.pad_block_table([3, 7, 1], mb),
                       jpaged.pad_block_table([5, 2, 9, 11], mb)])
    seq_lens = np.array([19, 26], dtype=np.int32) * (bs // 8)
    return dict(q=q, kc=kc, vc=vc, ks=ks, vs=vs, bt=tables, sl=seq_lens,
                bs=bs, nb=nb)


_CASES = {
    "plain": ({}, {}),
    "gqa_2_per_group": (dict(h_kv=4), {}),
    "window_8": ({}, dict(sliding_window=8)),
    "window_12": ({}, dict(sliding_window=12)),
    "window_16": ({}, dict(sliding_window=16)),
    "window_64": ({}, dict(sliding_window=64)),
    "softcap": ({}, dict(logit_softcap=30.0)),
    "alibi": ({}, dict(alibi=True)),
    "window_softcap": ({}, dict(sliding_window=10, logit_softcap=20.0)),
    "int8": (dict(int8=True), {}),
    "int8_window_softcap": (dict(int8=True), dict(sliding_window=12,
                                                  logit_softcap=30.0)),
    "head_dim_64": (dict(d=64), {}),
    "head_dim_64_window": (dict(d=64), dict(sliding_window=12)),
    "block_16": (dict(bs=16, nb=12), dict(sliding_window=20)),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_matches_jax_kernel_interpret(case):
    setup_kw, kw = _CASES[case]
    s = _setup(sorted(_CASES).index(case), **setup_kw)
    alibi = None
    if kw.pop("alibi", False):
        alibi = np.asarray(jax_alibi(s["q"].shape[1])) * s["q"].shape[2] ** -0.5
    jkw = dict(kw, alibi=alibi)
    if s["ks"] is not None:
        jkw.update(k_scale=jnp.asarray(s["ks"]), v_scale=jnp.asarray(s["vs"]))
    ref = np.asarray(jax_pa(jnp.asarray(s["q"]), jnp.asarray(s["kc"]),
                            jnp.asarray(s["vc"]), jnp.asarray(s["bt"]),
                            jnp.asarray(s["sl"]), block_size=s["bs"],
                            num_blocks=s["nb"], interpret=True, **jkw))
    t = {k: (None if s[k] is None else torch.from_numpy(s[k]))
         for k in ("q", "kc", "vc", "ks", "vs", "bt", "sl")}
    got = paged_attention_decode(
        t["q"], t["kc"], t["vc"], t["bt"], t["sl"], block_size=s["bs"],
        num_blocks=s["nb"], k_scale=t["ks"], v_scale=t["vs"],
        alibi=None if alibi is None else torch.from_numpy(alibi),
        device=CPU, **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_empty_row_stays_finite():
    """A row with no valid key (seq_len 0) stays finite in the plain version
    (uniform weights over masked keys, as the JAX reference gives); kernel
    B2 gives 0 there (denom = max(l, 1e-30)), so the card tests keep
    seq_len >= 1."""
    s = _setup(3)
    sl = torch.tensor([0, 26], dtype=torch.int32)
    got = paged_attention_reference(
        torch.from_numpy(s["q"]), torch.from_numpy(s["kc"]),
        torch.from_numpy(s["vc"]), torch.from_numpy(s["bt"]), sl, block_size=8)
    assert torch.isfinite(got).all()


def test_page_helpers_match_jax():
    bt = np.stack([jpaged.pad_block_table([3, 7], 4),
                   jpaged.pad_block_table([1], 4)])
    np.testing.assert_array_equal(tpaged.pad_block_table([3, 7], 4), bt[0])
    np.testing.assert_array_equal(
        tpaged.page_slot_index(8, torch.from_numpy(bt)).numpy(),
        np.asarray(jpaged.page_slot_index(8, jnp.asarray(bt))))
    for start, n in [(0, 5), (6, 11), (15, 1)]:
        np.testing.assert_array_equal(
            tpaged.compute_slot_mapping([3, 7, 1], start, n, 8, 99, pad_to=12),
            jpaged.compute_slot_mapping([3, 7, 1], start, n, 8, 99, pad_to=12))


@pytest.mark.parametrize("quantized", [False, True])
def test_write_paged_layer_matches_jax(quantized):
    """In-place writes land where the JAX scatter lands; int8 quantization
    is bit-equal (same absmax scale, same round-half-even)."""
    rng = np.random.default_rng(7)
    k_new = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    v_new = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    slots = np.array([[4, 5, 6], [17, 18, 32]], dtype=np.int32)   # 32 = trash
    jc = jpaged.init_paged_cache(2, 4, 8, 2, 16, dtype=jnp.float32,
                                 quantized=quantized)
    jc = jpaged.write_paged_layer(jc, 1, jnp.asarray(k_new), jnp.asarray(v_new),
                                  jnp.asarray(slots))
    tc = tpaged.init_paged_cache(2, 4, 8, 2, 16, dtype=torch.float32,
                                 quantized=quantized, device=CPU)
    out = tpaged.write_paged_layer(tc, 1, torch.from_numpy(k_new),
                                   torch.from_numpy(v_new), torch.from_numpy(slots))
    assert out is tc                                   # written in place
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    if quantized:
        np.testing.assert_array_equal(tc.k_scale.numpy(), np.asarray(jc.k_scale))
        np.testing.assert_array_equal(tc.v_scale.numpy(), np.asarray(jc.v_scale))


def test_wrapper_rejects_mismatched_cache():
    s = _setup(4)
    with pytest.raises(ValueError):
        paged_attention_decode(
            torch.from_numpy(s["q"][:, :, :64].copy()), torch.from_numpy(s["kc"]),
            torch.from_numpy(s["vc"]), torch.from_numpy(s["bt"]),
            torch.from_numpy(s["sl"]), block_size=8, num_blocks=16, device=CPU)


@pytest.mark.parametrize("case", ["plain", "window_12", "int8", "softcap"])
def test_plain_f16_matches_jax_kernel_interpret(case):
    """f16 queries and caches (the AWQ/GPTQ loader default): the JAX kernel
    computes in f16 with f32 sums and rounds the probabilities to f16; the
    plain version keeps them in f32 and rounds only the output. 3e-3 covers
    both f16 roundings (2^-11 relative each) on outputs of order max|v|."""
    setup_kw, kw = _CASES[case]
    s = _setup(40 + sorted(_CASES).index(case), **setup_kw)
    f16 = {k: (s[k] if s[k] is None or s[k].dtype != np.float32 or k in ("ks", "vs")
               else s[k].astype(np.float16)) for k in ("q", "kc", "vc", "ks", "vs")}
    jkw = dict(kw)
    if f16["ks"] is not None:
        jkw.update(k_scale=jnp.asarray(f16["ks"]), v_scale=jnp.asarray(f16["vs"]))
    ref = np.asarray(jax_pa(jnp.asarray(f16["q"]), jnp.asarray(f16["kc"]),
                            jnp.asarray(f16["vc"]), jnp.asarray(s["bt"]),
                            jnp.asarray(s["sl"]), block_size=s["bs"],
                            num_blocks=s["nb"], interpret=True, **jkw))
    assert ref.dtype == np.float16
    t = {k: (None if v is None else torch.from_numpy(v)) for k, v in f16.items()}
    got = paged_attention_decode(
        t["q"], t["kc"], t["vc"], torch.from_numpy(s["bt"]), torch.from_numpy(s["sl"]),
        block_size=s["bs"], num_blocks=s["nb"], k_scale=t["ks"], v_scale=t["vs"],
        device=CPU, **kw)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), ref.astype(np.float32),
                               rtol=0, atol=3e-3)
