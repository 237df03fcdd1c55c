"""Port parity: the paged llama forward of blazr_tpu_torch against
blazr_tpu.models.llama_paged.forward_paged on AWQ params carried over with
params_from_jax, in f32 on the CPU, for head_dim 64 and 128 at few heads.

Tolerance 1e-4 on logits of order 1: both sides compute in f32 with the same
weights; the sums run in another order (dequantize-and-dot vs the plain B1,
one-shot vs grouped einsums)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blazr_tpu.config.model_config import AttentionConfig as JAttn
from blazr_tpu.config.model_config import UniversalConfig as JCfg
from blazr_tpu.kvcache import paged as jpaged
from blazr_tpu.models.llama_paged import forward_paged as jax_forward
from blazr_tpu.utils.synthetic import synth_llama_params as jax_synth
from blazr_tpu_torch.config.model_config import AttentionConfig, UniversalConfig
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.kvcache import paged as tpaged
from blazr_tpu_torch.models.llama_paged import forward_paged

CPU = "cpu"
BS = 8


def _cfgs(head_dim, window):
    kw = dict(model_type="mistral", vocab_size=256, hidden_size=2 * head_dim,
              num_layers=2, max_seq_len=128, intermediate_size=256)
    att = dict(num_heads=2, num_kv_heads=1, head_dim=head_dim,
               sliding_window=window)
    return (JCfg(attention=JAttn(**att), **kw),
            UniversalConfig(attention=AttentionConfig(**att), **kw))


def _params(jcfg, seed):
    jp = jax_synth(jcfg, quant="awq", dtype=jnp.float32, group_size=64, seed=seed)
    # Norm weights of ones hide a wrong weight path: perturb them.
    rng = np.random.default_rng(seed)
    for layer in jp["layers"]:
        for k in ("input_norm", "post_norm"):
            layer[k] = jnp.asarray(1 + 0.1 * rng.standard_normal(
                layer[k].shape).astype(np.float32))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device=CPU)


def _run_both(jcfg, tcfg, jp, tp, tokens, positions, tables, seq_lens, slots,
              jc, tc, last_idx=None):
    jl, jc = jax_forward(jp, jcfg, jnp.asarray(tokens), jc, jnp.asarray(positions),
                         jnp.asarray(slots), jnp.asarray(tables),
                         jnp.asarray(seq_lens),
                         last_idx=None if last_idx is None else jnp.asarray(last_idx))
    tl, tc = forward_paged(tp, tcfg, torch.from_numpy(tokens), tc,
                           torch.from_numpy(positions), torch.from_numpy(slots),
                           torch.from_numpy(tables), torch.from_numpy(seq_lens),
                           last_idx=None if last_idx is None
                           else torch.from_numpy(last_idx), device=CPU)
    return np.asarray(jl), tl.numpy(), jc, tc


@pytest.mark.parametrize("head_dim,window", [(64, 6), (64, None), (128, 10)])
def test_prefill_then_decode_matches_jax(head_dim, window):
    """Two sequences of different lengths: batched prefill (padded, with
    last_idx), then 4 decode steps through the decode path (B2's plain
    version on the CPU) — logits match the JAX forward at every step."""
    jcfg, tcfg = _cfgs(head_dim, window)
    jp, tp = _params(jcfg, seed=head_dim + (window or 0))
    rng = np.random.default_rng(1)
    lens = [7, 12]
    blocks = [[3, 0, 5], [1, 6, 2]]
    mb = 4
    tables = np.stack([tpaged.pad_block_table(b, mb) for b in blocks])
    jc = jpaged.init_paged_cache(2, 8, BS, 1, head_dim, dtype=jnp.float32)
    tc = tpaged.init_paged_cache(2, 8, BS, 1, head_dim, dtype=torch.float32,
                                 device=CPU)
    trash = tc.trash_slot
    t = 16
    tokens = np.zeros((2, t), np.int64)
    positions = np.zeros((2, t), np.int64)
    slots = np.full((2, t), trash, np.int64)
    seqs = [rng.integers(0, 256, n) for n in lens]
    for i, (s, n) in enumerate(zip(seqs, lens)):
        tokens[i, :n] = s
        positions[i, :n] = np.arange(n)
        slots[i, :n] = tpaged.compute_slot_mapping(blocks[i], 0, n, BS, trash)
    seq_lens = np.array(lens, np.int32)
    last = np.array([n - 1 for n in lens], np.int64)
    jl, tl, jc, tc = _run_both(jcfg, tcfg, jp, tp, tokens, positions, tables,
                               seq_lens, slots, jc, tc, last_idx=last)
    assert tl.shape == (2, 1, 256)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    for step in range(4):
        nxt = np.argmax(tl[:, -1], axis=-1).astype(np.int64)[:, None]
        pos = (seq_lens.astype(np.int64) + step)[:, None]
        sl = np.stack([tpaged.compute_slot_mapping(blocks[i], int(pos[i, 0]), 1,
                                                   BS, trash) for i in range(2)])
        jl, tl, jc, tc = _run_both(jcfg, tcfg, jp, tp, nxt, pos, tables,
                                   (pos[:, 0] + 1).astype(np.int32),
                                   sl.astype(np.int64), jc, tc)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4,
                                   err_msg=f"decode step {step}")
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=1e-4, atol=1e-4)


def test_incremental_matches_full_prefill():
    """Prefill 6 + 4 single-token steps == one 10-token prefill (the port
    against itself, as test_batch_engine holds the JAX forward)."""
    jcfg, tcfg = _cfgs(64, None)
    _, tp = _params(jcfg, seed=9)
    toks = np.random.default_rng(4).integers(0, 256, (1, 10))
    blocks = [5, 2]
    bt = torch.from_numpy(tpaged.pad_block_table(blocks, 4)[None])

    def fresh():
        return tpaged.init_paged_cache(2, 8, BS, 1, 64, dtype=torch.float32,
                                       device=CPU)

    def step(c, lo, hi):
        pos = torch.arange(lo, hi)[None]
        sl = torch.from_numpy(tpaged.compute_slot_mapping(
            blocks, lo, hi - lo, BS, c.trash_slot)[None].astype(np.int64))
        out, _ = forward_paged(tp, tcfg, torch.from_numpy(toks[:, lo:hi]), c, pos,
                               sl, bt, torch.tensor([hi], dtype=torch.int32),
                               device=CPU)
        return out

    full = step(fresh(), 0, 10)
    c = fresh()
    pieces = [step(c, 0, 6)] + [step(c, t, t + 1) for t in range(6, 10)]
    np.testing.assert_allclose(torch.cat(pieces, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# constants built once per device (no host-to-device copy inside a forward)
# ---------------------------------------------------------------------------

def test_hoisted_embedding_scale_matches_jax():
    """scale_embeddings multiplies by sqrt(hidden) rounded to the dtype, as
    the JAX forward_embed does, from one cached 0-d tensor per device."""
    from blazr_tpu.models.llama import forward_embed as jax_embed
    from blazr_tpu_torch.models.layers import device_scalar
    from blazr_tpu_torch.models.llama import forward_embed

    jcfg, tcfg = _cfgs(64, None)
    jp, tp = _params(jcfg, seed=12)
    jcfg.scale_embeddings = tcfg.scale_embeddings = True
    toks = np.random.default_rng(2).integers(0, 256, (2, 5))
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        tp_d = dict(tp, embed=tp["embed"].to(dtype))
        jp_d = dict(jp, embed=jp["embed"].astype(jdt))
        got = forward_embed(tp_d, tcfg, torch.from_numpy(toks))
        ref = np.asarray(jax_embed(jp_d, jcfg, jnp.asarray(toks)).astype(jnp.float32))
        np.testing.assert_array_equal(got.float().numpy(), ref)
        before = tp_d["embed"][torch.from_numpy(toks)] * torch.tensor(
            tcfg.hidden_size ** 0.5, dtype=dtype)
        assert torch.equal(got, before)
    s = device_scalar(8.0, torch.float32, torch.device(CPU))
    assert s is device_scalar(8.0, torch.float32, torch.device(CPU))


def test_hoisted_alibi_slopes_give_the_forward_of_fresh_ones():
    """ALiBi slopes come from one cached tensor per (heads, device); the
    paged forward over them equals the forward with slopes built per call
    (the code before the hoist) and the JAX forward."""
    import math

    from blazr_tpu_torch.models import layers, llama

    jcfg, tcfg = _cfgs(64, None)
    jcfg.attention.use_alibi = tcfg.attention.use_alibi = True
    jp, tp = _params(jcfg, seed=13)
    assert layers.alibi_slopes(2, torch.device(CPU)) is \
        layers.alibi_slopes(2, torch.device(CPU))

    def fresh_slopes(n_heads, device):
        p = 2 ** math.floor(math.log2(n_heads))
        base = 2.0 ** (-(2.0 ** -(math.log2(p) - 3)))
        slopes = [base ** (i + 1) for i in range(p)]
        if p < n_heads:
            extra = 2.0 ** (-(2.0 ** -(math.log2(2 * p) - 3)))
            slopes += [extra ** (2 * i + 1) for i in range(n_heads - p)]
        return torch.tensor(slopes, dtype=torch.float32, device=device)

    for n in (2, 3, 6, 32):
        assert torch.equal(layers.alibi_slopes(n, torch.device(CPU)),
                           fresh_slopes(n, CPU))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (1, 9))
    pos = np.arange(9)[None]
    blocks = [4, 1]
    tables = tpaged.pad_block_table(blocks, 4)[None]

    def run():
        tc = tpaged.init_paged_cache(2, 8, BS, 1, 64, dtype=torch.float32, device=CPU)
        jc = jpaged.init_paged_cache(2, 8, BS, 1, 64, dtype=jnp.float32)
        slots = tpaged.compute_slot_mapping(blocks, 0, 9, BS, tc.trash_slot)[None]
        outs = []
        for lo, hi in ((0, 8), (8, 9)):       # a prefill, then a decode step
            jl, tl, jc, tc = _run_both(jcfg, tcfg, jp, tp, toks[:, lo:hi], pos[:, lo:hi],
                                       tables, np.array([hi], np.int32),
                                       slots[:, lo:hi].astype(np.int64), jc, tc)
            outs.append((jl, tl))
        return outs

    hoisted = run()
    real = llama.alibi_slopes
    llama.alibi_slopes = fresh_slopes
    try:
        fresh = run()
    finally:
        llama.alibi_slopes = real
    for (jl, tl), (_, tl_fresh) in zip(hoisted, fresh):
        assert np.array_equal(tl, tl_fresh)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
