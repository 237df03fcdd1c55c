"""Port parity: the host-RAM tier of blazr_tpu_torch's prefix cache against
blazr_tpu's (``tests/test_host_tier.py``'s cases) on the CPU.

Evicted computed blocks are saved host-side and restored into the blocks a
later lookup allocates. The port restores IN PLACE: the cache's tensors
keep their storage (``data_ptr``), which the decode graphs hold. Restored
bytes are exact, float and int8 (scale planes included); the same calls on
the JAX and the port tiers give the same block ids, cached counts, stats
and cache contents; and a BatchEngine whose prefixes go to the host tier
and come back gives the JAX engine's greedy streams and counts."""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.kvcache.block_allocator import BlockAllocator as JAlloc
from blazr_tpu.kvcache.host_tier import attach_host_tier as jax_attach
from blazr_tpu.kvcache.paged import init_paged_cache as jax_init_cache
from blazr_tpu.kvcache.prefix_cache import PrefixCache as JPrefix
from blazr_tpu.utils.synthetic import synth_llama_params as jax_synth
from blazr_tpu.utils.synthetic import synth_model, tiny_llama_config as jax_tiny
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.kvcache.block_allocator import BlockAllocator
from blazr_tpu_torch.kvcache.host_tier import HostKVTier, attach_host_tier
from blazr_tpu_torch.kvcache.paged import init_paged_cache
from blazr_tpu_torch.kvcache.prefix_cache import PrefixCache
from blazr_tpu_torch.models.registry import Model
from blazr_tpu_torch.utils.synthetic import tiny_llama_config

CPU = "cpu"


def _ptrs(cache) -> list:
    return [t.data_ptr() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)
            if t is not None]


def test_host_tier_lru():
    k = torch.zeros((1, 4, 2, 8))
    t = HostKVTier(max_blocks=2, block_planes=[k, k])
    t.save(b"a", k, k)
    t.save(b"b", k, k)
    t.save(b"c", k, k)           # evicts a
    assert b"a" not in t and b"b" in t and b"c" in t
    assert t.stats.dropped == 1
    t.save(b"b", k, k)           # already held: refreshed, not saved again
    assert t.stats.saved == 3 and len(t) == 2
    assert t.take(b"b") is not None
    assert t.take(b"b") is None
    assert t.stats.restored == 1


def test_host_tier_pool_is_allocated_once_and_reused():
    """Saves copy into slots of the pool made at construction: the pool's
    storage never changes, an LRU drop or a take frees a slot that the next
    save fills, and a taken entry reads back the bytes saved."""
    rng = np.random.default_rng(3)
    k0 = torch.zeros((2, 4, 2, 8))
    s0 = torch.zeros((2, 4, 2))
    t = HostKVTier(max_blocks=3, block_planes=[k0, k0, s0, s0])
    pool = [p.data_ptr() for p in t._pool]
    assert t.pool_bytes == 3 * 4 * (2 * k0.numel() + 2 * s0.numel())
    saved = {}
    for i in range(8):
        arrays = [torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32))
                  for a in (k0, k0, s0, s0)]
        h = bytes([i])
        t.save(h, *arrays)
        saved[h] = [a.clone() for a in arrays]
        for a in arrays:
            a.zero_()                               # the tier holds its own copy
        if i % 3 == 2:
            got = t.take(bytes([i - 1]))
            assert all(torch.equal(g, w) for g, w in zip(got, saved[bytes([i - 1])]))
        assert len(t) + len(t._free) == 3
    assert [p.data_ptr() for p in t._pool] == pool
    assert (t.stats.saved, t.stats.restored) == (8, 2)
    assert t.stats.dropped == 8 - 2 - len(t)


def test_host_tier_capped_by_bytes():
    """attach_host_tier sizes the pool by max_blocks and max_bytes, the
    smaller of the two (at least one slot)."""
    cache = init_paged_cache(num_layers=2, num_blocks=8, block_size=4, kv_heads=2,
                             head_dim=8, dtype=torch.float32, device=CPU)
    block = 2 * 2 * 4 * 2 * 8 * 4                   # k and v, f32
    pc = PrefixCache(BlockAllocator(8, 4))
    assert attach_host_tier(pc, cache, max_blocks=50, max_bytes=10 * block).max_blocks == 10
    assert attach_host_tier(pc, cache, max_blocks=6, max_bytes=10 * block).max_blocks == 6
    assert attach_host_tier(pc, cache, max_blocks=6, max_bytes=block // 2).max_blocks == 1
    tier = attach_host_tier(pc, cache, max_blocks=6)
    assert tier.pool_bytes == 6 * block and pc.host_tier is tier


def test_two_tier_restore_roundtrip_in_place():
    """Evicted block contents come back exactly, into the same tensors,
    with the cached-token count credited (a whole-prompt hit capped)."""
    bs = 4
    alloc = BlockAllocator(8, bs)
    pc = PrefixCache(alloc)
    cache = init_paged_cache(num_layers=2, num_blocks=8, block_size=bs, kv_heads=2,
                             head_dim=8, dtype=torch.float32, device=CPU)
    ptrs = _ptrs(cache)
    tier = attach_host_tier(pc, cache, max_blocks=16)
    tokens = [1, 2, 3, 4, 5, 6, 7, 8]           # 2 full blocks
    cached, blocks = pc.get_or_allocate_blocks(1, tokens)
    assert cached == 0
    for blk in blocks:                          # recognisable KV (a prefill)
        cache.k[:, blk * bs:(blk + 1) * bs] = float(blk + 1)
        cache.v[:, blk * bs:(blk + 1) * bs] = -float(blk + 1)
    want = {i: (cache.k[:, b * bs:(b + 1) * bs].clone(), cache.v[:, b * bs:(b + 1) * bs].clone())
            for i, b in enumerate(blocks)}
    pc.mark_computed(1, len(tokens))
    pc.release_blocks(1)
    while pc.stats.cached_blocks:
        pc._evict_one()
    assert tier.stats.saved == 2 and alloc.free_blocks == 8
    cache.k.zero_()
    cache.v.zero_()
    cached2, blocks2 = pc.get_or_allocate_blocks(2, tokens)
    assert cached2 == len(tokens) - 1
    assert tier.stats.restored == 2
    for i, blk in enumerate(blocks2):
        assert torch.equal(cache.k[:, blk * bs:(blk + 1) * bs], want[i][0])
        assert torch.equal(cache.v[:, blk * bs:(blk + 1) * bs], want[i][1])
    assert _ptrs(cache) == ptrs
    assert sorted(pc._computed) == sorted(blocks2) and not pc._pending.get(2)


def test_two_tier_restore_int8_scales():
    """int8 cache: the scale planes travel with the block."""
    bs = 4
    alloc = BlockAllocator(8, bs)
    pc = PrefixCache(alloc)
    cache = init_paged_cache(num_layers=1, num_blocks=8, block_size=bs, kv_heads=2,
                             head_dim=8, quantized=True, device=CPU)
    ptrs = _ptrs(cache)
    tier = attach_host_tier(pc, cache, max_blocks=16)
    tokens = [1, 2, 3, 4]
    _, blocks = pc.get_or_allocate_blocks(1, tokens)
    blk = blocks[0]
    cache.k[:, blk * bs:(blk + 1) * bs] = 42
    cache.v[:, blk * bs:(blk + 1) * bs] = -7
    cache.k_scale[:, blk * bs:(blk + 1) * bs] = 0.5
    cache.v_scale[:, blk * bs:(blk + 1) * bs] = 0.25
    pc.mark_computed(1, len(tokens))
    pc.release_blocks(1)
    while pc.stats.cached_blocks:
        pc._evict_one()
    for t in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        t.zero_()                               # restoration must carry them back
    _, blocks2 = pc.get_or_allocate_blocks(2, tokens)
    assert tier.stats.restored == 1
    b2 = blocks2[0]
    sl = slice(b2 * bs, (b2 + 1) * bs)
    assert (cache.k[:, sl] == 42).all() and (cache.v[:, sl] == -7).all()
    assert (cache.k_scale[:, sl] == 0.5).all() and (cache.v_scale[:, sl] == 0.25).all()
    assert _ptrs(cache) == ptrs


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_evictions_and_restores_match_jax(seed, quantized):
    """Six prompts over three shared prefixes, drawn again and again,
    through a 7-block pool (one sequence at most held over to the next
    call): each prefill writes seeded KV into its new blocks (the same
    bytes on both sides); block ids, cached counts, stats and every cache
    plane equal the JAX tier's after each call."""
    bs, nb, L, H, D = 4, 7, 2, 2, 8
    rng = np.random.default_rng(seed)
    jalloc, talloc = JAlloc(nb, bs), BlockAllocator(nb, bs)
    jpc, tpc = JPrefix(jalloc), PrefixCache(talloc)
    jc = {"c": jax_init_cache(num_layers=L, num_blocks=nb, block_size=bs, kv_heads=H,
                              head_dim=D, dtype=jnp.float32, quantized=quantized)}
    tc = init_paged_cache(num_layers=L, num_blocks=nb, block_size=bs, kv_heads=H,
                          head_dim=D, dtype=torch.float32, quantized=quantized, device=CPU)
    ptrs = _ptrs(tc)
    jtier = jax_attach(jpc, lambda: jc["c"], max_blocks=6)
    ttier = attach_host_tier(tpc, tc, max_blocks=6)
    names = ["k", "v"] + (["k_scale", "v_scale"] if quantized else [])
    prefixes = [rng.integers(0, 30, 12).tolist() for _ in range(3)]
    prompts = [prefixes[i % 3][:rng.integers(4, 13)] + rng.integers(0, 30, 2).tolist()
               for i in range(6)]
    held = None
    for sid in range(1, 41):
        toks = prompts[rng.integers(0, len(prompts))]
        try:
            jres = jpc.get_or_allocate_blocks(sid, toks)
        except MemoryError:
            jres = None
        try:
            tres = tpc.get_or_allocate_blocks(sid, toks)
        except MemoryError:
            tres = None
        assert tres == jres
        if tres is None:
            continue
        cached, blocks = tres
        for b in blocks[cached // bs:]:                 # the prefill's writes
            for name in names:
                shape = (L, bs, H, D) if name in ("k", "v") else (L, bs, H)
                data = rng.integers(-100, 100, shape)
                data = (data.astype(np.int8) if quantized and name in ("k", "v")
                        else (data / 7).astype(np.float32))
                sl = slice(b * bs, (b + 1) * bs)
                arr = getattr(jc["c"], name)
                setattr(jc["c"], name, arr.at[:, sl].set(jnp.asarray(data)))
                getattr(tc, name)[:, sl] = torch.from_numpy(data)
        jpc.mark_computed(sid, len(toks))
        tpc.mark_computed(sid, len(toks))
        if held is not None:                            # one sequence at most held
            jpc.release_blocks(held)
            tpc.release_blocks(held)
            held = None
        if rng.random() < 0.3:
            held = sid
        else:
            jpc.release_blocks(sid)
            tpc.release_blocks(sid)
        for name in names:
            assert np.array_equal(np.asarray(getattr(jc["c"], name)),
                                  getattr(tc, name).numpy()), name
        assert (ttier.stats.saved, ttier.stats.restored, ttier.stats.dropped) == \
            (jtier.stats.saved, jtier.stats.restored, jtier.stats.dropped)
        assert (tpc.stats.hits, tpc.stats.misses, tpc.stats.evictions) == \
            (jpc.stats.hits, jpc.stats.misses, jpc.stats.evictions)
    assert ttier.stats.saved > 0 and ttier.stats.restored > 0
    assert _ptrs(tc) == ptrs


# ---------------------------------------------------------------------------
# BatchEngine with the host tier
# ---------------------------------------------------------------------------

class _Tok:
    eos_token_id = -1

    def is_eos(self, t):
        return False

    def decode(self, ids):
        return "".join(chr(32 + i % 90) for i in ids)


async def _collect(handle):
    return [t.token_id async for t in handle.tokens()]


async def _waves(eng, waves, gen):
    task = asyncio.create_task(eng.run())
    out = []
    for wave in waves:
        handles = [eng.submit(p, gen()) for p in wave]
        out += await asyncio.wait_for(asyncio.gather(*[_collect(h) for h in handles]), 120)
    eng.stop()
    await task
    return out


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny()
    jmodel = synth_model(jcfg, quant="dense", dtype=jnp.float32)
    jmodel.params = jax_synth(jcfg, quant="awq", dtype=jnp.float32, group_size=32, seed=8)
    tparams = params_from_jax(jax.tree.map(np.asarray, jmodel.params), device=CPU)
    return jmodel, Model(tiny_llama_config(), tparams, torch.float32)


def _app(cls, cfg, kv):
    a = cls(model=cfg)
    a.inference.max_seq_len = 64
    a.inference.max_batch_size = 4
    a.inference.block_size = 8
    a.inference.num_blocks = 8
    a.inference.prefix_cache = True
    a.inference.gpu_prefix_cache = True
    a.inference.kv_cache_dtype = kv
    return a


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_engine_restores_evicted_prefix_like_jax(models, kv):
    """An 8-block pool: prefix A (2 blocks) is served, prefix B (7 blocks)
    evicts it to the host tier, A comes back restored (and evicts B's
    blocks in turn). Streams and counts equal the JAX engine's; A's second
    stream equals its first; the cache tensors are the ones it started
    with."""
    jmodel, tmodel = models
    a = list(range(40, 56))
    b = list(range(100, 156))
    waves = [[a + [1, 2]], [b + [3]], [a + [1, 2]], [a + [5]]]
    jeng = JEngine(jmodel, _Tok(), _app(JApp, jmodel.cfg, kv))
    ref = asyncio.run(_waves(jeng, waves, lambda: JGen(max_tokens=6, temperature=0.0)))
    teng = BatchEngine(tmodel, _Tok(), _app(AppConfig, tmodel.cfg, kv))
    ptrs = _ptrs(teng.cache)
    got = asyncio.run(_waves(teng, waves, lambda: GenerationConfig(max_tokens=6,
                                                                   temperature=0.0)))
    assert got == ref
    assert got[2] == got[0]
    tt, jt = teng.prefix_cache.host_tier.stats, jeng.prefix_cache.host_tier.stats
    assert (tt.saved, tt.restored, tt.dropped) == (jt.saved, jt.restored, jt.dropped)
    assert tt.restored >= 2 and tt.saved >= 2
    ts, js = teng.prefix_cache.stats, jeng.prefix_cache.stats
    assert (ts.hits, ts.misses, ts.evictions) == (js.hits, js.misses, js.evictions)
    assert _ptrs(teng.cache) == ptrs
