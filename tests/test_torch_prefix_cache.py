"""Port parity: blazr_tpu_torch's prefix cache, its scheduler hooks and the
BatchEngine with the prefix cache on (and its host tier) against
blazr_tpu's on the CPU.

The same seeded sequences of calls go through both PrefixCaches (block ids,
cached counts, stats and allocator state equal), through both schedulers
(block tables, cached and prefilled counts equal), and the same prompts
through both engines (greedy token ids and hit/miss counts equal). The
engine cases are a shared prefix with a whole-prompt hit on a block-aligned
prompt, a preemption whose sequence is admitted again, and prompts whose
prefix blocks are evicted to the host tier and restored from it."""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.sequence_scheduler import SchedulerConfig as JSchedCfg
from blazr_tpu.engine.sequence_scheduler import SequenceScheduler as JSched
from blazr_tpu.kvcache.block_allocator import BlockAllocator as JAlloc
from blazr_tpu.kvcache.prefix_cache import PrefixCache as JPrefix
from blazr_tpu.kvcache.prefix_cache import PrefixCacheConfig as JPrefixCfg
from blazr_tpu.utils.synthetic import synth_llama_params as jax_synth
from blazr_tpu.utils.synthetic import synth_model, tiny_llama_config as jax_tiny
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.sequence_scheduler import SchedulerConfig, SequenceScheduler
from blazr_tpu_torch.kvcache.block_allocator import BlockAllocator
from blazr_tpu_torch.kvcache.prefix_cache import PrefixCache, PrefixCacheConfig
from blazr_tpu_torch.models.registry import Model
from blazr_tpu_torch.utils.synthetic import tiny_llama_config



class _JPrefixUnaliased(JPrefix):
    """The JAX PrefixCache with its one known fault taken out: its
    ``get_or_allocate_blocks`` records the caller's own block list
    (``blazr_tpu/kvcache/prefix_cache.py:132``), which ``extend`` and the
    scheduler both append each decode block to, so the block is held and
    freed twice and two later sequences share it (ROADMAP §C). The port
    records a copy; everything else is compared with the JAX class as it
    is (``test_decode_blocks_are_freed_once`` pins the fault itself)."""

    def get_or_allocate_blocks(self, seq_id, tokens):
        cached, blocks = super().get_or_allocate_blocks(seq_id, tokens)
        self._seq_blocks[seq_id] = list(blocks)
        return cached, blocks


PORT = (BlockAllocator, PrefixCache, PrefixCacheConfig)
JAX = (JAlloc, _JPrefixUnaliased, JPrefixCfg)


# ---------------------------------------------------------------------------
# PrefixCache: the same calls, the same answers
# ---------------------------------------------------------------------------

def _state(alloc, pc) -> tuple:
    st = pc.stats
    return (sorted(alloc._free), sorted(alloc._refs.items()),
            (st.hits, st.misses, st.cached_blocks, st.evictions),
            sorted(pc._computed), sorted(pc._seq_blocks.items()))


def _drive(impl, ops, num_blocks, bs, max_cached=10000) -> list:
    """Apply ``ops`` to a fresh allocator and cache of ``impl``; the trace
    holds each call's result (or its MemoryError) and the state after it."""
    alloc_cls, pc_cls, cfg_cls = impl
    alloc = alloc_cls(num_blocks, bs)
    pc = pc_cls(alloc, cfg_cls(max_cached_blocks=max_cached))
    trace = []
    for op, *args in ops:
        try:
            if op == "get":
                res = pc.get_or_allocate_blocks(*args)
            elif op == "mark":
                res = pc.mark_computed(*args)
            elif op == "extend":
                res = pc.extend(*args)
            elif op == "release":
                res = pc.release_blocks(*args)
            else:
                res = pc._evict_one()
        except MemoryError:
            res = "MemoryError"
        trace.append((op, res, _state(alloc, pc)))
    return trace


def _same(ops, num_blocks=16, bs=4, max_cached=10000):
    got = _drive(PORT, ops, num_blocks, bs, max_cached)
    ref = _drive(JAX, ops, num_blocks, bs, max_cached)
    assert got == ref
    return got


P = [1, 2, 3, 4, 5, 6, 7, 8]                   # two full blocks of 4


def test_hits_after_mark_computed_only():
    trace = _same([("get", 1, P + [9]), ("get", 2, P + [10]), ("mark", 1, 9),
                   ("get", 3, P + [11]), ("release", 1), ("release", 2),
                   ("release", 3), ("get", 4, P)])
    assert trace[1][1][0] == 0                 # registered, not computed: miss
    assert trace[3][1][0] == 8                 # computed: two blocks hit
    assert trace[-1][1][0] == 8                # a whole-prompt hit (capped later)


def test_chain_hash_collision_case():
    """The same block content after another prefix is another block; the
    same prompt registered twice before a prefill dedupes its hash."""
    trace = _same([("get", 1, [1, 2, 3, 4, 9, 9, 9, 9]), ("mark", 1, 8),
                   ("get", 2, [5, 6, 7, 8, 9, 9, 9, 9]),
                   ("get", 3, [1, 2, 3, 4, 9, 9, 9, 9, 1]),
                   ("get", 4, [5, 6, 7, 8, 9, 9, 9, 9]),
                   ("mark", 2, 8), ("release", 4), ("get", 5, [5, 6, 7, 8, 9, 9, 9, 9])])
    assert trace[2][1][0] == 0 and trace[3][1][0] == 8
    assert trace[4][1][0] == 0 and trace[-1][1][0] == 8


def test_abort_before_prefill_and_partial_prefill_abort():
    toks = list(range(16))                     # four full blocks
    trace = _same([("get", 1, toks), ("release", 1), ("get", 2, toks),
                   ("mark", 2, 8), ("release", 2), ("get", 3, toks)])
    assert trace[2][1][0] == 0                 # never computed: not served
    assert trace[-1][1][0] == 8                # only the prefilled half survives


def test_memory_error_rolls_back():
    """A lookup that runs out of blocks part-way frees what it took and
    deregisters what it registered; extend frees its partial allocation."""
    trace = _same([("get", 1, list(range(12))), ("mark", 1, 12),
                   ("get", 2, list(range(100, 120))), ("extend", 1, 5),
                   ("release", 1), ("get", 3, list(range(200, 228))),
                   ("get", 4, list(range(12)))], num_blocks=6)
    assert trace[2][1] == "MemoryError" and trace[3][1] == "MemoryError"
    assert trace[-2][1] == "MemoryError" and trace[-1][1][0] == 0


def test_extend_and_register_evict_lru():
    toks = list(range(8))
    _same([("get", 1, toks), ("mark", 1, 8), ("release", 1), ("extend", 2, 3),
           ("get", 3, [7, 7, 7, 7, 8, 8, 8, 8]), ("mark", 3, 8), ("evict",),
           ("release", 2), ("release", 3), ("get", 4, toks)], num_blocks=4)
    # max_cached_blocks bounds the registered blocks: a new hash evicts LRU.
    _same([("get", 1, list(range(12))), ("mark", 1, 12), ("release", 1),
           ("get", 2, list(range(50, 62))), ("mark", 2, 12), ("get", 3, list(range(12)))],
          num_blocks=32, max_cached=4)


def test_adopt_serves_a_block_written_elsewhere():
    """adopt() registers a block of a lookup under its hash, marks it
    computed and takes it off the sequence's pending list, so a release
    keeps it and a later lookup hits it; a hash already held by another
    block stays with that block."""
    alloc = BlockAllocator(8, 4)
    pc = PrefixCache(alloc)
    _, blocks = pc.get_or_allocate_blocks(1, P)      # registered, pending
    h0 = pc._hash_of[blocks[0]]
    pc.release_blocks(1)                             # never computed: deregistered
    assert not pc._by_hash and alloc.free_blocks == 8
    _, blocks = pc.get_or_allocate_blocks(2, P)
    pc.adopt(2, h0, blocks[0])
    assert [b for b, _, _ in pc._pending[2]] == [blocks[1]]
    pc.release_blocks(2)
    assert pc._by_hash == {h0: blocks[0]} and pc._computed == {blocks[0]}
    cached, again = pc.get_or_allocate_blocks(3, P)
    assert cached == 4 and again[0] == blocks[0]
    pc.adopt(3, h0, again[1])                        # h0 is blocks[0]'s
    assert pc._by_hash[h0] == blocks[0] and again[1] in pc._computed


@pytest.mark.parametrize("seed", range(6))
def test_seeded_call_sequences_match_jax(seed):
    """Random calls over prompts drawn from a few shared prefixes, a small
    pool (MemoryError paths) and a small max_cached_blocks."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 50, 12).tolist() for _ in range(3)]
    ops, live = [], {}
    for step in range(60):
        r = rng.random()
        if r < 0.35 or not live:
            sid = step + 1
            toks = prefixes[rng.integers(0, 3)][:rng.integers(4, 13)]
            toks = toks + rng.integers(0, 50, rng.integers(0, 6)).tolist()
            if not toks:
                toks = [1]
            ops.append(("get", sid, toks))
            live[sid] = len(toks)
        elif r < 0.6:
            sid = list(live)[rng.integers(0, len(live))]
            ops.append(("mark", sid, int(rng.integers(0, live[sid] + 1))))
        elif r < 0.75:
            ops.append(("extend", list(live)[rng.integers(0, len(live))],
                        int(rng.integers(1, 3))))
        elif r < 0.95:
            sid = list(live)[rng.integers(0, len(live))]
            live.pop(sid)
            ops.append(("release", sid))
        else:
            ops.append(("evict",))
    _same(ops, num_blocks=int(rng.integers(8, 24)), bs=4,
          max_cached=int(rng.integers(3, 20)))


@pytest.mark.parametrize("cls,shared", [(PrefixCache, False), (JPrefix, True)],
                         ids=["port", "jax"])
def test_decode_blocks_are_freed_once(cls, shared):
    """The scheduler's admission of an 8-token prompt (blocks of 4) and one
    decode block: the port frees each block once; the JAX cache frees the
    decode block twice, so the free list holds it twice and it is handed
    out twice (the fault ``_JPrefixUnaliased`` takes out of the JAX side of
    the other tests)."""
    alloc = (BlockAllocator if cls is PrefixCache else JAlloc)(16, 4)
    pc = cls(alloc)
    _, table = pc.get_or_allocate_blocks(1, list(range(8)))
    table.extend(pc.extend(1, 1))                      # as the scheduler does
    pc.mark_computed(1, 8)
    pc.release_blocks(1)
    free = alloc._free
    assert (len(set(free)) < len(free)) == shared
    a = pc.get_or_allocate_blocks(2, list(range(50, 58)))[1]
    b = pc.get_or_allocate_blocks(3, list(range(60, 68)))[1]
    assert (len(set(a + b)) < len(a + b)) == shared     # a block handed out twice


def test_sequential_requests_equal_the_cache_off(models):
    """Requests one after another, each with a decode block, through the
    port's engine with the prefix cache on: the same streams as with it off
    (each request alone), since no two sequences share a block."""
    _, tmodel = models
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 250, n).tolist() for n in (8, 40, 19, 27)]

    def run(prefix):
        app = _app(AppConfig, tmodel.cfg, prefix_cache=prefix)
        eng = BatchEngine(tmodel, _Tok(), app)
        return asyncio.run(_waves(eng, [[p] for p in prompts],
                                  lambda: GenerationConfig(max_tokens=12,
                                                           temperature=0.0)))
    assert run(True) == run(False)


# ---------------------------------------------------------------------------
# the scheduler's prefix hooks
# ---------------------------------------------------------------------------

def _sched_trace(sched_cls, cfg_cls, alloc_cls, pc_cls, script, num_blocks):
    alloc = alloc_cls(num_blocks, 4)
    pc = pc_cls(alloc)
    s = sched_cls(alloc, cfg_cls(max_batch_size=4, max_batch_tokens=64, block_size=4,
                                 max_seq_len=64), prefix_cache=pc)
    out = []
    for op, *args in script:
        if op == "add":
            s.add_request(*args)
        elif op == "schedule":
            b = s.schedule()
            out.append(([q.seq_id for q in b.prefill_sequences],
                        [q.seq_id for q in b.decode_sequences]))
        elif op == "prefill":
            seq = s.sequences[args[0]]
            s.prefill_complete(args[0], len(seq.prompt_tokens) - seq.prefilled_tokens)
        elif op == "token":
            s.append_token(*args)
        elif op == "finish":
            s.finish_sequence(*args)
        elif op == "abort":
            s.abort_sequence(*args)
        out.append(sorted((sid, q.state.value, list(q.block_table), q.cached_tokens,
                           q.prefilled_tokens, len(q.prompt_tokens))
                          for sid, q in s.sequences.items()))
        out.append((pc.stats.hits, pc.stats.misses, pc.stats.cached_blocks,
                    pc.stats.evictions, alloc.free_blocks))
    return out


def test_scheduler_prefix_hooks_match_jax():
    """Admission with hits, a whole-prompt hit on a block-aligned prompt,
    decode growth through the cache, preemption of the newest sequence with
    its computed blocks kept, re-admission that hits them, abort."""
    pre = [1, 2, 3, 4, 5, 6, 7, 8]
    script = [("add", pre + [9]), ("schedule",), ("prefill", 1),
              ("add", pre + [10, 11]), ("add", pre), ("schedule",), ("prefill", 2),
              ("prefill", 3)]
    for t in range(6):
        script += [("token", 1, 20 + t), ("token", 2, 30 + t), ("token", 3, 40 + t),
                   ("schedule",)]
    script += [("schedule",), ("prefill", 3), ("finish", 1), ("schedule",),
               ("abort", 2), ("add", pre + [12]), ("schedule",), ("finish", 3)]
    got = _sched_trace(SequenceScheduler, SchedulerConfig, BlockAllocator, PrefixCache,
                       script, num_blocks=10)
    ref = _sched_trace(JSched, JSchedCfg, JAlloc, _JPrefixUnaliased, script,
                       num_blocks=10)
    assert got == ref
    # sequence 3 (block-aligned, 8 tokens) was a whole-prompt hit: 7 cached
    assert any(row[0] == 3 and row[3] == 7 for state in got if isinstance(state, list)
               for row in state)


# ---------------------------------------------------------------------------
# BatchEngine with the prefix cache: the JAX engine's streams exactly
# ---------------------------------------------------------------------------

class _Tok:
    """Stub tokenizer: no EOS, so every request runs to max_tokens."""

    eos_token_id = -1

    def is_eos(self, t):
        return False

    def decode(self, ids):
        return "".join(chr(32 + i % 90) for i in ids)


async def _collect(handle):
    return [t.token_id async for t in handle.tokens()]


async def _waves(eng, waves, gen):
    """Each wave is submitted once the previous one has finished; returns
    the streams in submit order."""
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
    jmodel.params = jax_synth(jcfg, quant="awq", dtype=jnp.float32, group_size=32, seed=5)
    tparams = params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    return jmodel, Model(tiny_llama_config(), tparams, torch.float32)


def _app(cls, cfg, **inf):
    a = cls(model=cfg)
    a.inference.max_seq_len = 64
    a.inference.max_batch_size = 4
    a.inference.block_size = 8
    a.inference.prefix_cache = True
    for k, v in inf.items():
        setattr(a.inference, k, v)
    return a


def _both(models, waves, max_tokens, **inf):
    """(port streams, port engine), (JAX streams, JAX engine); the JAX
    engine's prefix cache is ``_JPrefixUnaliased``."""
    import blazr_tpu.engine.batch_engine as jbe

    jmodel, tmodel = models
    real, jbe.PrefixCache = jbe.PrefixCache, _JPrefixUnaliased
    try:
        jeng = JEngine(jmodel, _Tok(), _app(JApp, jmodel.cfg, **inf))
    finally:
        jbe.PrefixCache = real
    ref = asyncio.run(_waves(jeng, waves, lambda: JGen(max_tokens=max_tokens,
                                                       temperature=0.0)))
    teng = BatchEngine(tmodel, _Tok(), _app(AppConfig, tmodel.cfg, **inf))
    got = asyncio.run(_waves(teng, waves, lambda: GenerationConfig(max_tokens=max_tokens,
                                                                   temperature=0.0)))
    return (got, teng), (ref, jeng)


def _stats(eng) -> tuple:
    st = eng.prefix_cache.stats
    return st.hits, st.misses, st.cached_blocks, st.evictions


def test_shared_prefix_streams_match_jax(models):
    """A 16-token shared prefix (two blocks of 8): the second wave hits it;
    the block-aligned 24-token prompt comes back whole (its last token is
    prefilled again inside its shared last block)."""
    pre = list(range(40, 56))
    aligned = pre + list(range(60, 68))
    waves = [[pre + [1, 2, 3], aligned],
             [pre + [4, 5, 6, 7, 8], pre + [9], aligned, pre]]
    (got, teng), (ref, jeng) = _both(models, waves, max_tokens=10)
    assert got == ref
    assert _stats(teng) == _stats(jeng)
    assert teng.prefix_cache.stats.hits >= 8


def test_preempted_sequence_hits_its_prompt_blocks(models):
    """A pool of 9 blocks of 8 for three sequences that grow to 5 blocks
    each: the newest is preempted, admitted again with its outputs folded
    into its prompt, and hits its computed prompt blocks."""
    prompts = [list(range(10, 26)), list(range(30, 46)), list(range(50, 66))]
    (got, teng), (ref, jeng) = _both(models, [prompts], max_tokens=22, num_blocks=9)
    assert got == ref
    assert teng.scheduler.preemptions > 0
    assert _stats(teng) == _stats(jeng)
    assert teng.prefix_cache.stats.hits > 0


def test_whole_prompt_hit_equals_a_cold_prefill(models):
    """The same prompts with the cache off: the whole-prompt and suffix
    hits give the cold streams (f32; the logits agree to rounding)."""
    _, tmodel = models
    pre = list(range(40, 56))
    waves = [[pre + [1, 2, 3]], [pre + [1, 2, 3], pre, pre + [7]]]
    streams = {}
    for on in (True, False):
        eng = BatchEngine(tmodel, _Tok(), _app(AppConfig, tmodel.cfg, prefix_cache=on))
        streams[on] = asyncio.run(_waves(eng, waves, lambda: GenerationConfig(
            max_tokens=8, temperature=0.0)))
    assert streams[True] == streams[False]


def test_warmup_changes_no_stream_and_no_state(models):
    """warmup() runs the prefill buckets and every decode step key on pad
    rows: it writes nothing but the trash slot, takes no block and no
    cache entry, and the streams after it equal an unwarmed engine's."""
    _, tmodel = models
    pre = list(range(40, 56))
    waves = [[pre + [1, 2, 3], [5, 9, 17]], [pre + [4], pre]]

    def engine():
        return BatchEngine(tmodel, _Tok(), _app(AppConfig, tmodel.cfg, max_batch_size=3))

    cold = engine()
    cold_streams = asyncio.run(_waves(cold, waves, lambda: GenerationConfig(
        max_tokens=9, temperature=0.0)))
    warm = engine()
    before = (warm.cache.k[:, :-1].clone(), warm.cache.v[:, :-1].clone(),
              sorted(warm.allocator._free), dict(warm.prefix_cache._by_hash),
              warm.prefix_cache.stats.hits, warm.prefix_cache.stats.misses)
    seconds = warm.warmup()
    after = (warm.cache.k[:, :-1], warm.cache.v[:, :-1], sorted(warm.allocator._free),
             dict(warm.prefix_cache._by_hash), warm.prefix_cache.stats.hits,
             warm.prefix_cache.stats.misses)
    assert seconds > 0
    assert torch.equal(before[0], after[0]) and torch.equal(before[1], after[1])
    assert before[2:] == after[2:]
    assert sorted(warm._steps) == [1, 2, 3]          # every decode batch, max_batch 3
    warm_streams = asyncio.run(_waves(warm, waves, lambda: GenerationConfig(
        max_tokens=9, temperature=0.0)))
    assert warm_streams == cold_streams
