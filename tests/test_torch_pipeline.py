"""The pipelined, fixed-shape decode round of blazr_tpu_torch's BatchEngine
on the CPU (the steps run eagerly here; on the card the same steps are
CUDA graphs): streams do not depend on the pipe depth, on padding the
round to a power of two or on allocator pressure that lands rounds early,
and greedy streams equal the JAX engine's at the same depth. Also the
round's table (rows, pad rows, full-width block tables) and the
Executor's caches."""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.utils.synthetic import synth_llama_params as jax_synth
from blazr_tpu.utils.synthetic import synth_model, tiny_llama_config as jax_tiny
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.decode_graph import BatchStep
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.engine.sequence_scheduler import Sequence, SequenceState
from blazr_tpu_torch.kvcache.paged import PAD_BLOCK
from blazr_tpu_torch.models.registry import Model
from blazr_tpu_torch.utils.synthetic import tiny_llama_config

CPU = "cpu"


class _Tok:
    """Stub tokenizer: no EOS, so every request runs to max_tokens."""

    eos_token_id = -1

    def is_eos(self, t):
        return False

    def decode(self, ids):
        return "".join(chr(32 + i % 90) for i in ids)


async def _collect(handle):
    return [t.token_id async for t in handle.tokens()]


async def _serve(eng, waves):
    """Submit ``waves`` of (prompt, config); a later wave is submitted once
    every request of the previous one has its first token, so it joins a
    running (pipelined) decode batch. Streams in submit order."""
    task = asyncio.create_task(eng.run())
    streams = []
    for wave in waves:
        handles = [eng.submit(p, c) for p, c in wave]
        firsts = [await asyncio.wait_for(h.queue.get(), timeout=120) for h in handles]
        streams.append((handles, firsts))
    out = []
    for handles, firsts in streams:
        rest = await asyncio.gather(*[asyncio.wait_for(_collect(h), 120) for h in handles])
        out += [[f[0].token_id] + r for f, r in zip(firsts, rest)]
    eng.stop()
    await task
    return out


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny()
    jmodel = synth_model(jcfg, quant="dense", dtype=jnp.float32)
    jmodel.params = jax_synth(jcfg, quant="awq", dtype=jnp.float32, group_size=32, seed=5)
    tparams = params_from_jax(jax.tree.map(np.asarray, jmodel.params), device=CPU)
    return jmodel, Model(tiny_llama_config(), tparams, torch.float32)


def _app(cfg, cls=AppConfig, **inf):
    a = cls(model=cfg)
    a.inference.max_seq_len = 64
    a.inference.max_batch_size = 4
    for k, v in inf.items():
        setattr(a.inference, k, v)
    return a


# Mixed lengths, a seeded sampled row, a penalty row, a logit-bias row, and
# a late joiner in a second wave.
_CFGS = [
    GenerationConfig(max_tokens=11, temperature=0.0),
    GenerationConfig(max_tokens=3, temperature=0.0),
    GenerationConfig(max_tokens=9, temperature=0.8, seed=11, top_p=0.9),
    GenerationConfig(max_tokens=6, temperature=0.0, repeat_penalty=1.3, repeat_last_n=4),
    GenerationConfig(max_tokens=7, temperature=0.0, logit_bias={42: 6.0}),
]
_PROMPTS = [[1, 2, 3], [9, 8, 7, 6], [5, 5, 5], [100, 101], [17] * 12]


def _waves():
    reqs = list(zip(_PROMPTS, _CFGS))
    return [reqs[:3], reqs[3:]]


def test_pipe_depth_matches_depth1(models):
    """Depths 1, 2 and 3 (as many unread rounds after each dispatch) give
    the same streams: lag, the all-overrun guard, chained rows keeping
    their row, and the flush when the late joiners change the round's
    row count."""
    _, tmodel = models

    def run(depth):
        eng = BatchEngine(tmodel, _Tok(), _app(tmodel.cfg, decode_horizon=4,
                                               decode_pipe_depth=depth))
        out = asyncio.run(_serve(eng, _waves()))
        return out, eng

    d1, _ = run(1)
    assert [len(s) for s in d1] == [c.max_tokens for c in _CFGS]
    for depth in (2, 3):
        got, eng = run(depth)
        assert got == d1, depth
        assert eng.horizon_steps > eng.horizon_dispatches
        assert eng.perf["h_fetch_n"] >= 1


def test_greedy_depth2_matches_jax_engine(models):
    """At decode_pipe_depth 2 and horizon 4 on both engines, greedy streams
    (default penalties) in two staggered waves are equal."""
    jmodel, tmodel = models
    waves = [[[5, 9, 17], [100, 3, 3, 7, 200, 11], [1] * 9],
             [[42] * 20, list(range(1, 18))]]
    lens = [12, 5, 9, 7, 10]

    async def serve(eng, make):
        task = asyncio.create_task(eng.run())
        i, streams = 0, []
        for wave in waves:
            handles = []
            for p in wave:
                handles.append(eng.submit(p, make(lens[i])))
                i += 1
            firsts = [await asyncio.wait_for(h.queue.get(), 120) for h in handles]
            streams.append((handles, firsts))
        out = []
        for handles, firsts in streams:
            rest = await asyncio.gather(*[asyncio.wait_for(_collect(h), 120)
                                          for h in handles])
            out += [[f[0].token_id] + r for f, r in zip(firsts, rest)]
        eng.stop()
        await task
        return out

    kw = dict(decode_horizon=4, decode_pipe_depth=2)
    ref = asyncio.run(serve(JEngine(jmodel, _Tok(), _app(jmodel.cfg, JApp, **kw)),
                            lambda n: JGen(max_tokens=n, temperature=0.0)))
    got = asyncio.run(serve(BatchEngine(tmodel, _Tok(), _app(tmodel.cfg, **kw)),
                            lambda n: GenerationConfig(max_tokens=n, temperature=0.0)))
    assert got == ref
    assert [len(s) for s in got] == lens


def test_padded_round_keeps_the_streams(models):
    """Three running rows under max_batch 4 run in rounds of 4 rows (one pad
    row on the trash slot); under max_batch 3 in rounds of 3 (the JAX cap);
    and each request alone in rounds of 1: the same streams."""
    _, tmodel = models
    reqs = list(zip(_PROMPTS[:3], _CFGS[:3]))

    def run(max_batch, waves):
        eng = BatchEngine(tmodel, _Tok(), _app(tmodel.cfg, max_batch_size=max_batch))
        return asyncio.run(_serve(eng, waves)), eng

    padded, eng4 = run(4, [reqs])
    assert 4 in eng4._steps
    capped, eng3 = run(3, [reqs])
    assert 4 not in eng3._steps and 3 in eng3._steps
    alone = [run(1, [[r]])[0][0] for r in reqs]
    assert padded == capped == alone


def test_squeezed_allocator_lands_rounds_and_keeps_the_streams(models):
    """A pool two blocks short of the three sequences' final lengths (the
    shorter ones finish first and free theirs): a chained round cannot
    cover its horizon and lag, so the oldest round is landed first
    (``pipe_pressure_n``); nothing is preempted, and the streams equal
    those of a roomy pool at depth 1."""
    _, tmodel = models
    cfgs = [GenerationConfig(max_tokens=n, temperature=0.0) for n in (20, 14, 9)]
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9]]
    waves = [list(zip(prompts, cfgs))]

    def run(depth, blocks):
        eng = BatchEngine(tmodel, _Tok(), _app(
            tmodel.cfg, block_size=4, num_blocks=blocks, decode_horizon=8,
            decode_pipe_depth=depth))
        return asyncio.run(_serve(eng, waves)), eng

    ref, _ = run(1, 64)
    final = sum(-(-(len(p) + c.max_tokens) // 4) for p, c in zip(prompts, cfgs))
    for depth in (1, 2, 3):
        got, eng = run(depth, final - 2)
        assert got == ref, depth
        assert eng.perf["pipe_pressure_n"] > 0, depth
        assert eng.scheduler.preemptions == 0


def test_round_table_rows_pads_and_full_width_tables(models):
    """The round's table: live rows carry their last token, position (lag
    included), sampling step (emitted + lag) and block table padded to
    max_blocks_per_seq; pad rows are not live and hold PAD blocks only."""
    _, tmodel = models
    eng = BatchEngine(tmodel, _Tok(), _app(tmodel.cfg, max_seq_len=256, block_size=16))
    assert eng.max_blocks_per_seq == 16
    seq = Sequence(seq_id=1, prompt_tokens=[4, 5, 6], gen_cfg=GenerationConfig(
        temperature=0.5, seed=3, repeat_last_n=8))
    seq.state = SequenceState.RUNNING
    seq.block_table = [7, 2]
    seq.output_tokens = [9, 10]
    seq.emitted = 2
    step = BatchStep(eng, 4, horizon=8, slots=3)
    win = np.full((64,), -1, dtype=np.int64)
    tab = step.build([None, seq, None, None], [0, 3, 0, 0],
                     np.array([True, False, True, True]), [None, win, None, None])
    lay = step.lay
    assert lay.width == lay.bt + 16 and tab.shape == (4, lay.width)
    assert tab[1, lay["tok"]] == 10 and tab[1, lay["pos"]] == 4 + 3
    assert tab[1, lay["live"]] == 1 and tab[1, lay["fresh"]] == 0
    assert tab[1, lay["rln"]] == 8
    assert tab[1, lay.seed + 1] == 2 + 3 and tab[1, lay.seed] == 3
    assert list(tab[1, lay.bt:lay.bt + 3]) == [7, 2, PAD_BLOCK]
    for r in (0, 2, 3):
        assert tab[r, lay["live"]] == 0 and (tab[r, lay.bt:] == PAD_BLOCK).all()
    assert (tab[:, lay["i"]] == 0).all()


def test_executor_keeps_its_caches(models):
    """The Executor's graphed steps hold their cache: sequential generations
    take the one cache (emptied between them), a generation started while
    another is open takes a second, and the streams are those of fresh
    executors."""
    _, tmodel = models
    a = AppConfig(model=tmodel.cfg)
    a.inference.max_seq_len = 64
    ex = Executor(tmodel, _Tok(), a)
    gen = GenerationConfig(max_tokens=6, temperature=0.0)

    def fresh(prompt):
        return [t.token_id for t in Executor(tmodel, _Tok(), a).generate(prompt, gen)]

    one = [t.token_id for t in ex.generate([1, 2, 3, 4], gen)]
    two = [t.token_id for t in ex.generate([7, 7, 9], gen)]
    assert len(ex._free) == 1
    g1, g2 = ex.generate([5, 6], gen), ex.generate([8, 1, 8], gen)
    both = [[], []]
    for _ in range(6):
        both[0].append(next(g1).token_id)
        both[1].append(next(g2).token_id)
    for g in (g1, g2):
        g.close()
    assert len(ex._free) == 2
    assert one == fresh([1, 2, 3, 4]) and two == fresh([7, 7, 9])
    assert both == [fresh([5, 6]), fresh([8, 1, 8])]
