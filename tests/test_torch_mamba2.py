"""Port parity: the Mamba2 family of blazr_tpu_torch (``models/mamba2.py``,
``kvcache/ssm_state.py``, the state slots of ``models/paged_multi.py`` and
both engines) against blazr_tpu on the CPU.

The scan's two forms (the step at one token, the chunked SSD form in one
chunk up to 128 tokens and several above) are held to the JAX package's
associative and chunked scans on both sides of 128 tokens, on inputs made from numpy seeds; the models come from
tiny checkpoints (``utils.synthetic.tiny_recurrent_config("mamba2")``:
hidden 64, 2 layers of 8 heads x 16, state 16, 2 groups) written by
``write_hf_checkpoint`` in HF Mamba2's layout (plain f32, or AWQ-INT4 in
groups of 32) and read by both packages' ``load_model``.

Tolerances: the scan within 5e-5 of its largest magnitude (f32 running
sums of up to 129 log-decays in another order), the conv and the gated
norm within 1e-5; logits within 1e-4; greedy streams exactly equal."""

import asyncio

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.loader import load_model as jax_load
from blazr_tpu.models import mamba2 as jm2
from blazr_tpu.models import paged_multi as jpm
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.kvcache.ssm_state import SSMState
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.models import mamba2 as tm2
from blazr_tpu_torch.models import paged_multi as tpm
from blazr_tpu_torch.utils.synthetic import (tiny_recurrent_config, write_gguf_recurrent,
                                             write_hf_checkpoint)

from test_torch_engine import _Tok, _serve

CPU = "cpu"
VOCAB = 256
CFG = tiny_recurrent_config("mamba2")


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


# ---------------------------------------------------------------------------
# The mixer's parts
# ---------------------------------------------------------------------------

def _scan_inputs(t: int, seed: int = 0):
    ssm = CFG.ssm
    rng = np.random.default_rng(seed)
    g_state = ssm.n_groups * ssm.state_size
    x = rng.standard_normal((2, t, ssm.inner_size), dtype=np.float32)
    b = rng.standard_normal((2, t, g_state), dtype=np.float32) * 0.5
    c = rng.standard_normal((2, t, g_state), dtype=np.float32) * 0.5
    dt = rng.standard_normal((2, t, ssm.num_heads), dtype=np.float32)
    state = rng.standard_normal((2, ssm.num_heads, ssm.head_dim, ssm.state_size),
                                dtype=np.float32)
    p = {"A_log": np.log(rng.uniform(1, 16, ssm.num_heads)).astype(np.float32),
         "dt_bias": rng.standard_normal(ssm.num_heads).astype(np.float32) * 0.5,
         "D": rng.standard_normal(ssm.num_heads).astype(np.float32)}
    return x, b, c, dt, state, p


# (tokens, the port's chunk length): by default one token takes the step
# form, up to 128 one chunk, above it chunks of 128 (129 tokens: a chunk and
# one); the JAX package takes its associative scan up to 128 and its
# chunked one above. The last two set the port's chunk on each side of 128:
# 128 tokens in four chunks, and 129 in one.
SCANS = [(1, None), (128, None), (129, None), (128, 32), (129, 129)]


@pytest.mark.parametrize("t,chunk", SCANS,
                         ids=[f"{t}-{'default' if c is None else f'chunks-of-{c}'}"
                              for t, c in SCANS])
def test_scan_matches_jax(t, chunk):
    x, b, c, dt, state, p = _scan_inputs(t)
    jy, js = jm2._ssm_scan(CFG, jnp.asarray(x), jnp.asarray(b), jnp.asarray(c),
                           jnp.asarray(dt), jnp.asarray(state),
                           {k: jnp.asarray(v) for k, v in p.items()})
    ty, ts = tm2._ssm_scan(CFG, torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(c),
                           torch.from_numpy(dt), torch.from_numpy(state),
                           {k: torch.from_numpy(v) for k, v in p.items()}, chunk=chunk)
    assert ty.shape == jy.shape and ts.shape == js.shape
    assert _rel(ty.numpy(), np.asarray(jy)) < 5e-5
    assert _rel(ts.numpy(), np.asarray(js)) < 5e-5


def test_scan_pieces_agree_with_a_carried_state():
    """300 tokens in one call (three chunks) equal 100 tokens (one chunk)
    then 200 (two) from the state the first call left."""
    x, b, c, dt, state, p = (torch.from_numpy(a) if isinstance(a, np.ndarray) else
                             {k: torch.from_numpy(v) for k, v in a.items()}
                             for a in _scan_inputs(300, seed=1))
    y, s = tm2._ssm_scan(CFG, x, b, c, dt, state, p)
    y1, s1 = tm2._ssm_scan(CFG, x[:, :100], b[:, :100], c[:, :100], dt[:, :100], state, p)
    y2, s2 = tm2._ssm_scan(CFG, x[:, 100:], b[:, 100:], c[:, 100:], dt[:, 100:], s1, p)
    assert _rel(torch.cat([y1, y2], dim=1).numpy(), y.numpy()) < 1e-5
    assert _rel(s2.numpy(), s.numpy()) < 1e-5


@pytest.mark.parametrize("t", [1, 7])
def test_conv_matches_jax(t):
    rng = np.random.default_rng(t)
    conv_dim = CFG.ssm.inner_size + 2 * CFG.ssm.n_groups * CFG.ssm.state_size
    xbc = rng.standard_normal((2, t, conv_dim), dtype=np.float32)
    st = rng.standard_normal((2, conv_dim, 3), dtype=np.float32)
    w = rng.standard_normal((conv_dim, 4), dtype=np.float32)
    bias = rng.standard_normal(conv_dim, dtype=np.float32)
    jo, js = jm2._conv_prefill(jnp.asarray(xbc), jnp.asarray(st), jnp.asarray(w),
                               jnp.asarray(bias))
    to, ts = tm2._conv(torch.from_numpy(xbc), torch.from_numpy(st), torch.from_numpy(w),
                       torch.from_numpy(bias))
    assert _rel(to.numpy(), np.asarray(jo)) < 1e-5
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_gated_rms_norm_matches_jax():
    """The variance over all of d_inner (the JAX package and transformers'
    ``MambaRMSNormGated``; mamba_ssm takes it per group, PERF.md §7)."""
    rng = np.random.default_rng(3)
    y, z = (rng.standard_normal((2, 5, 128), dtype=np.float32) for _ in range(2))
    w = rng.standard_normal(128, dtype=np.float32)
    ref = jm2.gated_rms_norm(jnp.asarray(y), jnp.asarray(z), jnp.asarray(w), 1e-5)
    got = tm2.gated_rms_norm(torch.from_numpy(y), torch.from_numpy(z), torch.from_numpy(w),
                             1e-5)
    assert _rel(got.numpy(), np.asarray(ref)) < 1e-5


# ---------------------------------------------------------------------------
# The model, from tiny checkpoints on disk
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("mamba2")
    out = {}
    for i, quant in enumerate(("plain", "awq")):
        d = root / quant
        write_hf_checkpoint(d, CFG, quant=quant, group_size=32, seed=40 + i,
                            dtype="float32", weight_exp=-4)
        out[quant] = d
    return out


def _pair(d):
    jm, _ = jax_load(d, dtype="f32")
    tm, _ = load_model(d, dtype="f32", device=CPU)
    return jm, tm


@pytest.mark.parametrize("quant", ["plain", "awq"])
@pytest.mark.parametrize("t0", [64, 150])
def test_contiguous_forward_matches_jax(ckpts, quant, t0):
    """Both loaders read HF Mamba2's ``backbone.*`` layout alike, and the
    forwards agree over a prefill of 64 tokens (one chunk) or 150 (two
    chunks) and three decode steps (the step form) on the carried
    state."""
    jm, tm = _pair(ckpts[quant])
    assert tm.cfg.model_type == "mamba2" and tm.needs_ssm_state and not tm.needs_kv_cache
    toks = np.random.default_rng(7).integers(0, VOCAB, (1, t0 + 3))
    jc, tc = jm.init_cache(1, 256), tm.init_cache(1, 256)
    assert isinstance(tc, SSMState) and tc.conv.dtype == tc.ssm.dtype == torch.float32
    for lo, hi in [(0, t0), (t0, t0 + 1), (t0 + 1, t0 + 2), (t0 + 2, t0 + 3)]:
        tok, pos = toks[:, lo:hi], np.arange(lo, hi)[None]
        jl, jc = jm.forward(jnp.asarray(tok, jnp.int32), jc, jnp.asarray(pos, jnp.int32))
        tl, tc = tm.forward(torch.from_numpy(tok), tc, torch.from_numpy(pos))
        assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4, (lo, hi)
    assert int(tc.length[0]) == t0 + 3


def test_slots_forward_matches_jax(ckpts):
    """The engine's step over the state pool: two sequences prefilled alone
    on rows 2 and 0 (exact shapes), then three decode steps of the two and
    a pad row on the trash row (3): each step's logits and the pool's rows
    equal the JAX package's; the other row stays zero."""
    jm, tm = _pair(ckpts["awq"])
    tpool = tpm.init_ssm_slots(tm.cfg, 3, device=CPU)
    jpool = jpm.init_ssm_slots(jm.cfg, 3)
    assert tpool.conv.shape[1] == 4
    rng = np.random.default_rng(5)
    seqs = [rng.integers(0, VOCAB, 7), rng.integers(0, VOCAB, 12)]
    rows = [2, 0]
    no = np.zeros((1, 1), np.int64)

    def step(tok, rows_):
        b, t = tok.shape
        pos = np.zeros((b, t), np.int64)
        lens = np.ones((b,), np.int32)
        tl, _ = tpm.mamba2_forward_slots(
            tm.params, tm.cfg, torch.from_numpy(tok), tpool, torch.from_numpy(pos),
            torch.from_numpy(no), torch.from_numpy(no), torch.from_numpy(lens),
            torch.tensor(rows_))
        nonlocal jpool
        jl, jpool = jpm.mamba2_forward_slots(
            jm.params, jm.cfg, jnp.asarray(tok, jnp.int32), jpool, jnp.asarray(pos),
            jnp.asarray(no), jnp.asarray(no), jnp.asarray(lens), jnp.asarray(rows_))
        assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4
        return tl

    nxt = []
    for s, r in zip(seqs, rows):
        nxt.append(int(step(s[None], [r])[0, -1].argmax()))
    for _ in range(3):
        out = step(np.array([[nxt[0]], [nxt[1]], [0]]), [2, 0, 3])
        nxt = [int(out[0, -1].argmax()), int(out[1, -1].argmax())]
    for r in rows:
        assert _rel(tpool.ssm[:, r].numpy(), np.asarray(jpool.ssm[:, r])) < 1e-5
        assert _rel(tpool.conv[:, r].numpy(), np.asarray(jpool.conv[:, r])) < 1e-5
    assert not tpool.ssm[:, 1].any() and not tpool.conv[:, 1].any()
    assert tpool.length.tolist()[:3] == [15, 0, 10]


def test_gguf_matches_jax(tmp_path):
    """A mamba2 GGUF file (Q8_0 in_proj and out_proj, the rest F32) loads
    into both packages alike, its config from the metadata."""
    f = tmp_path / "mamba2.gguf"
    write_gguf_recurrent(f, CFG, "Q8_0", seed=4)
    tm, _ = load_model(f, dtype="f32", device=CPU)
    jm, _ = jax_load(f, dtype="f32")
    assert tm.cfg.to_dict() == jm.cfg.to_dict()
    assert tm.params["layers"][0]["in_proj"].fmt == "ggml_q8_0"
    toks = np.random.default_rng(0).integers(0, VOCAB, (1, 24))
    jl, _ = jm.forward(jnp.asarray(toks, jnp.int32), jm.init_cache(1, 32),
                       jnp.arange(24, dtype=jnp.int32)[None])
    tl, _ = tm.forward(torch.from_numpy(toks), tm.init_cache(1, 32), torch.arange(24)[None])
    assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

PROMPTS = [[5, 9, 17], list(range(1, 21)), [7] * 150]


def _app(cls, cfg, max_batch=4):
    a = cls(model=cfg)
    a.inference.max_seq_len = 256
    a.inference.max_batch_size = max_batch
    return a


def test_executor_greedy_matches_jax(ckpts):
    """Prompts of 3, 20 and 150 tokens (exact power-of-two pieces, the last
    through the chunked scan): the JAX executor's streams; the executor's
    reused cache is zeroed between generations."""
    jm, tm = _pair(ckpts["awq"])
    ref = [[e.token_id for e in JExecutor(jm, _Tok(), JApp(model=jm.cfg)).generate(
        p, JGen(max_tokens=8, temperature=0.0))] for p in PROMPTS]
    ex = Executor(tm, _Tok(), _app(AppConfig, tm.cfg))
    got = [[e.token_id for e in ex.generate(p, GenerationConfig(max_tokens=8,
                                                                temperature=0.0))]
           for p in PROMPTS]
    assert got == ref and all(len(s) == 8 for s in got)
    assert ex._session is None and len(ex._free) == 1


WAVES = [[[5, 9, 17], [100, 3, 3, 7, 200, 11]], [[42] * 20, list(range(1, 150))]]


def test_batch_engine_greedy_matches_jax_and_executor(ckpts):
    """Two staggered waves on the state pool (the second joins running
    decode rows): the JAX engine's streams, and the port's Executor's."""
    jm, tm = _pair(ckpts["awq"])
    greedy = dict(max_tokens=8, temperature=0.0)
    ref = asyncio.run(_serve(JEngine(jm, _Tok(), _app(JApp, jm.cfg)), WAVES,
                             lambda: JGen(**greedy)))
    eng = BatchEngine(tm, _Tok(), _app(AppConfig, tm.cfg))
    assert eng.prefix_cache is None and eng._needs_state_rows
    got = asyncio.run(_serve(eng, WAVES, lambda: GenerationConfig(**greedy)))
    assert got == ref and all(len(s) == 8 for s in got)
    ex = Executor(tm, _Tok(), _app(AppConfig, tm.cfg))
    assert got == [[e.token_id for e in ex.generate(p, GenerationConfig(**greedy))]
                   for w in WAVES for p in w]
    assert sorted(eng._free_rows) == [0, 1, 2, 3] and not eng._seq_rows


def test_concurrent_matches_sequential(ckpts):
    """The state rows isolate sequences: five requests at once on a pool of
    four rows (one waits for a row) give the streams each gives alone."""
    tm, _ = load_model(ckpts["plain"], dtype="f32", device=CPU)
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5], [42, 43, 44, 45], [7] * 33, [11, 12]]
    greedy = dict(max_tokens=10, temperature=0.0)
    alone = [asyncio.run(_serve(BatchEngine(tm, _Tok(), _app(AppConfig, tm.cfg)), [[p]],
                                lambda: GenerationConfig(**greedy)))[0] for p in prompts]
    eng = BatchEngine(tm, _Tok(), _app(AppConfig, tm.cfg))
    together = asyncio.run(_serve(eng, [prompts], lambda: GenerationConfig(**greedy)))
    assert together == alone


def test_prefill_zeroes_a_reused_row(ckpts):
    """A row is zeroed when a sequence's prefill starts at token 0: a pool
    full of another state serves the streams of a clean one, and pad decode
    rows write only the trash row."""
    tm, _ = load_model(ckpts["plain"], dtype="f32", device=CPU)
    greedy = dict(max_tokens=6, temperature=0.0)
    waves = [[[3, 1, 4], [1, 5, 9, 2, 6]]]
    clean = asyncio.run(_serve(BatchEngine(tm, _Tok(), _app(AppConfig, tm.cfg)), waves,
                               lambda: GenerationConfig(**greedy)))
    eng = BatchEngine(tm, _Tok(), _app(AppConfig, tm.cfg))
    eng.warmup()
    eng.cache.conv.fill_(0.5)
    eng.cache.ssm.fill_(3.0)
    eng.cache.conv[:, 4].fill_(7.0)                 # the trash row
    assert asyncio.run(_serve(eng, waves, lambda: GenerationConfig(**greedy))) == clean
    used = [r for r in range(4) if not torch.all(eng.cache.ssm[:, r] == 3.0)]
    assert len(used) == 2                            # rows of the two sequences only
