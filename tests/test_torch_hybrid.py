"""Port parity: the Mamba2/attention hybrid family of blazr_tpu_torch
(``models/hybrid.py``, ``HybridPagedState`` and ``hybrid_forward_paged`` of
``models/paged_multi.py``, both engines) against blazr_tpu on the CPU.

Tiny checkpoints (``utils.synthetic.tiny_recurrent_config("bamba")``:
hidden 64, layers Mamba2 / attention (4 heads of 16 on 2 kv heads) /
Mamba2, an MLP of 96 on every layer) are written by ``write_hf_checkpoint``
in the hybrid layout the JAX package reads (``layer_types``, ``mixer.*``,
``self_attn.*``, ``mlp.*``; plain f32, or AWQ-INT4 in groups of 32) and
read by both packages' ``load_model``; inputs come from numpy seeds.

Tolerances: logits within 1e-4 of their largest magnitude (f32 in another
order); greedy streams exactly equal."""

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
from blazr_tpu.models import paged_multi as jpm
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.kvcache import paged as tpaged
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.models import paged_multi as tpm
from blazr_tpu_torch.models.hybrid import HybridState
from blazr_tpu_torch.utils.synthetic import tiny_recurrent_config, write_hf_checkpoint

from test_torch_engine import _Tok, _serve

CPU = "cpu"
VOCAB = 256
BS = 8


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("hybrid")
    out = {}
    for i, quant in enumerate(("plain", "awq")):
        d = root / quant
        write_hf_checkpoint(d, tiny_recurrent_config("bamba"), quant=quant, group_size=32,
                            seed=50 + i, dtype="float32", weight_exp=-4)
        out[quant] = d
    return out


def _pair(d):
    jm, _ = jax_load(d, dtype="f32")
    tm, _ = load_model(d, dtype="f32", device=CPU)
    return jm, tm


@pytest.mark.parametrize("quant", ["plain", "awq"])
def test_contiguous_forward_matches_jax(ckpts, quant):
    """Both loaders read the hybrid layout alike (each layer its mixer and
    its MLP), and the forwards agree over a 150-token prefill (the chunked
    scan, and attention over the KV cache) and three decode steps."""
    jm, tm = _pair(ckpts[quant])
    assert tm.cfg.layer_types() == ["mamba2", "attention", "mamba2"]
    for j, t in zip(jm.params["layers"], tm.params["layers"]):
        assert {k for k, v in t.items() if v is not None} == \
            {k for k, v in j.items() if v is not None}
    toks = np.random.default_rng(7).integers(0, VOCAB, (1, 153))
    jc, tc = jm.init_cache(1, 256), tm.init_cache(1, 256)
    assert isinstance(tc, HybridState) and tc.kv.k.shape[0] == 1 and tc.ssm.conv.shape[0] == 2
    for lo, hi in [(0, 150), (150, 151), (151, 152), (152, 153)]:
        tok, pos = toks[:, lo:hi], np.arange(lo, hi)[None]
        jl, jc = jm.forward(jnp.asarray(tok, jnp.int32), jc, jnp.asarray(pos, jnp.int32))
        tl, tc = tm.forward(torch.from_numpy(tok), tc, torch.from_numpy(pos))
        assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4, (lo, hi)


def test_paged_forward_matches_jax(ckpts):
    """The engine's step over paged KV and the state pool: two sequences
    prefilled alone (their blocks, their rows 1 and 0), then three decode
    steps of both and a pad row (the trash slot, the trash row 2; B2's
    plain version on the attention layer): the JAX package's logits."""
    jm, tm = _pair(ckpts["awq"])
    tstate = tpm.init_hybrid_paged_state(tm.cfg, 8, BS, 2, dtype=torch.float32, device=CPU)
    jstate = jpm.init_hybrid_paged_state(jm.cfg, 8, BS, 2, dtype=jnp.float32)
    trash = tstate.trash_slot
    rng = np.random.default_rng(1)
    lens, blocks, rows, mb = [7, 12], [[3, 0], [1, 6]], [1, 0], 3
    seqs = [rng.integers(0, VOCAB, n + 3) for n in lens]
    tables = [tpaged.pad_block_table(b, mb) for b in blocks]

    def step(tok, pos, slots, tabs, seq_lens, rows_, last):
        nonlocal jstate
        args = [tok, pos, slots, np.stack(tabs), np.asarray(seq_lens, np.int32)]
        tl, _ = tpm.hybrid_forward_paged(tm.params, tm.cfg, *map(torch.from_numpy, args[:1]),
                                         tstate, *map(torch.from_numpy, args[1:]),
                                         torch.tensor(rows_), last_idx=torch.tensor(last))
        jl, jstate = jpm.hybrid_forward_paged(jm.params, jm.cfg, jnp.asarray(tok, jnp.int32),
                                              jstate, *map(jnp.asarray, args[1:]),
                                              jnp.asarray(rows_), last_idx=jnp.asarray(last))
        assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4

    for s, n, b, t, r in zip(seqs, lens, blocks, tables, rows):
        step(s[None, :n], np.arange(n)[None],
             tpaged.compute_slot_mapping(b, 0, n, BS, trash).astype(np.int64)[None], [t], [n],
             [r], [n - 1])
    for j in range(3):
        pos = [n + j for n in lens]
        slots = [tpaged.compute_slot_mapping(b, p, 1, BS, trash)[0]
                 for b, p in zip(blocks, pos)] + [trash]
        step(np.array([[seqs[0][pos[0]]], [seqs[1][pos[1]]], [0]]),
             np.array([[pos[0]], [pos[1]], [0]]), np.array(slots, np.int64)[:, None],
             tables + [tpaged.pad_block_table([], mb)], [pos[0] + 1, pos[1] + 1, 0],
             rows + [2], [0, 0, 0])


PROMPTS = [[5, 9, 17], list(range(1, 21)), [7] * 150]
WAVES = [[[5, 9, 17], [100, 3, 3, 7, 200, 11]], [[42] * 20, list(range(1, 150))]]


def _app(cls, cfg):
    a = cls(model=cfg)
    a.inference.max_seq_len = 256
    a.inference.max_batch_size = 4
    return a


def test_executor_greedy_matches_jax(ckpts):
    jm, tm = _pair(ckpts["awq"])
    ref = [[e.token_id for e in JExecutor(jm, _Tok(), JApp(model=jm.cfg)).generate(
        p, JGen(max_tokens=8, temperature=0.0))] for p in PROMPTS]
    ex = Executor(tm, _Tok(), _app(AppConfig, tm.cfg))
    got = [[e.token_id for e in ex.generate(p, GenerationConfig(max_tokens=8,
                                                                temperature=0.0))]
           for p in PROMPTS]
    assert got == ref and all(len(s) == 8 for s in got)


def test_batch_engine_greedy_matches_jax_and_executor(ckpts):
    """Two staggered waves through paged KV and the state pool: the JAX
    engine's streams, and the port's Executor's."""
    jm, tm = _pair(ckpts["awq"])
    greedy = dict(max_tokens=8, temperature=0.0)
    ref = asyncio.run(_serve(JEngine(jm, _Tok(), _app(JApp, jm.cfg)), WAVES,
                             lambda: JGen(**greedy)))
    eng = BatchEngine(tm, _Tok(), _app(AppConfig, tm.cfg))
    assert isinstance(eng.cache, tpm.HybridPagedState) and eng.prefix_cache is None
    got = asyncio.run(_serve(eng, WAVES, lambda: GenerationConfig(**greedy)))
    assert got == ref and all(len(s) == 8 for s in got)
    ex = Executor(tm, _Tok(), _app(AppConfig, tm.cfg))
    assert got == [[e.token_id for e in ex.generate(p, GenerationConfig(**greedy))]
                   for w in WAVES for p in w]
