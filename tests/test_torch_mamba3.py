"""Port parity: the Mamba3 mixer of blazr_tpu_torch (``models/mamba2.py``'s
``_mamba3_mixer``, the widened conv-state buffer of ``kvcache/ssm_state.py``)
against blazr_tpu on the CPU.

Checkpoints: ``tests/test_mamba3.py``'s writer (hidden 64, 2 layers, d_inner
128, 8 heads of 16, state 16, 2 groups; f32 safetensors from numpy seeds)
under its flag sets: the rotational state with the trapezoid, the conv, MIMO
rank 2, no rotation, no trapezoid, and all on. Both packages read each
directory with ``load_model``; the JAX forwards run once a module.

Tolerances: logits within 1e-4 of their largest (f32; the port's scan is the
step form at one token and the chunked SSD form above, the JAX one its
associative scan); a prefill split into a chunk and single-token steps
within 2e-4 of the one-call prefill (``tests/test_mamba3.py``'s own bound);
greedy streams exactly equal."""

import asyncio

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.loader import load_model as jax_load
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.config.model_config import universal_from_hf_config
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.kvcache.ssm_state import init_ssm_state
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.models import mamba2 as tm2

from test_mamba3 import G_STATE, HD, INNER, NH, N, _write_mamba3
from test_torch_engine import _Tok, _serve

CPU = "cpu"
FLAGS = {"rot+trap": dict(), "conv": dict(use_conv=True), "mimo2": dict(mimo_rank=2),
         "no-rot": dict(complex_rope=False, with_omega=False), "no-lam": dict(with_lam=False),
         "all": dict(mimo_rank=2, use_conv=True)}
TOKENS = np.random.default_rng(1).integers(0, 256, (2, 12)).astype(np.int32)
POS = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
PROMPTS = [[int(t) for t in np.random.default_rng(6).integers(1, 250, 8)] for _ in range(3)]
WAVES = [PROMPTS[:2], PROMPTS[2:]]


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _gen():
    return GenerationConfig(max_tokens=5, temperature=0.0, repeat_penalty=1.0)


def _app(cls, cfg):
    a = cls(model=cfg)
    a.inference.max_seq_len = 64
    a.inference.max_batch_size = 4
    return a


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {}
    for name, kw in FLAGS.items():
        d = tmp_path_factory.mktemp(name.replace("+", "_"))
        _write_mamba3(d, np.random.default_rng(3), **kw)
        out[name] = d
    return out


@pytest.fixture(scope="module")
def jax_runs(ckpts):
    """Per flag set: the JAX model's logits over TOKENS and its state's
    shapes; for the default set, the JAX BatchEngine's greedy streams."""
    out = {}
    for name, d in ckpts.items():
        jm, _ = jax_load(d, dtype="f32")
        state = jm.init_cache(2, 32)
        logits, state = jm.forward(jnp.asarray(TOKENS), state, jnp.asarray(POS))
        out[name] = (np.asarray(logits), tuple(state.conv.shape), tuple(state.ssm.shape),
                     np.asarray(state.conv), np.asarray(state.ssm))
    jm, _ = jax_load(ckpts["rot+trap"], dtype="f32")
    out["engine"] = asyncio.run(_serve(
        JEngine(jm, _Tok(), _app(JApp, jm.cfg)), WAVES,
        lambda: JGen(max_tokens=5, temperature=0.0, repeat_penalty=1.0)))
    return out


@pytest.mark.parametrize("name", list(FLAGS))
def test_logits_and_state_match_jax(ckpts, jax_runs, name):
    """One 12-token prefill of two rows: logits at 1e-4 of JAX's, and the
    state (the conv buffer with its (x|B) carry column, the SSM state) in
    the JAX layout and values."""
    tm, app = load_model(ckpts[name], dtype="f32", device=CPU)
    assert app.model.ssm.variant == "mamba3"
    state = tm.init_cache(2, 32)
    logits, state = tm.forward(torch.from_numpy(TOKENS).long(), state,
                               torch.from_numpy(POS.copy()).long())
    jl, conv_shape, ssm_shape, jconv, jssm = jax_runs[name]
    assert _rel(logits, jl) < 1e-4
    assert tuple(state.conv.shape) == conv_shape and tuple(state.ssm.shape) == ssm_shape
    np.testing.assert_allclose(state.conv.numpy(), jconv, rtol=0,
                               atol=1e-4 * np.abs(jconv).max())
    np.testing.assert_allclose(state.ssm.numpy(), jssm, rtol=0,
                               atol=1e-4 * np.abs(jssm).max())


def test_conv_buffer_widths():
    """conv_dim (x|B|C) widened by the MIMO rank; one carry column, after
    the k-1 window columns when the conv is on (JAX ssm_state.py:45-55)."""
    base = {"model_type": "mamba3", "vocab_size": 256, "hidden_size": 64,
            "num_hidden_layers": 2, "state_size": N, "expand": 2, "conv_kernel": 4,
            "n_groups": 2, "num_heads": NH, "head_dim": HD}
    for rank, conv, shape in ((0, False, (INNER + 2 * G_STATE, 1)),
                              (2, False, (2 * INNER + 3 * G_STATE, 1)),
                              (2, True, (2 * INNER + 3 * G_STATE, 4))):
        cfg = universal_from_hf_config(dict(base, mamba3_mimo_rank=rank,
                                            mamba3_use_conv=conv))
        st = init_ssm_state(cfg, 3, device=CPU)
        assert tuple(st.conv.shape) == (2, 3) + shape


@pytest.mark.parametrize("name", ["rot+trap", "all"])
def test_decode_matches_prefill(ckpts, name, monkeypatch):
    """A 7-token prefill then 5 single-token steps equal the one-call
    prefill: the trapezoid's carry, the rotation frame and the conv window
    cross call boundaries. The chunked form with chunks of 4 equals one
    chunk."""
    tm, _ = load_model(ckpts[name], dtype="f32", device=CPU)
    toks, pos = torch.from_numpy(TOKENS).long(), torch.from_numpy(POS.copy()).long()
    full, s_full = tm.forward(toks, tm.init_cache(2, 32), pos)
    state = tm.init_cache(2, 32)
    pieces = [tm.forward(toks[:, :7], state, pos[:, :7])[0]]
    for t in range(7, 12):
        pieces.append(tm.forward(toks[:, t:t + 1], state, pos[:, t:t + 1])[0])
    inc = torch.cat(pieces, dim=1)
    assert (inc - full).abs().max() < 2e-4
    assert (state.ssm - s_full.ssm).abs().max() < 2e-4
    monkeypatch.setattr(tm2, "_CHUNK", 4)
    chunked, _ = tm.forward(toks, tm.init_cache(2, 32), pos)
    assert (chunked - full).abs().max() < 2e-4


def test_features_are_live(ckpts, jax_runs):
    """The trapezoid, the rotation and the rank each change the logits (as
    in the JAX package, where the same flags move them)."""
    base = jax_runs["rot+trap"][0]
    for other in ("no-lam", "no-rot", "mimo2"):
        assert _rel(jax_runs[other][0], base) > 1e-3


def test_engines_serve_mamba3(ckpts, jax_runs):
    """Three greedy prompts in two waves: the port's BatchEngine (its state
    rows) gives the JAX BatchEngine's streams, and the Executor each
    prompt's same stream."""
    tm, _ = load_model(ckpts["rot+trap"], dtype="f32", device=CPU)
    got = asyncio.run(_serve(BatchEngine(tm, _Tok(), _app(AppConfig, tm.cfg)), WAVES, _gen))
    assert got == jax_runs["engine"] and all(len(s) == 5 for s in got)
    ex = Executor(tm, _Tok(), _app(AppConfig, tm.cfg))
    assert [[e.token_id for e in ex.generate(p, _gen())] for p in PROMPTS] == got
