"""Port parity: the host samplers of blazr_tpu_torch (mirostat v2, DRY,
typical-p, dynamic temperature, the full host chain) and the device
sampler's grammar mask against blazr_tpu's on the CPU. Logits and
histories come from a seeded numpy generator; floats agree to 1e-6 and
tokens exactly under the same seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.engine import samplers as js
from blazr_tpu.engine.sampling import SamplingParams as JParams
from blazr_tpu.engine.sampling import sample_tokens as jax_sample
from blazr_tpu_torch.config import GenerationConfig
from blazr_tpu_torch.engine import samplers as ts
from blazr_tpu_torch.engine import sampling as tsamp

V = 300
SEEDS = [0, 1, 2, 3]


def _logits(seed: int, v: int = V) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(v) * rng.uniform(0.5, 4.0)).astype(np.float32)


def _history(seed: int, n: int = 60) -> list[int]:
    """A history with repeats, so DRY finds suffixes to penalize."""
    rng = np.random.default_rng(1000 + seed)
    base = rng.integers(0, 12, 8).tolist()
    return base * 4 + rng.integers(0, V, n - 37).tolist() + base[:5]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mult,base,allowed,breakers", [
    (0.8, 1.75, 2, None), (2.0, 2.0, 3, {3, 7}), (0.5, 1.5, 1, {0})])
def test_dry_penalty_matches_jax(seed, mult, base, allowed, breakers):
    lg, hist = _logits(seed), _history(seed)
    want = js.apply_dry_penalty(lg, hist, mult, base, allowed, breakers)
    got = ts.apply_dry_penalty(lg, hist, mult, base, allowed, breakers)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if breakers is None:
        assert (got != lg).any()                   # the history repeats


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p", [0.2, 0.7, 0.95, 1.0])
def test_typical_p_matches_jax(seed, p):
    lg = _logits(seed)
    want, got = js.apply_typical_p(lg, p), ts.apply_typical_p(lg, p)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("temp,rng_,exp", [(0.8, 0.5, 1.0), (1.2, 1.5, 2.0), (0.7, 0.0, 1.0)])
def test_dynamic_temperature_matches_jax(seed, temp, rng_, exp):
    lg = _logits(seed)
    assert ts.dynamic_temperature(lg, temp, rng_, exp) == pytest.approx(
        js.dynamic_temperature(lg, temp, rng_, exp), abs=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("temp", [0.0, 0.7, 1.3])
def test_mirostat_matches_jax(seed, temp):
    """Twelve draws of one mirostat state: tokens exact, mu to 1e-6."""
    cfg = dict(mirostat=2, mirostat_tau=4.0, mirostat_eta=0.2, seed=seed)
    jst = js.MirostatState.from_config(JGen(**cfg))
    tst = ts.MirostatState.from_config(GenerationConfig(**cfg))
    for i in range(12):
        lg = _logits(seed * 31 + i)
        assert tst.sample(lg, temp) == jst.sample(lg, temp)
        assert tst.mu == pytest.approx(jst.mu, abs=1e-6)


HOST_CFGS = {
    "mirostat": dict(mirostat=2, temperature=0.9),
    "dry": dict(dry_multiplier=0.8, temperature=0.8, top_k=40),
    "typical": dict(typical_p=0.6, temperature=1.1, min_p=0.02),
    "dynatemp": dict(dynatemp_range=0.6, temperature=0.9, top_p=0.9),
    "dry_greedy": dict(dry_multiplier=1.5, temperature=0.0, repeat_penalty=1.3,
                       frequency_penalty=0.2, presence_penalty=0.1,
                       logit_bias={5: 2.0, 9: -1.0}),
    "all": dict(mirostat=2, dry_multiplier=0.5, typical_p=0.8, dynatemp_range=0.3,
                temperature=1.0, repeat_penalty=1.1),
}


@pytest.mark.parametrize("name", sorted(HOST_CFGS))
@pytest.mark.parametrize("seed", SEEDS)
def test_host_sample_matches_jax(name, seed):
    """The whole host chain over eight steps with one generator and one
    mirostat state, history growing: tokens exact."""
    kw = dict(HOST_CFGS[name], seed=seed)
    jcfg, tcfg = JGen(**kw), GenerationConfig(**kw)
    assert ts.needs_host_sampling(tcfg) is js.needs_host_sampling(jcfg) is True
    jm = js.MirostatState.from_config(jcfg) if jcfg.mirostat == 2 else None
    tm = ts.MirostatState.from_config(tcfg) if tcfg.mirostat == 2 else None
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    hist = _history(seed)
    for i in range(8):
        lg = _logits(seed * 17 + i)
        want = js.host_sample(lg, jcfg, hist, jm, {2}, jr)
        got = ts.host_sample(lg, tcfg, hist, tm, {2}, tr)
        assert got == want
        hist.append(got)


def test_needs_host_sampling_matches_jax():
    for kw in [{}, dict(mirostat=1), dict(typical_p=0.99), dict(temperature=0.7, top_k=5),
               dict(dynatemp_range=0.1), dict(dry_multiplier=0.1)]:
        assert ts.needs_host_sampling(GenerationConfig(**kw)) == \
            js.needs_host_sampling(JGen(**kw))


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_tokens_grammar_mask_matches_jax(seed):
    """The device chain's grammar mask (after penalties and bias, before
    the temperature): greedy tokens exact, logprobs of the masked
    distribution at 1e-5; a masked-out token is never drawn by a sampled
    row."""
    rng = np.random.default_rng(seed)
    b = 4
    logits = rng.standard_normal((b, V)).astype(np.float32) * 3
    mask = rng.random((b, V)) < 0.3
    mask[:, 0] = True
    window = rng.integers(-1, V, (b, 64)).astype(np.int64)
    cfgs = [GenerationConfig(temperature=0.0, repeat_penalty=1.3, logit_bias={1: 5.0})] * b
    sp = tsamp.SamplingParams.from_config(cfgs, device="cpu")
    ids, vals = tsamp.make_bias_rows(cfgs)
    tok, lp = tsamp.sample_tokens(torch.from_numpy(logits), sp, torch.from_numpy(window),
                                  torch.from_numpy(ids), torch.from_numpy(vals),
                                  torch.from_numpy(mask))
    jsp = JParams.from_config([JGen(temperature=0.0, repeat_penalty=1.3)] * b)
    jids = np.asarray(ids, dtype=np.int32)
    jtok, jlp = jax_sample(jnp.asarray(logits), jsp, jnp.asarray(window, dtype=jnp.int32),
                           jnp.asarray(jids), jnp.asarray(vals), jnp.asarray(mask))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    fin = np.isfinite(np.asarray(jlp))
    np.testing.assert_array_equal(torch.isfinite(lp).numpy(), fin)
    np.testing.assert_allclose(lp.numpy()[fin], np.asarray(jlp)[fin], atol=1e-5)
    assert mask[np.arange(b), tok.numpy()].all()
    sp = tsamp.SamplingParams.from_config([GenerationConfig(temperature=1.5, seed=seed)] * b,
                                          step=list(range(b)), device="cpu")
    tok, _ = tsamp.sample_tokens(torch.from_numpy(logits), sp,
                                 grammar_mask=torch.from_numpy(mask))
    assert mask[np.arange(b), tok.numpy()].all()
