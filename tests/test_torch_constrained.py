"""Port parity: constrained decoding (GBNF grammars, JSON mode, JSON
schemas; the DFA and exact-PDA tiers) and the host samplers (mirostat,
DRY, typical-p, dynamic temperature) served by blazr_tpu_torch's
BatchEngine and Executor against blazr_tpu's on the CPU, on one tiny AWQ
model (f32); tests/test_torch_server.py holds the HTTP replies. Greedy and seeded streams must be equal token
for token: the host samplers draw from the same numpy generators, and the
grammar rows are greedy (the port's device sampler draws other bits than
JAX's threefry, ROADMAP §C)."""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.tokenizer.byte_tok import ByteTokenizer as JByteTok
from blazr_tpu.utils.synthetic import synth_llama_params as jax_synth
from blazr_tpu.utils.synthetic import synth_model, tiny_llama_config as jax_tiny
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.engine.grammar import INVALID_STATE, GrammarState, compile_grammar_to_dfa
from blazr_tpu_torch.engine.grammar_pda import PdaGrammarState
from blazr_tpu_torch.models.registry import Model
from blazr_tpu_torch.tokenizer.byte_tok import ByteTokenizer
from blazr_tpu_torch.utils.synthetic import tiny_llama_config
from test_torch_grammar import ensure_jax_pda


@pytest.fixture(autouse=True, scope="module")
def _jax_pda_loaded():
    """The JAX grammars here reach its PDA library: make sure it is loaded
    (``test_torch_grammar.ensure_jax_pda``)."""
    ensure_jax_pda()


DIGITS = 'root ::= [0-9]+ ("," [0-9]+)*'
DEEP = 'root ::= e\ne ::= "(" e ")" | "[" e "]" | "{" e "}" | "x"\n'
SCHEMA = {"type": "object", "properties": {"answer": {"enum": ["yes", "no"]},
                                           "n": {"type": "integer"}},
          "required": ["answer", "n"]}

# One request of each kind; the JAX and port GenerationConfigs take the
# same keywords.
KINDS = {
    "gbnf": dict(max_tokens=8, temperature=0.0, grammar=DIGITS),
    "yes_no": dict(max_tokens=6, temperature=0.0, grammar='root ::= "yes" | "no"'),
    "json_mode": dict(max_tokens=10, temperature=0.0, json_mode=True),
    "json_schema": dict(max_tokens=12, temperature=0.0, json_schema=SCHEMA),
    "pda": dict(max_tokens=8, temperature=0.0, grammar=DEEP),
    "mirostat": dict(max_tokens=8, temperature=0.9, mirostat=2, seed=3),
    "dry": dict(max_tokens=8, temperature=0.8, dry_multiplier=0.8, seed=4),
    "typical": dict(max_tokens=8, temperature=1.0, typical_p=0.6, seed=5),
    "dynatemp": dict(max_tokens=8, temperature=0.9, dynatemp_range=0.5, seed=6),
    "host_and_grammar": dict(max_tokens=8, temperature=0.9, mirostat=2, seed=7,
                             grammar=DIGITS),
}
FREE = dict(max_tokens=9, temperature=0.0)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny()
    jmodel = synth_model(jcfg, quant="dense", dtype=jnp.float32)
    jmodel.params = jax_synth(jcfg, quant="awq", dtype=jnp.float32, group_size=32, seed=3)
    tparams = params_from_jax(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    return jmodel, Model(tiny_llama_config(), tparams, torch.float32)


def _app(cls, cfg, horizon):
    a = cls(model=cfg)
    a.inference.max_seq_len = 64
    a.inference.max_batch_size = 4
    a.inference.decode_horizon = horizon
    return a


async def _collect(handle):
    return [t.token_id async for t in handle.tokens()]


def _serve(engine, prompts, kws, gen_cls):
    """Every request submitted at once (one wave); streams in order."""
    async def main():
        task = asyncio.create_task(engine.run())
        handles = [engine.submit(list(p), gen_cls(**kw)) for p, kw in zip(prompts, kws)]
        out = [await asyncio.wait_for(_collect(h), 120) for h in handles]
        engine.stop()
        await task
        return out
    return asyncio.run(main())


def _both(models, horizon, prompts, kws):
    jmodel, tmodel = models
    want = _serve(JEngine(jmodel, JByteTok(), _app(JApp, jmodel.cfg, horizon)),
                  prompts, kws, JGen)
    eng = BatchEngine(tmodel, ByteTokenizer(), _app(AppConfig, tmodel.cfg, horizon))
    return want, _serve(eng, prompts, kws, GenerationConfig), eng


PROMPTS = [[11, 12, 13], [1, 2], [40, 41, 42, 43]]


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_engine_streams_match_jax(models, kind, horizon):
    """A wave of the constrained or host-sampled request between two free
    greedy rows: every stream equals the JAX engine's."""
    kws = [FREE, KINDS[kind], dict(FREE, max_tokens=6)]
    want, got, _ = _both(models, horizon, PROMPTS, kws)
    assert got == want
    assert all(got)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_executor_streams_match_jax(models, kind):
    jmodel, tmodel = models
    jx = JExecutor(jmodel, JByteTok(), JApp(model=jmodel.cfg))
    tx = Executor(tmodel, ByteTokenizer(), AppConfig(model=tmodel.cfg))
    want = [t.token_id for t in jx.generate([5, 6, 7, 8], JGen(**KINDS[kind]))]
    got = [t for t in tx.generate([5, 6, 7, 8], GenerationConfig(**KINDS[kind]))]
    assert [t.token_id for t in got] == want
    host = "mirostat" in KINDS[kind] or kind in ("dry", "typical", "dynatemp")
    assert all((t.logprob is None) == host for t in got)


def test_grammar_replies_are_accepted(models):
    """Greedy replies under each grammar tier stay inside the grammar; one
    that finished on EOS is complete, and the schema's reply parses."""
    _, tmodel = models
    tx = Executor(tmodel, ByteTokenizer(), AppConfig(model=tmodel.cfg))
    for kind in ("gbnf", "yes_no", "json_schema", "pda"):
        cfg = GenerationConfig(**dict(KINDS[kind], max_tokens=48))
        toks = [t.token_id for t in tx.generate([9, 8, 7], cfg)]
        g = tx._grammar_for(cfg)
        body = toks[:-1] if toks[-1] == 0 else toks
        assert all(g.accept_token(t) for t in body), (kind, toks)
        if toks[-1] == 0:
            assert g.is_complete
        if kind == "json_schema" and toks[-1] == 0:
            reply = json.loads(bytes(body).decode())
            assert reply["answer"] in ("yes", "no") and isinstance(reply["n"], int)
        if kind == "yes_no":
            assert bytes(body) in (b"yes", b"no") and toks[-1] == 0


def test_device_tables_match_host_walk():
    """The [S, V] tables the engine uploads agree with the per-state mask
    and byte walk of the host DFA on every state (EOS self-loops)."""
    toks = ByteTokenizer().vocab_bytes()
    dfa = compile_grammar_to_dfa(DIGITS)
    masks, nxt = dfa.token_tables(toks, eos_token_id=0)
    for s in range(dfa.num_states):
        ref = dfa.token_mask(s, toks, eos_token_id=0)
        np.testing.assert_array_equal(masks[s], ref)
        for tok in range(1, 256):
            want = dfa.advance_bytes(s, toks[tok]) if ref[tok] else INVALID_STATE
            assert nxt[s, tok] == want
        assert nxt[s, 0] == s


def test_grammar_rows_step_on_the_device(models):
    """DFA rows ride the horizon graph: one table upload, multi-step
    rounds, the streams those of horizon 1 (host masks), every token legal."""
    kws = [KINDS["gbnf"], FREE, dict(max_tokens=7, temperature=0.9, seed=3)]
    _, single, eng1 = _both(models, 1, PROMPTS, kws)
    _, multi, eng4 = _both(models, 4, PROMPTS, kws)
    assert single == multi
    assert eng4.perf["grammar_uploads_n"] == 1 and len(eng4._gram_dev) == 1
    assert eng4.horizon_steps > eng4.horizon_dispatches
    assert eng1.perf["single_step_n"] > 0 and not eng1._gram_dev
    assert all(t in b"0123456789," or t == 0 for t in multi[0])


def test_pda_row_takes_the_side_step(models):
    """An exact-PDA row (JSON mode) steps on its own T=1 side step while the
    free rows keep multi-step rounds; horizon 1 and 4 agree."""
    kws = [KINDS["json_mode"], FREE, dict(FREE, max_tokens=7)]
    _, single, _ = _both(models, 1, PROMPTS, kws)
    want, multi, eng = _both(models, 4, PROMPTS, kws)
    assert single == multi == want
    assert eng._side_steps
    assert eng.horizon_steps > eng.horizon_dispatches
    assert isinstance(eng._grammar_for(GenerationConfig(json_mode=True)), PdaGrammarState)


def test_mixed_host_sampler_batch_keeps_horizon(models):
    """A mirostat row in a mixed batch steps in the side batch; the greedy
    rows keep horizon rounds, and every row equals its solo run."""
    _, tmodel = models
    jobs = [([4, 5, 6, 7], KINDS["mirostat"]), ([10, 20, 30], FREE),
            ([11, 21, 31], FREE)]

    def run(job_list):
        eng = BatchEngine(tmodel, ByteTokenizer(), _app(AppConfig, tmodel.cfg, 4))
        return eng, _serve(eng, [p for p, _ in job_list], [k for _, k in job_list],
                           GenerationConfig)
    solo = [run([j])[1][0] for j in jobs]
    eng, mixed = run(jobs)
    assert mixed == solo
    assert eng.horizon_dispatches > 0 and eng.perf["single_step_n"] > 0


def test_grammar_for_tiers(models):
    _, tmodel = models
    eng = BatchEngine(tmodel, ByteTokenizer(), _app(AppConfig, tmodel.cfg, 4))
    assert isinstance(eng._grammar_for(GenerationConfig(grammar=DIGITS)), GrammarState)
    assert isinstance(eng._grammar_for(GenerationConfig(json_schema=SCHEMA)), GrammarState)
    assert isinstance(eng._grammar_for(GenerationConfig(grammar=DEEP)), PdaGrammarState)
    assert eng._grammar_for(GenerationConfig()) is None


def test_bad_grammar_fails_only_its_request(models):
    """A grammar that does not parse raises from submit (a ValueError, the
    server's 400) before the scheduler is touched; the engine serves on."""
    _, tmodel = models
    eng = BatchEngine(tmodel, ByteTokenizer(), _app(AppConfig, tmodel.cfg, 4))
    with pytest.raises(ValueError):
        eng.submit([1, 2], GenerationConfig(grammar="::= not a grammar ((("))
    assert not eng.scheduler.has_work and not eng._grammars
    assert _serve(eng, [[5, 6, 7]], [FREE], GenerationConfig)[0]
