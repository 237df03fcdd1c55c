"""Port parity: speculative decoding (prompt-lookup and draft-model drafts,
verified in one [B, k+1] step) in blazr_tpu_torch's BatchEngine and
Executor against blazr_tpu's on the CPU, on the tiny Llama checkpoint of
the JAX package's own speculative tests (f32; the steps run eagerly here,
as CUDA graphs on the card). Greedy streams must equal the JAX engine's
token for token, and prompt lookup's counters too; a mixed batch equals
the port's plain engine (the port's seeded draws differ from JAX's by
design, ROADMAP §C). The JAX engines run once per module and the cases
share them. The reference's draft chain never writes its last draft's K/V
(ROADMAP §C); the port's does, so an identical-weights draft accepts every
draft."""

import asyncio
import types

import numpy as np
import pytest
import torch

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.config.inference import SpeculativeDecodingConfig as JSpec
from blazr_tpu.engine import speculative as jspec
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.loader import load_model as jax_load
from blazr_tpu.server.app import STATE_KEY, AppState as JAppState
from blazr_tpu.server.app import metrics_handler as jax_metrics_handler
from blazr_tpu.config.server import ServerConfig as JServerConfig
from blazr_tpu.tokenizer.byte_tok import ByteTokenizer as JByteTok
from blazr_tpu_torch.cli import main as cli
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.config.inference import SpeculativeDecodingConfig
from blazr_tpu_torch.engine import speculative
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.kvcache.paged import PAD_BLOCK, init_paged_cache, pad_block_table
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.models import moe as tmoe
from blazr_tpu_torch.models.llama_paged import forward_paged
from blazr_tpu_torch.models.registry import Model
from blazr_tpu_torch.server import metrics as port_metrics
from blazr_tpu_torch.tokenizer.byte_tok import ByteTokenizer
from blazr_tpu_torch.utils.synthetic import (synth_llama_params, synth_recurrent_params,
                                             tiny_llama_config, tiny_recurrent_config,
                                             write_hf_checkpoint)

from fixtures import write_byte_tokenizer_json, write_tiny_llama_checkpoint
from test_torch_metrics import samples
from test_torch_moe import _tiny as tiny_moe

CPU = "cpu"
K = 4
# The JAX package's speculative tests' prompts: a repeating pattern (n-gram
# drafts hit) and a short one; 60 new tokens each.
REPEAT = [5, 6, 7, 8] * 3 + [5, 6]
PROMPTS = [REPEAT, [10, 20, 30, 40]]
N_NEW = 60


def _greedy(cls, n=N_NEW):
    return cls(max_tokens=n, temperature=0.0, repeat_penalty=1.0)


def _app(cls, cfg, spec_cls=None, k=K, **inf):
    a = cls(model=cfg)
    a.inference.max_seq_len = 96
    a.inference.max_batch_size = 4
    if spec_cls is not None:
        a.inference.speculative = spec_cls(num_speculative_tokens=k)
    for key, v in inf.items():
        setattr(a.inference, key, v)
    return a


def _serve(engine, jobs):
    """Every (prompt, config) submitted at once; the streams in order."""
    async def main():
        task = asyncio.create_task(engine.run())
        handles = [engine.submit(list(p), c) for p, c in jobs]
        out = [[t.token_id async for t in h.tokens()] for h in handles]
        engine.stop()
        await task
        return out
    return asyncio.run(main())


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("spec")
    out = {}
    for name, seed in (("target", 23), ("other", 99)):
        write_tiny_llama_checkpoint(root / name, np.random.default_rng(seed))
        write_byte_tokenizer_json(root / name)
        out[name] = root / name
    return out


@pytest.fixture(scope="module")
def port(ckpts):
    return {name: load_model(d, dtype="f32", device=CPU)[0] for name, d in ckpts.items()}


@pytest.fixture(scope="module")
def jax_runs(ckpts):
    """The JAX engine's greedy streams (plain) and prompt lookup's streams
    and counters, each engine run once."""
    jm, _ = jax_load(ckpts["target"], dtype="f32")
    jobs = [(p, _greedy(JGen)) for p in PROMPTS]
    plain = _serve(JEngine(jm, JByteTok(), _app(JApp, jm.cfg)), jobs)
    eng = JEngine(jm, JByteTok(), _app(JApp, jm.cfg, JSpec))
    lookup = _serve(eng, jobs)
    assert lookup == plain
    return dict(plain=plain, lookup=lookup, drafted=eng.spec_drafted,
                accepted=eng.spec_accepted)


def _port_engine(model, spec=True, draft=None, **inf):
    return BatchEngine(model, ByteTokenizer(),
                       _app(AppConfig, model.cfg, SpeculativeDecodingConfig if spec else None,
                            **inf), draft_model=draft)


# ---------------------------------------------------------------------------
# the drafts and the depth
# ---------------------------------------------------------------------------

_HISTORIES = {
    "repeat": REPEAT,
    "repeat, budget past the end": [1, 2, 3, 1, 2, 3, 1, 2],
    "one token": [7],
    "no match": list(range(20)),
    "random 40": np.random.default_rng(3).integers(0, 6, 40).tolist(),
    "random 200": np.random.default_rng(4).integers(0, 30, 200).tolist(),
}


@pytest.mark.parametrize("name", sorted(_HISTORIES))
@pytest.mark.parametrize("budget", [1, 5])
def test_prompt_lookup_draft_matches_jax(name, budget):
    h = _HISTORIES[name]
    assert speculative.prompt_lookup_draft(h, budget) == jspec.prompt_lookup_draft(h, budget)


def test_adapt_spec_depth_matches_jax(port):
    """The same (drafted, accepted) rounds step the same depths: up past
    80%, down below 40%, every 8 rounds that drafted, within [1, k]."""
    j = JEngine.__new__(JEngine)
    j._spec_adaptive, j._spec_k, j._spec_depth = True, 6, 6
    j._spec_win, j._spec_rounds = [0, 0], 0
    t = _port_engine(port["target"], k=6)
    rng = np.random.default_rng(5)
    rounds = [(4, 4)] * 8 + [(5, 0)] * 40 + [(0, 0)] * 3 + [(3, 3)] * 30
    rounds += [(int(d), int(rng.integers(0, d + 1))) for d in rng.integers(0, 6, 64)]
    depths = []
    for d, a in rounds:
        j._adapt_spec_depth(d, a)
        t._adapt_spec_depth(d, a)
        assert t._spec_depth == j._spec_depth
        depths.append(t._spec_depth)
    assert min(depths) == 1 and max(depths) == 6


# ---------------------------------------------------------------------------
# BatchEngine
# ---------------------------------------------------------------------------

def test_prompt_lookup_streams_and_counters_match_jax(port, jax_runs):
    eng = _port_engine(port["target"])
    got = _serve(eng, [(p, _greedy(GenerationConfig)) for p in PROMPTS])
    assert got == jax_runs["lookup"] == jax_runs["plain"]
    assert (eng.spec_drafted, eng.spec_accepted) == (jax_runs["drafted"],
                                                     jax_runs["accepted"])
    assert eng.spec_drafted > eng.spec_accepted > 0
    assert eng.perf["spec_n"] > 0


_DIGITS = 'root ::= [0-9]+ ("," [0-9]+)*'


@pytest.mark.parametrize("horizon", [1, 4])
def test_mixed_batch_equals_plain_engine(port, horizon):
    """Greedy rows draft; a seeded sampled row, a DFA-grammar row and a
    logprobs row ride position 0 with the plain step's sampling; a mirostat
    row steps on the side. Every stream, and the logprobs, equal the plain
    engine's."""
    jobs = [(REPEAT, _greedy(GenerationConfig, 24)),
            ([9, 8, 7, 6], GenerationConfig(max_tokens=10, temperature=0.8, seed=7)),
            ([40, 41, 42], GenerationConfig(max_tokens=10, temperature=0.0, grammar=_DIGITS)),
            ([1, 2, 3, 1, 2, 3], GenerationConfig(max_tokens=10, temperature=0.0,
                                                  logprobs=True, top_logprobs=3)),
            ([3, 3, 3], GenerationConfig(max_tokens=8, temperature=0.9, mirostat=2, seed=2))]

    def run(spec):
        eng = _port_engine(port["target"], spec=spec, decode_horizon=horizon)

        async def main():
            task = asyncio.create_task(eng.run())
            handles = [eng.submit(list(p), c) for p, c in jobs]
            out = [[(t.token_id, t.logprob, t.top_logprobs and
                     [(x.token_id, x.logprob) for x in t.top_logprobs])
                    async for t in h.tokens()] for h in handles]
            eng.stop()
            await task
            return out
        return asyncio.run(main()), eng

    want, _ = run(False)
    got, eng = run(True)
    assert [[t for t, _, _ in s] for s in got] == [[t for t, _, _ in s] for s in want]
    for g, w in zip(got[1:4], want[1:4]):      # the rows that ride position 0
        assert g == w
    assert eng.spec_drafted > 0 and eng.perf["spec_n"] > 0
    assert eng.perf["single_step_n"] > 0       # the mirostat row on the side


def test_identical_draft_accepts_every_draft(port, jax_runs):
    """The target's own weights as its draft, k = 4, 60 tokens: every draft
    is accepted (the reference's chain, which leaves d_k's K/V unwritten,
    accepts 90 of 115 on this run), and the streams are the JAX engine's."""
    eng = _port_engine(port["target"], draft=port["target"])
    got = _serve(eng, [(p, _greedy(GenerationConfig)) for p in PROMPTS])
    assert got == jax_runs["plain"]
    assert eng.spec_drafted > 90
    assert eng.spec_accepted == eng.spec_drafted
    assert eng.perf["draft_prefill_n"] > 0


def test_divergent_draft_gives_the_target_stream(port, jax_runs):
    eng = _port_engine(port["target"], draft=port["other"])
    got = _serve(eng, [(p, _greedy(GenerationConfig)) for p in PROMPTS])
    assert got == jax_runs["plain"]
    assert eng.spec_drafted > eng.spec_accepted


def test_draft_prefix_hits_and_host_tier_keep_drafts_exact(port):
    """An 8-block pool (as tests/test_torch_host_tier.py's): prefix A is
    served, prefix B evicts it to the host tier, A comes back restored. The
    draft's K/V travels with the target's, so an identical draft still
    accepts every draft, and the streams equal the plain engine's."""
    a, b = list(range(40, 56)), list(range(100, 156))
    waves = [[a + [1, 2]], [b + [3]], [a + [1, 2]], [a + [5]]]
    inf = dict(prefix_cache=True, gpu_prefix_cache=True, num_blocks=8, block_size=8,
               max_seq_len=64)
    out = {}
    for name, spec, draft in (("plain", False, None), ("draft", True, port["target"])):
        eng = _port_engine(port["target"], spec=spec, draft=draft, **inf)
        out[name] = [_serve(eng, [(p, _greedy(GenerationConfig, 6)) for p in w])
                     for w in waves]
    assert out["draft"] == out["plain"]
    tier = eng.prefix_cache.host_tier
    assert tier.stats.saved >= 2 and tier.stats.restored >= 2
    assert eng.prefix_cache.stats.hits > 0
    assert eng.spec_accepted == eng.spec_drafted > 0


def test_moe_verify_takes_the_decode_form(port, tmp_path, monkeypatch):
    """A tiny Mixtral (AWQ experts): the speculative stream equals the plain
    one, and the verify step never takes the routed form (its host read)."""
    write_hf_checkpoint(tmp_path, tiny_moe("mixtral"), quant="awq", group_size=32, seed=4,
                        dtype="float32", weight_exp=-4)
    model, _ = load_model(tmp_path, dtype="f32", device=CPU)
    jobs = [(REPEAT, _greedy(GenerationConfig, 16)), ([1, 2, 3, 1, 2], _greedy(GenerationConfig, 12))]
    want = _serve(_port_engine(model, spec=False), jobs)
    eng = _port_engine(model, draft=model)
    state = {"verify": False, "verify_calls": 0}
    fwd, routed = eng._fwd, tmoe._routed_expert_sum

    def watched_fwd(*a, **kw):
        state["verify"] = kw.get("verify", False)
        state["verify_calls"] += state["verify"]
        try:
            return fwd(*a, **kw)
        finally:
            state["verify"] = False

    def watched_routed(*a, **kw):
        assert not state["verify"], "the verify step took the routed form"
        return routed(*a, **kw)

    eng._fwd = watched_fwd
    monkeypatch.setattr(tmoe, "_routed_expert_sum", watched_routed)
    assert _serve(eng, jobs) == want
    assert state["verify_calls"] > 0 and eng.spec_accepted == eng.spec_drafted > 0


# ---------------------------------------------------------------------------
# the verify step's attention: B2 a position against the gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,int8", [(None, False), (5, False), (None, True), (5, True)])
def test_verify_attention_b2_route_equals_gather(window, int8):
    """forward_paged at T = k+1 with ``verify`` (B2's plain version, one query
    row a position, the row's table repeated, ``position + 1`` keys) against
    its gather form, on two rows with spans 5 and 2 over ragged tables: the
    logits of every position inside a span agree at 1e-5."""
    cfg = tiny_llama_config()
    cfg.attention.sliding_window = window
    params = synth_llama_params(cfg, quant="awq", dtype=torch.float32, group_size=32,
                                seed=6, device=CPU)
    bs, mb, k1 = 8, 4, 5
    cache = init_paged_cache(cfg.num_layers, 10, bs, 2, 16, dtype=torch.float32,
                             quantized=int8, device=CPU)
    trash = cache.trash_slot
    rng = np.random.default_rng(2)
    blocks = [[3, 0, 5], [1, 6]]
    lens = [17, 9]
    tables = torch.from_numpy(np.stack([pad_block_table(b, mb) for b in blocks]))
    # Fill the histories with a prefill, then verify k+1 positions after them.
    pre_tok = torch.from_numpy(rng.integers(0, 256, (2, 17)))
    pre_pos = torch.arange(17)[None].repeat(2, 1)
    slot_of = lambda i, p: blocks[i][p // bs] * bs + p % bs   # noqa: E731
    pre_slots = torch.tensor([[slot_of(i, p) if p < lens[i] else trash for p in range(17)]
                              for i in range(2)])
    forward_paged(params, cfg, pre_tok, cache, pre_pos, pre_slots, tables,
                  torch.tensor(lens, dtype=torch.int32), device=CPU)
    spans = [5, 2]
    pos = torch.tensor([[lens[i] + j for j in range(k1)] for i in range(2)])
    slots = torch.tensor([[slot_of(i, lens[i] + j) if j < spans[i] else trash
                           for j in range(k1)] for i in range(2)])
    tok = torch.from_numpy(rng.integers(0, 256, (2, k1)))
    seq_lens = torch.tensor([lens[i] + spans[i] for i in range(2)], dtype=torch.int32)
    got, _ = forward_paged(params, cfg, tok, cache, pos, slots, tables, seq_lens,
                           verify=True, device=CPU)
    want, _ = forward_paged(params, cfg, tok, cache, pos, slots, tables, seq_lens,
                            device=CPU)
    for i in range(2):
        np.testing.assert_allclose(got[i, :spans[i]].numpy(), want[i, :spans[i]].numpy(),
                                   rtol=0, atol=1e-5)
    assert (tables != PAD_BLOCK).sum() == 5


# ---------------------------------------------------------------------------
# the Executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["prompt_lookup", "draft"])
def test_executor_streams_match_jax(ckpts, port, kind):
    jm, _ = jax_load(ckpts["target"], dtype="f32")
    jx = JExecutor(jm, JByteTok(), JApp(model=jm.cfg))
    tx = Executor(port["target"], ByteTokenizer(), AppConfig(model=port["target"].cfg))
    if kind == "prompt_lookup":
        js = jspec.PromptLookupExecutor(jx, num_speculative_tokens=K)
        ts = speculative.PromptLookupExecutor(tx, num_speculative_tokens=K)
    else:
        jd, _ = jax_load(ckpts["other"], dtype="f32")
        js = jspec.SpeculativeExecutor(JExecutor(jd, JByteTok(), JApp(model=jd.cfg)), jx,
                                       JSpec(num_speculative_tokens=K))
        ts = speculative.SpeculativeExecutor(
            Executor(port["other"], ByteTokenizer(), AppConfig(model=port["other"].cfg)),
            tx, SpeculativeDecodingConfig(num_speculative_tokens=K))
    want = [t.token_id for t in js.generate(REPEAT, _greedy(JGen, 24))]
    got = [t.token_id for t in ts.generate(REPEAT, _greedy(GenerationConfig, 24))]
    assert got == want
    plain = [t.token_id for t in tx.generate(REPEAT, _greedy(GenerationConfig, 24))]
    assert got == plain
    assert ts.stats.drafted > 0 and len(tx._free) >= 1     # the caches came back
    if kind == "prompt_lookup":
        assert (ts.stats.drafted, ts.stats.accepted) == (js.stats.drafted, js.stats.accepted)


def test_identical_draft_executor_accepts_every_draft(port):
    tx = Executor(port["target"], ByteTokenizer(), AppConfig(model=port["target"].cfg))
    dx = Executor(port["target"], ByteTokenizer(), AppConfig(model=port["target"].cfg))
    ts = speculative.SpeculativeExecutor(dx, tx, SpeculativeDecodingConfig(
        num_speculative_tokens=K, adaptive_depth=False))
    got = [t.token_id for t in ts.generate(PROMPTS[1], _greedy(GenerationConfig))]
    assert got == [t.token_id for t in tx.generate(PROMPTS[1], _greedy(GenerationConfig))]
    assert ts.stats.accepted == ts.stats.drafted > 40


# ---------------------------------------------------------------------------
# refusals, /metrics, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["target", "draft", "executor"])
def test_recurrent_state_refuses_speculation(port, where):
    cfg = tiny_recurrent_config("mamba2")
    ssm = Model(cfg, synth_recurrent_params(cfg, quant="awq", dtype=torch.float32,
                                            group_size=32, device=CPU), torch.float32)
    with pytest.raises(ValueError, match="recurrent state"):
        if where == "target":
            _port_engine(ssm)
        elif where == "draft":
            _port_engine(port["target"], draft=ssm)
        else:
            speculative.PromptLookupExecutor(Executor(ssm, ByteTokenizer()))


def test_draft_vocab_must_match(port):
    cfg = tiny_llama_config(vocab=320)
    other = Model(cfg, synth_llama_params(cfg, quant="awq", dtype=torch.float32,
                                          group_size=32, device=CPU), torch.float32)
    with pytest.raises(ValueError, match="vocab"):
        _port_engine(port["target"], draft=other)


def test_metrics_spec_gauges_follow_the_engine():
    """spec_drafted_total, spec_accepted_total, spec_acceptance_rate and
    spec_depth, as the JAX metrics handler sets them from the engine."""
    m = port_metrics.Metrics()
    engine = types.SimpleNamespace(
        scheduler=types.SimpleNamespace(stats=lambda: {
            "waiting": 0, "running": 2,
            "block_stats": {"total_blocks": 64, "allocated_blocks": 8}}),
        horizon_dispatches=0, horizon_steps=0, prefix_cache=None,
        spec_drafted=40, spec_accepted=30, _spec_depth=3)
    sched = types.SimpleNamespace(num_loaded=1, device=torch.device("cpu"))
    port_metrics.refresh(m, sched, engine)
    got = samples(m.render().decode())
    jstate = JAppState(scheduler=sched, server_cfg=JServerConfig(), batch_engine=engine,
                       user_config=object())
    resp = asyncio.run(jax_metrics_handler(types.SimpleNamespace(app={STATE_KEY: jstate})))
    want = samples(resp.body.decode())
    for key in ("spec_drafted_total", "spec_accepted_total", "spec_acceptance_rate",
                "spec_depth"):
        assert got[(f"blazr_tpu_{key}", ())] == want[(f"blazr_tpu_{key}", ())]
    assert got[("blazr_tpu_spec_acceptance_rate", ())] == 0.75


def test_cli_flags_reach_the_engine(ckpts, port, monkeypatch, capsys):
    """serve --continuous-batching --prompt-lookup / --draft-model build a
    speculating engine (the draft loaded); run --prompt-lookup and
    --draft-model print the penalty-free greedy text and an acceptance
    line; the flags without --continuous-batching, or both drafts at once,
    exit 2."""
    engines = []
    monkeypatch.setattr("blazr_tpu_torch.server.run_server",
                        lambda sched, cfg, batch_engine=None: engines.append(batch_engine))
    d = str(ckpts["target"])
    base = ["--device", "cpu", "serve", "--model", d, "--continuous-batching", "--no-warmup",
            "--dtype", "f32"]
    assert cli.main(base + ["--prompt-lookup", "--num-speculative-tokens", "3"]) == 0
    assert cli.main(base + ["--draft-model", str(ckpts["other"])]) == 0
    (a, b) = engines
    assert (a._spec_k, a._draft) == (3, None)
    assert b._spec_k == 5 and b._draft.cfg.vocab_size == 256
    assert cli.main(["--device", "cpu", "serve", "--model", d, "--prompt-lookup"]) == 2
    assert cli.main(base + ["--prompt-lookup", "--draft-model", d]) == 2
    capsys.readouterr()
    tok = ByteTokenizer()
    tx = Executor(port["target"], tok, AppConfig(model=port["target"].cfg))
    want = "".join(tok.decode([t.token_id]) for t in tx.generate(
        tok.encode("abcabcabc"), _greedy(GenerationConfig, 12)))
    run = ["--device", "cpu", "run", d, "--prompt", "abcabcabc", "-n", "12", "-t", "0",
           "--dtype", "f32", "--no-warmup"]
    for flags in (["--prompt-lookup"], ["--draft-model", str(ckpts["other"])]):
        assert cli.main(run + flags) == 0
        out = capsys.readouterr()
        assert out.out == want                  # the line ends on stderr, as in JAX
        assert "acceptance" in out.err
