"""Port parity: expert parallelism and ring attention
(``blazr_tpu_torch/parallel/ep.py``, ``ring_attention.py``) against
``blazr_tpu/parallel`` on the conftest's 8-device CPU mesh.

  * ``make_dispatch`` equals the JAX one exactly (the overflow and the
    adversarial cases of ``tests/test_ep_ring.py``): dispatch, combine and
    the dropped count, so the same (token, choice) pairs are dropped;
  * ``ring_attention`` over 4 gloo ranks within 1e-5 of the JAX
    ``ring_attention`` on a 4-device sp mesh, with and without a window
    (``ring_hops`` < 4), and with grouped kv heads;
  * ``moe_ffn_ep`` over ep 2 and ep 2 x tp 2 ranks within 1e-5 of the JAX
    ``moe_ffn_ep`` at a capacity that drops, with the same drop count;
  * the Executor and BatchEngine at sp 2, sp 2 x tp 2, ep 2 and ep 2 x tp 2:
    f32 logits within 1e-4 of the largest and greedy tokens equal to the
    JAX engines under the same mesh.
"""

import asyncio
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.config import MoeConfig as JMoe
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.loader import load_model as jax_load
from blazr_tpu.parallel import MeshConfig as JMeshConfig
from blazr_tpu.parallel import make_mesh as jmake_mesh
from blazr_tpu.parallel.ep import make_dispatch as jmake_dispatch
from blazr_tpu.parallel.ep import moe_ffn_ep as jmoe_ffn_ep
from blazr_tpu.parallel.ring_attention import ring_attention as jring
from blazr_tpu.parallel.ring_attention import ring_hops as jring_hops

from blazr_tpu_torch.config.model_config import MoeConfig
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.parallel.ep import make_dispatch, moe_ffn_ep
from blazr_tpu_torch.parallel.ring_attention import (reference_causal_attention,
                                                     ring_hops)
from blazr_tpu_torch.utils.synthetic import (mixtral_8x7b_config, tiny_llama_config,
                                             write_hf_checkpoint)
from torch_ranks import Tok, run_ranks

H, E, I_MOE = 32, 8, 48


@pytest.mark.parametrize("case", ["basic", "overflow", "adversarial", "top2_spread"])
def test_make_dispatch_equals_jax(case):
    """blazr_tpu.parallel.ep.make_dispatch: the same slots (cumsum over
    tokens), the same kept pairs, the same combine weights and drops."""
    rng = np.random.default_rng(5)
    if case == "basic":
        idx, e, cap = np.array([[0, 1], [1, 2], [1, 0]]), 4, 2
    elif case == "overflow":                      # every token to expert 2
        idx, e, cap = np.full((8, 1), 2), 4, 3
    elif case == "adversarial":                   # a hot pair, a cold tail
        idx, e, cap = np.array([[3, 1]] * 9 + [[0, 2]] * 3), 4, 4
    else:
        idx, e, cap = rng.integers(0, 8, (24, 2)), 8, 8
        idx[:, 1] = (idx[:, 0] + 1 + rng.integers(0, 7, 24)) % 8
    w = rng.random(idx.shape).astype(np.float32)
    jd, jc, jdrop = jmake_dispatch(jnp.asarray(idx), jnp.asarray(w), e, cap)
    td, tc, tdrop = make_dispatch(torch.from_numpy(idx), torch.from_numpy(w), e, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tdrop) == int(jdrop)


@pytest.mark.parametrize("p,s,w", [(4, 64, None), (4, 64, 20), (4, 64, 16), (2, 8, 1),
                                   (8, 1024, 4096)])
def test_ring_hops_equal_jax(p, s, w):
    assert ring_hops(p, s, w) == jring_hops(p, s, w)


def _moe_params(rng):
    f = lambda *s: (rng.standard_normal(s).astype(np.float32) * 0.1)  # noqa: E731
    return {"router": f(H, E), "correction_bias": None, "experts_gate": f(E, H, I_MOE),
            "experts_up": f(E, H, I_MOE), "experts_down": f(E, I_MOE, H)}


@pytest.fixture(scope="module")
def ring_moe_ranks(tmp_path_factory):
    """One world of 4 ranks for the ring (sp 4) and ep 2 x tp 2 MoE; one of 2
    for ep 2 MoE."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    ring_in = {"q": q, "k": k, "v": v, "windows": [None, 20, 8]}
    p = _moe_params(rng)
    x = rng.standard_normal((2, 12, H)).astype(np.float32)
    moe = MoeConfig(num_experts=E, experts_per_tok=2, norm_topk_prob=True)
    tcfg = dataclasses.replace(tiny_llama_config(), hidden_size=H, moe=moe,
                               intermediate_size=I_MOE)
    tp_ = {key: (torch.from_numpy(val) if val is not None else None) for key, val in p.items()}
    base = {"p": tp_, "x": x, "moe": moe, "cfg": tcfg, "vocab": 8, "capacities": [8, 4]}
    out = {"ring_in": ring_in, "moe_in": (p, x)}
    out["ring"] = run_ranks("ring", 4, ring_in, tmp_path_factory.mktemp("ring"))
    out["ep2tp2"] = run_ranks("moe_ep", 4, dict(base, mesh={"ep": 2, "tp": 2}),
                              tmp_path_factory.mktemp("ep2tp2"))
    out["ep2"] = run_ranks("moe_ep", 2, dict(base, mesh={"ep": 2}),
                           tmp_path_factory.mktemp("ep2"))
    return out


@pytest.mark.parametrize("window", [None, 20, 8])
def test_ring_attention_matches_jax(ring_moe_ranks, window):
    """blazr_tpu.parallel.ring_attention.ring_attention on a 4-device sp
    mesh (k/v repeated to every head there): the port's 4 ranks' blocks,
    concatenated, within 1e-5; and the dense reference alike."""
    inp = ring_moe_ranks["ring_in"]
    q, k, v = inp["q"], inp["k"], inp["v"]
    mesh = jmake_mesh(JMeshConfig(sp=4))
    rep = q.shape[2] // k.shape[2]
    want = np.asarray(jring(jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=2)),
                            jnp.asarray(np.repeat(v, rep, axis=2)), mesh,
                            sliding_window=window))
    got = np.concatenate([r[str(window)] for r in ring_moe_ranks["ring"]], axis=1)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    dense = reference_causal_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                       sliding_window=window).numpy()
    assert np.abs(got - dense).max() <= 1e-5 * max(1.0, np.abs(dense).max())


@pytest.mark.parametrize("mesh", ["ep2", "ep2tp2"])
@pytest.mark.parametrize("cap", [8, 4])
def test_moe_ffn_ep_matches_jax(ring_moe_ranks, mesh, cap):
    """blazr_tpu.parallel.ep.moe_ffn_ep at capacity 8 (24 pairs over 8
    experts) and 4 (drops): every rank's output within 1e-5 of the largest,
    and the same dropped count (DROPPED_TOKENS)."""
    p, x = ring_moe_ranks["moe_in"]
    jp = {k: (jnp.asarray(v) if v is not None else None) for k, v in p.items()}
    jmoe = JMoe(num_experts=E, experts_per_tok=2, norm_topk_prob=True)
    want = np.asarray(jmoe_ffn_ep(jnp.asarray(x), jp, jmoe, capacity=cap))
    from blazr_tpu.models.moe import route as jroute
    idx, _ = jroute(jnp.asarray(x).reshape(-1, H), jp["router"], jmoe, None)
    drops = int(jmake_dispatch(idx, jnp.ones(idx.shape), E, cap)[2])
    for r in ring_moe_ranks[mesh]:
        got, dropped = r[str(cap)]
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        assert dropped == drops
    if cap == 4:
        assert drops > 0


# ---------------------------------------------------------------------------
# sp and ep through the engines
# ---------------------------------------------------------------------------

PROMPTS = [list(np.random.default_rng(2).integers(0, 256, 40)), [5, 9, 17, 3, 8, 1] * 6]
WAVES = [[PROMPTS[0], [100, 3, 3, 7, 200, 11]], [PROMPTS[1]]]
N = 5


def _mixtral():
    cfg = mixtral_8x7b_config()
    att = dataclasses.replace(cfg.attention, num_heads=4, num_kv_heads=2, head_dim=16)
    moe = dataclasses.replace(cfg.moe, num_experts=4, experts_per_tok=2, intermediate_size=32)
    return dataclasses.replace(cfg, vocab_size=256, hidden_size=64, num_layers=2,
                               max_seq_len=128, intermediate_size=32, attention=att, moe=moe)


def _windowed():
    cfg = tiny_llama_config()
    cfg.attention.sliding_window = 24
    return cfg


def _japp(cfg, mesh, **inf):
    a = JApp(model=cfg)
    a.inference.max_seq_len = 64
    a.inference.max_batch_size = 4
    a.inference.tensor_parallel_size = mesh.get("tp", 1)
    a.inference.expert_parallel_size = mesh.get("ep", 1)
    a.inference.sequence_parallel_size = mesh.get("sp", 1)
    a.inference.sp_prefill_threshold = 16
    for k, v in inf.items():
        setattr(a.inference, k, v)
    return a


async def _jserve(eng, waves, n):
    task = asyncio.create_task(eng.run())
    streams = []
    for wave in waves:
        handles = [eng.submit([int(t) for t in p], JGen(max_tokens=n, temperature=0.0))
                   for p in wave]
        firsts = [await asyncio.wait_for(h.queue.get(), timeout=300) for h in handles]
        streams.append((handles, firsts))
    out = []
    for handles, firsts in streams:
        async def collect(h):
            return [t.token_id async for t in h.tokens()]
        rest = await asyncio.gather(*[collect(h) for h in handles])
        out += [[f[0].token_id] + r for f, r in zip(firsts, rest)]
    eng.stop()
    await task
    return out


def _jax_refs(path, mesh):
    jm, _ = jax_load(path, dtype="f32")
    ex = JExecutor(jm, Tok(), _japp(jm.cfg, mesh))
    last, _ = ex.prefill(ex.model.init_cache(1, ex.capacity), [int(t) for t in PROMPTS[0]])
    toks = [[t.token_id for t in ex.generate([int(x) for x in p], JGen(
        max_tokens=N, temperature=0.0))] for p in PROMPTS]
    jm2, _ = jax_load(path, dtype="f32")
    be = asyncio.run(_jserve(JEngine(jm2, Tok(), _japp(jm2.cfg, mesh)), WAVES, N))
    return {"logits": np.asarray(last, np.float32), "ex": toks, "be": be}


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    """Checkpoints of a windowed tiny llama (window 24: the ring's hops
    stop short) and a tiny Mixtral; the JAX engines under sp 2 and ep 2; the
    port's ranks at sp 2 and ep 2 (one world of 2), sp 2 x tp 2 and
    ep 2 x tp 2 (one world of 4)."""
    root = tmp_path_factory.mktemp("sp_ep")
    paths = {"llama": root / "llama", "mixtral": root / "mixtral"}
    write_hf_checkpoint(paths["llama"], _windowed(), quant="awq", group_size=16, seed=4,
                        dtype="float32")
    write_hf_checkpoint(paths["mixtral"], _mixtral(), quant="awq", group_size=16, seed=6,
                        dtype="float32", weight_exp=-4)
    refs = {"sp": _jax_refs(paths["llama"], {"sp": 2}),
            "ep": _jax_refs(paths["mixtral"], {"ep": 2})}

    def case(kind, mesh):
        m, _ = load_model(paths["llama" if kind == "sp" else "mixtral"], dtype="f32",
                          device="cpu")
        inf = {"sp_prefill_threshold": 16}
        return {"cfg": m.cfg, "params": m.params, "mesh": mesh, "n": N,
                "prompts": [[int(t) for t in p] for p in PROMPTS],
                "waves": [[[int(t) for t in p] for p in w] for w in WAVES],
                "logit_prompt": [int(t) for t in PROMPTS[0]], "ex_inf": inf, "inf": inf}

    runs = {}
    two = {"sp2": case("sp", {"sp": 2}), "ep2": case("ep", {"ep": 2})}
    res = run_ranks("engines", 2, {"cases": two}, root / "w2")
    runs.update({k: [r[k] for r in res] for k in two})
    four = {"sp2tp2": case("sp", {"sp": 2, "tp": 2}), "ep2tp2": case("ep", {"ep": 2, "tp": 2})}
    res = run_ranks("engines", 4, {"cases": four}, root / "w4")
    runs.update({k: [r[k] for r in res] for k in four})
    return refs, runs


@pytest.mark.parametrize("name", ["sp2", "sp2tp2", "ep2", "ep2tp2"])
def test_engines_under_sp_and_ep_match_jax(engine_runs, name):
    """blazr_tpu.engine.executor.Executor and batch_engine.BatchEngine under
    sequence_parallel_size 2 (ring prefill of prompts from 16 tokens, then
    decode over the gathered K/V) and expert_parallel_size 2: the prefill
    logits within 1e-4 of the largest and the greedy tokens equal, on every
    rank."""
    refs, runs = engine_runs
    ref = refs[name[:2]]
    for r in runs[name]:
        assert np.abs(r["logits"] - ref["logits"]).max() <= 1e-4 * np.abs(ref["logits"]).max()
        assert r["ex_tokens"] == ref["ex"]
        assert r["be_tokens"] == ref["be"]
        if name.startswith("sp"):
            assert r["sp_prefills"] == 2         # the two prompts of 40 and 36 tokens
