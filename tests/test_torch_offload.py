"""Port parity: MoE expert offload (``engine/moe_offload.py``, the offload
form of ``models/moe.py``) and layer offload (``loader/offloading.py``,
``engine/offload_stream.py``) of blazr_tpu_torch against blazr_tpu on the
CPU.

Inputs: a tiny Mixtral (hidden 64, 2 layers, 4 experts of 32, top-2,
AWQ-INT4 in groups of 32, the checkpoint ``tests/test_torch_moe.py`` writes)
and the tiny llama of ``tests/test_offload_stream.py``, both read from disk
by the two packages' ``load_model``; usage sequences from numpy seeds. The
JAX engines run once a module and every case reads their results.

Tolerances: greedy streams, resident ids, placements and transfer plans
exactly equal; the decayed usage counts within 1e-12 (the same f64
arithmetic, sums in another order); logits within 1e-4 of their largest
(f32, the cold experts' term summed on the host in another order)."""

import asyncio

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.engine import moe_offload as jmo
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.loader import load_model as jax_load
from blazr_tpu.loader import offloading as joff
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.engine import moe_offload as tmo
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.engine.offload_stream import StreamingModel
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.loader import offloading as toff
from blazr_tpu_torch.utils.synthetic import write_hf_checkpoint

from test_torch_engine import _Tok, _serve
from test_torch_moe import _tiny

CPU = "cpu"
PROMPT = [7, 21, 42]
N_TOK = 16
OFFLOAD = {"hybrid": dict(moe_offload="hybrid", moe_device_experts=2,
                          moe_rebalance_interval=2),
           "cpu": dict(moe_offload="cpu")}


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _app(cls, cfg, **inf):
    a = cls(model=cfg)
    a.inference.max_seq_len = 64
    a.inference.max_batch_size = 4
    for k, v in inf.items():
        setattr(a.inference, k, v)
    return a


@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    d = tmp_path_factory.mktemp("mixtral")
    write_hf_checkpoint(d, _tiny("mixtral"), quant="awq", group_size=32, seed=20,
                        dtype="float32", weight_exp=-4)
    return d


@pytest.fixture(scope="module")
def jax_runs(mixtral):
    """The JAX package's streams: the Executor without offload and under
    each strategy (its runtime kept), and the BatchEngine over a hybrid
    offload installed by an Executor, on two staggered waves."""
    out = {}
    jm, ja = jax_load(mixtral, dtype="f32")
    out["ref"] = [e.token_id for e in JExecutor(jm, _Tok(), _app(JApp, jm.cfg)).generate(
        PROMPT, JGen(max_tokens=N_TOK, temperature=0.0))]
    for name, inf in OFFLOAD.items():
        jm, _ = jax_load(mixtral, dtype="f32")
        ex = JExecutor(jm, _Tok(), _app(JApp, jm.cfg, **inf))
        toks = [e.token_id for e in ex.generate(PROMPT, JGen(max_tokens=N_TOK,
                                                             temperature=0.0))]
        out[name] = (toks, ex)
    jm, _ = jax_load(mixtral, dtype="f32")
    a = _app(JApp, jm.cfg, **OFFLOAD["hybrid"])
    JExecutor(jm, _Tok(), a)                      # installs the offload on jm
    out["engine"] = asyncio.run(_serve(JEngine(jm, _Tok(), a), WAVES,
                                       lambda: JGen(max_tokens=8, temperature=0.0)))
    return out


WAVES = [[[5, 9, 17], [100, 3, 3, 7, 200, 11]], [[42] * 20, list(range(1, 18))]]


def _port_executor(d, **inf):
    tm, _ = load_model(d, dtype="f32", device=CPU)
    return Executor(tm, _Tok(), _app(AppConfig, tm.cfg, **inf))


def _gen(ex, n=N_TOK):
    return [e.token_id for e in ex.generate(PROMPT, GenerationConfig(max_tokens=n,
                                                                     temperature=0.0))]


@pytest.mark.parametrize("strategy", sorted(OFFLOAD))
def test_executor_offload_matches_jax(mixtral, jax_runs, strategy):
    """Greedy tokens under ``hybrid`` (2 of 4 resident, a rebalance every 2
    passes) and ``cpu`` (1 resident) equal the JAX offload's and no
    offload's; the runtime ticked once a forward pass, and the host term ran."""
    ex = _port_executor(mixtral, **OFFLOAD[strategy])
    got = _gen(ex)
    jtoks, jex = jax_runs[strategy]
    assert got == jtoks == jax_runs["ref"]
    rt, jrt = ex._moe_rt, jex._moe_rt
    assert rt.manager.tracker.steps == jrt.manager.tracker.steps >= N_TOK
    assert rt.cold_accesses > 0 and not ex.graphs.enabled
    k = 2 if strategy == "hybrid" else 1
    assert all(len(r) == k for r in rt.resident.values())
    if strategy == "cpu":                          # never rebalanced
        assert rt.resident == {0: [0], 1: [0]} and rt.moved == 0


def test_rebalance_follows_the_jax_plan(mixtral, jax_runs):
    """After the hybrid run's rebalances, the decayed counts, the resident
    ids (in the tensor the forward reads too) and the placements equal the
    JAX manager's."""
    ex = _port_executor(mixtral, **OFFLOAD["hybrid"])
    _gen(ex)
    rt, jrt = ex._moe_rt, jax_runs["hybrid"][1]._moe_rt
    np.testing.assert_allclose(rt.manager.tracker.counts.numpy(),
                               jrt.manager.tracker.counts, rtol=0, atol=1e-12)
    assert rt.resident == jrt.resident
    assert rt.manager.placement.on_device == jrt.manager.placement.on_device
    assert rt.manager.transfers == jrt.manager.transfers > 0 and rt.moved > 0
    for layer, res in rt.resident.items():
        assert ex.model.params["layers"][layer]["moe"]["resident_ids"].tolist() == res


def test_logits_after_a_rebalance_equal_no_offload(mixtral):
    """Logits of the offloaded model after its rebalances equal the model
    without offload at 1e-4, at prefill and decode rows."""
    ex = _port_executor(mixtral, **OFFLOAD["hybrid"])
    _gen(ex)
    assert ex._moe_rt.moved > 0
    ref, _ = load_model(mixtral, dtype="f32", device=CPU)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 9)))
    pos = torch.arange(9)[None].expand(2, -1)
    for m in (ref, ex.model):
        cache = m.init_cache(2, 16)
        pre, _ = m.forward(toks[:, :8], cache, pos[:, :8])
        dec, _ = m.forward(toks[:, 8:], cache, pos[:, 8:])
        if m is ref:
            want = (pre, dec)
    assert _rel(pre, want[0]) < 1e-4 and _rel(dec, want[1]) < 1e-4


def test_batch_engine_offload_matches_jax(mixtral, jax_runs):
    """Four greedy requests in two waves through the paged engine over a
    hybrid offload (installed by the engine itself): the JAX engine's
    streams, ticked once an engine step, run eagerly."""
    tm, _ = load_model(mixtral, dtype="f32", device=CPU)
    eng = BatchEngine(tm, _Tok(), _app(AppConfig, tm.cfg, **OFFLOAD["hybrid"]))
    assert eng._moe_rt is tm.moe_offload_rt is not None and not eng.graphs.enabled
    got = asyncio.run(_serve(eng, WAVES, lambda: GenerationConfig(max_tokens=8,
                                                                  temperature=0.0)))
    assert got == jax_runs["engine"] and all(len(s) == 8 for s in got)
    assert eng._moe_rt.manager.tracker.steps > 0 and eng._moe_rt.cold_accesses > 0


def test_engines_share_one_runtime(mixtral):
    """An Executor and a BatchEngine over one model share the runtime the
    first installed (``ensure_offload``); ``close`` releases it."""
    ex = _port_executor(mixtral, **OFFLOAD["hybrid"])
    eng = BatchEngine(ex.model, _Tok(), ex.app_cfg)
    assert eng._moe_rt is ex._moe_rt is ex.model.moe_offload_rt
    ex.close()
    assert ex.model.moe_offload_rt is None and ex._moe_rt is None


def test_device_strategy_and_auto(mixtral):
    """``gpu`` keeps every expert on the device (no runtime); AUTO resolves
    as the JAX ``resolve_strategy`` does, against the device's free bytes
    (none on the CPU: every expert stays)."""
    assert _port_executor(mixtral, moe_offload="gpu")._moe_rt is None
    assert _port_executor(mixtral, moe_offload="auto")._moe_rt is None
    gib = 1 << 30
    for total, free in ((gib, None), (gib, 4 * gib), (3 * gib, 4 * gib),
                        (5 * gib, 4 * gib), (9 * gib, 4 * gib), (0, 0)):
        got = tmo.resolve_strategy(tmo.OffloadStrategy.AUTO, total, free)
        want = jmo.resolve_strategy(jmo.OffloadStrategy.AUTO, total, free)
        assert got.value == want.value
    for s in ("gpu", "cpu", "hybrid"):
        assert tmo.resolve_strategy(tmo.OffloadStrategy(s), 1, 0).value == s


def test_manager_plans_match_jax():
    """The same seeded usage through both managers (6 layers, 8 experts, 3
    resident, a rebalance every 3 passes): equal plans, placements and
    counts at every pass."""
    rng = np.random.default_rng(11)
    jm = jmo.MoeOffloadManager(6, 8, 3, rebalance_interval=3)
    tm = tmo.MoeOffloadManager(6, 8, 3, rebalance_interval=3)
    for _ in range(20):
        for layer in range(6):
            ids = rng.integers(0, 8, (int(rng.integers(1, 9)), 2))
            jm.record_usage(layer, ids)
            tm.record_usage(layer, torch.from_numpy(ids))
        assert tm.step() == jm.step()
        assert tm.placement.on_device == jm.placement.on_device
        np.testing.assert_allclose(tm.tracker.counts.numpy(), jm.tracker.counts,
                                   rtol=0, atol=1e-12)
    assert tm.transfers == jm.transfers > 0
    assert [tm.tracker.hot_set(l, 3) for l in range(6)] == \
        [jm.tracker.hot_set(l, 3) for l in range(6)]


def test_cold_cache_holds_its_cap():
    """The host term's f32 experts stay within the cache's byte cap, its
    scratch included: with room for 2 of 4 cold experts, every call's term
    equals the uncapped one, the cache keeps the first expert it meets
    beside one scratch expert, and keeps it (no eviction: each later call
    that routes to it hits); an expert above the cap is computed and not
    kept."""
    from blazr_tpu_torch.quant.qtensor import dequantize_stack_np, stack_quant
    from blazr_tpu_torch.utils.synthetic import _rand_awq_qt

    h, inter, e = 64, 32, 6
    gen = torch.Generator().manual_seed(0)
    stacks = {k: stack_quant([_rand_awq_qt(gen, a, b, group_size=32, device=CPU)
                              for _ in range(e)])
              for k, (a, b) in (("experts_gate", (h, inter)), ("experts_up", (h, inter)),
                                ("experts_down", (inter, h)))}
    one = 4 * (2 * h * inter + inter * h)              # f32 bytes of one expert

    def runtime(cap):
        rt = tmo.OffloadRuntime(tmo.MoeOffloadManager(1, e, 2), torch.device(CPU))
        rt.host[0] = stacks
        rt.cold_cache = tmo.ColdExpertCache(cap)
        return rt

    capped, free = runtime(2 * one), runtime(100 * one)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((5, h), dtype=np.float32))
    for _ in range(6):
        w = np.zeros((5, e), np.float32)
        for r in range(5):
            w[r, rng.choice(np.arange(2, e), 2, replace=False)] = rng.random(2)
        w = torch.from_numpy(w)
        assert torch.equal(capped.cold_term(0, x, w), free.cold_term(0, x, w))
        assert capped.cold_cache.bytes <= one
    cache = capped.cold_cache
    assert cache.peak_bytes == 2 * one and cache.bytes == one
    assert cache.hits == 5 and cache.misses == capped.cold_experts - 5
    assert free.cold_cache.misses == 4 and free.cold_cache.bytes == 4 * one
    dense = [torch.from_numpy(dequantize_stack_np(stacks[k], experts=[3])[0])
             for k in ("experts_gate", "experts_up", "experts_down")]
    assert all(torch.equal(a, b) for a, b in zip(free.dense_expert(0, 3), dense))
    tiny = runtime(one - 1)
    tiny.cold_term(0, x, w)
    assert tiny.cold_cache.bytes == 0 and tiny.cold_cache.misses > 0


def test_cold_cache_keeps_its_hits_over_a_layer_cycle():
    """A forward visits its layers in a cycle. Past the cap, the cache keeps
    the experts that fit and hits each of them once a cycle, where an LRU
    cache would evict every expert before its next use: 4 layers of 2 cold
    experts, room for 3 beside the scratch, 5 cycles."""
    h, inter, e, layers = 32, 16, 4, 4
    gen = torch.Generator().manual_seed(3)
    stacks = {k: torch.randn((e, a, b), generator=gen)
              for k, (a, b) in (("experts_gate", (h, inter)), ("experts_up", (h, inter)),
                                ("experts_down", (inter, h)))}
    one = 4 * 3 * h * inter
    rt = tmo.OffloadRuntime(tmo.MoeOffloadManager(layers, e, 2), torch.device(CPU))
    rt.host = {i: stacks for i in range(layers)}
    rt.cold_cache = tmo.ColdExpertCache(4 * one)
    x = torch.randn((3, h), generator=gen)
    w = torch.zeros((3, e))
    w[:, 2], w[:, 3] = 0.6, 0.4
    for _ in range(5):
        for i in range(layers):
            rt.cold_term(i, x, w)
    assert rt.cold_cache.bytes == 3 * one and rt.cold_cache.peak_bytes == 4 * one
    assert rt.cold_cache.hits == 4 * 3 and rt.cold_cache.misses == 5 * 8 - 12


@pytest.mark.parametrize("bits,signed", [(2, False), (4, True), (4, False), (8, True)])
def test_host_dequant_equals_dequantize(bits, signed):
    """``dequantize_stack_np`` (the host term's, in column blocks, into a
    given tensor or a new one) equals ``dequantize`` bit for bit."""
    import dataclasses

    from blazr_tpu_torch.quant.qtensor import (dequantize, dequantize_stack_np,
                                               expert_slice, stack_quant)
    from blazr_tpu_torch.utils.synthetic import _rand_awq_qt

    gen = torch.Generator().manual_seed(bits)
    st = stack_quant([_rand_awq_qt(gen, 128, 300, group_size=32, device=CPU)
                      for _ in range(3)])
    words = torch.randint(-2**31, 2**31 - 1, (3, 128 * bits // 32, 300), dtype=torch.int32,
                          generator=gen)
    st = dataclasses.replace(st, qweight=words, bits=bits, signed=signed)
    want = torch.stack([dequantize(expert_slice(st, i)) for i in (2, 0)])
    assert torch.equal(torch.from_numpy(dequantize_stack_np(st, experts=[2, 0])), want)
    out = torch.full((2, 128, 300), float("nan"))
    dequantize_stack_np(st, experts=[2, 0], out=out)
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# Layer offload
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    from fixtures import write_tiny_llama_checkpoint

    d = tmp_path_factory.mktemp("llama")
    write_tiny_llama_checkpoint(d, np.random.default_rng(21))
    return d


@pytest.mark.parametrize("device_layers", [0, 1])
def test_streaming_logits_match_full(llama_dir, device_layers):
    """A model with ``device_layers`` of 2 on the device: logits equal the
    full model's and the JAX streaming model's at 1e-4 over a prefill and 4
    greedy steps, with equal greedy tokens; each forward copies every host
    layer into the slots."""
    full, _ = load_model(llama_dir, dtype="f32", device=CPU)
    part, app = load_model(llama_dir, dtype="f32", device=CPU, device_layers=device_layers)
    jpart, _ = jax_load(llama_dir, dtype="f32", device_layers=device_layers)
    assert isinstance(part, StreamingModel) and len(part.host_layers) == 2 - device_layers
    assert app.inference.num_device_layers == device_layers
    toks = torch.tensor([[3, 17, 9, 40]])
    pos = torch.arange(4)[None]
    cf, cs = full.init_cache(1, 32), part.init_cache(1, 32)
    jc = jpart.init_cache(1, 32)
    lf, _ = full.forward(toks, cf, pos)
    ls, _ = part.forward(toks, cs, pos)
    lj, jc = jpart.forward(jnp.asarray(toks.numpy(), jnp.int32), jc,
                           jnp.asarray(pos.numpy(), jnp.int32))
    for i in range(5):
        assert _rel(ls, lf) < 1e-4 and _rel(ls, np.asarray(lj)) < 1e-4
        cur = int(lf[0, -1].argmax())
        assert cur == int(ls[0, -1].argmax()) == int(np.asarray(lj)[0, -1].argmax())
        if i == 4:
            break
        p = torch.tensor([[4 + i]])
        lf, _ = full.forward(torch.tensor([[cur]]), cf, p)
        ls, _ = part.forward(torch.tensor([[cur]]), cs, p)
        lj, jc = jpart.forward(jnp.asarray([[cur]], jnp.int32), jc,
                               jnp.asarray(p.numpy(), jnp.int32))
    assert part.copied_bytes == 5 * len(part.host_layers) * part.layer_bytes


def test_streaming_executor_matches_jax(llama_dir):
    """The Executor serves a streaming model (eagerly) with the JAX
    streaming Executor's greedy tokens, which are
    the full model's; ``BatchEngine`` refuses it, where the JAX engine
    cannot be built over one (ROADMAP §C)."""
    g = dict(max_tokens=10, temperature=0.0)
    jpart, japp = jax_load(llama_dir, dtype="f32", device_layers=1)
    want = [e.token_id for e in JExecutor(jpart, _Tok(), japp).generate(PROMPT, JGen(**g))]
    full, _ = load_model(llama_dir, dtype="f32", device=CPU)
    part, app = load_model(llama_dir, dtype="f32", device=CPU, device_layers=1)
    ex = Executor(part, _Tok(), app)
    assert not ex.graphs.enabled
    got = [e.token_id for e in ex.generate(PROMPT, GenerationConfig(**g))]
    ref = [e.token_id for e in Executor(full, _Tok(), None).generate(
        PROMPT, GenerationConfig(**g))]
    assert got == want == ref
    # A prefill from embeddings (the multimodal path) streams the layers too.
    from blazr_tpu_torch.models.llama import forward_embed

    ids = torch.tensor([PROMPT])
    rows = [Executor(m, _Tok(), None).prefill_embeddings(
        m.init_cache(1, 32), forward_embed(m.params, m.cfg, ids)) for m in (full, part)]
    assert _rel(rows[1], rows[0]) < 1e-6
    with pytest.raises(NotImplementedError, match="ROADMAP §C"):
        BatchEngine(part, _Tok(), AppConfig(model=part.cfg))
    with pytest.raises(AttributeError):
        JEngine(jpart, _Tok(), JApp(model=jpart.cfg))


@pytest.mark.parametrize("inf", [dict(quant_compute="w8a8"), dict(moe_offload="hybrid"),
                                 dict(quant_compute="w4a8", moe_offload="cpu")])
def test_streaming_executor_refuses_what_it_would_not_apply(llama_dir, inf):
    """A streamed model is served as loaded: the Executor raises for a
    ``quant_compute`` mode or ``moe_offload`` it would otherwise not apply
    (the JAX Executor ignores both; ROADMAP §C). ``w4a16`` and ``auto``
    are the loaded weights' own mode and are served."""
    part, app = load_model(llama_dir, dtype="f32", device=CPU, device_layers=1)
    for k, v in inf.items():
        setattr(app.inference, k, v)
    with pytest.raises(ValueError, match="ROADMAP §C") as err:
        Executor(part, _Tok(), app)
    assert all(f"{k}={v!r}" in str(err.value) for k, v in inf.items())
    app.inference.quant_compute, app.inference.moe_offload = "w4a16", None
    assert not Executor(part, _Tok(), app).graphs.enabled


def test_placement_helpers_match_jax():
    """``LayerDeviceMap``, ``compute_device_layer_budget`` (2 GiB KV
    reserve) and ``estimate_param_bytes`` give the JAX package's numbers;
    ``device_free_memory`` is None without a card."""
    for total, dev in ((8, 3), (8, 0), (8, 12), (1, -1)):
        t, j = (toff.LayerDeviceMap.with_device_layers(total, dev),
                joff.LayerDeviceMap.with_device_layers(total, dev))
        assert t.placements == j.placements
        assert (t.num_device_layers, t.fully_resident) == (j.num_device_layers,
                                                           j.fully_resident)
    gib = 1 << 30
    for args in ((gib // 4, 32, gib, 10 * gib), (gib // 4, 32, 0, 3 * gib),
                 (0, 32, 0, gib), (gib, 32, 0, gib)):
        assert (toff.compute_device_layer_budget(*args)
                == joff.compute_device_layer_budget(*args))
    assert toff.compute_device_layer_budget(gib, 32) == 32      # free bytes unknown
    assert toff.device_free_memory() is None
    assert toff.KV_RESERVE_BYTES == joff.KV_RESERVE_BYTES == 2 * gib


def test_estimate_and_plan_match_jax(llama_dir):
    from blazr_tpu.loader.api import load_varmap as jax_varmap
    from blazr_tpu.formats.detect import detect_model_source as jax_detect
    from blazr_tpu_torch.formats.detect import detect_model_source
    from blazr_tpu_torch.loader.api import load_varmap

    tvm = load_varmap(detect_model_source(llama_dir))
    jvm = jax_varmap(jax_detect(llama_dir))
    assert toff.estimate_param_bytes(tvm, 2) == joff.estimate_param_bytes(jvm, 2)
    assert (toff.plan_offload(tvm, 2, 1).placements
            == joff.plan_offload(jvm, 2, 1).placements)
    assert toff.plan_offload(tvm, 2).fully_resident


# ---------------------------------------------------------------------------
# The CLI flags
# ---------------------------------------------------------------------------

def test_cli_offload_flags(mixtral, tmp_path, capsys):
    """``run --moe-offload hybrid --moe-device-experts 2`` and ``generate
    --device-layers 1`` print the stream without the flags; ``serve
    --continuous-batching --device-layers 1`` refuses at the engine."""
    import shutil

    from blazr_tpu_torch.cli.main import build_parser, main
    from blazr_tpu_torch.utils.synthetic import write_bpe_tokenizer_json

    d = tmp_path / "m"
    shutil.copytree(mixtral, d)
    write_bpe_tokenizer_json(d, 256)
    base = ["--device", "cpu"]
    outs = []
    for extra in ([], ["--moe-offload", "hybrid", "--moe-device-experts", "2"],
                  ["--device-layers", "1"]):
        cmd = ["run", str(d), "--prompt", "ab", "-n", "6", "-t", "0", "--no-warmup"]
        assert main(base + cmd + ["--dtype", "f32"] + extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == outs[2] and outs[0].strip()
    assert main(base + ["generate", str(d), "ab", "-n", "6", "-t", "0", "--dtype", "f32",
                        "--device-layers", "1"]) == 0
    assert capsys.readouterr().out == outs[0]
    args = build_parser().parse_args(["serve", "--model", str(d), "--device-layers", "3",
                                      "--moe-offload", "cpu", "--moe-device-experts", "1"])
    assert (args.device_layers, args.moe_offload, args.moe_device_experts) == (3, "cpu", 1)
    with pytest.raises(NotImplementedError, match="ROADMAP §C"):
        main(base + ["serve", "--model", str(d), "--continuous-batching", "--no-warmup",
                     "--device-layers", "1", "--port", "0"])
