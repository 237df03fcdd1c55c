"""Port parity: LoRA adapters (loading, the registry, ``merge_lora`` on
dense, AWQ and GGUF bases, fused and unfused, the Executor's hot swap, the
BatchEngine's switch, speculation under an adapter, the K/V a switch makes
stale, the ``/v1/lora`` routes and a request's ``lora_adapter``) of
blazr_tpu_torch against blazr_tpu on the CPU, on tiny f32 models and
adapters written from seeded numpy data.

Tolerances: f32 logits within 1e-4 of their largest magnitude (the same
arithmetic in another order); greedy token streams exactly equal. Where the
port deviates on purpose (an adapter the model cannot wholly take is
refused; a switch drops the K/V computed under the previous weights;
ROADMAP §C), the test shows both sides."""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.engine import lora as jlora
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.formats import ggml_quants as jgq
from blazr_tpu.formats import gguf as jgguf
from blazr_tpu.formats import write_safetensors
from blazr_tpu.loader import load_model as jax_load_model
from blazr_tpu.quant import qtensor as jqt
from blazr_tpu.utils.synthetic import synth_llama_params as jax_synth
from blazr_tpu.utils.synthetic import synth_model, tiny_llama_config as jax_tiny
from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.config.inference import SpeculativeDecodingConfig
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.engine import lora as tlora
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.formats import gguf as tgguf
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.models.layers import LoraLinear
from blazr_tpu_torch.models.registry import Model
from blazr_tpu_torch.quant import qtensor as tqt
from blazr_tpu_torch.tokenizer.byte_tok import ByteTokenizer
from blazr_tpu_torch.utils.synthetic import tiny_llama_config

from fixtures import write_byte_tokenizer_json, write_tiny_llama_checkpoint
from test_engine_extras import _write_adapter
from test_torch_engine import _Tok, _serve
from test_torch_server import PortServer
from tests_helpers import ByteTok

CPU = "cpu"
ALL = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
PREFIX = "base_model.model.model.layers"


def _dims(cfg) -> dict:
    """(in, out) of each PEFT module of a llama config."""
    att = cfg.attention
    hd = att.resolved_head_dim(cfg.hidden_size)
    h, q, kv = cfg.hidden_size, att.num_heads * hd, att.kv_heads() * hd
    inter = cfg.resolved_intermediate_size()
    return {"q_proj": (h, q), "k_proj": (h, kv), "v_proj": (h, kv), "o_proj": (q, h),
            "gate_proj": (h, inter), "up_proj": (h, inter), "down_proj": (inter, h)}


def write_adapter(path, cfg, modules=ALL, layers=None, rank=4, alpha=8.0, seed=0,
                  scale=0.1, extra=()):
    """A HF-PEFT adapter directory over ``modules`` of ``layers`` (default
    all); ``extra`` adds (module path, in, out) entries as they are."""
    rng = np.random.default_rng(seed)
    dims = _dims(cfg)
    weights = {}
    entries = [(f"{PREFIX}.{i}.{'self_attn' if m[0] in 'qkvo' else 'mlp'}.{m}", *dims[m])
               for i in (range(cfg.num_layers) if layers is None else layers)
               for m in modules]
    for name, k, n in entries + [(f"base_model.model.{m}", k, n) for m, k, n in extra]:
        weights[f"{name}.lora_A.weight"] = (rng.standard_normal((rank, k)) * scale
                                            ).astype(np.float32)
        weights[f"{name}.lora_B.weight"] = (rng.standard_normal((n, rank)) * scale
                                            ).astype(np.float32)
    path.mkdir(parents=True, exist_ok=True)
    write_safetensors(path / "adapter_model.safetensors", weights)
    (path / "adapter_config.json").write_text(json.dumps({"r": rank, "lora_alpha": alpha}))
    return path


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    """Adapter A (every module, rank 4), A2 (A's shapes, other values) and
    B (q/v only, rank 2), over the tiny config, in both packages."""
    d = tmp_path_factory.mktemp("adapters")
    cfg = jax_tiny()
    paths = {"A": write_adapter(d / "A", cfg, seed=1),
             "A2": write_adapter(d / "A2", cfg, seed=2),
             "B": write_adapter(d / "B", cfg, modules=("q_proj", "v_proj"), rank=2,
                                alpha=4.0, seed=3, scale=0.2)}
    return {k: (jlora.load_lora_adapter(p), tlora.load_lora_adapter(p), p)
            for k, p in paths.items()}


def _jax_params(kind: str, cfg):
    """(JAX params, port params) of one base kind: dense or AWQ, fused or
    split projections, or GGUF Q8_0 / Q4_K words."""
    quant, fuse = {"dense": ("dense", False), "dense_fused": ("dense", True),
                   "awq": ("awq", False), "awq_fused": ("awq", True),
                   "gguf": ("dense", False)}[kind]
    jp = jax_synth(cfg, quant=quant, dtype=jnp.float32, group_size=32, seed=5, fuse=fuse)
    jp = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(jp, device=CPU)
    if kind == "gguf":
        for i, (jl, tl) in enumerate(zip(jp["layers"], tp["layers"])):
            for key in ("q", "k", "v", "o", "gate", "up", "down"):
                w = np.asarray(jl[key], np.float32)              # [in, out]
                gt = "Q8_0" if key in ("k", "v") else "Q4_K"
                raw = jgq.quantize_ggml(np.ascontiguousarray(w.T), jgguf.GgmlType[gt])
                jl[key] = jqt.from_ggml(raw, jgguf.GgmlType[gt], w.T.shape)
                tl[key] = tqt.from_ggml(raw, tgguf.GgmlType[gt], w.T.shape, device=CPU)
    return jp, tp


def _gguf_cfg():
    cfg = jax_tiny()
    cfg.hidden_size, cfg.intermediate_size = 256, 512
    cfg.attention.head_dim = 64
    return cfg


def _tcfg(jcfg):
    """The port's config of the same widths."""
    t = tiny_llama_config()
    t.hidden_size, t.intermediate_size = jcfg.hidden_size, jcfg.intermediate_size
    t.attention.head_dim = jcfg.attention.head_dim
    return t


def _logits_pair(jcfg, jp, tp, jad, tad):
    """Both packages' f32 logits of one prompt over ``jp``/``tp`` with the
    adapters merged (None: the base)."""
    toks = np.array([[3, 17, 5, 60, 9, 2]])
    pos = np.arange(toks.shape[1])[None]
    jm = synth_model(jcfg, quant="dense", dtype=jnp.float32)
    jm.params = jlora.merge_lora(jp, jad, model_cfg=jcfg) if jad else jp
    jl, _ = jm.forward(jnp.asarray(toks, jnp.int32), jm.init_cache(1, 16),
                       jnp.asarray(pos, jnp.int32))
    tcfg = _tcfg(jcfg)
    tm = Model(tcfg, tlora.merge_lora(tp, tad, model_cfg=tcfg) if tad else tp,
               torch.float32)
    tl, _ = tm.forward(torch.from_numpy(toks), tm.init_cache(1, 16), torch.from_numpy(pos),
                       torch.tensor([toks.shape[1]], dtype=torch.int32))
    return np.asarray(jl), tl.numpy()


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * float(np.abs(a).max()))


# ---------------------------------------------------------------------------
# loading, the registry, the merge
# ---------------------------------------------------------------------------

def test_adapter_loading_and_registry_match_jax(adapters, tmp_path):
    for key, (ja, ta, path) in adapters.items():
        assert (ta.name, ta.rank, ta.alpha, ta.scale, ta.num_modules()) == (
            ja.name, ja.rank, ja.alpha, ja.scale, ja.num_modules()), key
        assert list(ta.weights) == list(ja.weights)
        for m in ja.weights:
            for x, y in zip(ta.weights[m], ja.weights[m]):
                np.testing.assert_array_equal(x, y)
    jreg, treg = jlora.LoraAdapterRegistry(), tlora.LoraAdapterRegistry()
    for reg in (jreg, treg):
        reg.load(adapters["A"][2], "style")
        reg.load(adapters["B"][2])
    assert treg.list() == jreg.list()
    assert treg.get("style").rank == 4 and treg.get("nope") is None
    assert treg.unload("style") and not treg.unload("style")
    for bad in (tmp_path / "missing", tmp_path):
        for load in (jlora.load_lora_adapter, tlora.load_lora_adapter):
            with pytest.raises(FileNotFoundError):
                load(bad)
    # No lora_A/lora_B pairs: both refuse.
    write_safetensors(tmp_path / "adapter_model.safetensors",
                      {"x.weight": np.zeros((2, 2), np.float32)})
    for load in (jlora.load_lora_adapter, tlora.load_lora_adapter):
        with pytest.raises(ValueError, match="no LoRA weight pairs"):
            load(tmp_path)


@pytest.mark.parametrize("kind", ["dense", "dense_fused", "awq", "awq_fused", "gguf"])
def test_merge_matches_jax(adapters, kind, tmp_path):
    """Logits with adapter A (every module, both layers: on a fused base
    q/k/v share qkv and gate/up share gateup, the rank widening) over each
    base kind, and with B (q/v only) over the fused and the split AWQ base,
    agree with the JAX merge's; a packed base stays packed."""
    jcfg = _gguf_cfg() if kind == "gguf" else jax_tiny()
    jp, tp = _jax_params(kind, jcfg)
    if kind == "gguf":
        path = write_adapter(tmp_path / "A", jcfg, seed=1)
        pairs = {"A": (jlora.load_lora_adapter(path), tlora.load_lora_adapter(path))}
    else:
        pairs = {k: adapters[k][:2] for k in ("A", "B") if k == "A" or "awq" in kind}
    jbase, tbase = _logits_pair(jcfg, jp, tp, None, None)
    for k, (ja, ta) in pairs.items():
        jl, tl = _logits_pair(jcfg, jp, tp, ja, ta)
        _close(jl, tl)
        assert np.abs(jl - jbase).max() > 1e-3 * np.abs(jbase).max(), k
    merged = tlora.merge_lora(tp, pairs["A"][1], model_cfg=_tcfg(jcfg))
    lay = merged["layers"][0]
    fused = kind.endswith("fused")
    packed = kind not in ("dense", "dense_fused")
    assert isinstance(lay["qkv" if fused else "q"], LoraLinear) == packed
    if fused and packed:     # q, k and v of rank 4 on one weight: rank 12
        assert lay["qkv"].a.shape == (jcfg.hidden_size, 12)
    assert tp["layers"][0] is not lay                    # the base tree is untouched


def _refusals():
    cfg = jax_tiny()
    h, inter = cfg.hidden_size, cfg.intermediate_size
    return {
        "lm_head": ("lm_head", h, cfg.vocab_size),
        "experts": ("model.layers.0.mlp.experts.0.gate_proj", h, inter),
        "mla_latent": ("model.layers.0.self_attn.kv_a_proj_with_mqa", h, 32),
        "mamba2": ("model.layers.1.mixer.in_proj", h, 2 * h),
        "width": ("model.layers.0.self_attn.q_proj", h, h + 8),
        "layer_out_of_range": ("model.layers.9.self_attn.o_proj", h, h),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_unplaceable_modules_are_refused(case, tmp_path):
    """An adapter with a module the model has no weight for is refused with
    ValueError naming it, where the JAX merge skips it (or, for a width
    that does not match a split weight, merges a broken delta)."""
    module, k, n = _refusals()[case]
    jcfg = jax_tiny()
    path = write_adapter(tmp_path / "ad", jcfg, modules=("o_proj",), layers=[0],
                         extra=[(module, k, n)])
    if case == "width":
        path = write_adapter(tmp_path / "ad", jcfg, modules=(), extra=[(module, k, n)])
    jp, tp = _jax_params("awq_fused", jcfg)
    ad = tlora.load_lora_adapter(path)
    with pytest.raises(ValueError, match=module.replace(".", r"\.")):
        tlora.merge_lora(tp, ad, model_cfg=_tcfg(jcfg))
    tmodel = Model(_tcfg(jcfg), tp, torch.float32)
    ex = Executor(tmodel, _Tok(), AppConfig(model=tmodel.cfg))
    with pytest.raises(ValueError):
        ex.set_lora(ad)
    assert ex.active_lora is None and not tlora.lora_state(tmodel)._clean
    if case != "width":
        jlora.merge_lora(jp, jlora.load_lora_adapter(path), model_cfg=jcfg)   # no error


# ---------------------------------------------------------------------------
# the Executor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """JAX test_lora_executor_hot_swap_changes_generation's model and
    adapter (q_proj and v_proj of layer 0), from the same generator."""
    d = tmp_path_factory.mktemp("lora_model")
    ad = tmp_path_factory.mktemp("ad")
    rng = np.random.default_rng(3)
    write_tiny_llama_checkpoint(d, rng)
    _write_adapter(ad, rng)
    write_byte_tokenizer_json(d)
    return d, ad


def test_executor_hot_swap_matches_jax(ckpt):
    """JAX's test_lora_executor_hot_swap_changes_generation, in both
    packages: base, the adapter, base again; the streams agree."""
    mdir, ad = ckpt
    streams = {}
    for pkg in ("jax", "port"):
        if pkg == "jax":
            model, app = jax_load_model(mdir, dtype="f32")
            ex, cfg, load = JExecutor(model, ByteTok(), app), JGen, jlora.load_lora_adapter
        else:
            model, app = load_model(mdir, dtype="f32", device=CPU)
            ex, cfg, load = (Executor(model, ByteTokenizer(), app), GenerationConfig,
                             tlora.load_lora_adapter)
        app.inference.max_seq_len = 64
        gen = cfg(max_tokens=6, temperature=0.0)

        def run():
            return [t.token_id for t in ex.generate([5, 6, 7], gen)]

        base = run()
        ex.set_lora(load(ad, "style"))
        assert ex.active_lora == "style"
        lora = run()
        ex.clear_lora()
        assert ex.active_lora is None
        streams[pkg] = (base, lora, run())
    assert streams["port"] == streams["jax"]
    base, lora, again = streams["port"]
    assert lora != base and again == base


def test_executor_request_selects_its_adapter(ckpt):
    """A request's ``lora_adapter`` switches the Executor to the registry's
    adapter (the JAX engines leave that to the server); a name the registry
    lacks raises KeyError."""
    mdir, ad = ckpt
    model, app = load_model(mdir, dtype="f32", device=CPU)
    ex = Executor(model, ByteTokenizer(), app)
    gen = dict(max_tokens=6, temperature=0.0)
    with pytest.raises(KeyError, match="not loaded"):
        list(ex.generate([5, 6, 7], GenerationConfig(lora_adapter="style", **gen)))
    ex.lora_registry = tlora.LoraAdapterRegistry()
    ex.lora_registry.load(ad, "style")
    got = [t.token_id for t in ex.generate([5, 6, 7],
                                           GenerationConfig(lora_adapter="style", **gen))]
    assert ex.active_lora == "style"
    ex.clear_lora()
    want_base = [t.token_id for t in ex.generate([5, 6, 7], GenerationConfig(**gen))]
    ex.set_lora(ex.lora_registry.get("style"))
    assert [t.token_id for t in ex.generate([5, 6, 7], GenerationConfig(**gen))] == got
    assert got != want_base


# ---------------------------------------------------------------------------
# the BatchEngine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny()
    jmodel = synth_model(jcfg, quant="dense", dtype=jnp.float32)
    jmodel.params = jax_synth(jcfg, quant="awq", dtype=jnp.float32, group_size=32, seed=3)
    tparams = params_from_jax(jax.tree.map(np.asarray, jmodel.params), device=CPU)
    return jmodel, Model(tiny_llama_config(), tparams, torch.float32)


def _app(cls, cfg, horizon, **inf):
    a = cls(model=cfg)
    a.inference.max_seq_len = 128
    a.inference.max_batch_size = 4
    a.inference.decode_horizon = horizon
    for k, v in inf.items():
        setattr(a.inference, k, v)
    return a


PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], list(range(10, 31)), [40, 41]]


def _greedy(cls, n=8):
    return lambda: cls(max_tokens=n, temperature=0.0)


@pytest.fixture(scope="module")
def jax_streams(models, adapters):
    """The JAX engine's streams of PROMPTS with adapter A set (its params
    merged, as the JAX Executor's set_lora does), at horizon 1 and 8."""
    jmodel, _ = models
    base = jmodel.params
    out = {}
    jmodel.params = jlora.merge_lora(base, adapters["A"][0], model_cfg=jmodel.cfg)
    try:
        for horizon in (1, 8):
            eng = JEngine(jmodel, _Tok(), _app(JApp, jmodel.cfg, horizon))
            out[horizon] = asyncio.run(_serve(eng, [PROMPTS], _greedy(JGen)))
    finally:
        jmodel.params = base
    return out


@pytest.mark.parametrize("horizon", [1, 8])
def test_batch_engine_streams_under_adapter_match_jax(models, adapters, jax_streams,
                                                      horizon):
    _, tmodel = models
    eng = BatchEngine(tmodel, _Tok(), _app(AppConfig, tmodel.cfg, horizon))
    eng.set_lora(adapters["A"][1]).result()
    assert eng.active_lora == "A"
    got = asyncio.run(_serve(eng, [PROMPTS], _greedy(GenerationConfig)))
    eng.clear_lora().result()
    assert got == jax_streams[horizon]
    assert got != asyncio.run(_serve(eng, [PROMPTS], _greedy(GenerationConfig)))


async def _switch_mid_flight(eng, adapter, n_before: int, cls):
    """Serve PROMPTS; after ``n_before`` tokens of the first stream, switch
    to ``adapter`` while every row is running. Streams in submit order."""
    task = asyncio.create_task(eng.run())
    handles = [eng.submit(p, _greedy(cls, 40)()) for p in PROMPTS]
    first = []
    while len(first) < n_before:
        tok, _ = await asyncio.wait_for(handles[0].queue.get(), 120)
        first.append(tok.token_id)
    await asyncio.wrap_future(eng.set_lora(adapter))
    rest = await asyncio.gather(*[_collect_ids(h) for h in handles])
    eng.stop()
    await task
    return [first + rest[0]] + rest[1:]


async def _collect_ids(h):
    return [t.token_id async for t in h.tokens()]


@pytest.mark.parametrize("horizon", [1, 8])
def test_switch_mid_flight_lands_at_a_step_boundary(models, adapters, horizon):
    """A switch while rows run (40-token streams, past the rounds already in
    flight at horizon 8): each stream is the base stream up to the switch
    and differs later (rows continue under the new weights); a request
    after the switch equals a fresh engine's under A; the base again gives
    the base streams."""
    _, tmodel = models
    gen = _greedy(GenerationConfig, 40)
    base_eng = BatchEngine(tmodel, _Tok(), _app(AppConfig, tmodel.cfg, horizon))
    base = asyncio.run(_serve(base_eng, [PROMPTS], gen))
    eng = BatchEngine(tmodel, _Tok(), _app(AppConfig, tmodel.cfg, horizon))
    got = asyncio.run(_switch_mid_flight(eng, adapters["A"][1], 2, GenerationConfig))
    assert got[0][:2] == base[0][:2]
    assert all(len(s) == 40 and s != b for s, b in zip(got, base))
    assert eng.perf["lora_switch_n"] == 1 and eng.active_lora == "A"
    after = asyncio.run(_serve(eng, [PROMPTS[:1]], gen))
    fresh = BatchEngine(tmodel, _Tok(), _app(AppConfig, tmodel.cfg, horizon))
    assert after == asyncio.run(_serve(fresh, [PROMPTS[:1]], gen))
    eng.clear_lora().result()
    assert asyncio.run(_serve(eng, [PROMPTS], gen)) == base


def test_same_shape_switch_writes_in_place(models, adapters):
    """A to A2 (same targets and rank) rewrites the LoRA buffers in place:
    ``sig`` stays and the buffers are the same tensors; A to B replaces
    them; the base restores every weight to its clean value."""
    _, tmodel = models
    st = tlora.lora_state(tmodel)
    ex = Executor(tmodel, _Tok(), _app(AppConfig, tmodel.cfg, 1))
    ex.set_lora(adapters["A"][1])
    sig, lay = st.sig, tmodel.params["layers"][0]
    buf = lay["qkv"].a
    ex.set_lora(adapters["A2"][1])
    assert st.sig == sig and lay["qkv"].a is buf and ex.active_lora == "A2"
    want = tlora.merge_lora(params_from_jax(jax.tree.map(
        np.asarray, models[0].params), device=CPU), adapters["A2"][1],
        model_cfg=tmodel.cfg)["layers"][0]["qkv"]
    torch.testing.assert_close(lay["qkv"].a, want.a, rtol=0, atol=0)
    ex.set_lora(adapters["B"][1])
    assert st.sig == sig + 1 and "gateup" in lay and not isinstance(lay["gateup"],
                                                                      LoraLinear)
    ex.clear_lora()
    assert st.sig == sig + 2
    assert not any(isinstance(w, LoraLinear) for layer in tmodel.params["layers"]
                   for w in layer.values())


def test_dense_merge_in_place_equals_merged_load(adapters):
    """A dense base merged in place (the same tensors rewritten) equals the
    JAX merged params exactly, and the base comes back bit for bit."""
    jcfg = jax_tiny()
    jp, tp = _jax_params("dense", jcfg)
    tmodel = Model(_tcfg(jcfg), tp, torch.float32)
    before = {k: v.clone() for k, v in tp["layers"][1].items()}
    ids = {k: id(v) for k, v in tp["layers"][1].items()}
    Executor(tmodel, _Tok(), _app(AppConfig, tmodel.cfg, 1)).set_lora(adapters["A"][1])
    want = jlora.merge_lora(jp, adapters["A"][0], model_cfg=jcfg)["layers"][1]
    for k, v in tmodel.params["layers"][1].items():
        assert id(v) == ids[k]
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    tlora.lora_state(tmodel).activate(None)
    for k, v in tmodel.params["layers"][1].items():
        assert torch.equal(v, before[k])
    assert not tlora.lora_state(tmodel)._clean


def test_speculative_target_under_adapter(models, adapters):
    """Prompt-lookup speculation under adapter A gives the plain engine's
    greedy streams under A (the adapter applies to the target)."""
    _, tmodel = models
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 5, 6, 5, 6]]
    gen = lambda: GenerationConfig(max_tokens=10, temperature=0.0, repeat_penalty=1.0)
    out = []
    for spec in (None, SpeculativeDecodingConfig(num_speculative_tokens=3)):
        eng = BatchEngine(tmodel, _Tok(), _app(AppConfig, tmodel.cfg, 4, speculative=spec))
        eng.set_lora(adapters["A"][1]).result()
        out.append(asyncio.run(_serve(eng, [prompts], gen)))
        eng.clear_lora().result()
        if spec is not None:
            assert eng.spec_drafted > 0
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# K/V computed under other weights
# ---------------------------------------------------------------------------

LONG = list(range(1, 41))           # 40 tokens: session reuse at >= 16, 2 blocks of 16


def test_switch_drops_the_executor_session(ckpt):
    """After a switch the port's Executor computes an extended prompt
    afresh, as a fresh executor under the adapter does; the JAX executor
    reuses the K/V its session computed under the base, and differs."""
    mdir, ad = ckpt
    out = {}
    for pkg in ("jax", "port"):
        runs = []
        for warm in (True, False):
            if pkg == "jax":
                model, app = jax_load_model(mdir, dtype="f32")
                ex, gen, load = JExecutor(model, ByteTok(), app), JGen, jlora.load_lora_adapter
            else:
                model, app = load_model(mdir, dtype="f32", device=CPU)
                ex, gen, load = (Executor(model, ByteTokenizer(), app), GenerationConfig,
                                 tlora.load_lora_adapter)
            app.inference.prefix_cache = True
            cfg = gen(max_tokens=6, temperature=0.0)
            if warm:
                list(ex.generate(LONG, cfg))           # the session, under the base
            ex.set_lora(load(ad, "style", ) if pkg == "port" else load(ad, "style"))
            runs.append([t.token_id for t in ex.generate(LONG + [50, 51], cfg)])
        out[pkg] = runs
    assert out["port"][0] == out["port"][1] == out["jax"][1]
    assert out["jax"][0] != out["jax"][1]


async def _serve_pairs(eng, prompt, gen, between=None):
    """(token, logprob) pairs of ``prompt`` served; with ``between``, it is
    served to its end, ``between()`` runs, and the second serving's pairs
    come back."""
    task = asyncio.create_task(eng.run())
    for i in range(1 if between is None else 2):
        out = [(t.token_id, t.logprob) async for t in eng.submit(prompt, gen()).tokens()]
        if between is not None and not i:
            await between()
    eng.stop()
    await task
    return out


def test_switch_drops_the_prefix_cache(models, adapters):
    """The BatchEngine's prefix cache and host tier are emptied by a switch:
    a prompt served under the base, then under A, equals (tokens and
    logprobs) a fresh engine's under A; the JAX engine serves the base's
    cached blocks, and its logprobs are not its fresh engine's."""
    jmodel, tmodel = models
    gen = _greedy(GenerationConfig, 6)
    kw = dict(prefix_cache=True, block_size=16, gpu_prefix_cache=True)
    eng = BatchEngine(tmodel, _Tok(), _app(AppConfig, tmodel.cfg, 1, **kw))
    seen = []

    async def switch():
        seen.append(eng.prefix_cache.stats.cached_blocks)
        await asyncio.wrap_future(eng.set_lora(adapters["A"][1]))
        seen.append((eng.prefix_cache.stats.cached_blocks, len(eng.prefix_cache.host_tier)))

    got = asyncio.run(_serve_pairs(eng, LONG, gen, switch))
    assert seen[0] > 0 and seen[1] == (0, 0) and eng.prefix_cache.stats.hits == 0
    fresh = BatchEngine(tmodel, _Tok(), _app(AppConfig, tmodel.cfg, 1))
    assert fresh.active_lora == "A"
    assert got == asyncio.run(_serve_pairs(fresh, LONG, gen))
    eng.clear_lora().result()
    base = jmodel.params
    jgen = _greedy(JGen, 6)
    jeng = JEngine(jmodel, _Tok(), _app(JApp, jmodel.cfg, 1, prefix_cache=True,
                                        block_size=16))

    async def jswitch():
        jmodel.params = jlora.merge_lora(base, adapters["A"][0], model_cfg=jmodel.cfg)

    try:
        stale = asyncio.run(_serve_pairs(jeng, LONG, jgen, jswitch))
        jfresh = asyncio.run(_serve_pairs(JEngine(jmodel, _Tok(), _app(JApp, jmodel.cfg, 1)),
                                          LONG, jgen))
    finally:
        jmodel.params = base
    assert jeng.prefix_cache.stats.hits > 0
    assert [t for t, _ in got] == [t for t, _ in jfresh]
    assert [lp for _, lp in stale] != [lp for _, lp in jfresh]


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------

CHAT = {"messages": [{"role": "user", "content": "hello there, tiny model"}],
        "max_tokens": 10, "temperature": 0}


def _route_script(adapter: str, unplaceable: str) -> list:
    return [("POST", "/v1/lora", {"path": adapter, "name": "test-adapter"}),
            ("GET", "/v1/lora", None),
            ("POST", "/v1/chat/completions", dict(CHAT, lora_adapter="test-adapter")),
            ("POST", "/v1/completions", {"prompt": "The quick", "max_tokens": 8,
                                         "temperature": 0, "lora_adapter": "nope"}),
            ("DELETE", "/v1/lora/test-adapter", None),
            ("POST", "/v1/chat/completions", CHAT),
            ("DELETE", "/v1/lora/test-adapter", None),
            ("POST", "/v1/lora", {"path": "/nope"}),
            ("POST", "/v1/lora", {}),
            ("POST", "/v1/lora", {"path": unplaceable, "name": "bad"}),
            ("GET", "/v1/lora", None)]


def _jax_routes(model_dir, script, engine: bool):
    from aiohttp.test_utils import TestClient, TestServer

    from blazr_tpu.config.server import ServerConfig as JServerConfig
    from blazr_tpu.engine.model_scheduler import ModelScheduler as JScheduler
    from blazr_tpu.server.app import create_app as jax_create_app

    async def main():
        sched = JScheduler(model_dir, dtype="f32")
        eng = None
        if engine:
            ex = sched.get_executor("default")
            eng = JEngine(ex.model, ex.tokenizer, ex.app_cfg)
        out = []
        async with TestClient(TestServer(jax_create_app(sched, JServerConfig(),
                                                        batch_engine=eng))) as c:
            for method, path, body in script:
                r = await c.request(method, path, json=body)
                out.append((r.status, await r.read()))
        return out
    return asyncio.run(main())


@pytest.fixture(scope="module")
def route_setup(ckpt, tmp_path_factory):
    mdir, _ = ckpt
    ad = write_adapter(tmp_path_factory.mktemp("strong"), jax_tiny(), seed=4, scale=0.3)
    bad = write_adapter(tmp_path_factory.mktemp("bad"), jax_tiny(), modules=("o_proj",),
                        layers=[0], extra=[("lm_head", 64, 256)])
    script = _route_script(str(ad), str(bad))
    fresh = [("POST", "/v1/chat/completions", CHAT)]
    return mdir, script, {e: (_jax_routes(mdir, script, e), _jax_routes(mdir, fresh, e)[0])
                          for e in (False, True)}


@pytest.mark.parametrize("engine", [False, True], ids=["executor", "batch_engine"])
def test_lora_routes_match_jax(route_setup, engine):
    """JAX's test_lora_routes and a request's adapter, over the port's
    server and the JAX one: the statuses, the registry's listing, and the
    chat replies with the adapter and after its DELETE, are equal; the
    adapter's reply differs from the base reply. An adapter with a module
    the model cannot take answers 400 in the port (JAX: 201). After the
    DELETE the port's base reply is a fresh server's (the JAX server may
    reuse K/V its session computed under the adapter)."""
    mdir, script, jax_out = route_setup
    with PortServer(mdir, engine=engine) as srv:
        got = [srv.request(m, p, b)[::2] for m, p, b in script]
    want, fresh = jax_out[engine]
    statuses = [s for s, _ in got]
    assert statuses[:9] == [s for s, _ in want[:9]] == [201, 200, 200, 404, 200, 200, 404,
                                                         400, 400]
    assert (statuses[9], want[9][0]) == (400, 201)
    assert b"lm_head" in got[9][1]
    assert json.loads(got[1][1]) == json.loads(want[1][1])
    assert json.loads(got[10][1]) == {"adapters": []}

    def text(reply):
        return json.loads(reply)["choices"][0]["message"]["content"]
    assert text(got[2][1]) == text(want[2][1])
    assert text(got[5][1]) == text(fresh[1])
    assert text(got[2][1]) != text(got[5][1])
    assert json.loads(got[0][1]) == json.loads(want[0][1])
