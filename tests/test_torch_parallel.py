"""Port parity: tensor parallelism (``blazr_tpu_torch/parallel``) against
``blazr_tpu/parallel`` on the conftest's 8-device CPU mesh.

  * each rank's slice of every weight kind equals the JAX shard's
    ``addressable_shards`` (packed words, scales, mins; the embedding and
    head rows) under ``blazr_tpu.parallel.tp.shard_params``;
  * ``validate_quant_tp`` and ``validate_tp_size`` raise the JAX errors;
  * the Executor's f32 prefill logits (1e-4 of the largest) and greedy
    tokens, and the BatchEngine's greedy streams (f32 and int8 KV), at tp 2
    and 4 over gloo ranks on the CPU equal the JAX ``Executor`` and
    ``BatchEngine`` under ``tensor_parallel_size`` (``tests/torch_ranks.py``
    runs the ranks; each world is spawned once a module);
  * ``data_parallel_size=2`` is routing: both engines take it, no mesh.
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
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.parallel import MeshConfig as JMeshConfig
from blazr_tpu.parallel import make_mesh as jmake_mesh
from blazr_tpu.parallel import tp as jtp
from blazr_tpu.parallel.mesh import validate_tp_size as jvalidate_tp_size
from blazr_tpu.utils.synthetic import synth_llama_params as jax_synth
from blazr_tpu.utils.synthetic import synth_model, tiny_llama_config as jax_tiny

from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.models.layers import RowParallel
from blazr_tpu_torch.models.registry import Model
from blazr_tpu_torch.parallel import tp as ttp
from blazr_tpu_torch.parallel.comm import Axis
from blazr_tpu_torch.parallel.mesh import MeshConfig, RankMesh, validate_tp_size
from blazr_tpu_torch.utils.synthetic import tiny_llama_config
from torch_ranks import Tok, run_ranks

PROMPTS = [[5, 9, 17, 3], [100, 3, 3, 7, 200, 11]]
WAVES = [[[5, 9, 17], [100, 3, 3, 7, 200, 11]], [[42] * 20, list(range(1, 18))]]
LOGIT_PROMPT = [7, 3, 250, 11, 12, 99, 4, 8, 1]
N = 6


def _jparams(seed=3, group_size=16):
    return jax_synth(jax_tiny(), quant="awq", dtype=jnp.float32, group_size=group_size,
                     seed=seed)


@pytest.fixture(scope="module")
def jparams():
    return _jparams()


def _rank_mesh(cfg: MeshConfig, index: dict) -> RankMesh:
    """A rank's view without processes (slicing needs no collective)."""
    axes = {}
    for name, size in (("tp", cfg.tp), ("sp", cfg.sp), ("ep", cfg.ep),
                       ("moe", cfg.ep * cfg.tp)):
        i = index.get(name, 0) if name != "moe" else index.get("ep", 0) * cfg.tp + index.get(
            "tp", 0)
        axes[name] = Axis(name, None, i, tuple(range(size)))
    return RankMesh(cfg, 0, cfg.ranks, torch.device("cpu"), "gloo", axes)


def _shard_of(arr, tp_dim: int, index: int):
    """The JAX shard of ``arr`` whose slice along ``tp_dim`` is part ``index``."""
    for sh in arr.addressable_shards:
        sl = sh.index[tp_dim]
        size = sh.data.shape[tp_dim]
        if (sl.start or 0) == index * size:
            return np.asarray(sh.data)
    raise AssertionError("no shard")


def _words(qt) -> np.ndarray:
    return qt.qweight.numpy().view(np.uint32)


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_slices_equal_jax_shards(jparams, tp):
    """blazr_tpu.parallel.tp.shard_params: each rank's q/k/v/gate/up (N),
    o/down (packed K rows and whole groups), embedding and head slices equal
    the JAX shards exactly. k/v at tp 4 (2 kv heads) stay a whole head on
    each rank in the port (JAX splits half heads and reshards)."""
    mesh = jmake_mesh(JMeshConfig(tp=tp))
    jsh = jtp.shard_params(jparams, mesh, jax_tiny())
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = tiny_llama_config()
    for r in range(tp):
        mine = ttp.shard_params(tparams, _rank_mesh(MeshConfig(tp=tp), {"tp": r}), cfg)
        for li, (jl, tl) in enumerate(zip(jsh["layers"], mine["layers"])):
            for key in ("q", "k", "v", "gate", "up", "o", "down"):
                if key in ("k", "v") and tp == 4:
                    continue
                jq, tq = jl[key], tl[key]
                if key in ("o", "down"):
                    assert isinstance(tq, RowParallel)
                    tq = tq.weight
                    dim = 0
                else:
                    dim = 1
                np.testing.assert_array_equal(
                    _words(tq), _shard_of(jq.qweight, dim, r).view(np.uint32))
                np.testing.assert_array_equal(tq.scales.numpy(), _shard_of(jq.scales, dim, r))
                np.testing.assert_array_equal(tq.mins.numpy(), _shard_of(jq.mins, dim, r))
                assert (tq.in_features, tq.out_features) == (
                    _shard_of(jq.scales, dim, r).shape[0] * tq.group_size,
                    _shard_of(jq.scales, dim, r).shape[1])
        np.testing.assert_array_equal(mine["embed"].numpy(), _shard_of(jsh["embed"], 0, r))
        assert mine["rank"].start == r * cfg.vocab_size // tp
        if jsh.get("lm_head") is not None:
            np.testing.assert_array_equal(mine["lm_head"].numpy(),
                                          _shard_of(jsh["lm_head"], 1, r))


def _errors(fn_j, fn_t):
    with pytest.raises(ValueError) as je:
        fn_j()
    with pytest.raises(ValueError) as te:
        fn_t()
    return str(je.value), str(te.value)


@pytest.mark.parametrize("case", ["group_cut", "packed_rows", "desc_act", "col_width",
                                  "q_b_width", "fused", "heads", "kv_heads", "inter",
                                  "vocab"])
def test_validate_errors_equal_jax(jparams, case):
    """blazr_tpu.parallel.tp.validate_quant_tp and
    blazr_tpu.parallel.mesh.validate_tp_size: the same refusals, word for
    word."""
    tp = 2
    if case in ("heads", "kv_heads", "inter", "vocab"):
        jc, tc = jax_tiny(), tiny_llama_config()
        over = {"heads": dict(num_heads=6), "kv_heads": dict(num_kv_heads=3)}.get(case)
        if over:
            jc = dataclasses.replace(jc, attention=dataclasses.replace(jc.attention, **over))
            tc = dataclasses.replace(tc, attention=dataclasses.replace(tc.attention, **over))
            tp = 4
        if case == "inter":
            jc, tc = (dataclasses.replace(c, intermediate_size=129) for c in (jc, tc))
        if case == "vocab":
            jc, tc = (dataclasses.replace(c, vocab_size=257) for c in (jc, tc))
        j, t = _errors(lambda: jvalidate_tp_size(jc, tp), lambda: validate_tp_size(tc, tp))
        assert j == t
        return
    jl = jtp.unfuse_projections(jparams, jax_tiny())["layers"][0]
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tl = ttp.unfuse_projections(tparams, tiny_llama_config())["layers"][0]
    key = {"col_width": "q", "q_b_width": "q", "fused": "qkv"}.get(case, "o")
    jw = jparams["layers"][0][key] if key == "qkv" else jl[key]
    tw = tparams["layers"][0][key] if key == "qkv" else tl[key]
    if case == "q_b_width":
        key = "q_b"             # MLA's q up-projection, a column key in both
    if case == "group_cut":
        tp = 8                  # o: K 64 / 8 = 8 rows, groups of 16
    elif case == "packed_rows":
        jw = dataclasses.replace(jw, qweight=jw.qweight[:7])
        tw = dataclasses.replace(tw, qweight=tw.qweight[:7])
    elif case == "desc_act":
        jw = dataclasses.replace(jw, perm=jnp.arange(64, dtype=jnp.int32))
        tw = dataclasses.replace(tw, perm=torch.arange(64, dtype=torch.int32))
    else:
        tp = 3                  # N 64 (q, q_b) and 128 (qkv)
    j, t = _errors(lambda: jtp.validate_quant_tp({"layers": [{key: jw}]}, tp),
                   lambda: ttp.validate_quant_tp({"layers": [{key: tw}]}, tp))
    assert j == t


# ---------------------------------------------------------------------------
# the engines over gloo ranks
# ---------------------------------------------------------------------------

def _japp(tp, **inf):
    a = JApp(model=jax_tiny())
    a.inference.max_seq_len = 64
    a.inference.max_batch_size = 4
    a.inference.tensor_parallel_size = tp
    for k, v in inf.items():
        setattr(a.inference, k, v)
    return a


def _jmodel(params):
    m = synth_model(jax_tiny(), quant="dense", dtype=jnp.float32)
    m.params = params
    return m


async def _jserve(eng, waves, n):
    task = asyncio.create_task(eng.run())
    streams = []
    for wave in waves:
        handles = [eng.submit(p, JGen(max_tokens=n, temperature=0.0)) for p in wave]
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


def _jexecutor(params, tp):
    ex = JExecutor(_jmodel(copy.deepcopy(params)), Tok(), _japp(tp))
    last, _ = ex.prefill(ex.model.init_cache(1, ex.capacity), LOGIT_PROMPT)
    toks = [[t.token_id for t in ex.generate(p, JGen(max_tokens=N, temperature=0.0))]
            for p in PROMPTS]
    return np.asarray(last, dtype=np.float32), toks


@pytest.fixture(scope="module")
def jax_refs(jparams):
    """The JAX engines at tp 2 on the 8-device CPU mesh (tp 4 gives the same
    tokens: tests/test_tp_serving.py), f32 and int8 KV."""
    logits, ex_toks = _jexecutor(jparams, 2)
    be = asyncio.run(_jserve(JEngine(_jmodel(copy.deepcopy(jparams)), Tok(), _japp(2)),
                             WAVES, N))
    be8 = asyncio.run(_jserve(JEngine(_jmodel(copy.deepcopy(jparams)), Tok(),
                                      _japp(2, kv_cache_dtype="int8")), WAVES, N))
    return {"logits": logits, "ex": ex_toks, "be": be, "be8": be8}


def _case(jparams, mesh, **over):
    case = {"cfg": tiny_llama_config(), "mesh": mesh, "n": N, "prompts": PROMPTS,
            "waves": WAVES, "logit_prompt": LOGIT_PROMPT,
            "params": params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")}
    case.update(over)
    return case


@pytest.fixture(scope="module")
def tp_ranks(jparams, tmp_path_factory):
    """One world of 2 ranks (tp 2; int8 KV) and one of 4 (tp 4), each
    spawned once."""
    out = {}
    two = {"tp2": _case(jparams, {"tp": 2}),
           "tp2_int8": _case(jparams, {"tp": 2}, executor=False,
                             inf={"kv_cache_dtype": "int8"})}
    res = run_ranks("engines", 2, {"cases": two}, tmp_path_factory.mktemp("tp2"))
    out.update({k: [r[k] for r in res] for k in two})
    four = {"tp4": _case(jparams, {"tp": 4})}
    res = run_ranks("engines", 4, {"cases": four}, tmp_path_factory.mktemp("tp4"))
    out.update({k: [r[k] for r in res] for k in four})
    return out


@pytest.mark.parametrize("name", ["tp2", "tp4"])
def test_executor_logits_and_greedy_match_jax(tp_ranks, jax_refs, name):
    """blazr_tpu.engine.executor.Executor (tensor_parallel_size 2): the
    port's prefill logits within 1e-4 of the largest, and every rank's
    greedy tokens equal."""
    ranks = tp_ranks[name]
    ref = jax_refs["logits"]
    for r in ranks:
        assert np.abs(r["logits"] - ref).max() <= 1e-4 * np.abs(ref).max()
        assert r["ex_tokens"] == jax_refs["ex"]
    tp = int(name[2:])
    # Each rank's cache holds its kv heads: 2 / 2 = 1; at tp 4 the head its
    # q heads share.
    assert ranks[0]["shape_k"][3] == 1


@pytest.mark.parametrize("name,ref", [("tp2", "be"), ("tp2_int8", "be8"), ("tp4", "be")])
def test_batch_engine_streams_match_jax(tp_ranks, jax_refs, name, ref):
    """blazr_tpu.engine.batch_engine.BatchEngine (tensor_parallel_size 2,
    f32 and int8 paged KV): the staggered waves' greedy streams, on every
    rank."""
    for r in tp_ranks[name]:
        assert r["be_tokens"] == jax_refs[ref]
        assert r["be_cache_k"][2] == 1          # the rank's kv heads


def _tmodel(jparams):
    return Model(tiny_llama_config(), params_from_jax(jax.tree.map(np.asarray, jparams),
                                                      device="cpu"), torch.float32)


def test_data_parallel_2_is_routing_in_both_engines(jparams):
    """data_parallel_size=2 is replica routing (engine/data_parallel.py), as
    in blazr_tpu.parallel.tp.maybe_serving_mesh: both engines take it, build
    no mesh, and serve the JAX engine's streams."""
    app = AppConfig(model=tiny_llama_config())
    app.inference.max_seq_len = 64
    app.inference.max_batch_size = 4
    app.inference.data_parallel_size = 2
    ex = Executor(_tmodel(jparams), Tok(), app)
    assert ex.mesh is None and ex.model.mesh is None
    toks = [t.token_id for t in ex.generate(PROMPTS[0], GenerationConfig(
        max_tokens=N, temperature=0.0))]
    je = JExecutor(_jmodel(copy.deepcopy(jparams)), Tok(), _japp(1, data_parallel_size=2))
    assert je.mesh is None
    assert toks == [t.token_id for t in je.generate(PROMPTS[0], JGen(max_tokens=N,
                                                                     temperature=0.0))]
    eng = BatchEngine(_tmodel(jparams), Tok(), app)
    assert eng.mesh is None
    assert ttp.maybe_serving_mesh(app.inference, tiny_llama_config()) is None


def _recurrent(family: str):
    from blazr_tpu_torch.utils.synthetic import synth_recurrent_params, tiny_recurrent_config

    cfg = tiny_recurrent_config(family)
    return Model(cfg, synth_recurrent_params(cfg, quant="dense", dtype=torch.float32,
                                             device="cpu"), torch.float32)


@pytest.mark.parametrize("what", ["deepseek", "mamba2", "bamba", "vision", "lora", "spec"])
def test_what_a_mesh_does_not_serve_names_item_13(jparams, what):
    """ROADMAP queue A entry 8 (item 13's rest) is served: under tp 2 the
    MLA, Mamba2 and hybrid families and a vision tower pass the mesh check
    and reach the process group (without a world, the ``RuntimeError`` that
    names ``init_distributed``), and speculative decoding passes its check
    on a model sliced to a rank. A LoRA adapter on a sliced model raises the
    JAX Executor's ``ValueError`` (tests/test_torch_mesh_features.py runs
    the served cases on gloo ranks). No message names item 13 any more."""
    from blazr_tpu_torch.engine.speculative import check_speculative

    app = AppConfig(model=tiny_llama_config())
    app.inference.tensor_parallel_size = 2
    assert not hasattr(ttp, "not_served_under_mesh")
    if what == "lora":
        eng = object.__new__(BatchEngine)
        eng.mesh = object()
        with pytest.raises(ValueError) as e:
            eng.set_lora(object())
        assert str(e.value) == "LoRA under mesh-sharded serving is not supported yet"
        return
    if what == "spec":
        model = _tmodel(jparams)
        model.mesh = object()
        check_speculative(model)
        return
    with pytest.raises(RuntimeError, match="init_distributed") as e:
        if what in ("deepseek", "mamba2", "bamba"):
            model = _recurrent(what)
            app = AppConfig(model=model.cfg)
            app.inference.tensor_parallel_size = 2
            BatchEngine(model, Tok(), app)
        else:
            model = _tmodel(jparams)
            model.vision_params = {}
            Executor(model, Tok(), app)
    assert "item 13" not in str(e.value)
