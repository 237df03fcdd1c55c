"""Port parity: every family under a tensor or expert parallel mesh.

``parallel/tp.py``'s key rules for the MLA, Mamba2/Mamba3 and hybrid trees
(``q_b`` by columns, ``kv_b_k``/``kv_b_v`` on their head axis, the mixer
whole), ``rank_config`` and the caches the engines allocate from it, against
blazr_tpu on the conftest's 8-device CPU mesh, and the families a mesh
already served against the port's own one-rank run:

  * each rank's slice of ``q_b``, ``o``, the dense MLP, the expert stacks
    (tp and ep) and the hybrid's attention equals the JAX ``shard_params``
    shard (``addressable_shards``); ``kv_b_k``/``kv_b_v``, whole in the JAX
    layout, equal the matching head range of the JAX tree; the mixer keys,
    whole in both, are the JAX tree's;
  * DeepSeek (MLA + MoE) at tp 2 and ep 2, Mamba2, Bamba (the hybrid) and
    Mamba3 at tp 2: the Executor's f32 prefill logits within 1e-4 of the
    largest and its greedy tokens, and the BatchEngine's greedy streams in two
    staggered waves, equal the JAX ``Executor`` and ``BatchEngine`` under the
    same ``tensor_parallel_size``/``expert_parallel_size``; under sp 2 they
    take the ordinary prefill (no ring) and give the same streams;
  * int8 latents (DeepSeek) and int8 KV (Bamba) at tp 2 equal the port's
    one-rank run of the same mode;
  * the nine other dense layouts of ``test_torch_families.tiny_config`` and
    Qwen2-MoE and Qwen3-MoE of ``test_torch_moe._tiny`` at tp 2, and the two
    MoE families at ep 2: prefill logits within 1e-5 of the largest of the
    port's one-rank run's, and both engines' greedy streams equal to it.

Checkpoints are tiny (hidden 64, AWQ in groups of 16: groups of 32 cannot be
cut at tp 2; Falcon and Mamba3 plain) and read by both packages'
``load_model``. One gloo world of two ranks (``tests/torch_ranks.py``) runs
every port case, on a thread while the JAX engines run here."""

import asyncio
import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.loader import load_model as jax_load
from blazr_tpu.parallel import MeshConfig as JMeshConfig
from blazr_tpu.parallel import make_mesh as jmake_mesh
from blazr_tpu.parallel import tp as jtp
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.models.layers import RowParallel
from blazr_tpu_torch.parallel import tp as ttp
from blazr_tpu_torch.parallel.mesh import MeshConfig
from blazr_tpu_torch.quant.qtensor import QuantTensor
from blazr_tpu_torch.utils.synthetic import tiny_recurrent_config, write_hf_checkpoint

from test_mamba3 import _write_mamba3
from test_torch_families import FAMILIES, tiny_config
from test_torch_moe import _tiny as moe_tiny
from test_torch_parallel import _rank_mesh, _shard_of
from torch_ranks import Tok, run_ranks

# Prompts of 5 to 8 tokens: one prefill bucket keeps the JAX compiles few.
PROMPTS = [[5, 9, 17, 3, 8], [100, 3, 3, 7, 200, 11]]
WAVES = [[[5, 9, 17, 3, 8, 1], [100, 3, 3, 7, 200, 11]], [[42] * 7, list(range(1, 8))]]
LOGIT_PROMPT = [7, 3, 250, 11, 12, 99, 4, 8]
N = 6
MOE = ["qwen2_moe", "qwen3_moe"]
# The newly served families and their meshes, held to the JAX engines.
JAX_CASES = {"deepseek/tp2": ("deepseek", {"tp": 2}), "deepseek/ep2": ("deepseek", {"ep": 2}),
             "mamba2/tp2": ("mamba2", {"tp": 2}), "bamba/tp2": ("bamba", {"tp": 2}),
             "mamba3/tp2": ("mamba3", {"tp": 2})}


def _write(d, cfg, quant="awq", seed=0):
    write_hf_checkpoint(d, cfg, quant=quant, group_size=16, seed=seed, dtype="float32",
                        weight_exp=-4, keep_plain=("kv_b_proj",))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("meshfam")
    out = {}
    for i, fam in enumerate(("deepseek", "mamba2", "bamba")):
        _write(root / fam, tiny_recurrent_config(fam), seed=40 + i)
        out[fam] = root / fam
    qlora = tiny_recurrent_config("deepseek")
    qlora.attention = dataclasses.replace(qlora.attention, q_latent_dim=32)
    _write(root / "deepseek_qlora", qlora, seed=44)
    out["deepseek_qlora"] = root / "deepseek_qlora"
    (root / "mamba3").mkdir()
    _write_mamba3(root / "mamba3", np.random.default_rng(3))
    out["mamba3"] = root / "mamba3"
    for i, fam in enumerate(FAMILIES):
        _write(root / fam, tiny_config(fam), "plain" if fam.startswith("falcon") else "awq",
               seed=50 + i)
        out[fam] = root / fam
    for i, fam in enumerate(MOE):
        _write(root / fam, moe_tiny(fam), seed=60 + i)
        out[fam] = root / fam
    return out


def _tmodel(d):
    return load_model(d, dtype="f32", device="cpu")[0]


def _case(d, mesh, **over):
    m = _tmodel(d)
    case = {"cfg": m.cfg, "params": m.params, "mesh": mesh, "n": N, "prompts": PROMPTS,
            "waves": WAVES, "logit_prompt": LOGIT_PROMPT}
    case.update(over)
    return case


@pytest.fixture(scope="module")
def world(ckpts, tmp_path_factory):
    """Every port case in one world of two ranks, started on a thread (the
    JAX engines run meanwhile); each rank's results by case."""
    cases = {}
    for fam in FAMILIES + MOE:
        cases[f"{fam}/one"] = _case(ckpts[fam], {})
        cases[f"{fam}/tp2"] = _case(ckpts[fam], {"tp": 2})
    for fam in MOE:
        cases[f"{fam}/ep2"] = _case(ckpts[fam], {"ep": 2})
    for name, (fam, mesh) in JAX_CASES.items():
        cases[name] = _case(ckpts[fam], mesh)
    for fam in ("deepseek", "bamba"):
        cases[f"{fam}/sp2"] = _case(ckpts[fam], {"sp": 2}, inf={"sp_prefill_threshold": 4},
                                    ex_inf={"sp_prefill_threshold": 4})
    # int8 latents (the Executor's MLA cache and the engine's pages) and the
    # hybrid's int8 KV pages (the engine only: the Executor's recurrent
    # caches take no quantized mode).
    for mesh, tag in (({}, "one"), ({"tp": 2}, "tp2")):
        cases[f"deepseek/{tag}_int8"] = _case(ckpts["deepseek"], mesh,
                                              inf={"kv_cache_dtype": "int8"},
                                              ex_inf={"kv_cache_dtype": "int8"})
        cases[f"bamba/{tag}_int8"] = _case(ckpts["bamba"], mesh, executor=False,
                                           inf={"kv_cache_dtype": "int8"})
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_ranks, "engines", 2, {"cases": cases},
                      tmp_path_factory.mktemp("meshfam_world"), 400.0)
    yield fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(world, jax_refs):
    """The world's results (after the JAX engines, which ran meanwhile)."""
    res = world.result()
    return {k: [r[k] for r in res] for k in res[0]}


# ---------------------------------------------------------------------------
# the JAX engines
# ---------------------------------------------------------------------------

def _japp(cfg, mesh):
    a = JApp(model=cfg)
    a.inference.max_seq_len = 64
    a.inference.max_batch_size = 4
    a.inference.tensor_parallel_size = mesh.get("tp", 1)
    a.inference.expert_parallel_size = mesh.get("ep", 1)
    return a


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


@pytest.fixture(scope="module")
def jax_refs(ckpts, world):
    """Each newly served case in the JAX Executor (prefill logits, greedy
    tokens) and BatchEngine (the waves), under the case's mesh."""
    out = {}
    for name, (fam, mesh) in JAX_CASES.items():
        jm, _ = jax_load(ckpts[fam], dtype="f32")
        ex = JExecutor(jm, Tok(), _japp(jm.cfg, mesh))
        assert ex.mesh is not None
        last, _ = ex.prefill(ex.model.init_cache(1, ex.capacity), LOGIT_PROMPT)
        toks = [[t.token_id for t in ex.generate(p, JGen(max_tokens=N, temperature=0.0))]
                for p in PROMPTS]
        jm, _ = jax_load(ckpts[fam], dtype="f32")
        be = asyncio.run(_jserve(JEngine(jm, Tok(), _japp(jm.cfg, mesh)), WAVES, N))
        out[name] = {"logits": np.asarray(last, dtype=np.float32), "ex": toks, "be": be}
    return out


# ---------------------------------------------------------------------------
# each rank's slices
# ---------------------------------------------------------------------------

def _jshards(d, mesh):
    jm, _ = jax_load(d, dtype="f32")
    jsh = jtp.shard_params(jm.params, jmake_mesh(JMeshConfig(**mesh)), jm.cfg)
    return jm, jsh


def _assert_slice(t, j, dim, r):
    """The port's rank-r slice ``t`` equals the JAX shard of ``j`` whose
    slice along ``dim`` is part r (dim None: the whole JAX leaf)."""
    if isinstance(t, RowParallel):
        t = t.weight
    pick = (lambda a: np.asarray(a)) if dim is None else (lambda a: _shard_of(a, dim, r))
    if isinstance(t, QuantTensor):
        np.testing.assert_array_equal(t.qweight.numpy().view(np.uint32),
                                      pick(j.qweight).view(np.uint32))
        np.testing.assert_array_equal(t.scales.numpy(), pick(j.scales))
        np.testing.assert_array_equal(t.mins.numpy(), pick(j.mins))
    else:
        np.testing.assert_array_equal(t.numpy(), pick(j))


@pytest.mark.parametrize("case", ["deepseek_tp2", "deepseek_ep2", "bamba_tp2", "mamba2_tp2"])
def test_rank_slices_equal_jax_shards(ckpts, case):
    """blazr_tpu.parallel.tp.shard_params on the JAX tree, against the
    port's ``shard_params`` of the same tree carried across, for each rank."""
    fam, mesh = case.split("_")
    mesh = {mesh[:2]: int(mesh[2:])}
    d = ckpts["deepseek_qlora" if fam == "deepseek" else fam]
    jm, jsh = _jshards(d, mesh)
    tparams = params_from_jax(jax.tree.map(np.asarray, jm.params), device="cpu")
    cfg = _tmodel(d).cfg
    size = next(iter(mesh.values()))
    for r in range(size):
        mine = ttp.shard_params(tparams, _rank_mesh(MeshConfig(**mesh), {k: r for k in mesh}),
                                cfg)
        for li, (jl, tl) in enumerate(zip(jsh["layers"], mine["layers"])):
            if fam == "deepseek" and "tp" in mesh:
                assert "q" not in tl
                for key, dim in (("q_b", 1), ("o", 0), ("q_a", None), ("kv_a", None)):
                    _assert_slice(tl[key], jl[key], dim, r)
                assert isinstance(tl["o"], RowParallel)
                for key in ("kv_b_k", "kv_b_v"):
                    whole = np.asarray(jl[key])
                    h = whole.shape[1] // 2
                    np.testing.assert_array_equal(tl[key].numpy(), whole[:, r * h:(r + 1) * h])
            if fam == "deepseek" and li == 0:
                for key, dim in (("gate", 1), ("up", 1), ("down", 0)):
                    _assert_slice(tl[key], jl[key], dim if "tp" in mesh else None, r)
            if fam == "deepseek" and li == 1:
                tm, jmoe = tl["moe"], jl["moe"]
                ep = "ep" in mesh
                for key, dim in (("experts_gate", 2), ("experts_up", 2), ("experts_down", 1)):
                    _assert_slice(tm[key], jmoe[key], 0 if ep else dim, r)
                for key in ("router", "shared_gate", "shared_up", "shared_down"):
                    _assert_slice(tm[key], jmoe[key], None, r)
                assert (tm["mesh"].first, tm["mesh"].count) == ((2 * r, 2) if ep else (0, 4))
            if fam == "bamba":
                keys = (("q", 1), ("k", 1), ("v", 1), ("o", 0)) if li == 1 else (
                    ("in_proj", None), ("out_proj", None), ("conv_w", None),
                    ("A_log", None), ("D", None), ("dt_bias", None), ("norm", None))
                for key, dim in keys + (("gate", 1), ("up", 1), ("down", 0)):
                    _assert_slice(tl[key], jl[key], dim, r)
            if fam == "mamba2":
                for key in ("in_proj", "out_proj", "conv_w", "A_log", "D", "dt_bias", "norm"):
                    _assert_slice(tl[key], jl[key], None, r)
        if "tp" in mesh:
            np.testing.assert_array_equal(mine["embed"].numpy(), _shard_of(jsh["embed"], 0, r))
            if jsh.get("lm_head") is not None:
                _assert_slice(mine["lm_head"], jsh["lm_head"], 1, r)


def test_rank_config_keeps_the_latent_and_ssm_widths(ckpts):
    """An MLA rank's config has its heads and the whole latent and head
    dims; a hybrid rank's has its q and kv heads and the whole mixer."""
    ds = ttp.rank_config(_tmodel(ckpts["deepseek"]).cfg,
                         _rank_mesh(MeshConfig(tp=2), {"tp": 1}))
    att = ds.attention
    assert (att.num_heads, att.rank_heads, att.kv_latent_dim, att.d_nope, att.d_rope,
            att.v_head_dim) == (2, (2, 4), 32, 16, 16, 16)
    bamba = _tmodel(ckpts["bamba"]).cfg
    rc = ttp.rank_config(bamba, _rank_mesh(MeshConfig(tp=2), {"tp": 0}))
    assert (rc.attention.num_heads, rc.attention.kv_heads(), rc.attention.head_dim) == (2, 1, 16)
    assert rc.ssm == bamba.ssm and rc.intermediate_size == 48


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_executor_matches_jax_under_mesh(ranks, jax_refs, name):
    """blazr_tpu.engine.executor.Executor under the same mesh: the f32
    prefill logits within 1e-4 of the largest and the greedy tokens, on
    every rank."""
    ref = jax_refs[name]
    for r in ranks[name]:
        assert _rel(r["logits"], ref["logits"]) <= 1e-4
        assert r["ex_tokens"] == ref["ex"]


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_batch_engine_matches_jax_under_mesh(ranks, jax_refs, name):
    """blazr_tpu.engine.batch_engine.BatchEngine under the same mesh: the
    two staggered waves' greedy streams, on every rank."""
    for r in ranks[name]:
        assert r["be_tokens"] == jax_refs[name]["be"]
        assert all(len(s) == N for s in r["be_tokens"])


def test_caches_follow_the_rank_config(ranks):
    """The MLA latent and k_rope planes and the state rows are whole on a
    rank; the hybrid's KV pages hold the rank's kv heads (2 / 2)."""
    ds = ranks["deepseek/tp2"][0]
    assert ds["be_cache"]["latent"][-1] == 32 and ds["be_cache"]["k_rope"][-1] == 16
    assert ds["ex_cache"]["latent"][-1] == 32
    bamba = ranks["bamba/tp2"][0]["be_cache"]
    assert bamba["kv.k"][2] == 1 and bamba["ssm.ssm"][2:] == [8, 16, 16]
    assert ranks["mamba2/tp2"][0]["be_cache"]["ssm"][2:] == [8, 16, 16]
    assert ranks["bamba/tp2_int8"][0]["be_cache"]["kv.k_scale"][2] == 1


@pytest.mark.parametrize("fam", ["deepseek", "bamba"])
def test_sp_takes_the_ordinary_prefill(ranks, jax_refs, fam):
    """Under sp 2 the MLA and hybrid families prefill without the ring (the
    JAX ring is llama-only) and give the JAX streams of the same function."""
    for r in ranks[f"{fam}/sp2"]:
        assert r["sp_prefills"] == 0
        assert r["be_tokens"] == jax_refs[f"{fam}/tp2"]["be"]
        assert r["ex_tokens"] == jax_refs[f"{fam}/tp2"]["ex"]


@pytest.mark.parametrize("fam", ["deepseek", "bamba"])
def test_int8_caches_match_one_rank(ranks, fam):
    """int8 latents (DeepSeek, both engines) and the hybrid's int8 KV pages
    (Bamba) at tp 2: the streams of one rank in the same mode."""
    one = ranks[f"{fam}/one_int8"][0]
    for r in ranks[f"{fam}/tp2_int8"]:
        assert r["be_tokens"] == one["be_tokens"]
        if fam == "deepseek":
            assert r["ex_tokens"] == one["ex_tokens"]
            assert _rel(r["logits"], one["logits"]) <= 1e-4


@pytest.mark.parametrize("name", [f"{f}/tp2" for f in FAMILIES + MOE]
                         + [f"{f}/ep2" for f in MOE])
def test_served_families_match_one_rank(ranks, name):
    """The dense layouts and the MoE families a mesh already served: the
    prefill logits within 1e-5 of the largest of one rank's, and both
    engines' greedy streams equal to one rank's, on every rank."""
    one = ranks[name.split("/")[0] + "/one"][0]
    for r in ranks[name]:
        assert _rel(r["logits"], one["logits"]) <= 1e-5
        assert r["ex_tokens"] == one["ex_tokens"]
        assert r["be_tokens"] == one["be_tokens"]
