"""Port parity: the features a mesh serves and the two it refuses, against
blazr_tpu on the conftest's 8-device CPU mesh.

  * LoRA: under ``tensor_parallel_size=2`` both engines' ``set_lora``
    raise the JAX Executor's ``ValueError``, word for word;
  * a streamed model (``device_layers``): the JAX Executor ignores the mesh
    and serves it on one device; the port refuses it, naming ROADMAP §C;
  * speculative decoding at tp 2: the BatchEngine's greedy streams with
    prompt-lookup drafts, with a draft model sliced like the target, and
    with a draft left whole (its ``o`` cannot be cut in whole AWQ groups:
    the JAX engine logs and leaves it replicated, the port logs and leaves
    it whole) equal the JAX ``BatchEngine``'s under the same mesh, with
    drafts made and accepted; ``PromptLookupExecutor`` and
    ``SpeculativeExecutor`` over tp 2 Executors give the JAX executors'
    tokens;
  * image chats at tp 2: the ``MultimodalExecutor`` over the sharded
    Executor (the tower whole on every rank) gives the JAX
    ``MultimodalExecutor``'s greedy tokens under the same mesh, and so does
    the chat run as a lockstep op from rank 0; an image that does not
    decode fails its chat alone;
  * ``cli run --tp 2`` with ``--prompt-lookup`` and ``--draft-model``
    prints the one-process greedy text.

One gloo world of two ranks (``tests/torch_ranks.py::features``) runs on a
thread while the JAX engines run here."""

import asyncio
import concurrent.futures
import dataclasses
import io
import os

import numpy as np
import pytest
from PIL import Image

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.config.inference import SpeculativeDecodingConfig as JSpec
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.engine.executor import Executor as JExecutor
from blazr_tpu.engine.executor_multimodal import MultimodalExecutor as JMultimodal
from blazr_tpu.engine.speculative import PromptLookupExecutor as JLookup
from blazr_tpu.engine.speculative import SpeculativeExecutor as JSpeculative
from blazr_tpu.loader import load_model as jax_load
from blazr_tpu_torch.engine.executor import Executor
from blazr_tpu_torch.loader import load_model
from blazr_tpu_torch.utils.synthetic import tiny_llama_config, write_hf_checkpoint

from fixtures import write_byte_tokenizer_json, write_tiny_llava_checkpoint
from torch_ranks import Tok, run_ranks

K, N = 3, 10
WAVES = [[[1, 2, 3, 4, 1, 2, 3, 4, 1, 2], [7, 8, 9, 7, 8, 9, 7]], [[5, 6] * 6, [3, 3, 3, 3]]]
SPEC_PROMPT = [1, 2, 3, 4, 1, 2, 3, 4, 1, 2]
MM_PROMPT = [10, 20, 30]


def _png() -> bytes:
    px = np.random.default_rng(1).integers(0, 256, (30, 40, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A tiny Llama (AWQ, groups of 16), a draft whose ``o`` (K 48) cannot
    be cut at tp 2 in whole groups, and a tiny LLaVA."""
    root = tmp_path_factory.mktemp("meshfeat")
    write_hf_checkpoint(root / "llama", tiny_llama_config(), quant="awq", group_size=16,
                        seed=5, dtype="float32", weight_exp=-4)
    dcfg = dataclasses.replace(tiny_llama_config(), hidden_size=48)
    dcfg.attention = dataclasses.replace(dcfg.attention, num_heads=3, num_kv_heads=3)
    write_hf_checkpoint(root / "draft3", dcfg, quant="awq", group_size=16, seed=6,
                        dtype="float32", weight_exp=-4)
    write_tiny_llava_checkpoint(root / "llava", np.random.default_rng(3))
    for d in ("llama", "llava"):
        write_byte_tokenizer_json(root / d)
    return {k: root / k for k in ("llama", "draft3", "llava")}


@pytest.fixture(scope="module")
def world(dirs, tmp_path_factory):
    pool = concurrent.futures.ThreadPoolExecutor(1)
    inp = {"dirs": {k: str(v) for k, v in dirs.items()}, "k": K, "n": N, "waves": WAVES,
           "spec_prompt": SPEC_PROMPT, "mm_prompt": MM_PROMPT, "png": _png()}
    fut = pool.submit(run_ranks, "features", 2, inp, tmp_path_factory.mktemp("meshfeat_w"),
                      300.0)
    yield fut
    pool.shutdown(wait=True)


def _japp(cfg, tp=2, k=0):
    a = JApp(model=cfg)
    a.inference.max_seq_len = 64
    a.inference.max_batch_size = 4
    a.inference.tensor_parallel_size = tp
    if k:
        a.inference.speculative = JSpec(num_speculative_tokens=k)
    return a


def _jgen(n):
    return JGen(max_tokens=n, temperature=0.0, repeat_penalty=1.0)


async def _jserve(eng, waves, n):
    task = asyncio.create_task(eng.run())
    streams = []
    for wave in waves:
        handles = [eng.submit(p, _jgen(n)) for p in wave]
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
def jax_refs(dirs, world, caplog_jax):
    """The JAX engines at tp 2: BatchEngine speculation (lookup, a draft it
    shards, a draft it leaves replicated), the two speculative executors,
    the multimodal executor, and the LoRA refusal."""
    out = {"spec": {}}
    for draft in ("lookup", "llama", "draft3"):
        jm, _ = jax_load(dirs["llama"], dtype="f32")
        dm = None if draft == "lookup" else jax_load(dirs[draft], dtype="f32")[0]
        eng = JEngine(jm, Tok(), _japp(jm.cfg, k=K), draft_model=dm)
        out["spec"][draft] = {"streams": asyncio.run(_jserve(eng, WAVES, N)),
                              "drafted": eng.spec_drafted, "accepted": eng.spec_accepted}
    out["warnings"] = list(caplog_jax)
    jm, _ = jax_load(dirs["llama"], dtype="f32")
    ex = JExecutor(jm, Tok(), _japp(jm.cfg))
    pl = JLookup(ex, num_speculative_tokens=K)
    out["pl"] = ([t.token_id for t in pl.generate(SPEC_PROMPT, _jgen(N))], pl.stats.drafted,
                 pl.stats.accepted)
    dm, _ = jax_load(dirs["llama"], dtype="f32")
    se = JSpeculative(JExecutor(dm, Tok(), _japp(dm.cfg)), ex, JSpec(num_speculative_tokens=K))
    out["se"] = ([t.token_id for t in se.generate(SPEC_PROMPT, _jgen(N))], se.stats.drafted,
                 se.stats.accepted)
    jm, ja = jax_load(dirs["llava"], dtype="f32")
    ja.inference.tensor_parallel_size = 2
    jex = JExecutor(jm, Tok(), ja)
    assert jex.mesh is not None
    out["mm"] = [t.token_id for t in JMultimodal(jex, jm.vision_params, jm.vision_cfg)
                 .generate_multimodal(MM_PROMPT, images=[_png()], gen_cfg=JGen(
                     max_tokens=8, temperature=0.0))]
    with pytest.raises(ValueError) as e:
        jex.set_lora(object())
    out["lora"] = str(e.value)
    return out


@pytest.fixture(scope="module")
def caplog_jax():
    """The JAX batch engine's warnings while the module's JAX engines run."""
    import logging

    got: list[str] = []

    class Grab(logging.Handler):
        def emit(self, rec):
            got.append(rec.getMessage())

    log = logging.getLogger("blazr_tpu.engine.batch_engine")
    handler = Grab(logging.WARNING)
    log.addHandler(handler)
    yield got
    log.removeHandler(handler)


@pytest.fixture(scope="module")
def ranks(world, jax_refs):
    return world.result()


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", [0, 1], ids=["executor", "batch_engine"])
def test_lora_under_mesh_raises_the_jax_error(ranks, jax_refs, engine):
    """blazr_tpu.engine.executor.Executor.set_lora at tp 2 raises
    ``ValueError("LoRA under mesh-sharded serving is not supported yet")``;
    the port's Executor and BatchEngine raise the same on every rank."""
    assert jax_refs["lora"] == "LoRA under mesh-sharded serving is not supported yet"
    for r in ranks:
        assert r["lora"][engine] == jax_refs["lora"]


def test_streamed_model_under_mesh(dirs):
    """A model with layers streamed from host RAM under tp 2: the JAX
    Executor builds no mesh and serves it on one device (its one-device
    tokens); the port refuses it before any process group is needed, naming
    ROADMAP §C and not queue A."""
    jpart, _ = jax_load(dirs["llama"], dtype="f32", device_layers=1)
    jex = JExecutor(jpart, Tok(), _japp(jpart.cfg))
    assert jpart.is_streaming and jex.mesh is None
    got = [t.token_id for t in jex.generate(SPEC_PROMPT[:4], _jgen(4))]
    jfull, _ = jax_load(dirs["llama"], dtype="f32")
    assert got == [t.token_id for t in JExecutor(jfull, Tok(), _japp(jfull.cfg, tp=1))
                   .generate(SPEC_PROMPT[:4], _jgen(4))]
    part, app = load_model(dirs["llama"], dtype="f32", device="cpu", device_layers=1)
    app.inference.tensor_parallel_size = 2
    with pytest.raises(NotImplementedError, match="ROADMAP §C") as e:
        Executor(part, Tok(), app)
    assert "queue A" not in str(e.value) and "item" not in str(e.value)


# ---------------------------------------------------------------------------
# speculation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["lookup", "llama", "draft3"])
def test_speculative_batch_engine_matches_jax(ranks, jax_refs, draft):
    """blazr_tpu.engine.batch_engine.BatchEngine with num_speculative_tokens
    3 at tp 2: the waves' greedy streams on every rank, drafts made (and
    accepted, except by the narrow draft, which the target never agrees
    with in either package). A draft of the target's heads and widths is
    sliced like it; the narrow one is left whole with a log line, as the JAX
    engine leaves it replicated with one."""
    ref = jax_refs["spec"][draft]
    assert ref["drafted"] > 0 and (ref["accepted"] > 0 or draft == "draft3")
    for r in ranks:
        got = r["spec"][draft]
        assert got["streams"] == ref["streams"]
        assert got["drafted"] > 0 and (got["accepted"] > 0 or draft == "draft3")
        assert got["draft_sliced"] is (draft == "llama")
        whole = [w for w in r["warnings"] if "draft model left whole" in w]
        assert len(whole) == 1 and "not divisible by tp=2" in whole[0]
    assert any("draft model left replicated over the mesh" in w for w in jax_refs["warnings"])


@pytest.mark.parametrize("kind", ["pl", "se"])
def test_speculative_executors_match_jax(ranks, jax_refs, kind):
    """blazr_tpu.engine.speculative's PromptLookupExecutor and
    SpeculativeExecutor over tp 2 Executors: the same tokens, drafts made
    and accepted."""
    toks, drafted, accepted = jax_refs[kind]
    assert drafted > 0 and accepted > 0
    for r in ranks:
        assert r[kind][0] == toks and len(toks) == N
        assert r[kind][1] > 0 and r[kind][2] > 0


# ---------------------------------------------------------------------------
# image chats
# ---------------------------------------------------------------------------

def test_image_chat_matches_jax(ranks, jax_refs):
    """blazr_tpu.engine.executor_multimodal.MultimodalExecutor over a tp 2
    Executor: a PNG before a 3-token prompt gives the same 8 greedy tokens
    on every rank."""
    assert len(jax_refs["mm"]) == 8
    for r in ranks:
        assert r["mm"] == jax_refs["mm"]


def test_image_chat_as_a_lockstep_op(ranks, jax_refs):
    """Rank 0 drives a LockstepEngine: the image chat runs as an op on both
    ranks and streams the JAX tokens; an image that does not decode fails
    its chat alone, and a text request and the chat again are served
    after it."""
    ls = ranks[0]["lockstep"]
    assert ls["chat"] == jax_refs["mm"] == ls["again"]
    assert ls["bad"] == "MultimodalError"
    assert len(ls["text"]) == 4


def test_cli_run_tp2_speculates(dirs, capsys):
    """``cli --device cpu run --tp 2`` with ``--prompt-lookup`` and with
    ``--draft-model`` prints the one-process greedy text (rank 1 started by
    the command itself)."""
    from blazr_tpu_torch.cli.main import main

    base = ["--device", "cpu", "run", str(dirs["llama"]), "--prompt", "abab", "-n", "6",
            "-t", "0", "--no-warmup", "--dtype", "f32"]
    outs = []
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for extra in ([], ["--tp", "2", "--prompt-lookup"],
                      ["--tp", "2", "--draft-model", str(dirs["llama"])]):
            assert main(base + extra) == 0
            outs.append(capsys.readouterr().out)
    finally:
        if env is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = env
    texts = [o.strip() for o in outs]
    assert texts[0] and texts[0] == texts[1] == texts[2]
