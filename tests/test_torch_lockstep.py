"""Port parity: lockstep serving (``blazr_tpu_torch/distributed/lockstep.py``)
against ``blazr_tpu/distributed/lockstep.py`` and ``tests/test_lockstep.py``.

  * the op codec's bytes equal the JAX ``encode_ops``; one-process
    broadcasts are the identity;
  * one process: ``LockstepEngine`` over the port's BatchEngine gives the
    plain engine's and the JAX ``LockstepEngine``'s greedy tokens; cancel,
    stop, a failed request and an abandoned submit behave as in the JAX
    tests;
  * two gloo ranks at tp 2: rank 0's streams equal the JAX BatchEngine's,
    a cancel and a failed request leave the world in step, the follower runs
    as many steps as rank 0, through an idle heartbeat;
  * ``cli serve --tp 2 --continuous-batching --device cpu`` answers chats,
    embeddings and reranks over HTTP from rank 0, and ``cli run`` under ``--tp 2``, ``--ep 2`` and
    ``--sp 2`` prints the one-process greedy text.
"""

import asyncio
import copy
import json
import os
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blazr_tpu.config import AppConfig as JApp
from blazr_tpu.config import GenerationConfig as JGen
from blazr_tpu.distributed.lockstep import LockstepEngine as JLockstep
from blazr_tpu.distributed.lockstep import encode_ops as jencode_ops
from blazr_tpu.engine.batch_engine import BatchEngine as JEngine
from blazr_tpu.utils.synthetic import synth_llama_params as jax_synth
from blazr_tpu.utils.synthetic import synth_model, tiny_llama_config as jax_tiny

from blazr_tpu_torch.config import AppConfig, GenerationConfig
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.distributed.lockstep import (LockstepEngine, broadcast_payload,
                                                  decode_ops, encode_ops)
from blazr_tpu_torch.engine.batch_engine import BatchEngine
from blazr_tpu_torch.models.registry import Model
from blazr_tpu_torch.parallel.multihost import free_port
from blazr_tpu_torch.utils.synthetic import (tiny_llama_config, write_bpe_tokenizer_json,
                                             write_hf_checkpoint)
from torch_ranks import Tok, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[1, 2, 3], [9, 8, 7, 6]]


@pytest.fixture(scope="module")
def jparams():
    return jax_synth(jax_tiny(), quant="awq", dtype=jnp.float32, group_size=16, seed=5)


def _tmodel(jparams):
    return Model(tiny_llama_config(), params_from_jax(jax.tree.map(np.asarray, jparams),
                                                      device="cpu"), torch.float32)


def _engine(jparams):
    app = AppConfig(model=tiny_llama_config())
    app.inference.max_seq_len = 64
    app.inference.max_batch_size = 4
    return BatchEngine(_tmodel(jparams), Tok(), app)


def _jengine(jparams):
    m = synth_model(jax_tiny(), quant="dense", dtype=jnp.float32)
    m.params = copy.deepcopy(jparams)
    app = JApp(model=jax_tiny())
    app.inference.max_seq_len = 64
    app.inference.max_batch_size = 4
    return JEngine(m, Tok(), app)


async def _collect(handle, limit=64):
    out = []
    async for tok in handle.tokens():
        out.append(tok.token_id)
        if len(out) >= limit:
            break
    return out


def test_ops_codec_equals_jax():
    """blazr_tpu.distributed.lockstep.encode_ops: the same bytes."""
    ops = [{"op": "submit", "tokens": [1, 2, 3],
            "gen": GenerationConfig(max_tokens=4).to_dict()},
           {"op": "cancel", "seq": 7}, {"op": "stop"}]
    jops = [dict(ops[0], gen=JGen(max_tokens=4).to_dict()), ops[1], ops[2]]
    assert encode_ops(ops[1:]) == jencode_ops(jops[1:])
    assert decode_ops(encode_ops(ops)) == ops
    assert decode_ops(b"") == []


def test_broadcast_identity_single_process():
    assert broadcast_payload(b"hello") == b"hello"
    assert broadcast_payload(None) == b""


async def _lockstep(eng, prompts, n=5):
    ls = (LockstepEngine if isinstance(eng, BatchEngine) else JLockstep)(eng, heartbeat_s=0.2)
    gen = GenerationConfig if isinstance(eng, BatchEngine) else JGen
    task = asyncio.create_task(ls.run())
    res = []
    for p in prompts:
        h = await ls.submit(p, gen(max_tokens=n, temperature=0.0))
        res.append(await asyncio.wait_for(_collect(h), timeout=120))
    ls.stop()
    await asyncio.wait_for(task, timeout=60)
    assert ls.steps > 0
    return res


def test_lockstep_single_process_matches_direct_and_jax(jparams):
    """One process: the port's LockstepEngine gives the plain engine's
    greedy tokens and the JAX LockstepEngine's."""
    async def direct():
        eng = _engine(jparams)
        task = asyncio.create_task(eng.run())
        res = []
        for p in PROMPTS:
            h = eng.submit(p, GenerationConfig(max_tokens=5, temperature=0.0))
            res.append(await asyncio.wait_for(_collect(h), timeout=120))
        eng.stop()
        await task
        return res

    got = asyncio.run(_lockstep(_engine(jparams), PROMPTS))
    assert got == asyncio.run(direct())
    assert got == asyncio.run(_lockstep(_jengine(jparams), PROMPTS))


def test_lockstep_cancel_and_stop(jparams):
    async def main():
        ls = LockstepEngine(_engine(jparams), heartbeat_s=0.2)
        task = asyncio.create_task(ls.run())
        h = await ls.submit([5, 6, 7], GenerationConfig(max_tokens=500, temperature=0.0))
        await asyncio.sleep(0.05)
        ls.cancel(h.seq_id)
        toks = await asyncio.wait_for(_collect(h, limit=500), timeout=60)
        ls.stop()
        await asyncio.wait_for(task, timeout=60)
        return toks

    assert len(asyncio.run(main())) < 500


def test_lockstep_bad_request_fails_only_that_request(jparams):
    async def main():
        ls = LockstepEngine(_engine(jparams), heartbeat_s=0.2)
        task = asyncio.create_task(ls.run())
        failed = False
        try:
            await asyncio.wait_for(ls.submit([1, 2], GenerationConfig(
                max_tokens=4, temperature=0.0, grammar="::= not a grammar (((")), timeout=30)
        except Exception:
            failed = True
        h = await asyncio.wait_for(ls.submit([5, 6, 7], GenerationConfig(
            max_tokens=4, temperature=0.0)), timeout=30)
        toks = await asyncio.wait_for(_collect(h, limit=8), timeout=60)
        ls.stop()
        await asyncio.wait_for(task, timeout=60)
        return failed, toks

    failed, toks = asyncio.run(main())
    assert failed and 1 <= len(toks) <= 4


def test_lockstep_cancelled_future_detaches(jparams):
    async def main():
        ls = LockstepEngine(_engine(jparams), heartbeat_s=0.2)
        sub = asyncio.create_task(ls.submit([9, 9, 9], GenerationConfig(
            max_tokens=3, temperature=0.0)))
        await asyncio.sleep(0)
        sub.cancel()
        task = asyncio.create_task(ls.run())
        h = await asyncio.wait_for(ls.submit([5, 6], GenerationConfig(
            max_tokens=3, temperature=0.0)), timeout=30)
        toks = await asyncio.wait_for(_collect(h, limit=8), timeout=60)
        ls.stop()
        await asyncio.wait_for(task, timeout=60)
        return toks

    assert 1 <= len(asyncio.run(main())) <= 3


def test_lockstep_two_ranks_tp2_match_jax(jparams, tmp_path):
    """Two gloo ranks at tp 2, rank 0 driving: its waves' greedy streams
    equal the JAX BatchEngine's (tensor_parallel_size 2); a cancelled
    request ends early, a request with a grammar that does not parse fails
    alone, the world serves again after an idle heartbeat, and the follower
    ran rank 0's steps."""
    waves = [[[5, 9, 17], [100, 3, 3, 7, 200, 11]], [[42] * 20]]
    case = {"cfg": tiny_llama_config(), "mesh": {"tp": 2}, "n": 6, "waves": waves,
            "params": params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")}
    r0, r1 = run_ranks("lockstep", 2, {"case": case}, tmp_path)

    async def jax_side():
        eng = _jengine(jparams)
        task = asyncio.create_task(eng.run())
        out = []
        for wave in waves:
            hs = [eng.submit(p, JGen(max_tokens=6, temperature=0.0)) for p in wave]
            out += await asyncio.gather(*[_collect(h) for h in hs])
        eng.stop()
        await task
        return out

    want = asyncio.run(jax_side())
    assert r0["streams"] == want
    assert r0["again"] == want[0]
    assert r0["cancelled"] < 50 and r0["failed"] is not None
    assert r0["steps"] == r1["steps"] > 0
    assert not r0["finished"] and not r1["finished"]


# ---------------------------------------------------------------------------
# the CLI's one-command worlds on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("lockstep_cli")
    cfg = tiny_llama_config(vocab=320)
    write_hf_checkpoint(d, cfg, quant="awq", group_size=16, dtype="float32", seed=2)
    write_bpe_tokenizer_json(d, 320)
    return d


def _cli(*argv, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "blazr_tpu_torch.cli", "--device", "cpu",
                          *argv], env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_cli_run_under_each_mesh_prints_the_plain_text(ckpt):
    """``cli run`` under --tp 2, --ep 2 (a dense model: experts none, the
    ranks replicated) and --sp 2 (a 260-token prompt: one ring prefill)
    prints the one-process greedy text."""
    prompt = " ".join(["hello world"] * 44)
    base = ["run", str(ckpt), "--prompt", prompt, "-t", "0", "-n", "8", "--no-warmup"]
    want = _one_process_text(ckpt, prompt, 8)
    for flags in (["--tp", "2"], ["--ep", "2"], ["--sp", "2"]):
        assert _cli(*base, *flags) == want, flags


def _one_process_executor(ckpt):
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.loader import load_model
    from blazr_tpu_torch.tokenizer import load_tokenizer

    model, app = load_model(ckpt, device="cpu")
    return Executor(model, load_tokenizer(ckpt), app)


def _one_process_text(ckpt, prompt: str, n: int) -> str:
    """What ``cli run -t 0`` prints, from the Executor in this process."""
    from blazr_tpu_torch.engine.generate_text import stream_generation

    ex = _one_process_executor(ckpt)
    gen = GenerationConfig(max_tokens=n, temperature=0.0)
    text = "".join(d for d, _ in stream_generation(ex, ex.tokenizer.encode(prompt), gen))
    return text + "\n"


def test_cli_serve_tp2_answers_over_http(ckpt, tmp_path):
    """``cli serve --tp 2 --continuous-batching --device cpu``: rank 0 serves
    HTTP through the lockstep engine, rank 1 mirrors it; two chats answer
    with the same greedy text as ``cli run``. /v1/embeddings and /v1/rerank
    (the vocab-sharded lookup, a lockstep op on both ranks) give the
    one-process Executor's pooled vectors within 1e-5, a request naming
    another model is served by the loaded one, and a chat after them still
    answers the same text; the world ends with rank 0."""
    from blazr_tpu_torch.server.pooling import pool

    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "blazr_tpu_torch.cli", "--device", "cpu",
                             "serve", "--model", str(ckpt), "--port", str(port), "--tp", "2",
                             "--continuous-batching", "--no-warmup"], env=env,
                            stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 180
        while True:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=2)
                break
            except OSError:
                assert proc.poll() is None, (tmp_path / "serve.log").read_text()[-4000:]
                assert time.monotonic() < deadline, "server did not start"
                time.sleep(0.5)
        def post(path, body):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                         json.dumps(body).encode(),
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        def complete(**extra):
            return post("/v1/completions", {"prompt": "hello world", "max_tokens": 6,
                                            "temperature": 0.0, **extra})["choices"][0]["text"]

        texts = [complete(), complete()]
        assert texts[0] == texts[1]
        assert texts[0] == _one_process_text(ckpt, "hello world", 6).rstrip("\n")
        ex = _one_process_executor(ckpt)

        def want(text):
            return pool(ex.get_embeddings(ex.tokenizer.encode(text)), "mean", True)

        got = post("/v1/embeddings", {"input": ["hello world", "abc"]})["data"]
        for row, text in zip(got, ["hello world", "abc"]):
            assert np.abs(np.asarray(row["embedding"]) - want(text)).max() < 1e-5
        ranked = post("/v1/rerank", {"query": "hello", "documents": ["hello world", "abc"]})
        for r in ranked["results"]:
            doc = r["document"]["text"]
            assert abs(r["relevance_score"] - float(np.dot(want("hello"), want(doc)))) < 1e-5
        assert complete(model="another") == texts[0]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    assert "lockstep follower" in (tmp_path / "serve.log").read_text()
