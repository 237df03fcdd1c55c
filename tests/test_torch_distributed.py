"""Port parity: the distributed package (``blazr_tpu_torch/distributed``)
against ``blazr_tpu/distributed``.

  * ``serialize_arrays`` / ``serialize_kv_cache`` give the JAX package's
    bytes for equal arrays (f32, f16, i32, u32, bool, bf16), and the port
    reads the JAX bytes back; int8 KV (which the JAX serializer refuses)
    round-trips;
  * ``compute_layer_assignment`` and ``PipelineSchedule`` equal the JAX
    ones;
  * the TCP mesh bootstraps and routes tagged messages;
  * a two-stage swarm and a router with one prefill and one decode worker
    (threads of this process, on the CPU) reproduce the JAX model's
    single-process greedy tokens; the router's HTTP app answers
    ``/v1/completions`` with them; ``cli swarm`` and ``cli disagg`` run as
    processes.
"""

import json
import os
import struct
import subprocess
import sys
import threading
import time
import urllib.request

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from blazr_tpu.distributed import kv_serialize as jkv
from blazr_tpu.distributed.topology import PipelineSchedule as JSchedule
from blazr_tpu.distributed.topology import SwarmConfig as JSwarmConfig
from blazr_tpu.distributed.topology import SwarmManager as JManager
from blazr_tpu.distributed.topology import SwarmNode as JNode
from blazr_tpu.distributed.topology import SwarmRole as JRole
from blazr_tpu.kvcache.contiguous import KVCache as JKVCache
from blazr_tpu.loader import load_model as jax_load

from blazr_tpu_torch.distributed import kv_serialize as tkv
from blazr_tpu_torch.distributed.disagg import (DecodeWorker, DisaggConfig, DisaggRouter,
                                                PrefillWorker, make_router_app)
from blazr_tpu_torch.distributed.swarm import SwarmLeader, SwarmWorker
from blazr_tpu_torch.distributed.topology import (PipelineSchedule, SwarmConfig,
                                                  SwarmManager, SwarmNode, SwarmRole)
from blazr_tpu_torch.distributed.transport import TcpMesh, tags
from blazr_tpu_torch.kvcache.contiguous import init_kv_cache
from blazr_tpu_torch.parallel.multihost import free_port
from blazr_tpu_torch.utils.synthetic import (tiny_llama_config, write_bpe_tokenizer_json,
                                             write_hf_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_serialize_arrays_bytes_equal_jax():
    """blazr_tpu.distributed.kv_serialize.serialize_arrays: the same bytes
    for equal arrays of every dtype both know; each reads the other's."""
    rng = np.random.default_rng(3)
    f = rng.standard_normal((2, 3, 5)).astype(np.float32)
    arrays = [f, f.astype(np.float16), rng.integers(-9, 9, (4,)).astype(np.int32),
              rng.integers(0, 2 ** 31, (3, 2)).astype(np.uint32), np.array([True, False]),
              rng.integers(0, 255, (6,)).astype(np.uint8), np.arange(5, dtype=np.int64)]
    bf = f.astype(ml_dtypes.bfloat16)
    want = jkv.serialize_arrays(arrays + [bf])
    got = tkv.serialize_arrays(arrays + [torch.from_numpy(f).to(torch.bfloat16)])
    assert got == want
    back = tkv.deserialize_arrays(want)
    for a, b in zip(arrays, back[:-1]):
        np.testing.assert_array_equal(b.numpy(), a)
    assert torch.equal(back[-1], torch.from_numpy(f).to(torch.bfloat16))
    with pytest.raises(ValueError, match="exceeds cap"):
        tkv.serialize_arrays([f], max_bytes=10)


@pytest.mark.parametrize("quantized", [False, True])
def test_kv_cache_bytes_equal_jax(quantized):
    """blazr_tpu.distributed.kv_serialize.serialize_kv_cache of a contiguous
    cache (k, v, lengths; scale planes of an int8 cache): the port's cache
    gives the JAX bytes (f32), and an int8 cache round-trips."""
    cache = init_kv_cache(2, 1, 8, 2, 4, dtype=torch.float32, quantized=quantized,
                          device="cpu")
    g = torch.Generator().manual_seed(0)
    if quantized:
        cache.k.copy_(torch.randint(-127, 127, cache.k.shape, generator=g).to(torch.int8))
        cache.v.copy_(torch.randint(-127, 127, cache.v.shape, generator=g).to(torch.int8))
        cache.k_scale.uniform_(generator=g)
        cache.v_scale.uniform_(generator=g)
    else:
        cache.k.normal_(generator=g)
        cache.v.normal_(generator=g)
    cache.length.fill_(5)
    data = tkv.serialize_kv_cache(cache)
    back = tkv.deserialize_kv_cache(data)
    for name in ("k", "v", "length", "k_scale", "v_scale"):
        a, b = getattr(cache, name), getattr(back, name)
        assert (a is None and b is None) or torch.equal(a, b)
    if not quantized:
        j = JKVCache(k=jnp.asarray(cache.k.numpy()), v=jnp.asarray(cache.v.numpy()),
                     length=jnp.asarray(cache.length.numpy()))
        assert data == jkv.serialize_kv_cache(j)


@pytest.mark.parametrize("weights", [None, [1.0, 1.0, 1.0], [2.0, 1.0, 1.0], [1, 3, 1, 1]])
@pytest.mark.parametrize("layers", [4, 7, 32])
def test_layer_assignment_equals_jax(weights, layers):
    """blazr_tpu.distributed.topology.SwarmManager.compute_layer_assignment
    and PipelineSchedule.from_assignments."""
    n = len(weights) if weights else 2
    tm, jm = SwarmManager(SwarmConfig(world_size=n + 1)), JManager(JSwarmConfig(world_size=n + 1))
    for r in range(1, n + 1):
        w = weights[r - 1] if weights else 1.0
        tm.register_node(SwarmNode(rank=r, role=SwarmRole.WORKER, weight=w))
        jm.register_node(JNode(rank=r, role=JRole.WORKER, weight=w))
    ta, ja = tm.compute_layer_assignment(layers), jm.compute_layer_assignment(layers)
    assert [(a.rank, a.start_layer, a.end_layer) for a in ta] == \
        [(a.rank, a.start_layer, a.end_layer) for a in ja]
    ts, js = PipelineSchedule.from_assignments(ta), JSchedule.from_assignments(ja)
    assert [vars(s) for s in ts.stages] == [vars(s) for s in js.stages]


def test_transport_bootstrap_and_tagged_messages():
    port = free_port()
    got = {}

    def worker(i):
        mesh = TcpMesh.bootstrap_worker(("127.0.0.1", port))
        got[i] = (mesh.rank, mesh.recv(0, tags.REQUEST, timeout=30))
        mesh.send(0, tags.RESPONSE, struct.pack("<I", mesh.rank))
        mesh.close()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    mesh = TcpMesh.bootstrap_leader(3, seed_port=port)
    for r in (1, 2):
        mesh.send(r, tags.REQUEST, f"to {r}".encode())
    answers = sorted(struct.unpack("<I", mesh.recv(r, tags.RESPONSE, timeout=30))[0]
                     for r in (1, 2))
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    mesh.close()
    assert answers == [1, 2]
    assert sorted(got.values()) == [(1, b"to 1"), (2, b"to 2")]


# ---------------------------------------------------------------------------
# swarm and disagg against the JAX model's greedy tokens
# ---------------------------------------------------------------------------

PROMPT = [5, 9, 42, 7, 100]
N = 6


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_model")
    cfg = tiny_llama_config(vocab=320)
    cfg.num_layers = 3
    write_hf_checkpoint(d, cfg, quant="awq", group_size=16, dtype="float32", seed=8)
    write_bpe_tokenizer_json(d, 320)
    return d


@pytest.fixture(scope="module")
def jax_greedy(ckpt):
    """The JAX model's single-process greedy tokens (the JAX swarm and
    disagg tests' reference)."""
    model, _ = jax_load(ckpt, dtype="f32")
    cache = model.init_cache(1, 64)
    logits, cache = model.forward(jnp.asarray([PROMPT], dtype=jnp.int32), cache,
                                  jnp.asarray(np.arange(len(PROMPT), dtype=np.int32)[None]))
    out = []
    cur = int(np.asarray(logits)[0, -1].argmax())
    for i in range(N):
        out.append(cur)
        logits, cache = model.forward(jnp.asarray([[cur]], dtype=jnp.int32), cache,
                                      jnp.asarray([[len(PROMPT) + i]], dtype=jnp.int32))
        cur = int(np.asarray(logits)[0, -1].argmax())
    return out


def _start(targets):
    threads = [threading.Thread(target=t, daemon=True) for t in targets]
    for t in threads:
        t.start()
    return threads


def _join(threads):
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()


def test_swarm_two_stages_match_jax(ckpt, jax_greedy):
    """blazr_tpu.distributed.swarm: two stages (layers [0, 2) and [2, 3))
    over TCP give the JAX greedy tokens, twice (each request resets the
    stages' K/V)."""
    port = free_port()

    def worker():
        mesh = TcpMesh.bootstrap_worker(("127.0.0.1", port))
        w = SwarmWorker(mesh, capacity=64, dtype="f32", device="cpu")
        w.receive_assignment()
        w.run_compute_loop()
        mesh.close()

    threads = _start([worker, worker])
    mesh = TcpMesh.bootstrap_leader(3, seed_port=port)
    leader = SwarmLeader(mesh, str(ckpt), num_layers=3)
    leader.start_workers()
    got = leader.generate_greedy(PROMPT, N)
    got2 = leader.generate_greedy(PROMPT, N)
    assert leader.hop_bytes > 0
    leader.shutdown()
    _join(threads)
    mesh.close()
    assert [(s.start_layer, s.end_layer) for s in leader.schedule.stages] == [(0, 2), (2, 3)]
    assert got == jax_greedy and got2 == jax_greedy


def test_disagg_router_and_http_match_jax(ckpt, jax_greedy):
    """blazr_tpu.distributed.disagg: router → prefill worker → one KV
    transfer → decode worker gives the JAX greedy tokens; the router's HTTP
    app (the port's server) answers /health and /v1/completions with them."""
    import asyncio

    from blazr_tpu_torch.server.app import serve
    from blazr_tpu_torch.tokenizer import load_tokenizer

    port = free_port()
    workers = {}

    def worker(role):
        def run():
            mesh = TcpMesh.bootstrap_worker(("127.0.0.1", port))
            cls = PrefillWorker if role == "prefill" else DecodeWorker
            workers[role] = cls(mesh, str(ckpt), capacity=64, dtype="f32", device="cpu")
            workers[role].run_loop()
            mesh.close()
        return run

    threads = _start([worker("prefill"), worker("decode")])
    mesh = TcpMesh.bootstrap_leader(3, seed_port=port)
    router = DisaggRouter(mesh, DisaggConfig())
    router.wait_workers()
    assert router.route_request(PROMPT, N) == jax_greedy
    assert workers["prefill"].kv_bytes > 0

    app = make_router_app(router, load_tokenizer(ckpt))
    http = free_port()

    async def client():
        stop = asyncio.Event()
        started = asyncio.get_running_loop().create_future()
        task = asyncio.create_task(serve(app, "127.0.0.1", http, started.set_result, stop))
        await started

        def call(path, body=None):
            req = urllib.request.Request(f"http://127.0.0.1:{http}{path}",
                                         json.dumps(body).encode() if body else None,
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        health = await asyncio.to_thread(call, "/health")
        res = await asyncio.to_thread(call, "/v1/completions",
                                      {"prompt": PROMPT, "max_tokens": N})
        stop.set()
        await task
        return health, res

    health, res = asyncio.run(client())
    router.shutdown()
    _join(threads)
    mesh.close()
    assert health["prefill_workers"] == 1 and health["decode_workers"] == 1
    assert res["choices"][0]["tokens"] == jax_greedy
    assert res["usage"]["completion_tokens"] == N


def test_cli_swarm_and_disagg_run(ckpt, jax_greedy):
    """``cli swarm leader|worker`` (requests on the leader's standard input)
    and ``cli disagg router|prefill|decode`` answer with the JAX greedy
    tokens."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cli = [sys.executable, "-m", "blazr_tpu_torch.cli", "--device", "cpu"]
    req = json.dumps({"tokens": PROMPT, "max_tokens": N}) + "\n"
    for mode, roles in (("swarm", ["worker"]), ("disagg", ["prefill", "decode"])):
        seed = f"127.0.0.1:{free_port()}"
        world = ["--world-size", str(len(roles) + 1)]
        lead = "leader" if mode == "swarm" else "router"
        leader = subprocess.Popen(cli + [mode, lead, "--model", str(ckpt), "--seed", seed,
                                         *world, "--dtype", "f32"], env=env,
                                  stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
        time.sleep(0.5)
        procs = [subprocess.Popen(cli + [mode, role, "--seed", seed, "--dtype", "f32",
                                         "--capacity", "64"]
                                  + (["--model", str(ckpt)] if mode == "disagg" else []),
                                  env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                  text=True) for role in roles]
        try:
            out, err = leader.communicate(req, timeout=180)
            assert leader.returncode == 0, err[-3000:]
            assert json.loads(out.splitlines()[-1])["tokens"] == jax_greedy
            for p in procs:
                assert p.wait(timeout=60) == 0
        finally:
            for p in [leader, *procs]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
