"""Ranks of a CPU gloo world for the port's parallel tests.

``run_ranks(scenario, world, inputs, workdir)`` runs
``SCENARIOS[scenario](inputs)`` on ``world`` ranks of a
``blazr_tpu_torch.parallel.multihost.RankPool`` (each a process joining a
gloo group through a file store in ``workdir``, with one thread) and returns
each rank's output dict; a world that does not end within its deadline is
killed, so a rank stuck in a collective cannot hang the suite. This file imports no JAX: the tests hold its outputs to the JAX
package in their own process.
"""

from __future__ import annotations

import asyncio
import os
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


class Tok:
    """Stub tokenizer: no EOS, so every request runs to max_tokens."""

    eos_token_id = -1

    def is_eos(self, t):
        return False

    def decode(self, ids):
        return "".join(chr(32 + i % 90) for i in ids)

    def encode(self, text):
        return [ord(c) % 256 for c in text]

    def vocab_bytes(self):
        return [bytes([i % 256]) for i in range(256)]


def run_ranks(scenario: str, world: int, inputs: dict, workdir: Path,
              timeout: float = 240.0) -> list[dict]:
    from blazr_tpu_torch.parallel.multihost import RankPool

    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    device = "cuda" if scenario.startswith("card") else "cpu"
    with RankPool(world, Path(workdir), device, env) as pool:
        try:
            return pool.run(f"{Path(__file__).resolve()}:scenario", world,
                            {"scenario": scenario, "inputs": inputs}, timeout)
        except RuntimeError as e:
            raise AssertionError(f"{scenario}: world of {world} failed\n{e}") from None


# ---------------------------------------------------------------------------
# scenarios (run inside the ranks)
# ---------------------------------------------------------------------------

def _app(cfg, mesh: dict, **inf):
    from blazr_tpu_torch.config import AppConfig

    app = AppConfig(model=cfg)
    app.inference.max_seq_len = inf.pop("max_seq_len", 64)
    app.inference.max_batch_size = inf.pop("max_batch_size", 4)
    app.inference.tensor_parallel_size = mesh.get("tp", 1)
    app.inference.expert_parallel_size = mesh.get("ep", 1)
    app.inference.sequence_parallel_size = mesh.get("sp", 1)
    for k, v in inf.items():
        setattr(app.inference, k, v)
    return app


def _model(case: dict):
    import copy

    from blazr_tpu_torch.models.registry import Model

    return Model(copy.deepcopy(case["cfg"]), copy.deepcopy(case["params"]), torch.float32)


async def _serve(eng, waves, gen):
    """Waves of prompts; each later wave once the previous wave has its first
    tokens. The token streams in submit order."""
    task = asyncio.create_task(eng.run())
    streams = []
    for wave in waves:
        handles = [eng.submit(p, gen()) for p in wave]
        firsts = [await asyncio.wait_for(h.queue.get(), timeout=120) for h in handles]
        streams.append((handles, firsts))
    out = []
    for handles, firsts in streams:
        rest = await asyncio.gather(*[asyncio.wait_for(
            _collect(h), 120) for h in handles])
        out += [[f[0].token_id] + r for f, r in zip(firsts, rest)]
    eng.stop()
    await task
    return out


async def _collect(handle):
    return [t.token_id async for t in handle.tokens()]


def cache_shapes(cache, prefix: str = "") -> dict:
    """Every tensor plane of a cache (a hybrid's parts under ``kv.``/``ssm.``)
    by name: its shape."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(cache):
        v = getattr(cache, f.name)
        if isinstance(v, torch.Tensor):
            out[prefix + f.name] = list(v.shape)
        elif dataclasses.is_dataclass(v):
            out.update(cache_shapes(v, f"{prefix}{f.name}."))
    return out


def engines(inp: dict) -> dict:
    """Each case: the Executor's prefill logits and greedy streams, and the
    BatchEngine's greedy streams, on the case's mesh."""
    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine
    from blazr_tpu_torch.engine.executor import Executor

    out = {}
    for name, case in inp["cases"].items():
        mesh = case["mesh"]
        res = {}
        if case.get("executor", True):
            model = _model(case)
            ex = Executor(model, Tok(), _app(model.cfg, mesh, **case.get("ex_inf", {})))
            cache = ex._init_cache(1)
            last, _ = ex.prefill(cache, case["logit_prompt"])
            res["logits"] = last.float().cpu().numpy()
            res["ex_tokens"] = [[t.token_id for t in ex.generate(
                p, GenerationConfig(max_tokens=case["n"], temperature=0.0))]
                for p in case["prompts"]]
            res["shape_k"] = list(cache.k.shape) if hasattr(cache, "k") else None
            res["ex_cache"] = cache_shapes(cache)
        if case.get("engine", True):
            model = _model(case)
            eng = BatchEngine(model, Tok(), _app(model.cfg, mesh, **case.get("inf", {})))
            res["be_tokens"] = asyncio.run(_serve(
                eng, case["waves"],
                lambda: GenerationConfig(max_tokens=case["n"], temperature=0.0)))
            res["be_cache_k"] = list(eng.cache.k.shape) if hasattr(eng.cache, "k") else None
            res["be_cache"] = cache_shapes(eng.cache)
            res["sp_prefills"] = eng.perf.get("sp_prefill_n", 0)
        out[name] = res
    return out


def ring(inp: dict) -> dict:
    """ring_attention of this rank's block under each window."""
    import torch.distributed as dist

    from blazr_tpu_torch.parallel.multihost import serving_mesh
    from blazr_tpu_torch.parallel.mesh import MeshConfig
    from blazr_tpu_torch.parallel.ring_attention import ring_attention

    world = dist.get_world_size()
    axis = serving_mesh(MeshConfig(sp=world), torch.device("cpu")).axis("sp")
    q, k, v = (torch.from_numpy(inp[n]) for n in ("q", "k", "v"))
    s = q.shape[1] // world
    blk = slice(axis.index * s, (axis.index + 1) * s)
    return {str(w): ring_attention(q[:, blk], k[:, blk], v[:, blk], axis,
                                   sliding_window=w).numpy()
            for w in inp["windows"]}


def moe_ep(inp: dict) -> dict:
    """moe_ffn_ep on this rank's experts (ep x tp mesh), each capacity."""
    from blazr_tpu_torch.parallel.ep import DROPPED_TOKENS, moe_ffn_ep
    from blazr_tpu_torch.parallel.mesh import MeshConfig
    from blazr_tpu_torch.parallel.multihost import serving_mesh
    from blazr_tpu_torch.parallel.tp import shard_params

    mesh = serving_mesh(MeshConfig(**inp["mesh"]), torch.device("cpu"))
    moe = inp["moe"]
    moe.ep_count_drops = True
    layer = shard_params({"layers": [{"moe": inp["p"]}], "embed": torch.zeros(
        inp["vocab"], 4)}, mesh, inp["cfg"])["layers"][0]["moe"]
    x = torch.from_numpy(inp["x"])
    out = {}
    for cap in inp["capacities"]:
        before = DROPPED_TOKENS["count"]
        out[str(cap)] = (moe_ffn_ep(x, layer, moe, capacity=cap).numpy(),
                         DROPPED_TOKENS["count"] - before)
    return out


def lockstep(inp: dict) -> dict:
    """Rank 0 drives a LockstepEngine: requests in two waves, one cancelled
    after its first token and one whose grammar does not parse; the others
    mirror it."""
    import torch.distributed as dist

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.distributed.lockstep import LockstepEngine
    from blazr_tpu_torch.engine.batch_engine import BatchEngine

    case = inp["case"]
    model = _model(case)
    eng = BatchEngine(model, Tok(), _app(model.cfg, case["mesh"]))
    ls = LockstepEngine(eng, heartbeat_s=0.5)

    async def primary():
        task = asyncio.create_task(ls.run())
        gen = lambda: GenerationConfig(max_tokens=case["n"], temperature=0.0)  # noqa: E731
        out = []
        for wave in case["waves"]:
            handles = [await ls.submit(p, gen()) for p in wave]
            out += await asyncio.gather(*[asyncio.wait_for(_collect(h), 120)
                                          for h in handles])
        victim = await ls.submit(case["waves"][0][0], GenerationConfig(
            max_tokens=50, temperature=0.0))
        first = await victim.queue.get()
        ls.cancel(victim.seq_id)
        rest = await asyncio.wait_for(_collect(victim), 60)
        failed = None
        try:
            await ls.submit([1, 2, 3], GenerationConfig(max_tokens=4, grammar='root ::= "a'))
        except Exception as e:                # fails alone, the world goes on
            failed = type(e).__name__
        await asyncio.sleep(1.2)              # idle past the heartbeat
        after = await ls.submit(case["waves"][0][0], gen())
        again = await asyncio.wait_for(_collect(after), 120)
        ls.stop()
        await task
        return {"streams": out, "cancelled": 1 + len(rest), "first": first[0].token_id,
                "failed": failed, "again": again}

    res = asyncio.run(primary()) if dist.get_rank() == 0 else {}
    if dist.get_rank() != 0:
        asyncio.run(ls.run())
    res["steps"] = ls.steps
    res["finished"] = eng.scheduler.has_work
    return res


def features(inp: dict) -> dict:
    """Under tp 2: BatchEngine speculation (prompt lookup, a draft sliced
    like the target, a draft left whole), the speculative executors, an image
    chat through the MultimodalExecutor and as a lockstep op driven by rank 0,
    and both engines' LoRA refusal."""
    import logging

    import torch.distributed as dist

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.config.inference import SpeculativeDecodingConfig
    from blazr_tpu_torch.distributed.lockstep import LockstepEngine, LockstepMedia
    from blazr_tpu_torch.engine.batch_engine import BatchEngine
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.engine.executor_multimodal import (MediaBoundExecutor,
                                                             MultimodalExecutor)
    from blazr_tpu_torch.engine.speculative import PromptLookupExecutor, SpeculativeExecutor
    from blazr_tpu_torch.loader import load_model

    mesh, k, n = {"tp": 2}, inp["k"], inp["n"]

    def load(name):
        return load_model(inp["dirs"][name], dtype="f32", device="cpu")[0]

    def gen(m):
        return GenerationConfig(max_tokens=m, temperature=0.0, repeat_penalty=1.0)

    def spec_app(cfg):
        return _app(cfg, mesh, speculative=SpeculativeDecodingConfig(num_speculative_tokens=k))

    warnings: list[str] = []

    class Grab(logging.Handler):
        def emit(self, rec):
            warnings.append(rec.getMessage())

    logging.getLogger("blazr_tpu_torch.engine.batch_engine").addHandler(Grab(logging.WARNING))
    out: dict = {"spec": {}}
    for draft in ("lookup", "llama", "draft3"):
        model = load("llama")
        dm = None if draft == "lookup" else load(draft)
        eng = BatchEngine(model, Tok(), spec_app(model.cfg), draft_model=dm)
        streams = asyncio.run(_serve(eng, inp["waves"], lambda: gen(n)))
        out["spec"][draft] = {"streams": streams, "drafted": eng.spec_drafted,
                              "accepted": eng.spec_accepted,
                              "draft_sliced": dm is not None and dm.mesh is not None}
    out["warnings"] = warnings
    target, draft = load("llama"), load("llama")
    ex = Executor(target, Tok(), _app(target.cfg, mesh))
    pl = PromptLookupExecutor(ex, num_speculative_tokens=k)
    out["pl"] = ([t.token_id for t in pl.generate(inp["spec_prompt"], gen(n))],
                 pl.stats.drafted, pl.stats.accepted)
    dex = Executor(draft, Tok(), _app(draft.cfg, mesh))
    se = SpeculativeExecutor(dex, ex, SpeculativeDecodingConfig(num_speculative_tokens=k))
    out["se"] = ([t.token_id for t in se.generate(inp["spec_prompt"], gen(n))],
                 se.stats.drafted, se.stats.accepted)

    model = load("llava")
    ex = Executor(model, Tok(), _app(model.cfg, mesh))
    eng = BatchEngine(model, Tok(), _app(model.cfg, mesh))
    out["lora"] = []
    for obj in (ex, eng):
        try:
            obj.set_lora(object())
            out["lora"].append(None)
        except ValueError as e:
            out["lora"].append(str(e))
    mm = MultimodalExecutor(ex, model.vision_params, model.vision_cfg)
    out["mm"] = [t.token_id for t in mm.generate_multimodal(
        inp["mm_prompt"], images=[inp["png"]], gen_cfg=gen(8))]
    ls = LockstepEngine(eng, heartbeat_s=0.5, executor=ex)

    def chat(bound, prompt, m):
        return [t.token_id for t in bound.generate(prompt, gen(m))]

    async def primary():
        def bind(images):           # on the loop, as the server binds a chat
            return LockstepMedia(ls, MediaBoundExecutor(mm, images, []))

        task = asyncio.create_task(ls.run())
        got = await asyncio.to_thread(chat, bind([inp["png"]]), inp["mm_prompt"], 8)
        bad = None
        try:
            await asyncio.to_thread(chat, bind([b"not an image"]), [1, 2], 2)
        except Exception as e:                # fails alone, the world goes on
            bad = type(e).__name__
        text = await asyncio.wait_for(_collect(await ls.submit(inp["mm_prompt"], gen(4))),
                                      120)
        again = await asyncio.to_thread(chat, bind([inp["png"]]), inp["mm_prompt"], 8)
        ls.stop()
        await task
        return {"chat": got, "bad": bad, "text": text, "again": again}

    if dist.get_rank() == 0:
        out["lockstep"] = asyncio.run(primary())
    else:
        asyncio.run(ls.run())
    return out


def card_tp(inp: dict) -> dict:
    """On the card (ranks sharing it over gloo): the tp Executor's prefill
    logits and greedy tokens, with B1's and B2's launches."""
    from blazr_tpu_torch.attention.paged_attention import paged_attention_decode
    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.quant.kernels import qmm
    from blazr_tpu_torch.utils.synthetic import synth_llama_params

    cfg = inp["cfg"]
    params = synth_llama_params(cfg, quant="awq", dtype=torch.float32, group_size=32,
                                seed=inp["seed"], device="cuda")
    ex = Executor(Model(cfg, params, torch.float32), Tok(), _app(cfg, inp["mesh"]))
    qmm.launches = 0
    cache = ex._init_cache(1)
    last, _ = ex.prefill(cache, inp["prompt"])
    toks = [t.token_id for t in ex.generate(inp["prompt"], GenerationConfig(
        max_tokens=inp["n"], temperature=0.0))]
    return {"logits": last.float().cpu().numpy(), "tokens": toks, "qmm": qmm.launches,
            "backend": torch.distributed.get_backend()}


SCENARIOS = {"engines": engines, "ring": ring, "moe_ep": moe_ep, "lockstep": lockstep,
             "features": features, "card_tp": card_tp}


def scenario(job: dict) -> dict:
    """A RankPool job: one scenario on this rank, with one thread."""
    torch.set_num_threads(1)
    return SCENARIOS[job["scenario"]](job["inputs"])
