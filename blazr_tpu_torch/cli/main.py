"""Command-line interface.

Counterpart of ``blazr_tpu/cli/main.py``: ``run`` and ``generate`` (one
prompt, or a REPL, through the Executor), ``chat`` (a multi-turn REPL over
the chat template, the Executor's session cache reused across turns),
``serve`` (the OpenAI-compatible HTTP server, optionally over the
continuous-batching engine; ``--tls-cert``/``--tls-key`` serve HTTPS),
``bench`` (the prompt-length sweep of ``engine/bench.py``), ``convert``
(safetensors ↔ GGUF), ``info`` (a checkpoint's metadata as JSON), ``list``
(the models of a directory), ``ps`` (a running server's loaded models),
``tokenize``, ``completions`` (a bash or zsh completion script) and
``pull`` (a Hub download; needs ``huggingface_hub`` and a network). The
commands that load a model run on ``cuda`` unless ``--device cpu``.
``run`` and ``serve --continuous-batching`` speculate under
``--prompt-lookup`` or ``--draft-model`` (``--num-speculative-tokens``);
``serve`` without ``--continuous-batching`` refuses both, and so does
either command given both.
``run``, ``generate`` and ``serve`` take ``--device-layers N`` (layer
offload: the other layers stream from host RAM, through the Executor; ``serve
--continuous-batching`` refuses it, ROADMAP §C), ``--moe-offload
auto|gpu|cpu|hybrid`` and ``--moe-device-experts K`` (MoE expert offload), as
the JAX ``run`` and ``generate`` do (cli/main.py:40-70, :299-320); the JAX
``serve`` lacks the three.
``run``, ``generate`` and ``serve`` take ``--tp``, ``--sp`` and ``--ep``
(``auto``: every card): without ``--num-processes`` the command starts the
mesh's other ranks on this host itself (``parallel/multihost.py``;
``--device cpu`` runs them on the CPU over gloo), and ``serve`` then serves
HTTP from rank 0 through ``distributed/lockstep.py`` (continuous batching is
forced, as the JAX ``serve`` forces it in a multi-process world). With the
global ``--coordinator/--num-processes/--process-id`` each command is one
rank (JAX cli/main.py:225-252). Every family is served on such a mesh, and
the mesh flags combine with ``--mmproj``, ``--draft-model`` and
``--prompt-lookup`` (``run``'s draft Executor is loaded whole on every rank,
as the JAX ``run`` loads it; ``serve``'s draft is sliced like the target by
the batch engine, or left whole where it cannot be). ``swarm`` (leader and workers, pipeline
stages over TCP) and ``disagg`` (router, prefill and decode workers; the
router serves ``/v1/completions`` with ``--port``) are the JAX commands.

    python -m blazr_tpu_torch.cli serve --model FILE.gguf --continuous-batching
    python -m blazr_tpu_torch.cli serve --model DIR --tls-cert cert.pem --tls-key key.pem
    python -m blazr_tpu_torch.cli run DIR --prompt "..." --device cpu
    python -m blazr_tpu_torch.cli run DIR --prompt "..." --prompt-lookup
    python -m blazr_tpu_torch.cli serve --model DIR --continuous-batching --draft-model DRAFT
    python -m blazr_tpu_torch.cli generate DIR "..." -t 0
    python -m blazr_tpu_torch.cli run DIR --prompt "..." --device-layers 16
    python -m blazr_tpu_torch.cli run MIXTRAL --prompt "..." --moe-offload hybrid
    python -m blazr_tpu_torch.cli info DIR
    python -m blazr_tpu_torch.cli --device cpu serve --model DIR --tp 2 --continuous-batching
    python -m blazr_tpu_torch.cli run DIR --prompt "..." --ep 2
    python -m blazr_tpu_torch.cli swarm leader --model DIR --world-size 2 &
    python -m blazr_tpu_torch.cli swarm worker
    python -m blazr_tpu_torch.cli disagg router --model DIR --port 8090 &
    python -m blazr_tpu_torch.cli bench FILE.gguf --prompt-lens 32,128,512
    python -m blazr_tpu_torch.cli convert DIR out.gguf --quant Q4_K
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Optional

# Commands of the JAX CLI this one does not run, with the ROADMAP queue A
# item that ports them: none since swarm and disagg (item 13) were ported.
NOT_PORTED: dict[str, str] = {}

# The commands that load a model onto a mesh's ranks (--tp/--sp/--ep).
MESH_COMMANDS = ("run", "generate", "serve")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="blazr-tpu-torch",
        description="quantized LLM inference on an NVIDIA GPU (PyTorch/CUDA port)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default) or cpu")
    p.add_argument("--coordinator", default=None,
                   help="multi-process coordinator address host:port")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process world size")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank in the multi-process world")
    sub = p.add_subparsers(dest="command", required=True)

    loadopts = argparse.ArgumentParser(add_help=False)
    loadopts.add_argument("--dtype", choices=["f32", "f16", "bf16"])
    loadopts.add_argument("--kv-cache-dtype", choices=["auto", "int8", "int4"],
                          default="auto")
    loadopts.add_argument("--quant-compute",
                          choices=["auto", "w4a16", "w4a8", "w8a8", "w4a8-prefill"],
                          default=None)
    loadopts.add_argument("--device-layers", type=int, default=None, metavar="N",
                          help="decoder layers kept on the card; the rest stream from "
                               "host RAM (the reference's n-gpu-layers)")
    loadopts.add_argument("--moe-offload", choices=["auto", "gpu", "cpu", "hybrid"],
                          default=None,
                          help="MoE expert offload: the hot experts on the card, the "
                               "cold ones in host RAM")
    loadopts.add_argument("--moe-device-experts", type=int, default=None, metavar="K",
                          help="card-resident experts a layer under --moe-offload "
                               "(default: half for hybrid, one for cpu)")
    loadopts.add_argument("--tp", default=None, metavar="N",
                          help="tensor-parallel degree ('auto' = every card)")
    loadopts.add_argument("--sp", default=None, metavar="N",
                          help="sequence-parallel degree: long prompts prefill with ring "
                               "attention over the ranks")
    loadopts.add_argument("--ep", default=None, metavar="N",
                          help="expert-parallel degree: MoE experts split over the ranks")
    loadopts.add_argument("--mmproj", default=None, metavar="PATH",
                          help="GGUF vision projector (mmproj) sidecar for multimodal "
                               "models (auto-detected when colocated with the model)")

    specopts = argparse.ArgumentParser(add_help=False)
    specopts.add_argument("--prompt-lookup", action="store_true",
                          help="speculative decoding with drafts from n-gram matches in "
                               "the sequence's own history (greedy rows)")
    specopts.add_argument("--draft-model", default=None, metavar="PATH",
                          help="speculative decoding with this (smaller) draft model")
    specopts.add_argument("--num-speculative-tokens", type=int, default=5)

    run = sub.add_parser("run", help="run a model (one-shot or REPL)",
                         parents=[loadopts, specopts])
    run.add_argument("model", help="model dir / file")
    run.add_argument("--prompt", "-p", help="prompt (omits REPL)")
    run.add_argument("--max-tokens", "-n", type=int, default=256)
    run.add_argument("--temperature", "-t", type=float, default=0.7)
    run.add_argument("--top-p", type=float, default=0.9)
    run.add_argument("--top-k", type=int, default=40)
    run.add_argument("--seed", type=int)
    run.add_argument("--grammar", help="GBNF grammar file or inline")
    run.add_argument("--json", action="store_true", dest="json_mode")
    run.add_argument("--mirostat", type=int, choices=[0, 2], default=0,
                     help="mirostat v2 on the host (a flag the JAX CLI lacks)")
    run.add_argument("--no-warmup", action="store_true")

    gen = sub.add_parser("generate", help="alias of run --prompt", parents=[loadopts])
    gen.add_argument("model")
    gen.add_argument("prompt")
    gen.add_argument("--max-tokens", "-n", type=int, default=256)
    gen.add_argument("--temperature", "-t", type=float, default=0.7)

    chat = sub.add_parser("chat", help="multi-turn chat REPL")
    chat.add_argument("model")
    chat.add_argument("--system", help="system prompt")
    chat.add_argument("--template", help="chat template override")
    chat.add_argument("--max-tokens", "-n", type=int, default=512)
    chat.add_argument("--temperature", "-t", type=float, default=0.7)
    chat.add_argument("--dtype", choices=["f32", "f16", "bf16"])

    serve = sub.add_parser("serve", help="start the OpenAI-compatible server",
                           parents=[loadopts, specopts])
    serve.add_argument("--model", default=os.environ.get("BLAZR_TPU_MODEL_DIR", "."))
    serve.add_argument("--host", default="0.0.0.0")
    serve.add_argument("--port", type=int, default=8080)
    serve.add_argument("--api-key", action="append", default=None,
                       help="require this bearer key (repeatable)")
    serve.add_argument("--max-inflight-tokens", type=int)
    serve.add_argument("--max-loaded", type=int, default=1)
    serve.add_argument("--no-warmup", action="store_true")
    serve.add_argument("--continuous-batching", action="store_true",
                       help="serve through the paged continuous-batching engine")
    serve.add_argument("--max-batch-size", type=int, default=8)
    serve.add_argument("--decode-horizon", type=int, default=8,
                       help="decode steps per engine round")
    serve.add_argument("--tls-cert", metavar="PEM", help="serve HTTPS with this certificate "
                       "chain (with --tls-key)")
    serve.add_argument("--tls-key", metavar="PEM", help="the certificate's private key")

    bench = sub.add_parser("bench", help="benchmark a model")
    bench.add_argument("model", nargs="?", help="model dir / file (synthetic if omitted)")
    bench.add_argument("--prompt-lens", default="32,128,512")
    bench.add_argument("--decode-tokens", type=int, default=128)
    bench.add_argument("--runs", type=int, default=3)
    bench.add_argument("--json", dest="json_out", help="write JSON results to file")
    bench.add_argument("--dtype", choices=["f32", "f16", "bf16"])
    bench.add_argument("--profile", metavar="DIR",
                       help="write a torch.profiler trace (Chrome trace JSON) to DIR")

    info = sub.add_parser("info", help="show checkpoint metadata")
    info.add_argument("model")

    lst = sub.add_parser("list", help="list local models")
    lst.add_argument("--dir", default=os.environ.get("BLAZR_TPU_MODEL_DIR", "."))

    ps = sub.add_parser("ps", help="query a running server for loaded models")
    ps.add_argument("--host", default="localhost")
    ps.add_argument("--port", type=int, default=8080)

    tok = sub.add_parser("tokenize", help="tokenize text with a model's tokenizer")
    tok.add_argument("model")
    tok.add_argument("text")

    comp = sub.add_parser("completions", help="emit a shell completion script")
    comp.add_argument("shell", choices=["bash", "zsh"], nargs="?", default="bash")

    pull = sub.add_parser("pull", help="download a model from HF Hub")
    pull.add_argument("repo_id")
    pull.add_argument("--dest", default=None)
    pull.add_argument("--revision", default="main")

    conv = sub.add_parser("convert", help="convert checkpoint formats")
    conv.add_argument("src")
    conv.add_argument("dst")
    conv.add_argument("--quant", default=None,
                      help="ggml quant type for GGUF output (Q8_0, Q4_K, ...)")

    swarm = sub.add_parser("swarm", help="pipeline-parallel swarm node")
    swarm.add_argument("role", choices=["leader", "worker"])
    swarm.add_argument("--model", help="model dir (leader)")
    swarm.add_argument("--seed", default="127.0.0.1:29500",
                       help="leader seed address host:port")
    swarm.add_argument("--world-size", type=int, default=2)
    swarm.add_argument("--capacity", type=int, default=2048)
    swarm.add_argument("--dtype", choices=["f32", "f16", "bf16"])
    swarm.add_argument("--mdns", action="store_true",
                       help="find the leader by a LAN broadcast beacon (no --seed)")

    disagg = sub.add_parser("disagg", help="disaggregated prefill/decode node")
    disagg.add_argument("role", choices=["router", "prefill", "decode"])
    disagg.add_argument("--model", help="model dir (workers; the router's tokenizer)")
    disagg.add_argument("--seed", default="127.0.0.1:29501")
    disagg.add_argument("--world-size", type=int, default=3)
    disagg.add_argument("--prefill-ranks", default="1")
    disagg.add_argument("--decode-ranks", default="2")
    disagg.add_argument("--capacity", type=int, default=2048)
    disagg.add_argument("--dtype", choices=["f32", "f16", "bf16"])
    disagg.add_argument("--port", type=int,
                        help="serve /v1/completions over HTTP on this port (router)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    if args.command in NOT_PORTED:
        print(f"blazr-tpu-torch: '{args.command}' is not ported to the PyTorch/CUDA "
              f"package yet (ROADMAP queue A {NOT_PORTED[args.command]}); "
              "run it with python -m blazr_tpu.cli", file=sys.stderr)
        return 2
    command = {"run": cmd_run, "generate": cmd_generate, "chat": cmd_chat,
               "serve": cmd_serve, "bench": cmd_bench, "info": cmd_info, "list": cmd_list,
               "ps": cmd_ps, "tokenize": cmd_tokenize, "convert": cmd_convert,
               "pull": cmd_pull, "completions": cmd_completions, "swarm": cmd_swarm,
               "disagg": cmd_disagg}[args.command]
    from ..parallel import multihost

    if args.coordinator or args.num_processes:
        # One rank of a world started by hand (or by launch_local).
        multihost.watch_parent()
        multihost.init_distributed(args.coordinator, args.num_processes, args.process_id,
                                   device=args.device)
        return command(args)
    world = _mesh_ranks(args) if args.command in MESH_COMMANDS else 1
    if world <= 1:
        return command(args)
    # The one-command form: this process is rank 0 and starts the others.
    coordinator, procs = multihost.launch_local(
        list(argv if argv is not None else sys.argv[1:]), world)
    try:
        multihost.init_distributed(coordinator, world, 0, device=args.device)
        rc = command(args)
    finally:
        codes = multihost.stop_ranks(procs)
        multihost.shutdown()
    bad = [c for c in codes if c != 0]
    if bad and rc == 0:
        print(f"error: ranks exited with {bad}", file=sys.stderr)
        return 1
    return rc


def _resolve_degree(value) -> int:
    """A --tp/--sp/--ep value: 'auto' → every card (JAX ``_resolve_tp``,
    cli/main.py:288); None → 1."""
    if value in (None, "", "1"):
        return 1
    if value == "auto":
        import torch

        return max(1, torch.cuda.device_count())
    return int(value)


def _mesh(args) -> dict:
    return dict(tp=_resolve_degree(getattr(args, "tp", None)),
                ep=_resolve_degree(getattr(args, "ep", None)),
                sp=_resolve_degree(getattr(args, "sp", None)))


def _mesh_ranks(args) -> int:
    m = _mesh(args)
    return m["tp"] * m["ep"] * m["sp"]


def _load_executor(model_path: str, dtype, device: str, kv_cache_dtype=None,
                   quant_compute=None, prefix_cache: bool = False, mmproj=None,
                   device_layers=None, moe_offload=None, moe_device_experts=None,
                   tp: int = 1, ep: int = 1, sp: int = 1):
    from ..engine.executor import Executor
    from ..loader import load_model
    from ..tokenizer import load_tokenizer

    t0 = time.time()
    model, app_cfg = load_model(model_path, dtype=dtype, device=device, mmproj=mmproj,
                                device_layers=device_layers)
    if moe_offload:
        app_cfg.inference.moe_offload = moe_offload
    if moe_device_experts is not None:
        app_cfg.inference.moe_device_experts = moe_device_experts
    if kv_cache_dtype:
        app_cfg.inference.kv_cache_dtype = kv_cache_dtype
    if quant_compute:
        app_cfg.inference.quant_compute = quant_compute
    if prefix_cache:
        app_cfg.inference.prefix_cache = True
    app_cfg.inference.tensor_parallel_size = tp
    app_cfg.inference.expert_parallel_size = ep
    app_cfg.inference.sequence_parallel_size = sp
    p = Path(model_path)
    tok = load_tokenizer(p.parent if p.is_file() else p)
    ex = Executor(model, tok, app_cfg)
    print(f"loaded {model.cfg.model_type} ({model.hidden_size}d x{model.num_layers}L, "
          f"vocab {model.vocab_size}) on {model.device} in {time.time() - t0:.1f}s",
          file=sys.stderr)
    return ex


def _offload_flags(args) -> dict:
    """The load flags every model-loading command passes on: offload and
    the mesh."""
    return dict(device_layers=args.device_layers, moe_offload=args.moe_offload,
                moe_device_experts=args.moe_device_experts, **_mesh(args))


def _spec_flags(args) -> Optional[str]:
    """Why the speculation flags cannot be served as given, or None."""
    if args.prompt_lookup and args.draft_model:
        return "--prompt-lookup and --draft-model are two draft sources: give one"
    if (args.prompt_lookup or args.draft_model) and args.num_speculative_tokens < 1:
        return "--num-speculative-tokens must be at least 1"
    return None


def _speculator(args, ex):
    """The speculative executor that ``run`` drives under its flags (JAX
    cli/main.py:382-392), or None."""
    if args.prompt_lookup:
        from ..engine.speculative import PromptLookupExecutor

        return PromptLookupExecutor(ex, num_speculative_tokens=args.num_speculative_tokens)
    if args.draft_model:
        from ..config.inference import SpeculativeDecodingConfig
        from ..engine.speculative import SpeculativeExecutor

        draft = _load_executor(args.draft_model, args.dtype, args.device,
                               kv_cache_dtype=args.kv_cache_dtype,
                               quant_compute=args.quant_compute)
        return SpeculativeExecutor(draft, ex, SpeculativeDecodingConfig(
            num_speculative_tokens=args.num_speculative_tokens))
    return None


def _print_speculative(spec, prompt_ids, cfg) -> None:
    """A speculative stream and its acceptance line (JAX :393-402)."""
    t0 = time.time()
    n = 0
    for gt in spec.generate(prompt_ids, cfg):
        print(gt.text, end="", flush=True)
        n += 1
    dt = time.time() - t0
    print(f"\n[{n} tokens, {n / max(dt, 1e-9):.1f} tok/s, "
          f"acceptance {spec.stats.acceptance_rate:.0%}]", file=sys.stderr)


def _print_stream(executor, prompt_ids, cfg) -> None:
    from ..engine.generate_text import stream_generation

    t0 = time.time()
    first = None
    count = 0
    for delta, fin in stream_generation(executor, prompt_ids, cfg):
        if delta:
            if first is None:
                first = time.time()
            count += 1
            print(delta, end="", flush=True)
    dt = time.time() - (first or t0)
    print()
    if count > 1 and dt > 0:
        print(f"[{count} tokens, {count / dt:.1f} tok/s, "
              f"ttft {((first or t0) - t0) * 1e3:.0f} ms]", file=sys.stderr)


def cmd_run(args) -> int:
    from ..config.generation import GenerationConfig

    why = _spec_flags(args)
    if why:
        print(f"error: {why}", file=sys.stderr)
        return 2
    ex = _load_executor(args.model, args.dtype, args.device,
                        kv_cache_dtype=args.kv_cache_dtype,
                        quant_compute=args.quant_compute, mmproj=args.mmproj,
                        **_offload_flags(args))
    if not args.no_warmup:
        ex.warmup()
    cfg = GenerationConfig(max_tokens=args.max_tokens, temperature=args.temperature,
                           top_p=args.top_p, top_k=args.top_k, seed=args.seed,
                           json_mode=args.json_mode, mirostat=args.mirostat)
    if args.grammar:
        g = Path(args.grammar)
        cfg.grammar = g.read_text() if g.exists() else args.grammar
    spec = _speculator(args, ex)

    def answer(text: str) -> None:
        if spec is not None:
            _print_speculative(spec, ex.tokenizer.encode(text), cfg)
        else:
            _print_stream(ex, ex.tokenizer.encode(text), cfg)

    if args.prompt:
        answer(args.prompt)
        return 0
    print("interactive mode — /exit to quit", file=sys.stderr)
    while True:
        try:
            line = input(">>> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if line in ("/exit", "/quit"):
            break
        if line:
            answer(line)
    return 0


def cmd_generate(args) -> int:
    from ..config.generation import GenerationConfig

    ex = _load_executor(args.model, args.dtype, args.device,
                        kv_cache_dtype=args.kv_cache_dtype, quant_compute=args.quant_compute,
                        mmproj=args.mmproj, **_offload_flags(args))
    cfg = GenerationConfig(max_tokens=args.max_tokens, temperature=args.temperature)
    _print_stream(ex, ex.tokenizer.encode(args.prompt), cfg)
    return 0


def cmd_chat(args) -> int:
    """The JAX ``cmd_chat`` (cli/main.py:452): each turn's prompt is the
    whole conversation, so the Executor's session cache (prefix cache on)
    prefills only what the turn adds."""
    from ..config.generation import GenerationConfig
    from ..engine.generate_text import collect_generation
    from ..model_meta.chat_template import ChatMessage, ChatTemplate, TemplateFormat

    ex = _load_executor(args.model, args.dtype, args.device, prefix_cache=True)
    template = (ChatTemplate(TemplateFormat.from_name(args.template)) if args.template
                else ChatTemplate.detect(model_type=ex.model.cfg.model_type))
    msgs: list[ChatMessage] = []
    if args.system:
        msgs.append(ChatMessage("system", args.system))
    cfg = GenerationConfig(max_tokens=args.max_tokens, temperature=args.temperature)
    print("chat mode — /exit to quit", file=sys.stderr)
    while True:
        try:
            line = input("user> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if line in ("/exit", "/quit"):
            break
        if not line:
            continue
        msgs.append(ChatMessage("user", line))
        res = collect_generation(ex, ex.tokenizer.encode(template.apply(msgs)), cfg)
        print(f"assistant> {res.text}")
        msgs.append(ChatMessage("assistant", res.text))
    return 0


def cmd_serve(args) -> int:
    """The JAX ``cmd_serve`` (cli/main.py:487): under
    ``--continuous-batching`` the batch engine serves with the prefix cache
    on and is warmed before the server starts (unless ``--no-warmup``),
    speculating under ``--prompt-lookup`` or ``--draft-model`` (the draft
    loaded by ``load_model``, JAX :531-545); without it the Executor is
    warmed instead, and the speculation flags are refused."""
    from ..config.server import ServerConfig
    from ..engine.model_scheduler import ModelScheduler
    from ..server import run_server

    why = _spec_flags(args)
    if not why and (args.prompt_lookup or args.draft_model) and not args.continuous_batching:
        why = "--prompt-lookup and --draft-model need --continuous-batching"
    if why:
        print(f"error: {why}", file=sys.stderr)
        return 2
    from ..parallel import multihost

    multi = multihost.process_info()["process_count"] > 1
    if multi and not args.continuous_batching:
        print("serve: a multi-process world serves through the batch engine in "
              "lockstep; forcing --continuous-batching", file=sys.stderr)
        args.continuous_batching = True
    api_keys = args.api_key or []
    env_key = os.environ.get("BLAZR_TPU_API_KEY")
    if env_key:
        api_keys.append(env_key)
    scheduler = ModelScheduler(args.model, max_loaded=args.max_loaded,
                               dtype=args.dtype, quant_compute=args.quant_compute,
                               device=args.device, mmproj=args.mmproj,
                               **_offload_flags(args))
    if not args.no_warmup and not args.continuous_batching:
        try:
            scheduler.get_executor("default").warmup()
        except FileNotFoundError:
            print("no default model found; loading on demand", file=sys.stderr)
    cfg = ServerConfig(host=args.host, port=args.port, api_keys=api_keys,
                       max_inflight_tokens=args.max_inflight_tokens,
                       tls_cert=args.tls_cert, tls_key=args.tls_key)
    batch_engine = None
    if args.continuous_batching:
        from ..engine.batch_engine import BatchEngine

        try:
            ex = scheduler.get_executor("default")
        except FileNotFoundError as e:
            print("error: --continuous-batching requires a loadable "
                  f"default model: {e}", file=sys.stderr)
            return 2
        inf = ex.app_cfg.inference
        inf.max_batch_size = args.max_batch_size
        inf.prefix_cache = True
        inf.kv_cache_dtype = args.kv_cache_dtype
        inf.decode_horizon = args.decode_horizon
        draft = None
        if args.prompt_lookup or args.draft_model:
            from ..config.inference import SpeculativeDecodingConfig

            inf.speculative = SpeculativeDecodingConfig(
                draft_model=args.draft_model,
                num_speculative_tokens=args.num_speculative_tokens)
        if args.draft_model:
            from ..loader import load_model

            draft, _ = load_model(args.draft_model, dtype=args.dtype, device=args.device)
        batch_engine = BatchEngine(ex.model, ex.tokenizer, ex.app_cfg, draft_model=draft)
        if not args.no_warmup:
            dt = batch_engine.warmup()
            print(f"batch engine warmed in {dt:.1f}s", file=sys.stderr)
        print(f"continuous batching enabled (max_batch={args.max_batch_size})",
              file=sys.stderr)
    if multi:
        import asyncio

        from ..distributed.lockstep import LockstepEngine

        lockstep = LockstepEngine(batch_engine, executor=ex)
        if not multihost.is_primary():
            # A follower: no HTTP; it mirrors rank 0's op stream until stopped.
            print("serve: lockstep follower (HTTP on rank 0 only)", file=sys.stderr)
            asyncio.run(lockstep.run())
            return 0
        batch_engine = lockstep
    run_server(scheduler, cfg, batch_engine=batch_engine)
    return 0


def _lines():
    """JSON requests on standard input, one a line, until its end."""
    while True:
        try:
            line = input()
        except EOFError:
            return
        if line.strip():
            yield json.loads(line)


def cmd_swarm(args) -> int:
    """Pipeline-parallel swarm mode (the JAX ``cmd_swarm``, cli/main.py:675):
    the leader assigns layer ranges and answers ``{"tokens": [...],
    "max_tokens": N}`` lines on standard input with greedy tokens; a worker
    runs its stage on its device."""
    from ..distributed.swarm import SwarmLeader, SwarmWorker
    from ..distributed.transport import TcpMesh, announce_seed, discover_seed

    host, port = args.seed.rsplit(":", 1)
    if args.role == "worker" and args.mdns:
        host, port = discover_seed()
        print(f"discovered leader at {host}:{port}", file=sys.stderr)
    if args.role == "leader":
        if not args.model:
            print("--model required for the leader", file=sys.stderr)
            return 2
        from ..formats import detect_model_source
        from ..loader import resolve_config

        cfg = resolve_config(detect_model_source(args.model))
        beacon = announce_seed(host, int(port)) if args.mdns else None
        mesh = TcpMesh.bootstrap_leader(args.world_size, host=host, seed_port=int(port))
        if beacon is not None:
            beacon.set()            # every worker connected
        leader = SwarmLeader(mesh, str(Path(args.model).resolve()), cfg.model.num_layers)
        leader.start_workers()
        print(f"swarm ready: {len(leader.schedule.stages)} stages", file=sys.stderr)
        try:
            for req in _lines():
                toks = leader.generate_greedy(req["tokens"], req.get("max_tokens", 32))
                print(json.dumps({"tokens": toks}), flush=True)
        finally:
            leader.shutdown()
            mesh.close()
        return 0
    mesh = TcpMesh.bootstrap_worker((host, int(port)))
    w = SwarmWorker(mesh, capacity=args.capacity, dtype=args.dtype or "bf16",
                    device=args.device)
    w.receive_assignment()
    try:
        w.run_compute_loop()
    finally:
        mesh.close()
    return 0


def cmd_disagg(args) -> int:
    """Disaggregated prefill/decode mode (the JAX ``cmd_disagg``,
    cli/main.py:721): the router routes ``{"tokens", "max_tokens"}`` lines
    on standard input, or serves ``/v1/completions`` with ``--port``; the
    workers run their pool's loop on their device."""
    from ..distributed.disagg import DecodeWorker, DisaggConfig, DisaggRouter, PrefillWorker
    from ..distributed.transport import TcpMesh

    host, port = args.seed.rsplit(":", 1)
    if args.role == "router":
        if args.port and not args.model:
            print("disagg router --port needs --model for the tokenizer", file=sys.stderr)
            return 2
        mesh = TcpMesh.bootstrap_leader(args.world_size, host=host, seed_port=int(port))
        router = DisaggRouter(mesh, DisaggConfig(
            prefill_workers=[int(x) for x in args.prefill_ranks.split(",")],
            decode_workers=[int(x) for x in args.decode_ranks.split(",")]))
        router.wait_workers()
        try:
            if args.port:
                import asyncio

                from ..distributed.disagg import make_router_app
                from ..server.app import serve
                from ..tokenizer import load_tokenizer

                p = Path(args.model)
                app = make_router_app(router, load_tokenizer(p.parent if p.is_file() else p))
                print(f"disagg router serving on :{args.port}", file=sys.stderr)
                try:
                    asyncio.run(serve(app, "0.0.0.0", args.port))
                except KeyboardInterrupt:
                    pass
                return 0
            print("disagg router ready", file=sys.stderr)
            for req in _lines():
                toks = router.route_request(req["tokens"], req.get("max_tokens", 32))
                print(json.dumps({"tokens": toks}), flush=True)
            return 0
        finally:
            router.shutdown()
            mesh.close()
    if not args.model:
        print("--model required for a disagg worker", file=sys.stderr)
        return 2
    mesh = TcpMesh.bootstrap_worker((host, int(port)))
    worker = PrefillWorker if args.role == "prefill" else DecodeWorker
    try:
        worker(mesh, args.model, capacity=args.capacity, dtype=args.dtype or "bf16",
               device=args.device).run_loop()
    finally:
        mesh.close()
    return 0


def cmd_bench(args) -> int:
    """The JAX ``cmd_bench`` (cli/main.py:576); ``--profile`` writes a
    ``torch.profiler`` trace where JAX writes a ``jax.profiler`` one."""
    from ..engine.bench import run_benchmark

    prof: contextlib.AbstractContextManager = contextlib.nullcontext()
    if args.profile:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
    with prof:
        results = run_benchmark(
            model_path=args.model,
            prompt_lens=[int(x) for x in args.prompt_lens.split(",")],
            decode_tokens=args.decode_tokens, runs=args.runs, dtype=args.dtype,
            device=args.device)
    if args.profile:
        out = Path(args.profile)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        print(f"profiler trace written to {out / 'trace.json'}", file=sys.stderr)
    print(json.dumps(results, indent=2))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(results, indent=2))
    return 0


def cmd_info(args) -> int:
    """The JAX ``cmd_info`` (cli/main.py:603): format, quant and path, and
    the GGUF metadata's or the config chain's model keys, as JSON."""
    from ..formats import Gguf, ModelFormat, detect_model_source
    from ..loader import load_varmap, resolve_config

    src = detect_model_source(args.model)
    out = {"format": src.format.value, "quant": src.quant.value, "path": str(src.path)}
    if src.format == ModelFormat.GGUF:
        with Gguf.open(src.path) as g:
            md = g.metadata()
            arch = md.architecture()
            out.update({
                "architecture": arch, "hidden_size": md.embedding_length(),
                "num_layers": md.block_count(), "context_length": md.context_length(),
                "dominant_quant": g.dominant_quant_type(),
                "num_tensors": len(g.tensor_names()),
                "is_mla": md.get_u32(f"{arch}.attention.kv_lora_rank") is not None,
                "is_moe": md.get_u32(f"{arch}.expert_count") is not None})
    else:
        m = resolve_config(src, None if src.config_path else load_varmap(src)).model
        out.update({
            "architecture": m.model_type, "hidden_size": m.hidden_size,
            "num_layers": m.num_layers, "vocab_size": m.vocab_size,
            "is_mla": bool(m.attention and m.attention.is_mla),
            "is_moe": m.moe is not None, "is_ssm": m.ssm is not None})
    print(json.dumps(out, indent=2))
    return 0


def cmd_list(args) -> int:
    from ..engine.model_scheduler import ModelScheduler

    for name in ModelScheduler(args.dir, device=args.device).discover_models():
        print(name)
    return 0


def cmd_ps(args) -> int:
    import urllib.request

    with urllib.request.urlopen(f"http://{args.host}:{args.port}/api/ps", timeout=10) as r:
        print(r.read().decode())
    return 0


def cmd_tokenize(args) -> int:
    from ..tokenizer import load_tokenizer

    p = Path(args.model)
    tok = load_tokenizer(p.parent if p.is_file() else p,
                         gguf_path=p if p.suffix == ".gguf" else None)
    ids = tok.encode(args.text)
    print(json.dumps({"tokens": ids, "count": len(ids)}))
    return 0


_COMPLETION_BASH = """_blazr_tpu_torch() {
  local cur=${COMP_WORDS[COMP_CWORD]}
  local cmds="run generate chat serve bench info list ps tokenize convert \
swarm disagg pull completions"
  if [ $COMP_CWORD -eq 1 ]; then
    COMPREPLY=( $(compgen -W "$cmds" -- "$cur") )
  else
    COMPREPLY=( $(compgen -f -- "$cur") )
  fi
}
complete -F _blazr_tpu_torch blazr-tpu-torch
complete -F _blazr_tpu_torch "python -m blazr_tpu_torch.cli"
"""


def cmd_completions(args) -> int:
    """A shell completion script: the JAX one, for this package's names.
    zsh reads the bash script through its bash-compatibility layer."""
    if args.shell == "zsh":
        print("autoload -U +X bashcompinit && bashcompinit")
    print(_COMPLETION_BASH)
    return 0


def cmd_pull(args) -> int:
    """Download config, tokenizer and weights from the HF Hub (needs
    ``huggingface_hub`` and a network): exit 2 without the package, 1 on a
    failed download, as the JAX ``cmd_pull``."""
    dest = Path(args.dest or args.repo_id.split("/")[-1])
    try:
        from huggingface_hub import snapshot_download
    except ImportError:
        print("huggingface_hub is not installed; cannot pull", file=sys.stderr)
        return 2
    try:
        snapshot_download(args.repo_id, revision=args.revision, local_dir=dest,
                          allow_patterns=["*.safetensors", "*.json", "*.gguf", "*.model"])
    except Exception as e:
        print(f"pull failed (network unavailable?): {e}", file=sys.stderr)
        return 1
    print(f"pulled {args.repo_id} -> {dest}")
    return 0


def cmd_convert(args) -> int:
    from ..loader.convert import convert_checkpoint

    convert_checkpoint(args.src, args.dst, quant=args.quant)
    print(f"converted {args.src} -> {args.dst}")
    return 0
