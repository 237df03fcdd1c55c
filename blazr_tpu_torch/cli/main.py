"""Command-line interface.

Counterpart of ``blazr_tpu/cli/main.py`` for the commands of the port's
entry path: ``run`` (one prompt, or a REPL, through the Executor),
``serve`` (the OpenAI-compatible HTTP server, optionally over the
continuous-batching engine), ``bench`` (the prompt-length sweep of
``engine/bench.py``) and ``convert`` (safetensors ↔ GGUF). They run on
``cuda`` unless ``--device cpu``. The JAX CLI's other commands exit 2 and
name their ROADMAP item.

    python -m blazr_tpu_torch.cli serve --model FILE.gguf --continuous-batching
    python -m blazr_tpu_torch.cli run DIR --prompt "..." --device cpu
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

# Commands of the JAX CLI this one does not run, with the ROADMAP queue A
# item that ports them.
NOT_PORTED = {
    "generate": "item 9", "chat": "item 9", "info": "item 9", "list": "item 9",
    "ps": "item 9", "tokenize": "item 9", "swarm": "item 13", "disagg": "item 13",
    "completions": "item 9", "pull": "item 9",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="blazr-tpu-torch",
        description="quantized LLM inference on an NVIDIA GPU (PyTorch/CUDA port)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the default) or cpu")
    sub = p.add_subparsers(dest="command", required=True)

    loadopts = argparse.ArgumentParser(add_help=False)
    loadopts.add_argument("--dtype", choices=["f32", "f16", "bf16"])
    loadopts.add_argument("--kv-cache-dtype", choices=["auto", "int8", "int4"],
                          default="auto")
    loadopts.add_argument("--quant-compute",
                          choices=["auto", "w4a16", "w4a8", "w8a8", "w4a8-prefill"],
                          default=None)

    run = sub.add_parser("run", help="run a model (one-shot or REPL)",
                         parents=[loadopts])
    run.add_argument("model", help="model dir / file")
    run.add_argument("--prompt", "-p", help="prompt (omits REPL)")
    run.add_argument("--max-tokens", "-n", type=int, default=256)
    run.add_argument("--temperature", "-t", type=float, default=0.7)
    run.add_argument("--top-p", type=float, default=0.9)
    run.add_argument("--top-k", type=int, default=40)
    run.add_argument("--seed", type=int)
    run.add_argument("--no-warmup", action="store_true")

    serve = sub.add_parser("serve", help="start the OpenAI-compatible server",
                           parents=[loadopts])
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

    bench = sub.add_parser("bench", help="benchmark a model")
    bench.add_argument("model", nargs="?", help="model dir / file (synthetic if omitted)")
    bench.add_argument("--prompt-lens", default="32,128,512")
    bench.add_argument("--decode-tokens", type=int, default=128)
    bench.add_argument("--runs", type=int, default=3)
    bench.add_argument("--json", dest="json_out", help="write JSON results to file")
    bench.add_argument("--dtype", choices=["f32", "f16", "bf16"])
    bench.add_argument("--profile", metavar="DIR",
                       help="write a torch.profiler trace (Chrome trace JSON) to DIR")

    conv = sub.add_parser("convert", help="convert checkpoint formats")
    conv.add_argument("src")
    conv.add_argument("dst")
    conv.add_argument("--quant", default=None,
                      help="ggml quant type for GGUF output (Q8_0, Q4_K, ...)")

    for name, item in NOT_PORTED.items():
        sub.add_parser(name, help=f"not ported yet (ROADMAP queue A {item})",
                       add_help=False).add_argument("rest", nargs=argparse.REMAINDER)
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
    return {"run": cmd_run, "serve": cmd_serve, "bench": cmd_bench,
            "convert": cmd_convert}[args.command](args)


def _load_executor(model_path: str, dtype, device: str, kv_cache_dtype=None,
                   quant_compute=None):
    from ..engine.executor import Executor
    from ..loader import load_model
    from ..tokenizer import load_tokenizer

    t0 = time.time()
    model, app_cfg = load_model(model_path, dtype=dtype, device=device)
    if kv_cache_dtype:
        app_cfg.inference.kv_cache_dtype = kv_cache_dtype
    if quant_compute:
        app_cfg.inference.quant_compute = quant_compute
    p = Path(model_path)
    tok = load_tokenizer(p.parent if p.is_file() else p)
    ex = Executor(model, tok, app_cfg)
    print(f"loaded {model.cfg.model_type} ({model.hidden_size}d x{model.num_layers}L, "
          f"vocab {model.vocab_size}) on {model.device} in {time.time() - t0:.1f}s",
          file=sys.stderr)
    return ex


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

    ex = _load_executor(args.model, args.dtype, args.device,
                        kv_cache_dtype=args.kv_cache_dtype,
                        quant_compute=args.quant_compute)
    if not args.no_warmup:
        ex.warmup()
    cfg = GenerationConfig(max_tokens=args.max_tokens, temperature=args.temperature,
                           top_p=args.top_p, top_k=args.top_k, seed=args.seed)
    if args.prompt:
        _print_stream(ex, ex.tokenizer.encode(args.prompt), cfg)
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
            _print_stream(ex, ex.tokenizer.encode(line), cfg)
    return 0


def cmd_serve(args) -> int:
    """The JAX ``cmd_serve`` (cli/main.py:487): under
    ``--continuous-batching`` the batch engine serves with the prefix cache
    on and is warmed before the server starts (unless ``--no-warmup``);
    without it the Executor is warmed instead."""
    from ..config.server import ServerConfig
    from ..engine.model_scheduler import ModelScheduler
    from ..server import run_server

    api_keys = args.api_key or []
    env_key = os.environ.get("BLAZR_TPU_API_KEY")
    if env_key:
        api_keys.append(env_key)
    scheduler = ModelScheduler(args.model, max_loaded=args.max_loaded,
                               dtype=args.dtype, quant_compute=args.quant_compute,
                               device=args.device)
    if not args.no_warmup and not args.continuous_batching:
        try:
            scheduler.get_executor("default").warmup()
        except FileNotFoundError:
            print("no default model found; loading on demand", file=sys.stderr)
    cfg = ServerConfig(host=args.host, port=args.port, api_keys=api_keys,
                       max_inflight_tokens=args.max_inflight_tokens)
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
        batch_engine = BatchEngine(ex.model, ex.tokenizer, ex.app_cfg)
        if not args.no_warmup:
            dt = batch_engine.warmup()
            print(f"batch engine warmed in {dt:.1f}s", file=sys.stderr)
        print(f"continuous batching enabled (max_batch={args.max_batch_size})",
              file=sys.stderr)
    run_server(scheduler, cfg, batch_engine=batch_engine)
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


def cmd_convert(args) -> int:
    from ..loader.convert import convert_checkpoint

    convert_checkpoint(args.src, args.dst, quant=args.quant)
    print(f"converted {args.src} -> {args.dst}")
    return 0
