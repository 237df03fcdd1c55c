#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``blazr_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                      # every phase, result lines
    python3 chip_smoke.py --phases build,b3    # a subset, no result lines
    python3 chip_smoke.py --tree DIR --phases build,timings,executor,serve_int8
        # this script's phases on another checkout's package in DIR (an A/B)
    python3 chip_smoke.py --phases build,layout_times   # B5 and B6 timed alone

Phases, in order; any failure raises and the script exits non-zero:
  1.  print the card (name, power limit) and build csrc/*.cu (B1-B6) with
      nvcc, one process per source, all started together;
  2.  kernel B1 (fused dequant-matmul) against its plain version at the
      Mistral-7B projection shapes (gate+up at the rows around its variants'
      tile edges), the dense families' new shapes (K 3072-18432, N 4608-49152;
      FAMILY_B1_SHAPES) and small edge cases, f16 and f32 included;
  3.  kernel B2 (paged decode attention) against its plain version, with
      its sequence splits (one sequence over 32 splits, split edges, empty
      splits under a window), and at the decode graphs' full-width tables
      (64 and 512 slots, sequences of 1 to 4095 tokens, with and without a
      window) against the plain version and the trimmed tables; then at the
      dense families' geometries (head_dim 96 and 256, 1-71 query heads a kv
      head, Gemma2's softcap 50, score scale and window on its even layers
      only, f32 and int8 KV) past 4096 tokens;
  3b. kernel B3 (int8-activation matmul) against its plain version: the four
      projections at m ∈ {1, 5, 8, 16, 17, 32, 33, 64, 65, 256, 512, 4096}
      (its decode and wgmma variants and their tile edges), groups 32, 64
      and 128, w4a8 and w8a8, bf16, f16 and f32, a GPTQ desc-act perm,
      all-zero rows; its quant kernel's integers equal the CPU's;
  3c. kernel B4 (streaming decode matmul) against its plain version at
      m ∈ {1, 5, 8, 9, 16, 17, 32}, groups 32, 64 and 128, three dtypes;
  3d. kernel B5 (wide KV view) and 3e. kernel B6 (head-major KV cache)
      against their plain versions, bf16, f32 and f16, bs 64/128, B 8/32
      ragged; B=1 and B=32 to 4096 tokens; tables 64 slots wide over short
      sequences (empty splits) with ids outside [0, NB) and seq_len 0
      (exact zeros);
  3f. the layout tools' sweeps (their main path): B2 vs B5, B2 vs B6;
  4.  a full-width 2-layer Mistral-7B AWQ forward_paged, prefill + 4
      teacher-forced decode steps, on the card (bf16) against the CPU (f32);
  4b. the same for the contiguous llama.forward under w8a8 (B3 on the card);
  4c. the Δppl gate: w4a8-prefill and w8a8 within 2% of w4a16;
  5.  the 32-layer Mistral-7B AWQ BatchEngine (16 layers in a full run,
      SERVE_LAYERS; so phases 5b, 5c and 6) serving 8 requests (w4a16)
      in two waves, with decode graphs and without in turns (on, off, off,
      on); the 8 in one wave both ways, where the streams (greedy and
      seeded) and the launch counts must be equal; then a torch.profiler
      pass both ways over one prefill group, and over the 32 decode steps
      after it in a window that holds decode rounds only (device idle
      share, device events a step, the top device operations and the
      longest idle gaps with the host calls inside them);
  5b. the 32-layer Executor under w8a8: a 512-token prompt, 128 greedy
      tokens, in the same turns (the four streams equal), B3 launched 128
      times per forward and B1 never; then 16 decode tokens profiled both
      ways (idle share, top device operations, idle gaps, at most 3
      kernels a B3 call);
  5c. the 8 requests of phase 5 under w4a8-prefill with
      BLAZR_TPU_STREAM_KERNEL=1: B3 (prefill), B4 (decode) and B2 launched;
      the same turns, checks and profiles as phase 5;
  6.  (``prefix``) the 32-layer BatchEngine as ``cli serve
      --continuous-batching`` runs it (prefix cache, warmed): 8 requests
      sharing a 1024-token system prefix with 32-256-token suffixes, 64
      greedy tokens each, in two waves of 4, the prefix cache on, off, off,
      on (per wave: TTFT, tok/s, prompt tokens prefilled, hits, misses; the
      warmup's seconds, graphs and pool); one wave of misses on a warmed
      engine equal to an unwarmed engine's prefix-off streams exactly; the
      hits' first-token logits within 5e-2 of the largest prefix-off logit;
      the host tier on a warmed engine (prefix B evicts prefix A to the
      tier's pinned pool, A restored in place gives a device-tier hit's
      stream exactly; a block's save and restore timed); wave 2's prefill
      group profiled with the cache on and off; B1 and B2 launched;
  7.  the normal entry point: an 8-layer full-width AWQ checkpoint and a
      BPE tokenizer.json written to disk, loaded by load_model (f16) and
      served over HTTP with continuous batching and the prefix cache, the
      engine warmed and not in turns (8 concurrent requests each, the chats
      sharing a system message, then one more chat that hits its cached
      blocks; ``GET /metrics`` parses, counts the tokens sent back and
      reports the engine's prefix-cache hits), then ``python -m
      blazr_tpu_torch.cli serve`` (warmed) as a subprocess;
  8.  the sweeps behind the launch plans, straight through the libraries:
      B1's two variants over rows (TC_MIN_ROWS) and over K splits at decode
      rows, B2 over its split count, B3's two variants over rows
      (DEC_MAX_ROWS) and K splits, B4's K splits, B5's and B6's split
      counts at B2's three points;
  10. (``families``) each dense family (qwen2, qwen3, phi3, gemma, gemma2,
      starcoder2, falcon) at its published width, 2 layers, written to disk
      in its HF layout (AWQ-INT4; Falcon plain bf16) and loaded by
      load_model onto the card: a 64-token prefill and 4 decode steps of
      forward_paged (B1, B2) against the CPU f32 forward at 5e-2 of the
      largest logit, Gemma2 again past a window cut to 64 in a config copy;
      then Qwen3-8B (36 layers, tables 4096 tokens wide; 6 in a full run)
      and Gemma2-9B (42 layers, 8192; 6 in a full run) AWQ-INT4 served as
      ``cli serve --continuous-batching`` serves (prefix cache on, engine warmed): 8 requests of phase 5 in one
      wave, with decode graphs and without (streams equal), tok/s, ms a
      decode step, TTFT, then 32 decode steps profiled (idle share);
  11. (``moe``) the MoE families: B1 against its plain version and timed at
      every expert shape of Mixtral-8x7B, Qwen3-30B-A3B and
      Qwen1.5-MoE-A2.7B (K 768-14336, N 768-14336) at 1, 2, 4, 8, 16 and
      512 rows; each family at its published width, 2 layers, written to
      disk as an AWQ-INT4 checkpoint and loaded by load_model onto the card:
      the paged forward (64 and 37 tokens, 4 decode steps) and the
      contiguous one (64 tokens, 4 decode steps) against the CPU f32
      forward, the CPU taking the card's routing and, layer by layer, the
      card's input: each layer's output and the logits at 5e-2 of their
      largest magnitude; the paged forward again free-running (its drift
      reported), and the share of routing decisions that agree; then
      Mixtral-8x7B (32 layers; 4 in a full run) and Qwen3-30B-A3B (48
      layers; 2 in a full run, MOE_SERVING) AWQ-INT4 served as in phase 10
      (streams equal with
      graphs and without), with B1's launches and device ms a decode step;
  9.  timings (device time of one call: CUDA graphs of many calls), B1 over
      rows 1-512 at every projection, B2 at three batch/context points (and
      at B=8, ctx 1024 on full-width tables: at most 1.2x), B3
      at every projection at m ∈ {1, 8, 512} (w4a8, w8a8) and gate+up at
      4096, its quant kernel, B4 at every projection at m ∈ {1, 8, 16, 32},
      B5 and B6 at B2's three points (``layout_times`` runs only these, and
      is not part of a full run), B1 at the families' shapes (m 8 and 512)
      and B2 at their geometries (B=8, ctx 1024); then one
      ``{"kernels": [...]}`` JSON line
      with each kernel's launches in its serving phase, max error, time,
      bound, plain time and library-call time (B1 and B3: prefill, with
      their decode point under "decode"; B5 and B6: B=8, their other two
      points under "at"), a row each for B1 and B2 at the families'
      shapes, with phase 10's launches (Qwen3-8B with graphs), a row
      for B1 at the MoE expert shapes with phase 11's times and launches
      (Mixtral-8x7B with graphs), and rows for B1 at the MLA and Mamba2
      shapes (phase 2's times; the launches of DeepSeek-V2-Lite's,
      Codestral's and the hybrid's served runs with graphs) and for B2 on
      the hybrid's attention layers (phase 14's launches).
  12. (``gguf``) Mistral-7B-Instruct-v0.2 written as llama.cpp writes a
      Q4_K_M file (architecture llama, permuted Q/K rows, Q4_K with Q6_K for
      the head and for attn_v and ffn_down where ``use_more_bits`` picks,
      F32 norms, Q4_K token_embd, an embedded 32000-token SentencePiece
      tokenizer) at its published width, GGUF_LAYERS layers, alone in a
      directory, and loaded as ``cli serve`` loads it (config and tokenizer
      from the file); the paged and contiguous forwards against the CPU f32
      forward (layer by layer at 5e-2), the paged one free-running in bf16
      (reported) and with the card in f32 (held at F32_FREE_TOL); B1 on the
      file's own Q4_K and Q6_K weights and its Q6_K head at 1, 8 and 512
      rows against its plain version, timed with its bound, and B3 (w4a8)
      and B4 on its Q4_K gate weight; ``cli bench`` on the file as a
      subprocess (TTFT, decode tok/s, ITL percentiles at prompts of 32, 128
      and 512 tokens); ``cli serve --model FILE.gguf --continuous-batching``
      as a subprocess (graphs on) and the same server in this process with
      graphs off: 8 streamed chats one after another, whose greedy streams
      must be equal both ways, then 8 others at once (tok/s, client TTFT),
      whose prompts also go at once, in a fixed order, to a warmed
      BatchEngine with graphs and without: the 8 greedy streams equal.
      Phase 11's forwards also run free-running with the card in f32, held
      at F32_FREE_TOL.
  13. (``mla``) DeepSeek-V2-Lite (MLA + MoE, RECURRENT_CONFIGS): its
      2-layer AWQ-INT4 checkpoint (groups of 64; layer 0 dense, layer 1
      with 64 experts) and a BPE tokenizer.json written once and loaded by
      load_model onto the card; the engine's step (latent pages: prefills
      of 64 and 37 tokens, 4 decode steps) and the contiguous forward (64
      tokens, 4 decode steps) against the CPU f32 forward, layer by layer
      on the card's routing at 5e-2, again with int8 latents, and
      free-running with the card in f32 (F32_FREE_TOL); then the model
      served through a warmed engine (RECURRENT_SERVING: 27 layers, 2 in a
      full run), 8 requests in one wave with graphs and without (streams
      equal; B1 launches a decode step counted inside the decode rounds),
      profiled, and the latent gather's and absorbed
      einsums' share of a decode step; ``cli serve --continuous-batching``
      (streamed chats answered) and ``cli run`` (the Executor's decode
      graph over the latent cache) on the 2-layer checkpoint. Phase 2 holds B1 at its shapes
      (N 576, K 10944) and Codestral's first (RECURRENT_B1_SHAPES).
  14. (``ssm``) Mamba-Codestral-7B and the hybrid at Bamba-9B's widths:
      each 2-layer checkpoint (the hybrid's: one Mamba2 layer, one
      attention layer) held as in phase 13 with prefills of 160 tokens (the
      chunked scan) and 64; Codestral (64 layers, 4 in a full run) and the
      hybrid (32, 4 in a full run) served as in phase 13 (B2 on the
      hybrid's attention layers), with the conv's and scan's share of a
      decode step; the wave of 8 greedy requests equal to the 8 served one
      after another (Codestral with the card in f32); ``cli run`` on both
      2-layer checkpoints.
Phases 10-14 run between phases 7 and 8.
Each serving run sets the launch counts to 0 just before it and reads
them just after; a replayed graph adds the launches it holds, and the
kernels line counts the first run with graphs (the default path). Under
``--tree`` (another checkout, a subset of phases) phase 5b reports that
tree's kernels per B3 call without holding it to this one's limit, and
phase 9 leaves out B3's quant kernel where that tree has none. The last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or run outside a
checkout that holds ``blazr_tpu_torch/``, it prints no result and exits
non-zero. The compiler's full report goes to
``blazr_tpu_torch/csrc/_build/build.log``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TREE = REPO                         # the checkout whose blazr_tpu_torch runs (--tree)
SEED = 0
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
H100_F32_FLOPS = 67e12              # f32 on the CUDA cores
H100_INT8_OPS = 1979e12             # dense int8 tensor-core peak

# Mistral-7B projections (K, N): fused qkv, o, fused gate+up, down.
B1_SHAPES = {"qkv": (4096, 6144), "o": (4096, 4096), "gateup": (4096, 28672),
             "down": (14336, 4096)}
# The dense families' new B1 shapes (K, N) at their published widths.
FAMILY_B1_SHAPES = {"phi3 qkv": (3072, 9216), "phi3 gate+up": (3072, 16384),
                    "qwen3 gate+up": (4096, 24576), "gemma2 gate+up": (3584, 28672),
                    "qwen2 gate+up": (3584, 37888), "gemma gate+up": (3072, 49152),
                    "starcoder2 c_fc": (4608, 18432), "starcoder2 c_proj": (18432, 4608)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def entry_name(mangled: str) -> str:
    """'qmm_int8_wgmma_kernel<8,128,2,bf16>' from a mangled kernel name
    ('...<len><kernel>I<template arguments>E...')."""
    import re

    for run in re.finditer(r"\d+", mangled):       # a hash may run into the length
        start = run.end()
        for i in range(run.start(), start):
            name = mangled[start:start + int(mangled[i:start])]
            if name.endswith(("kernel", "splits", "bf16")):
                break
        after = mangled[start + len(name):start + len(name) + 1]
        if name.endswith(("kernel", "splits", "bf16")) and after == "E":
            return name                                  # not a template
        if name.endswith(("kernel", "splits", "bf16")) and after == "I":
            args = mangled[start + len(name) + 1:].split("EEv")[0]
            short = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32", "a": "s8"}
            out: list[str] = []
            for n, t in re.findall(r"Li(\d+)E|(13__nv_bfloat16|6__half|S1_|f|a)", args):
                out.append(n or (out[0] if t == "S1_" else short[t]))   # S1_: the first again
            return f"{name}<{','.join(out)}>"
    return mangled[:60]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time (ms) of one ``fn()``: ``iters`` calls captured in one CUDA
    graph, replayed once between two events, so a wrapper's host time does
    not hide in the kernel's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def time_eager(fn, iters: int, warmup: int = 2) -> float:
    """Time (ms) of one eager ``fn()`` over ``iters`` calls on the stream:
    the plain versions, and host-bound calls as a caller sees them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, rate: float = H100_BF16_FLOPS) -> tuple[float, str]:
    """The least time (ms) for moving ``nbytes`` and doing ``ops`` at
    ``rate``, and which of the two bounds it."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: B1
# ---------------------------------------------------------------------------

def rand_planes(k, n, bits, gs, gen, dev):
    import torch

    qw = torch.randint(-2 ** 31, 2 ** 31 - 1, (k * bits // 32, n),
                       dtype=torch.int32, device=dev, generator=gen)
    s = torch.rand((k // gs, n), device=dev, generator=gen) * 0.01 + 0.001
    m = torch.rand((k // gs, n), device=dev, generator=gen) * 0.05
    return qw, s, m


def check_b1(dev, gen) -> dict:
    import numpy as np
    import torch

    from blazr_tpu_torch.quant import qtensor
    from blazr_tpu_torch.quant.kernels import qmm, qmm_reference
    from blazr_tpu_torch.quant.matmul import quant_matmul

    # The kernel's bf16 output is off the f32 plain version by half a bf16
    # ulp, at most 2^-8 of the largest output; 8e-3 doubles that for f32
    # sums taken in another order.
    rel_tol = 8e-3
    worst = 0.0

    def one(name, x, qw, s, m, bits, signed, gs):
        nonlocal worst
        got = qmm(x, qw, s, m, bits=bits, signed=signed, group_size=gs, device=dev)
        # f16 x: the plain version rounds it to bf16 as the kernel does.
        xr = x if x.dtype == torch.float16 else x.float()
        ref = qmm_reference(xr, qw, s, m, bits=bits, signed=signed,
                            group_size=gs).float()
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got).all(), name
        err = (got.float() - ref).abs().max().item()
        tol = rel_tol * ref.abs().max().item()
        log(f"  B1 {name:34s} max_abs_err {err:.4g}  tol {tol:.4g}")
        assert err <= tol, f"B1 {name}: {err} > {tol}"
        worst = max(worst, err)
        return err

    for pname, (k, n) in B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 4, 128, gen, dev)
        rows = (1, 4, 5, 8, 16, 64, 65, 128, 129, 512) if pname == "gateup" else (1, 8, 64, 512)
        for m in rows:
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            one(f"{pname} K={k} N={n} m={m}", x, qw, s, mn, 4, True, 128)
    family_worst = 0.0
    for pname, (k, n) in FAMILY_B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 4, 128, gen, dev)
        for m in (1, 8, 64, 512):
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            family_worst = max(family_worst, one(f"{pname} K={k} N={n} m={m}", x, qw, s,
                                                 mn, 4, True, 128))
    small = [  # name, m, k, n, bits, signed, gs, x dtype (m >= 16: tensor cores)
        ("2-bit unsigned gs16", 7, 512, 256, 2, False, 16, torch.bfloat16),
        ("2-bit unsigned gs16 m=100", 100, 512, 256, 2, False, 16, torch.bfloat16),
        ("2-bit signed gs32", 3, 256, 128, 2, True, 32, torch.bfloat16),
        ("8-bit signed gs32", 9, 512, 256, 8, True, 32, torch.bfloat16),
        ("8-bit signed gs32 m=33 N=96", 33, 512, 96, 8, True, 32, torch.bfloat16),
        ("8-bit unsigned gs64", 2, 256, 192, 8, False, 64, torch.bfloat16),
        ("8-bit unsigned gs64 m=130 N=136", 130, 512, 136, 8, False, 64, torch.bfloat16),
        ("4-bit unsigned gs128", 5, 512, 256, 4, False, 128, torch.bfloat16),
        ("4-bit gs256 m=17", 17, 512, 256, 4, True, 256, torch.bfloat16),
        # groups of 8 rows: one per dequantized chunk on tensor cores; 8-bit
        # groups of 4 split a chunk, so they take the split-K variant
        ("4-bit gs8 m=40", 40, 512, 256, 4, True, 8, torch.bfloat16),
        ("8-bit signed gs4 m=40", 40, 512, 128, 8, True, 4, torch.bfloat16),
        ("8-bit unsigned gs4 f32 m=40", 40, 512, 128, 8, False, 4, torch.float32),
        ("ragged N=200 K=384 m=37", 37, 384, 200, 4, True, 128, torch.bfloat16),
        ("ragged N=70 m=1", 1, 256, 70, 4, True, 64, torch.bfloat16),
        ("f32 activations", 6, 512, 256, 4, True, 128, torch.float32),
        ("f32 activations m=40", 40, 512, 256, 4, True, 128, torch.float32),
        ("f16 activations", 6, 4096, 4096, 4, True, 128, torch.float16),
        ("f16 activations m=64 (tensor cores)", 64, 4096, 6144, 4, True, 128,
         torch.float16),
        ("f16 activations m=512 (tensor cores)", 512, 4096, 4096, 4, True, 128,
         torch.float16),
    ]
    for name, m, k, n, bits, signed, gs, dt in small:
        qw, s, mn = rand_planes(k, n, bits, gs, gen, dev)
        x = torch.randn((m, k), device=dev, generator=gen).to(dt)
        one(name, x, qw, s, mn, bits, signed, gs)
    # GPTQ desc-act: the activation permutation gathered before B1.
    rng = np.random.default_rng(SEED)
    k, n, gs = 512, 128, 128
    qweight = rng.integers(0, 2 ** 32, (k // 8, n), dtype=np.uint64).astype(np.uint32)
    qzeros = rng.integers(0, 2 ** 32, (k // gs, n // 8), dtype=np.uint64).astype(np.uint32)
    scales = (rng.random((k // gs, n)) * 0.01 + 0.001).astype(np.float32)
    g_idx = rng.permutation(np.arange(k) // gs).astype(np.int32)
    qt = qtensor.from_gptq(qweight, scales, qzeros, g_idx, gs, device=dev)
    assert qt.perm is not None
    x = torch.randn((4, k), device=dev, generator=gen).to(torch.bfloat16)
    got = quant_matmul(x, qt)
    xp = x.index_select(-1, qt.perm)
    ref = qmm_reference(xp.float(), qt.qweight, qt.scales, qt.mins, bits=4,
                        signed=qt.signed, group_size=gs)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    tol = rel_tol * ref.abs().max().item()
    log(f"  B1 {'GPTQ desc-act perm':34s} max_abs_err {err:.4g}  tol {tol:.4g}")
    assert err <= tol
    return {"max_abs_err": max(worst, err), "families_max_abs_err": family_worst}


B1_ROWS = (1, 8, 16, 32, 64, 128, 512)


def time_b1(dev, gen) -> dict:
    """B1 at every projection over B1_ROWS, and gate+up at m=4096: kernel
    time, bound and torch.matmul on the bf16-dequantized weight (the library
    call); the plain version at gate+up m=8 and m=512; f16 x at the same two
    points."""
    import torch

    from blazr_tpu_torch.quant.kernels import qmm, qmm_reference
    from blazr_tpu_torch.quant.qtensor import dequantize_planes

    gs = 128
    rows = {}
    for pname, (k, n) in B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 4, gs, gen, dev)
        w = dequantize_planes(qw, s, mn, 4, True, gs, torch.bfloat16)
        for m in B1_ROWS + ((4096,) if pname == "gateup" else ()):
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            iters = 5 if m >= 4096 else 20
            ms = time_ms(lambda: qmm(x, qw, s, mn, bits=4, signed=True, group_size=gs,
                                     device=dev), iters=iters)
            library_ms = time_ms(lambda: torch.matmul(x, w), iters=iters)
            nbytes = qw.numel() * 4 + s.numel() * 8 + x.numel() * 2 + m * n * 2
            bms, by = bound(nbytes, 2.0 * m * k * n)
            row = dict(ms=ms, library_ms=library_ms, bound_ms=bms, bound_by=by,
                       plain_ms=None, shape=f"{pname} m={m} K={k} N={n}")
            if pname == "gateup" and m in (8, 512):
                row["plain_ms"] = time_eager(lambda: qmm_reference(
                    x, qw, s, mn, bits=4, signed=True, group_size=gs), iters=3, warmup=1)
                x16 = x.to(torch.float16)
                row["f16_ms"] = time_ms(lambda: qmm(x16, qw, s, mn, bits=4, signed=True,
                                                    group_size=gs, device=dev), iters=iters)
            rows[(pname, m)] = row
            log(f"  B1 {pname} m={m} K={k} N={n}: kernel {ms:.4f} ms "
                f"({2.0 * m * k * n / ms / 1e9:.1f} TFLOP/s), bound {bms:.4f} ms ({by}, "
                f"x{ms / bms:.1f}), torch.matmul(bf16 dequantized) {library_ms:.4f} ms "
                f"(x{ms / library_ms:.2f})"
                + ("" if row["plain_ms"] is None else
                   f", plain {row['plain_ms']:.4f} ms, f16 x {row['f16_ms']:.4f} ms"))
        del w
    return rows


def time_b1_families(dev, gen) -> dict:
    """B1 at the dense families' new shapes (FAMILY_B1_SHAPES), m = 8 and
    512: kernel, bound, plain version and torch.matmul on the
    bf16-dequantized weight."""
    import torch

    from blazr_tpu_torch.quant.kernels import qmm, qmm_reference
    from blazr_tpu_torch.quant.qtensor import dequantize_planes

    gs = 128
    rows = {}
    for pname, (k, n) in FAMILY_B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 4, gs, gen, dev)
        w = dequantize_planes(qw, s, mn, 4, True, gs, torch.bfloat16)
        for m in (8, 512):
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            ms = time_ms(lambda: qmm(x, qw, s, mn, bits=4, signed=True, group_size=gs,
                                     device=dev), iters=20)
            nbytes = qw.numel() * 4 + s.numel() * 8 + x.numel() * 2 + m * n * 2
            bms, by = bound(nbytes, 2.0 * m * k * n)
            row = dict(ms=ms, bound_ms=bms, bound_by=by,
                       library_ms=time_ms(lambda: torch.matmul(x, w), iters=20),
                       plain_ms=time_eager(lambda: qmm_reference(
                           x, qw, s, mn, bits=4, signed=True, group_size=gs), iters=3,
                           warmup=1),
                       shape=f"{pname} m={m} K={k} N={n}")
            rows[(pname, m)] = row
            log(f"  B1 {pname} m={m} K={k} N={n}: kernel {ms:.4f} ms, bound {bms:.4f} ms "
                f"({by}, x{ms / bms:.1f}), torch.matmul(bf16 dequantized) "
                f"{row['library_ms']:.4f} ms (x{ms / row['library_ms']:.2f}), plain "
                f"{row['plain_ms']:.4f} ms")
        del w
    return rows


def b1_launcher(lib, variant, x, qw, s, mn, y, part, m, k, n, bm, splits, per):
    """One launch of a B1 variant straight through the library (its own
    rows per block and K split), on the current stream; not counted."""
    import torch

    ptrs = (x.data_ptr(), qw.data_ptr(), s.data_ptr(), mn.data_ptr())

    def simt():
        stream = torch.cuda.current_stream(x.device).cuda_stream   # the capture's
        assert lib.qmm_launch(*ptrs, part.data_ptr(), y.data_ptr(), m, k, n, 4, 1,
                              128, bm, splits, per, 0, stream) == 0

    def wgmma():
        stream = torch.cuda.current_stream(x.device).cuda_stream
        assert lib.qmm_tc_launch(*ptrs, None, part.data_ptr(), y.data_ptr(), m, k,
                                 n, 4, 1, 128, bm, splits, per, 0, stream) == 0

    return simt if variant == "simt" else wgmma


def b1_variants(dev, gen) -> None:
    """B1's two variants against each other at the Mistral projections and
    the rows around TC_MIN_ROWS, in turns (split-K CUDA-core, wgmma, wgmma,
    CUDA-core), best of each pair: the sweep behind the wrapper's
    TC_MIN_ROWS. Then each variant over its K split count at decode rows:
    the sweep behind the planners' block targets (quant/kernels.py). Calls
    the library directly, so these launches do not count."""
    import torch

    from blazr_tpu_torch.quant import kernels

    lib = kernels._lib()
    for pname, (k, n) in B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 4, 128, gen, dev)
        row = []
        for m in (1, 4, 6, 8, 12, 16, 32, 64):
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
            plan_d = kernels.decode_plan(m, k, n)
            plan_t = kernels.tc_plan(m, k, n)
            part = torch.empty((max(plan_d[1], plan_t[1]), m, n), dtype=torch.float32,
                               device=dev)
            simt = b1_launcher(lib, "simt", x, qw, s, mn, y, part, m, k, n, *plan_d)
            wgmma = b1_launcher(lib, "wgmma", x, qw, s, mn, y, part, m, k, n, *plan_t)
            t = {"simt": [], "wgmma": []}
            for name, fn in (("simt", simt), ("wgmma", wgmma), ("wgmma", wgmma),
                             ("simt", simt)):
                t[name].append(time_ms(fn, iters=20))
            row.append(f"m={m} {min(t['simt']):.4f}/{min(t['wgmma']):.4f}")
        log(f"  B1 {pname} split-K CUDA-core/wgmma ms: " + ", ".join(row))
    for pname, (k, n) in B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 4, 128, gen, dev)
        for variant, m, unit in (("simt", 1, 128), ("simt", 4, 128), ("wgmma", 8, 64),
                                 ("wgmma", 64, 64)):
            plan = (kernels.decode_plan if variant == "simt" else kernels.tc_plan)(m, k, n)
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
            part = torch.empty((16, m, n), dtype=torch.float32, device=dev)
            row = []
            for want in (1, 2, 4, 8, 16):
                per = -(-(k // unit) // want) * unit
                splits = -(-k // per)
                fn = b1_launcher(lib, variant, x, qw, s, mn, y, part, m, k, n, plan[0],
                                 splits, per)
                mark = "*" if splits == plan[1] else ""
                row.append(f"{splits}{mark}: {time_ms(fn, iters=20):.4f}")
            tiles = -(-m // plan[0]) * -(-n // 128)
            log(f"  B1 {variant} {pname} m={m} ({tiles} tiles) ms by K splits "
                f"(* the plan's): " + ", ".join(row))


def b2_splits(dev, gen) -> None:
    """B2 over its split count at B2_SHAPES, straight through the library
    (not counted): the sweep behind split_plan's one-wave rule."""
    import math

    import torch

    from blazr_tpu_torch.attention import paged_attention as pa

    lib = pa._lib()
    h_q, h_kv, d, bs, window = 32, 8, 128, 64, 4096
    for b, ctx in B2_SHAPES:
        s = pa_inputs(dev, gen, b=b, h_q=h_q, h_kv=h_kv, d=d, bs=bs, seq_lens=[ctx] * b)
        mb = s["bt"].shape[1]
        walk = pa.walk_slots(mb, bs, window)
        plan = pa.split_plan(b, h_kv, mb, bs, window)
        out = torch.empty_like(s["q"])
        acc = torch.empty((b, h_q, walk, d), dtype=torch.float32, device=dev)
        ml = torch.empty((b, h_q, walk, 2), dtype=torch.float32, device=dev)
        row = []
        for splits in sorted({1, 2, 3, 4, 5, 6, 8, 12, 16} & set(range(1, walk + 1))):

            def fn():
                stream = torch.cuda.current_stream(dev).cuda_stream
                assert lib.pa_decode_launch(
                    s["q"].data_ptr(), s["kc"].data_ptr(), s["vc"].data_ptr(), None, None,
                    s["bt"].data_ptr(), s["sl"].data_ptr(), None, out.data_ptr(),
                    acc.data_ptr(), ml.data_ptr(), b, h_q, h_kv, d, bs, s["nb"], mb,
                    window, 0.0, 1.0 / math.sqrt(d), splits, 1, 0, 0, stream) == 0

            mark = "*" if splits == plan else ""
            row.append(f"{splits}{mark} ({b * h_kv * splits} blocks): "
                       f"{time_ms(fn, iters=100):.4f}")
        log(f"  B2 B={b} ctx={ctx} ms by splits (* the plan's): " + ", ".join(row))
        del s, acc, ml


def layout_splits(dev, gen) -> None:
    """B5 and B6 over their split counts at B2_SHAPES (seq_len ctx - 1, bs
    64, bf16), straight through the libraries (not counted): the sweep
    behind their plans' one-wave rule and byte floor."""
    import math

    import torch

    from blazr_tpu_torch.tools import bench_pa_headmajor as hm
    from blazr_tpu_torch.tools import bench_pa_wide as wide

    h_q, h_kv, d, bs = 32, 8, 128, 64
    for b, ctx in B2_SHAPES:
        s = pa_inputs(dev, gen, b=b, h_q=h_q, h_kv=h_kv, d=d, bs=bs, seq_lens=[ctx - 1] * b,
                      nb_extra=0)
        mb = s["bt"].shape[1]
        k_hm, v_hm = hm.to_head_major(s["kc"]), hm.to_head_major(s["vc"])
        out = torch.empty_like(s["q"])
        acc = torch.empty((b, h_q, mb, d), dtype=torch.float32, device=dev)
        ml = torch.empty((b, h_q, mb, 2), dtype=torch.float32, device=dev)
        args = (s["bt"].data_ptr(), s["sl"].data_ptr(), out.data_ptr(), acc.data_ptr(),
                ml.data_ptr(), b, h_q, h_kv, d, bs, s["nb"], mb)
        for name, plan, units in (("B5", wide.wide_split_plan, b),
                                  ("B6", hm.headmajor_split_plan, b * h_kv)):
            chosen = plan(b, h_kv, mb, bs, d, 2)[0]
            row = []
            plans = sorted({(-(-mb // -(-mb // want)), -(-mb // want))
                            for want in (1, 2, 4, 8, 12, 16, 24, 32) if want <= mb})
            for splits, per in plans:

                def fn(splits=splits, per=per):
                    stream = torch.cuda.current_stream(dev).cuda_stream
                    if name == "B5":
                        err = wide._lib().pa_wide_launch(
                            s["q"].data_ptr(), s["kc"].data_ptr(), s["vc"].data_ptr(), *args,
                            splits, per, 1.0 / math.sqrt(d), 0, stream)
                    else:
                        err = hm._lib().pa_headmajor_launch(
                            s["q"].data_ptr(), k_hm.data_ptr(), v_hm.data_ptr(), *args,
                            k_hm.shape[1], splits, per, 1.0 / math.sqrt(d), 0, stream)
                    assert err == 0, err

                mark = "*" if splits == chosen else ""
                row.append(f"{splits}{mark} ({units * splits} blocks): "
                           f"{time_ms(fn, iters=100):.4f}")
            log(f"  {name} B={b} seq_len={ctx - 1} ms by splits (* the plan's): "
                + ", ".join(row))
        del s, k_hm, v_hm, acc, ml


def b3_launcher(lib, acts, qw, s, mn, y, part, m, k, n, bits, variant, rows, splits, per):
    """One launch of a B3 product variant straight through the library, on
    the quantized activations ``acts`` (xq, xs, group sums); not counted."""
    import torch

    xq, xs, gsum = acts
    code = 1 if variant == "wgmma" else 0

    def fn():
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        assert lib.qmm_int8_launch(xq.data_ptr(), xs.data_ptr(), gsum.data_ptr(),
                                   qw.data_ptr(), s.data_ptr(), mn.data_ptr(),
                                   part.data_ptr(), y.data_ptr(), m, k, n, bits, 128, code,
                                   rows, splits, per, 0, stream) == 0

    return fn


def turns(fns: dict, iters: int = 20) -> dict:
    """Best time of each named launcher over two turns (a, b, b, a)."""
    names = list(fns)
    t = {name: [] for name in names}
    for name in names + names[::-1]:
        t[name].append(time_ms(fns[name], iters=iters))
    return {name: min(v) for name, v in t.items()}


def b3_sweeps(dev, gen) -> None:
    """Phase 8 for B3, straight through the library on pre-quantized
    activations (not counted): the decode (mma) variant against wgmma over
    rows 8-64 (the sweep behind DEC_MAX_ROWS), and each variant over its K
    splits (the planners' block targets)."""
    import torch

    from blazr_tpu_torch.quant import int8

    lib = int8._lib()
    for pname, (k, n) in B1_SHAPES.items():
        for bits in ((4, 8) if pname == "gateup" else (8,)):
            qw, s, mn = rand_planes(k, n, bits, 128, gen, dev)
            part = torch.empty((16 * 64 * n,), dtype=torch.float32, device=dev)
            row = []
            for m in (8, 16, 24, 32, 40, 48, 64):
                x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
                acts = int8.quantize_activations(x, group_size=128, device=dev)
                y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
                fns = {}
                for variant, (rows, splits, per) in (
                        ("mma", int8.mma_plan(m, k, n, 128, bits)),
                        ("wgmma", int8.wgmma_plan(m, k, n, 128))):
                    fns[variant] = b3_launcher(lib, acts, qw, s, mn, y, part, m, k, n, bits,
                                               variant, rows, splits, per)
                t = turns(fns)
                row.append(f"m={m} {t['mma']:.4f}/{t['wgmma']:.4f}")
            log(f"  B3 w{bits}a8 {pname} mma/wgmma ms: " + ", ".join(row))
    for pname, (k, n) in B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 8, 128, gen, dev)
        part = torch.empty((16 * 512 * n,), dtype=torch.float32, device=dev)
        for variant, m in (("mma", 1), ("mma", 8), ("wgmma", 64), ("wgmma", 512)):
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            acts = int8.quantize_activations(x, group_size=128, device=dev)
            y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
            if variant == "mma":
                rows, plan, _ = int8.mma_plan(m, k, n, 128, 8)
            else:
                rows, plan, _ = int8.wgmma_plan(m, k, n, 128)
            row = []
            for want in ((1, 2, 4, 8, 16) if variant == "mma" else (1, 2, 4, 8)):
                per = -(-(k // 128) // want) * 128
                splits = -(-k // per)
                fn = b3_launcher(lib, acts, qw, s, mn, y, part, m, k, n, 8, variant, rows,
                                 splits, per)
                row.append(f"{splits}{'*' if splits == plan else ''}: "
                           f"{time_ms(fn, iters=20):.4f}")
            log(f"  B3 w8a8 {variant} {pname} m={m} ms by K splits (* the plan's): "
                + ", ".join(row))


def b4_splits(dev, gen) -> None:
    """Phase 8 for B4: its K split count at m ∈ {1, 8, 32} on the four
    projections, straight through the library (not counted): the sweep
    behind stream_splits' block target."""
    import torch

    from blazr_tpu_torch.quant import kernels

    lib = kernels._stream_lib()
    for pname, (k, n) in B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 4, 128, gen, dev)
        plan = kernels.stream_splits(k, n, 128)[0]
        for m in (1, 8, 32):
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
            xb = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
            xsum = torch.empty((m, k // 128), dtype=torch.float32, device=dev)
            part = torch.empty((16, m, n), dtype=torch.float32, device=dev)
            row = []
            for want in (1, 2, 4, 8, 16):
                per = -(-(k // 128) // want) * 128
                splits = -(-k // per)

                def fn(splits=splits, per=per):
                    stream = torch.cuda.current_stream(dev).cuda_stream
                    assert lib.qmm_stream_launch(
                        x.data_ptr(), qw.data_ptr(), s.data_ptr(), mn.data_ptr(),
                        xb.data_ptr(), xsum.data_ptr(), part.data_ptr(), y.data_ptr(), m, k,
                        n, 4, 128, splits, per, 0, stream) == 0

                row.append(f"{splits}{'*' if splits == plan else ''}: "
                           f"{time_ms(fn, iters=20):.4f}")
            log(f"  B4 {pname} m={m} ms by K splits (* the plan's): " + ", ".join(row))


# ---------------------------------------------------------------------------
# phase 3b/3c: B3 and B4
# ---------------------------------------------------------------------------

B3_ROWS = (1, 5, 8, 16, 17, 32, 33, 64, 65, 256, 512, 4096)
DTYPES = ("bfloat16", "float16", "float32")


def check_b3(dev, gen) -> dict:
    """B3 against its plain version: the four Mistral-7B projections at
    m ∈ B3_ROWS (both variants and their tile edges), w4a8 and w8a8 weights,
    group 128, the activation dtype turning over bf16, f16, f32 with the
    row count (from m=5 with one all-zero row); groups 32 and 64 on qkv in
    all three dtypes; a GPTQ desc-act permutation. The quant kernel's xq, xs
    and group sums must equal the CPU's plain quant as integers."""
    import numpy as np
    import torch

    from blazr_tpu_torch.quant import qtensor
    from blazr_tpu_torch.quant.int8 import (qmm_int8, qmm_int8_reference, quantize_activations,
                                            quantize_activations_reference)
    from blazr_tpu_torch.quant.matmul import quant_matmul

    # Both sides sum exact int32 group partials; they differ by the order of
    # the f32 affine sums (f32: 1e-3 of the largest output) and, in bf16, by
    # the output rounding (2^-9 relative; 8e-3 leaves room for the sums).
    tols = {torch.float32: 1e-3, torch.bfloat16: 8e-3, torch.float16: 8e-3}
    worst = 0.0
    quant_err = 0.0

    def one(name, x, qw, s, mn, bits, gs):
        nonlocal worst, quant_err
        got = qmm_int8(x, qw, s, mn, bits=bits, group_size=gs, device=dev)
        ref = qmm_int8_reference(x.float(), qw, s, mn, bits=bits, group_size=gs)
        card = quantize_activations(x, group_size=gs, device=dev)
        cpu = quantize_activations_reference(x.cpu(), gs)
        torch.cuda.synchronize()
        for a, b in zip(card, cpu):
            quant_err = max(quant_err, (a.cpu().double() - b.double()).abs().max().item())
        assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)), \
            f"B3 {name}: the quant kernel's integers differ from the CPU's"
        assert got.shape == ref.shape and torch.isfinite(got).all(), name
        err = (got.float() - ref).abs().max().item()
        tol = tols[x.dtype] * ref.abs().max().item()
        log(f"  B3 {name:40s} max_abs_err {err:.4g}  tol {tol:.4g}")
        assert err <= tol, f"B3 {name}: {err} > {tol}"
        worst = max(worst, err)

    for pname, (k, n) in B1_SHAPES.items():
        for mode, bits in (("w4a8", 4), ("w8a8", 8)):
            qw, s, mn = rand_planes(k, n, bits, 128, gen, dev)
            for i, m in enumerate(B3_ROWS):
                dt = getattr(torch, DTYPES[(i + bits) % 3])
                x = torch.randn((m, k), device=dev, generator=gen).to(dt)
                if m > 1:
                    x[m // 2] = 0
                one(f"{pname} {mode} m={m} {str(dt)[6:]}", x, qw, s, mn, bits, 128)
    k, n = B1_SHAPES["qkv"]
    for gs in (32, 64):
        for mode, bits in (("w4a8", 4), ("w8a8", 8)):
            qw, s, mn = rand_planes(k, n, bits, gs, gen, dev)
            for i, m in enumerate((1, 17, 64, 512)):
                for dname in DTYPES if m in (17, 512) else DTYPES[i % 2:i % 2 + 1]:
                    x = torch.randn((m, k), device=dev, generator=gen).to(getattr(torch, dname))
                    one(f"qkv {mode} gs={gs} m={m} {dname}", x, qw, s, mn, bits, gs)
    rng = np.random.default_rng(SEED + 3)
    k, n, gs = 512, 128, 128
    qweight = rng.integers(0, 2 ** 32, (k // 8, n), dtype=np.uint64).astype(np.uint32)
    qzeros = rng.integers(0, 2 ** 32, (k // gs, n // 8), dtype=np.uint64).astype(np.uint32)
    scales = (rng.random((k // gs, n)) * 0.01 + 0.001).astype(np.float32)
    g_idx = rng.permutation(np.arange(k) // gs).astype(np.int32)
    qt = qtensor.mark_act_quant(qtensor.from_gptq(qweight, scales, qzeros, g_idx, gs,
                                                  device=dev))
    assert qt.perm is not None
    x = torch.randn((4, k), device=dev, generator=gen).to(torch.bfloat16)
    before = qmm_int8.launches
    got = quant_matmul(x, qt)
    assert qmm_int8.launches == before + 1, "GPTQ w4a8 did not route to B3"
    ref = qmm_int8_reference(x.index_select(-1, qt.perm).float(), qt.qweight,
                             qt.scales, qt.mins, bits=4, group_size=gs)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    tol = tols[torch.bfloat16] * ref.abs().max().item()
    log(f"  B3 {'GPTQ desc-act perm':40s} max_abs_err {err:.4g}  tol {tol:.4g}")
    assert err <= tol
    return {"max_abs_err": max(worst, err), "quant_max_abs_err": quant_err}


B4_ROWS = (1, 5, 8, 9, 16, 17, 32)


def check_b4(dev, gen) -> dict:
    """B4 against its plain version: m ∈ B4_ROWS (its 8-, 16- and 32-row x
    tiles and their edges), signed 4- and 8-bit weights, the four Mistral-7B
    projections at group 128, the activation dtype turning over bf16, f16,
    f32 with the row count; groups 32 and 64 on o in all three dtypes."""
    import torch

    from blazr_tpu_torch.quant.kernels import qmm_stream, qmm_stream_reference

    rel_tol = 8e-3                       # as B1: bf16 output, f32 sums
    worst = 0.0
    cases = [(pname, k, n, bits, m, DTYPES[(i + bits) % 3], 128)
             for pname, (k, n) in B1_SHAPES.items() for bits in (4, 8)
             for i, m in enumerate(B4_ROWS)]
    cases += [("o", 4096, 4096, bits, m, dname, gs) for gs in (32, 64) for bits in (4, 8)
              for m in (1, 9, 32) for dname in DTYPES]
    for pname, k, n, bits, m, dname, gs in cases:
        qw, s, mn = rand_planes(k, n, bits, gs, gen, dev)
        x = torch.randn((m, k), device=dev, generator=gen).to(getattr(torch, dname))
        got = qmm_stream(x, qw, s, mn, bits=bits, group_size=gs, device=dev)
        ref = qmm_stream_reference(x.float(), qw, s, mn, bits=bits, group_size=gs)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got).all(), pname
        err = (got.float() - ref).abs().max().item()
        tol = rel_tol * ref.abs().max().item()
        log(f"  B4 {pname} {bits}-bit gs={gs:<3d} m={m:<3d} {dname:9s} max_abs_err "
            f"{err:.4g}  tol {tol:.4g}")
        assert err <= tol, f"B4 {pname} {bits}-bit m={m}: {err} > {tol}"
        worst = max(worst, err)
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 3: B2
# ---------------------------------------------------------------------------

def pa_inputs(dev, gen, *, b, h_q, h_kv, d, bs, seq_lens, int8=False, nb_extra=8,
              dtype=None, width=None):
    """B2's operands; with ``width`` the tables are that many slots wide (the
    decode graphs' max_blocks_per_seq), each row's own blocks then PAD."""
    import torch

    from blazr_tpu_torch.kvcache.paged import PAD_BLOCK

    mb = max(-(-int(s) // bs) for s in seq_lens)
    nb = b * mb + nb_extra
    perm = torch.randperm(nb, device=dev, generator=gen)[: b * mb]
    tables = perm.reshape(b, mb).to(torch.int32)
    if width is not None:
        full = torch.full((b, width), PAD_BLOCK, dtype=torch.int32, device=dev)
        for i, s in enumerate(seq_lens):
            n = -(-int(s) // bs)
            full[i, :n] = tables[i, :n]
        tables = full
    shape = (nb * bs + 1, h_kv, d)
    ks = vs = None
    if int8:
        kc = torch.randint(-127, 128, shape, device=dev, generator=gen).to(torch.int8)
        vc = torch.randint(-127, 128, shape, device=dev, generator=gen).to(torch.int8)
        ks = torch.rand(shape[:2], device=dev, generator=gen) / 64 + 1 / 128
        vs = torch.rand(shape[:2], device=dev, generator=gen) / 64 + 1 / 128
    dtype = dtype or torch.bfloat16
    if not int8:
        kc = torch.randn(shape, device=dev, generator=gen).to(dtype)
        vc = torch.randn(shape, device=dev, generator=gen).to(dtype)
    q = torch.randn((b, h_q, d), device=dev, generator=gen).to(dtype)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    return dict(q=q, kc=kc, vc=vc, ks=ks, vs=vs, bt=tables, sl=sl, nb=nb, bs=bs)


def check_b2(dev, gen) -> dict:
    import torch

    from blazr_tpu_torch.attention.paged_attention import (
        paged_attention_decode, paged_attention_reference)
    from blazr_tpu_torch.models.layers import alibi_slopes

    ragged = [1024, 700, 513, 64, 1, 999, 300, 130]
    cases = [  # name, geometry, options
        ("mistral B=8 ragged<=1024 W=4096", dict(d=128, bs=64), dict(sliding_window=4096)),
        ("window 256", dict(d=128, bs=64), dict(sliding_window=256)),
        ("int8 KV + window 256", dict(d=128, bs=64, int8=True), dict(sliding_window=256)),
        ("softcap 30", dict(d=128, bs=64), dict(logit_softcap=30.0)),
        ("alibi", dict(d=128, bs=64), dict(alibi=True)),
        ("head_dim 64", dict(d=64, bs=64), {}),
        ("block size 16 + window 100", dict(d=128, bs=16), dict(sliding_window=100)),
        ("f16 W=4096", dict(d=128, bs=64, dtype=torch.float16), dict(sliding_window=4096)),
        ("f16 int8 KV + window 256", dict(d=128, bs=64, int8=True, dtype=torch.float16),
         dict(sliding_window=256)),
        # the sequence splits: one sequence over 32 splits; 32 sequences in
        # one split; block 16 with the window starting inside a split, whole
        # splits empty, a row ending at a split edge and one past it
        ("B=1 ctx 4096 W=4096 (32 splits)", dict(d=128, bs=64, lens=[4096]),
         dict(sliding_window=4096)),
        ("B=32 ragged<=1024 (1 split)", dict(d=128, bs=64, lens=ragged * 4), {}),
        ("split edges bs 16 W=700", dict(d=128, bs=16, lens=[1400, 100, 288, 289, 1, 700,
                                                             701, 1024]),
         dict(sliding_window=700)),
    ]
    # The decode graphs' tables, max_blocks_per_seq wide (64 at 4096 tokens
    # and block 64; 512 at 32768), over sequences of 1 to 4095 tokens: each
    # block takes its span from seq_len on the device.
    full = [1, 63, 64, 65, 577, 1024, 2049, 4095]
    for width in (64, 512):
        for opt in ({}, dict(sliding_window=4096), dict(sliding_window=1000)):
            tag = f" W={opt['sliding_window']}" if opt else ""
            cases.append((f"full width {width} B=8 1..4095{tag}",
                          dict(d=128, bs=64, lens=full, width=width), opt))
        cases.append((f"full width {width} B=1 4095", dict(d=128, bs=64, lens=[4095],
                                                             width=width), {}))
    cases.append(("full width 64 B=32 ragged<=1024", dict(d=128, bs=64, lens=ragged * 4,
                                                          width=64), {}))
    # The dense families (phase 10): head_dim 96 and 256, query heads per kv
    # head 1, 2, 7, 9 and 71, Gemma2's softcap 50 and score scale on its
    # sliding (even) and global (odd) layers, past the 4096-token window.
    fam = [1, 63, 700, 1025, 4097, 5000, 300, 64]
    g2 = dict(logit_softcap=50.0, scale=256 ** -0.5)
    family_cases = [
        ("phi3 d=96 32/32 W=2047", dict(d=96, h_q=32, h_kv=32), dict(sliding_window=2047)),
        ("phi3 d=96 f16", dict(d=96, h_q=32, h_kv=32, dtype=torch.float16), {}),
        ("gemma d=256 16/16", dict(d=256, h_q=16, h_kv=16), {}),
        ("gemma2 d=256 16/8 even layer W=4096", dict(d=256, h_q=16, h_kv=8),
         dict(g2, sliding_window=4096)),
        ("gemma2 d=256 16/8 odd layer", dict(d=256, h_q=16, h_kv=8), g2),
        ("gemma2 full width 128 even layer", dict(d=256, h_q=16, h_kv=8, width=128),
         dict(g2, sliding_window=4096)),
        ("gemma2 full width 128 odd layer", dict(d=256, h_q=16, h_kv=8, width=128), g2),
        ("gemma2 d=256 int8 KV", dict(d=256, h_q=16, h_kv=8, int8=True), g2),
        ("gemma2 d=256 f32", dict(d=256, h_q=16, h_kv=8, dtype=torch.float32), g2),
        ("falcon d=64 71/1", dict(d=64, h_q=71, h_kv=1), {}),
        ("falcon d=64 71/1 f32", dict(d=64, h_q=71, h_kv=1, dtype=torch.float32), {}),
        ("qwen2 d=128 28/4", dict(d=128, h_q=28, h_kv=4), dict(sliding_window=131072)),
        ("starcoder2 d=128 36/4 W=4096", dict(d=128, h_q=36, h_kv=4),
         dict(sliding_window=4096)),
        ("score scale 144^-0.5 d=128 32/16", dict(d=128, h_q=32, h_kv=16),
         dict(logit_softcap=50.0, scale=144 ** -0.5)),
    ]
    cases += [(name, dict(geo, bs=64, lens=fam), opt) for name, geo, opt in family_cases]
    worst = family_worst = 0.0
    first_family = len(cases) - len(family_cases)
    for i, (name, geo, opt) in enumerate(cases):
        geo = dict(geo)
        lens = geo.pop("lens", ragged)
        h_q, h_kv = geo.pop("h_q", 32), geo.pop("h_kv", 8)
        s = pa_inputs(dev, gen, b=len(lens), h_q=h_q, h_kv=h_kv, seq_lens=lens, **geo)
        opt = dict(opt)
        if opt.pop("alibi", False):
            opt["alibi"] = alibi_slopes(h_q, dev) * geo["d"] ** -0.5
        kw = dict(block_size=s["bs"], k_scale=s["ks"], v_scale=s["vs"], **opt)
        got = paged_attention_decode(s["q"], s["kc"], s["vc"], s["bt"], s["sl"],
                                     num_blocks=s["nb"], device=dev, **kw)
        ref = paged_attention_reference(s["q"].float(), s["kc"], s["vc"], s["bt"],
                                        s["sl"], **kw)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got).all(), name
        err = (got.float() - ref).abs().max().item()
        if "width" in geo:                 # the same sequences, trimmed tables
            trim = -(-max(lens) // geo["bs"])
            same = paged_attention_decode(s["q"], s["kc"], s["vc"],
                                          s["bt"][:, :trim].contiguous(), s["sl"],
                                          num_blocks=s["nb"], device=dev, **kw)
            name += f" (trimmed {trim}: max diff {(same - got).abs().max().item():.3g})"
        # Probabilities drop to bf16 (f16) before the AV product and the
        # output is bf16 (f16): 2^-9 (2^-11) relative each, against outputs
        # of order max|v|.
        tol = 1e-2 * max(1.0, ref.abs().max().item())
        log(f"  B2 {name:34s} max_abs_err {err:.4g}  tol {tol:.4g}")
        assert err <= tol, f"B2 {name}: {err} > {tol}"
        if i >= first_family:
            family_worst = max(family_worst, err)
        else:
            worst = max(worst, err)
    return {"max_abs_err": worst, "families_max_abs_err": family_worst}


def sdpa_ms(q, k, v, h_q, h_kv) -> float:
    """One scaled_dot_product_attention call over pre-gathered KV [B, H_kv,
    S, D] (GQA), the library call beside the attention kernels."""
    import torch.nn.functional as F

    qg = q[:, :, None, :]                                      # [B, H_q, 1, D]
    try:
        F.scaled_dot_product_attention(qg, k, v, enable_gqa=True)
        return time_ms(lambda: F.scaled_dot_product_attention(qg, k, v, enable_gqa=True),
                       iters=100)
    except TypeError:                   # PyTorch without enable_gqa
        ke = k.repeat_interleave(h_q // h_kv, dim=1)
        ve = v.repeat_interleave(h_q // h_kv, dim=1)
        return time_ms(lambda: F.scaled_dot_product_attention(qg, ke, ve), iters=100)


B2_SHAPES = ((8, 1024), (8, 4096), (32, 1024))          # (B, context), bf16 KV


def time_b2(dev, gen) -> dict:
    """Mistral decode attention (32/8 heads, D 128, bs 64, window 4096) at
    B2_SHAPES: kernel, bound, SDPA on pre-gathered KV; the plain version, f16
    and the decode graphs' full-width tables (64 slots) at B=8, ctx 1024,
    which must take at most 1.2x the trimmed tables' time."""
    import torch

    from blazr_tpu_torch.attention.paged_attention import (
        paged_attention_decode, paged_attention_reference)
    from blazr_tpu_torch.kvcache.paged import PAD_BLOCK, page_slot_index

    h_q, h_kv, d, bs, window = 32, 8, 128, 64, 4096
    rows = {}
    for b, ctx in B2_SHAPES:
        s = pa_inputs(dev, gen, b=b, h_q=h_q, h_kv=h_kv, d=d, bs=bs, seq_lens=[ctx] * b)
        kw = dict(block_size=bs, sliding_window=window)
        ms = time_ms(lambda: paged_attention_decode(
            s["q"], s["kc"], s["vc"], s["bt"], s["sl"], num_blocks=s["nb"],
            device=dev, **kw), iters=100)
        idx = page_slot_index(bs, s["bt"])                         # [B, ctx]
        k = s["kc"][idx].permute(0, 2, 1, 3).contiguous()          # [B, H_kv, S, D]
        v = s["vc"][idx].permute(0, 2, 1, 3).contiguous()
        library_ms = sdpa_ms(s["q"], k, v, h_q, h_kv)
        del k, v
        keys = min(ctx, window)
        nbytes = (2 * b * keys * h_kv * d * 2 + 2 * b * h_q * d * 2
                  + s["bt"].numel() * 4 + b * 4)
        bms, by = bound(nbytes, 4.0 * b * h_q * keys * d)
        row = dict(ms=ms, library_ms=library_ms, bound_ms=bms, bound_by=by, plain_ms=None,
                   shape=f"B={b} ctx={ctx}")
        extra = ""
        if (b, ctx) == B2_SHAPES[0]:
            row["plain_ms"] = time_eager(lambda: paged_attention_reference(
                s["q"], s["kc"], s["vc"], s["bt"], s["sl"], **kw), iters=10)
            q16, k16, v16 = (s[n].to(torch.float16) for n in ("q", "kc", "vc"))
            row["f16_ms"] = time_ms(lambda: paged_attention_decode(
                q16, k16, v16, s["bt"], s["sl"], num_blocks=s["nb"], device=dev, **kw),
                iters=100)
            wide = torch.full((b, 64), PAD_BLOCK, dtype=torch.int32, device=dev)
            wide[:, :s["bt"].shape[1]] = s["bt"]
            row["full_width_ms"] = time_ms(lambda: paged_attention_decode(
                s["q"], s["kc"], s["vc"], wide, s["sl"], num_blocks=s["nb"], device=dev,
                **kw), iters=100)
            extra = (f", plain {row['plain_ms']:.4f} ms, f16 {row['f16_ms']:.4f} ms, "
                     f"full-width tables (64 slots) {row['full_width_ms']:.4f} ms "
                     f"(x{row['full_width_ms'] / ms:.2f} the trimmed)")
            if TREE == REPO:
                assert row["full_width_ms"] <= 1.2 * ms, (row["full_width_ms"], ms)
        rows[(b, ctx)] = row
        log(f"  B2 B={b} ctx={ctx}: kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}, "
            f"{nbytes / 1e6:.1f} MB, x{ms / bms:.1f}), SDPA(GQA, gathered KV) "
            f"{library_ms:.4f} ms{extra}")
        del s
    return rows


# The dense families' B2 points at B=8, ctx 1024, bf16 KV: (name, H_q, H_kv,
# D, window, softcap, score scale).
FAMILY_B2_POINTS = (("gemma d=256 16/16", 16, 16, 256, None, None, None),
                    ("phi3 d=96 32/32", 32, 32, 96, 2047, None, None),
                    ("falcon d=64 71/1", 71, 1, 64, None, None, None),
                    ("gemma2 d=256 16/8 softcap 50", 16, 8, 256, 4096, 50.0, 256 ** -0.5))


def time_b2_families(dev, gen) -> dict:
    """B2 at FAMILY_B2_POINTS: kernel, bound, plain version and SDPA on
    pre-gathered KV (none under a softcap: SDPA computes another function)."""
    from blazr_tpu_torch.attention.paged_attention import (
        paged_attention_decode, paged_attention_reference)
    from blazr_tpu_torch.kvcache.paged import page_slot_index

    b, ctx, bs = 8, 1024, 64
    rows = {}
    for name, h_q, h_kv, d, window, softcap, scale in FAMILY_B2_POINTS:
        s = pa_inputs(dev, gen, b=b, h_q=h_q, h_kv=h_kv, d=d, bs=bs, seq_lens=[ctx] * b)
        kw = dict(block_size=bs, sliding_window=window, logit_softcap=softcap, scale=scale)
        ms = time_ms(lambda: paged_attention_decode(
            s["q"], s["kc"], s["vc"], s["bt"], s["sl"], num_blocks=s["nb"], device=dev,
            **kw), iters=100)
        library_ms = None
        if softcap is None:
            idx = page_slot_index(bs, s["bt"])
            k = s["kc"][idx].permute(0, 2, 1, 3).contiguous()
            v = s["vc"][idx].permute(0, 2, 1, 3).contiguous()
            library_ms = sdpa_ms(s["q"], k, v, h_q, h_kv)
            del k, v
        keys = min(ctx, window or ctx)
        nbytes = (2 * b * keys * h_kv * d * 2 + 2 * b * h_q * d * 2
                  + s["bt"].numel() * 4 + b * 4)
        bms, by = bound(nbytes, 4.0 * b * h_q * keys * d)
        row = dict(ms=ms, library_ms=library_ms, bound_ms=bms, bound_by=by,
                   plain_ms=time_eager(lambda: paged_attention_reference(
                       s["q"], s["kc"], s["vc"], s["bt"], s["sl"], **kw), iters=10),
                   shape=f"{name} B={b} ctx={ctx}")
        rows[name] = row
        log(f"  B2 {name} B={b} ctx={ctx}: kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}, "
            f"x{ms / bms:.1f}), plain {row['plain_ms']:.4f} ms, SDPA(GQA, gathered KV) "
            + (f"{library_ms:.4f} ms" if library_ms is not None else "none (softcap)"))
        del s
    return rows


# ---------------------------------------------------------------------------
# phases 3d/3e: B5 (wide KV view) and B6 (head-major KV cache); the tools
# ---------------------------------------------------------------------------

def layout_kernel(layout: str):
    """(wrapper, prepare(flat k, flat v) -> the layout's k, v) of B5 or B6."""
    from blazr_tpu_torch.tools.bench_pa_headmajor import pa_headmajor, to_head_major
    from blazr_tpu_torch.tools.bench_pa_wide import pa_wide

    if layout == "wide":
        return pa_wide, lambda k, v: (k, v)
    return pa_headmajor, lambda k, v: (to_head_major(k), to_head_major(v))


def layout_case(dev, gen, *, b, bs, lens, dtype, mb=None, bad_ids=False):
    """Inputs for B5/B6 at the tools' geometry (G=8, 4 query heads each,
    D=128): flat caches, a random table ``mb`` slots wide (default: the
    longest sequence's), and, with ``bad_ids``, ids outside [0, NB) (-1,
    PAD_BLOCK, NB + 7) after each sequence's end and one inside a sequence,
    which reads block 0. ``ref_bt`` is the table with those ids set to 0, as
    the kernels read it."""
    import torch

    from blazr_tpu_torch.kvcache.paged import PAD_BLOCK

    need = max(1, max(-(-int(s) // bs) for s in lens))
    mb = mb or need
    nb = b * need + 8
    tables = torch.randint(0, nb, (b, mb), device=dev, generator=gen, dtype=torch.int32)
    if bad_ids:
        for i, n in enumerate(lens):
            used = -(-int(n) // bs)
            tables[i, used:] = torch.tensor([-1, PAD_BLOCK, nb + 7], dtype=torch.int32,
                                            device=dev).repeat(mb)[: mb - used]
        inside = max(range(b), key=lambda i: lens[i])
        tables[inside, 0] = nb + 2
    shape = (nb * bs + 1, 8, 128)
    kc = torch.randn(shape, device=dev, generator=gen).to(dtype)
    vc = torch.randn(shape, device=dev, generator=gen).to(dtype)
    q = torch.randn((b, 32, 128), device=dev, generator=gen).to(dtype)
    ref_bt = torch.where((tables < 0) | (tables >= nb), torch.zeros_like(tables), tables)
    return dict(q=q, kc=kc, vc=vc, bt=tables, ref_bt=ref_bt, nb=nb, bs=bs,
                sl=torch.tensor(lens, dtype=torch.int32, device=dev))


def check_layout(dev, gen, layout: str) -> dict:
    """B5 or B6 against its plain version at the tools' geometry: bf16, f32
    and f16, bs 64 and 128, B 8 and 32 with ragged seq_lens (1, a partial
    last block, 1024); B=1 and B=32 at ctx 4096 (32 and more splits);
    tables 64 slots wide over short sequences (empty splits) with ids
    outside [0, NB) and seq_len 0, whose output must be exact zeros (the TPU
    kernel's; the plain version gives the uniform mean there). The
    probabilities stay f32 on both sides: 2e-2 absolute in bf16, 4e-3 in f16
    (output rounding on outputs of order max|v|), 1e-4 in f32 (sum order)."""
    import torch

    from blazr_tpu_torch.tools.bench_pa_wide import pa_wide_reference

    fn, prepare = layout_kernel(layout)
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    tols = {bf16: 2e-2, f32: 1e-4, f16: 4e-3}
    cases = []
    for dtype in (bf16, f32, f16):
        for bs in (64, 128):
            for b in (8, 32):
                lens = torch.randint(1, 1025, (b,), device=dev, generator=gen).tolist()
                lens[:3] = [1, 1024, bs + 5]
                cases.append((f"{str(dtype)[6:]} bs={bs} B={b}", dtype, bs,
                              dict(b=b, lens=lens)))
    short = [0, 5, 300, 0, 64, 129, 1, 200]
    cases += [
        ("bf16 bs=64 B=1 ctx 4096", bf16, 64, dict(b=1, lens=[4096])),
        ("f16 bs=128 B=1 ctx 4095", f16, 128, dict(b=1, lens=[4095])),
        ("bf16 bs=64 B=32 ctx<=4096", bf16, 64,
         dict(b=32, lens=[4096, 1, 4000] + list(range(100, 3000, 100)))),
        ("f32 bs=64 B=8 ctx 4096", f32, 64, dict(b=8, lens=[4096] * 7 + [3000])),
    ] + [(f"{str(dt)[6:]} bs={bs} B=8 wide table, seq_len 0, bad ids", dt, bs,
          dict(b=8, lens=short, mb=4096 // bs, bad_ids=True))
         for dt in (bf16, f32, f16) for bs in (16, 64)]
    worst = 0.0
    for name, dtype, bs, kw in cases:
        s = layout_case(dev, gen, bs=bs, dtype=dtype, **kw)
        k, v = prepare(s["kc"], s["vc"])
        got = fn(s["q"], k, v, s["bt"], s["sl"], block_size=bs, num_blocks=s["nb"],
                 device=dev)
        ref = pa_wide_reference(s["q"].float(), s["kc"].float(), s["vc"].float(),
                                s["ref_bt"], s["sl"], block_size=bs)
        empty = s["sl"] <= 0
        ref[empty] = 0.0                       # the TPU kernel's 0, exactly
        torch.cuda.synchronize()
        assert got.shape == ref.shape and got.dtype == dtype and torch.isfinite(got).all()
        assert torch.equal(got[empty].float(), ref[empty]), f"{name}: seq_len 0 not 0"
        err = (got.float() - ref).abs().max().item()
        label = f"{layout} {name}"
        log(f"  {label:50s} max_abs_err {err:.4g}  tol {tols[dtype]}")
        assert err <= tols[dtype], f"{label}: {err} > {tols[dtype]}"
        worst = max(worst, err)
        del s, k, v, ref, got
    return {"max_abs_err": worst}


def run_tools() -> dict:
    """Phase 3f: both layout tools' sweeps in-process (their main path):
    B2 against B5, then B2 against B6, at bs {64, 128} x B {8, 32}."""
    from blazr_tpu_torch.tools import bench_pa_headmajor, bench_pa_wide

    reset_counts()
    rows = {"wide": bench_pa_wide.main([]), "headmajor": bench_pa_headmajor.main([])}
    launches = read_counts()
    log(f"  launches during the sweeps: {launches}")
    assert launches["pa_wide"] > 0 and launches["pa_headmajor"] > 0, launches
    return dict(launches, rows=rows)


def time_layout(dev, gen, layout: str) -> dict:
    """B5 or B6 at B2_SHAPES with seq_len ctx - 1 (the tools' 1023 at ctx
    1024), bs 64, bf16: time, plain time, SDPA over pre-gathered KV (the
    library call) and the bound. The dot products are f32 on CUDA cores:
    the operations' bound takes the f32 rate."""
    from blazr_tpu_torch.kvcache.paged import page_slot_index
    from blazr_tpu_torch.tools.bench_pa_wide import pa_wide_reference

    fn, prepare = layout_kernel(layout)
    h_q, h_kv, d, bs = 32, 8, 128, 64
    rows = {}
    for b, ctx in B2_SHAPES:
        n = ctx - 1
        s = pa_inputs(dev, gen, b=b, h_q=h_q, h_kv=h_kv, d=d, bs=bs, seq_lens=[n] * b,
                      nb_extra=0)
        k, v = prepare(s["kc"], s["vc"])
        ms = time_ms(lambda: fn(s["q"], k, v, s["bt"], s["sl"], block_size=bs,
                                num_blocks=s["nb"], device=dev), iters=100)
        plain_ms = time_eager(lambda: pa_wide_reference(s["q"], s["kc"], s["vc"], s["bt"],
                                                     s["sl"], block_size=bs), iters=10)
        idx = page_slot_index(bs, s["bt"])[:, :n]
        kg = s["kc"][idx].permute(0, 2, 1, 3).contiguous()
        vg = s["vc"][idx].permute(0, 2, 1, 3).contiguous()
        library_ms = sdpa_ms(s["q"], kg, vg, h_q, h_kv)
        del kg, vg
        nbytes = (2 * b * n * h_kv * d * 2 + 2 * b * h_q * d * 2
                  + s["bt"].numel() * 4 + b * 4)
        bound_ms, bound_by = bound(nbytes, 4.0 * b * h_q * n * d, H100_F32_FLOPS)
        log(f"  {layout} B={b} seq_len={n} bs={bs}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, SDPA(GQA, gathered KV) {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB, x{ms / bound_ms:.1f})")
        rows[(b, ctx)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              shape=f"B={b} seq_len={n} bs={bs}")
        del s, k, v
    return rows


def layout_times(dev, gen) -> dict:
    """B5 and B6 at B2_SHAPES (the kernel rows of phase 9), alone."""
    return {layout: time_layout(dev, gen, layout) for layout in ("wide", "headmajor")}


# ---------------------------------------------------------------------------
# phase 4: teacher-forced 2-layer full-width forward, card vs CPU
# ---------------------------------------------------------------------------

def to_cpu_f32(tree, dense: bool = False):
    """The CPU f32 reference's params: dense tensors in f32, stacked expert
    weights dequantized, and with ``dense`` every QuantTensor dequantized
    (on the card) to a dense f32 [K, N] weight, so the CPU's plain B1 does
    not dequantize a full-width weight at every call."""
    import torch

    from blazr_tpu_torch.quant.qtensor import (QuantTensor, dequantize, expert_slice,
                                               is_stacked)

    if isinstance(tree, dict):
        return {k: to_cpu_f32(v, dense) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu_f32(v, dense) for v in tree]
    if is_stacked(tree):
        # A stacked expert weight becomes a dense f32 stack, dequantized on
        # the card expert by expert: the CPU's plain B1 would dequantize a
        # Mixtral expert (235 MB in f32) at every call.
        return torch.stack([dequantize(expert_slice(tree, e)).cpu()
                            for e in range(tree.qweight.shape[0])])
    if isinstance(tree, QuantTensor) and dense:
        return dequantize(tree).cpu()
    if isinstance(tree, QuantTensor):
        return dataclasses.replace(
            tree, qweight=tree.qweight.cpu(), scales=tree.scales.cpu(),
            mins=tree.mins.cpu(), perm=None if tree.perm is None else tree.perm.cpu())
    if isinstance(tree, torch.Tensor):
        return tree.float().cpu()
    return tree


def card_f32(tree):
    """The card's params with every dense tensor in f32 (QuantTensors as
    they are): B1's split-K variant and B2 take f32, so the card runs the
    forward in f32."""
    import torch

    if isinstance(tree, dict):
        return {k: card_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [card_f32(v) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.float()
    return tree


def card_vs_cpu(dev, cfg, params, cpu_params, lens, tag: str, steps: int = 4,
                bs: int = 64, rel_tol: float | None = 5e-2, card_dtype=None,
                quantized: bool = False) -> float:
    """Teacher-forced engine steps of any family (``make_paged_forward`` and
    ``init_engine_cache``) on the card (``params``, bf16) and on the CPU
    (``cpu_params``, f32): the sequences ``lens`` prefilled in one padded
    batch (paged KV, MLA's latent pages), or each alone on its state row in
    exact shape (Mamba2, hybrid: no pad token may enter a scan), then
    ``steps`` decode steps of all of them (B2, where the family has paged
    attention; its plain version on the CPU). Card in bf16 against the CPU
    in f32: activations are rounded to bf16 between every op on the card,
    so the logits agree to a few 1e-2 of their largest magnitude
    (``rel_tol``), not to f32 precision; ``rel_tol=None`` reports the error
    without holding it. ``card_dtype`` (default bf16) is the card's cache
    type: f32 params and an f32 cache run the card in f32. ``quantized``:
    int8 KV (latents) on both sides. Returns the worst relative error."""
    import numpy as np
    import torch

    from blazr_tpu_torch.kvcache.paged import compute_slot_mapping, pad_block_table
    from blazr_tpu_torch.models.paged_multi import trash_slot
    from blazr_tpu_torch.models.registry import (init_engine_cache, make_paged_forward,
                                                 resolve_paged_kind)

    fwd = make_paged_forward(cfg)
    rows_only = resolve_paged_kind(cfg) in ("mamba2", "hybrid")
    rng = np.random.default_rng(SEED)
    b = len(lens)
    nblk = [-(-(n + steps) // bs) for n in lens]
    blocks = [list(range(sum(nblk[:i]), sum(nblk[:i + 1]))) for i in range(b)]
    tables = np.stack([pad_block_table(bl, max(nblk)) for bl in blocks])
    seqs = [rng.integers(0, cfg.vocab_size, n + steps) for n in lens]
    caches = {"gpu": init_engine_cache(cfg, sum(nblk), bs, b,
                                       dtype=card_dtype or torch.bfloat16,
                                       quantized=quantized, device=dev)[0],
              "cpu": init_engine_cache(cfg, sum(nblk), bs, b, dtype=torch.float32,
                                       quantized=quantized, device=torch.device("cpu"))[0]}
    trash = trash_slot(caches["cpu"])

    def slots(i, start, n):
        return compute_slot_mapping(blocks[i], start, n, bs, trash).astype(np.int64)

    inputs = []                     # (tokens, positions, slots, tables, lens, rows, last)
    if rows_only:
        for i, n in enumerate(lens):
            inputs.append((seqs[i][None, :n], np.arange(n)[None], slots(i, 0, n)[None],
                           tables[i:i + 1], np.array([n], np.int32), np.array([i]),
                           np.array([n - 1])))
    else:
        t = max(lens)
        tok = np.zeros((b, t), np.int64)
        pos = np.zeros((b, t), np.int64)
        sl = np.full((b, t), trash, np.int64)
        for i, n in enumerate(lens):
            tok[i, :n], pos[i, :n], sl[i, :n] = seqs[i][:n], np.arange(n), slots(i, 0, n)
        inputs.append((tok, pos, sl, tables, np.array(lens, np.int32), np.arange(b),
                       np.array([n - 1 for n in lens])))
    for j in range(steps):
        p = np.array([[n + j] for n in lens], np.int64)
        inputs.append((np.array([[seqs[i][n + j]] for i, n in enumerate(lens)]), p,
                       np.stack([slots(i, int(p[i, 0]), 1) for i in range(b)]), tables,
                       (p[:, 0] + 1).astype(np.int32), np.arange(b), None))
    worst = 0.0
    for step, (tk, ps, sl, tb, ln, rw, last) in enumerate(inputs):
        out = {}
        for name, d, pr in (("gpu", dev, params), ("cpu", torch.device("cpu"), cpu_params)):
            def tt(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(d)
            with torch.no_grad():
                logits, _ = fwd(pr, cfg, tt(tk), caches[name], tt(ps), tt(sl), tt(tb), tt(ln),
                                tt(rw), last_idx=None if last is None else tt(last))
            out[name] = logits.float().cpu()
        g, c = out["gpu"], out["cpu"]
        assert g.shape == c.shape and torch.isfinite(g).all()
        rel = ((g - c).abs().max() / c.abs().max()).item()
        agree = (g.argmax(-1) == c.argmax(-1)).float().mean().item()
        log(f"  {tag} step {step} ({'prefill' if last is not None else 'decode'}): "
            f"max|gpu-cpu|/max|cpu| {rel:.4g} "
            + (f"(tol {rel_tol})" if rel_tol else "(reported, not held)")
            + f", argmax agreement {agree:.2f}")
        assert not rel_tol or rel <= rel_tol, f"{tag} step {step}: {rel} > {rel_tol}"
        worst = max(worst, rel)
    del caches
    return worst


def teacher_forced(dev) -> None:
    """Phase 4: the 2-layer full-width Mistral-7B AWQ forward_paged, card
    against CPU, over sequences of 64, 100, 37 and 128 tokens."""
    import torch

    from blazr_tpu_torch.utils.synthetic import mistral_7b_config, synth_llama_params

    cfg = mistral_7b_config()
    cfg.num_layers = 2
    params = synth_llama_params(cfg, quant="awq", dtype=torch.bfloat16, seed=SEED,
                                device=dev)
    card_vs_cpu(dev, cfg, params, to_cpu_f32(params), [64, 100, 37, 128], "forward")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: full-depth serving
# ---------------------------------------------------------------------------

class StubTokenizer:
    """Enough of a tokenizer for the engine: ids only, no EOS."""

    eos_token_id = -1

    def is_eos(self, t):
        return False

    def decode(self, ids):
        return "".join(chr(32 + i % 90) for i in ids)


async def serve(engine, waves, on_wave=None) -> list[dict]:
    """Serve ``waves`` of (prompt, GenerationConfig); each later wave is
    submitted once every request of the one before has its first token.
    ``on_wave(i)`` is called just before wave i is submitted."""
    t0 = time.perf_counter()
    task = asyncio.create_task(engine.run())
    results = []

    async def consume(rec):
        async for tok in rec["handle"].tokens():
            if rec["ttft"] is None:
                rec["ttft"] = time.perf_counter() - rec["t_submit"]
                rec["first"].set()
            rec["tokens"].append(tok.token_id)
        rec["t_done"] = time.perf_counter()

    consumers = []
    for w, wave in enumerate(waves):
        if on_wave is not None:
            on_wave(w)
        recs = []
        for prompt, gen in wave:
            rec = dict(handle=engine.submit(prompt, gen), t_submit=time.perf_counter(),
                       ttft=None, tokens=[], first=asyncio.Event(),
                       prompt_len=len(prompt), temperature=gen.temperature)
            recs.append(rec)
            consumers.append(asyncio.create_task(consume(rec)))
        # The next wave arrives once this one has tokens, so its prefill
        # joins a running decode batch.
        await asyncio.wait_for(asyncio.gather(*[r["first"].wait() for r in recs]), 600)
        results += recs
    await asyncio.wait_for(asyncio.gather(*consumers), 900)
    engine.stop()
    await task
    for r in results:
        r["wall"] = r["t_done"] - t0
    return results


def counted() -> dict:
    """Every kernel wrapper of the port by the key its launches go under."""
    from blazr_tpu_torch.attention.paged_attention import paged_attention_decode
    from blazr_tpu_torch.quant import int8
    from blazr_tpu_torch.quant.kernels import qmm, qmm_stream
    from blazr_tpu_torch.tools.bench_pa_headmajor import pa_headmajor
    from blazr_tpu_torch.tools.bench_pa_wide import pa_wide

    out = {"qmm": qmm, "paged_attention": paged_attention_decode,
           "qmm_int8": int8.qmm_int8, "qmm_stream": qmm_stream, "pa_wide": pa_wide,
           "pa_headmajor": pa_headmajor}
    if hasattr(int8, "quantize_activations"):      # absent in trees before its kernel
        out["act_quant"] = int8.quantize_activations
    return out


def reset_counts() -> None:
    for fn in counted().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in counted().items()}


# The depth of phases 5-6's Mistral-7B: 32 layers, FULL_RUN_SERVE_LAYERS in
# a full run (``main`` sets it); ``--phases build,serve,...`` serves 32.
SERVE_LAYERS = 32
FULL_RUN_SERVE_LAYERS = 16


def mistral_model(dev, layers: int | None = None):
    import torch

    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.utils.synthetic import mistral_7b_config, synth_llama_params

    cfg = mistral_7b_config()
    cfg.num_layers = layers if layers is not None else SERVE_LAYERS
    t0 = time.perf_counter()
    params = synth_llama_params(cfg, quant="awq", dtype=torch.bfloat16, seed=SEED,
                                device=dev)
    torch.cuda.synchronize()
    log(f"  synthesized {cfg.num_layers}-layer Mistral-7B AWQ-INT4 on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    return Model(cfg, params, torch.bfloat16)


# Decode graphs on and off, in turns within one call (ABBA).
GRAPH_TURNS = (True, False, False, True)


def graph_stats(obj) -> dict:
    """The decode graphs an engine or Executor captured (none in a tree
    before them)."""
    g = getattr(obj, "graphs", None)
    if g is None or not hasattr(g, "captured"):
        return dict(captured=0, capture_s=0.0, pool_mib=0.0)
    return dict(captured=g.captured, capture_s=g.capture_s, pool_mib=g.pool_bytes / 2**20)


def free_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def make_engine(model, quant_compute: str, graphs: bool):
    from blazr_tpu_torch.config import AppConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine

    app = AppConfig(model=model.cfg)
    app.inference.quant_compute = quant_compute
    app.inference.graphs = graphs
    return BatchEngine(model, StubTokenizer(), app)


def full_depth(dev, card: str, quant_compute: str = "w4a16",
               stream: bool = False) -> dict:
    """The 32-layer BatchEngine serving 8 requests in two waves, with decode
    graphs and without in turns (GRAPH_TURNS); then the 8 in one wave (a
    schedule that host timing cannot change), where the streams and the
    launch counts with graphs must equal those without; then profiled both
    ways. Returns the launch counts of the first run with graphs (the
    default path) and every turn's numbers."""
    import numpy as np
    import torch

    from blazr_tpu_torch.config import GenerationConfig

    model = mistral_model(dev)
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 5)
    lens = [64, 512, 200, 333, 128, 480, 96, 256]
    reqs = []
    for i, n in enumerate(lens):
        prompt = rng.integers(0, cfg.vocab_size, n).tolist()
        gen = (GenerationConfig(max_tokens=64, temperature=0.7, top_p=0.9, seed=100 + i)
               if i in (2, 6) else GenerationConfig(max_tokens=64, temperature=0.0))
        reqs.append((prompt, gen))
    old = os.environ.get("BLAZR_TPU_STREAM_KERNEL")
    os.environ["BLAZR_TPU_STREAM_KERNEL"] = "1" if stream else "0"
    turns, launches = [], None
    try:
        for graphs in GRAPH_TURNS:
            engine = make_engine(model, quant_compute, graphs)
            reset_counts()
            t0 = time.perf_counter()
            results = asyncio.run(serve(engine, [reqs[:4], reqs[4:]]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            assert counts["paged_attention"] > 0, counts
            if stream:
                assert counts["qmm_int8"] > 0 and counts["qmm_stream"] > 0, counts
            else:
                assert counts["qmm"] > 0, counts
            if graphs and launches is None:
                launches = counts
                for i, r in enumerate(results):
                    log(f"  request {i}: prompt {r['prompt_len']:4d}, temperature "
                        f"{r['temperature']}, tokens {len(r['tokens'])}, TTFT "
                        f"{r['ttft'] * 1e3:.1f} ms, done at {r['wall']:.2f} s")
                log(f"  launches during serving (graphs on): {counts}")
            total = 0
            for i, r in enumerate(results):
                assert len(r["tokens"]) == 64, f"request {i}: {len(r['tokens'])} tokens"
                assert all(0 <= t < cfg.vocab_size for t in r["tokens"])
                total += len(r["tokens"])
            perf = engine.perf
            ttft = sorted(r["ttft"] for r in results)
            stats = graph_stats(engine)
            turn = dict(graphs=graphs, tok_s=total / wall,
                        tok_s_after_capture=total / (wall - stats["capture_s"]),
                        ms_per_step=perf["decode"] / engine.horizon_steps * 1e3,
                        ms_per_step_after_capture=(perf["decode"] - stats["capture_s"])
                        / engine.horizon_steps * 1e3,
                        ttft_ms_median=ttft[len(ttft) // 2] * 1e3,
                        ttft_ms_wave1=max(r["ttft"] for r in results[:4]) * 1e3,
                        rounds=engine.horizon_dispatches, steps=engine.horizon_steps,
                        **stats)
            turns.append(turn)
            log(f"  graphs {'on ' if graphs else 'off'}: {total} tokens in {wall:.2f} s, "
                f"{turn['tok_s']:.1f} tok/s ({turn['tok_s_after_capture']:.1f} without the "
                f"capture); {turn['ms_per_step']:.2f} ms a decode step "
                f"({turn['ms_per_step_after_capture']:.2f} without the capture; "
                f"{turn['steps']} steps in {turn['rounds']} rounds); TTFT median "
                f"{turn['ttft_ms_median']:.1f} ms, wave 1 {turn['ttft_ms_wave1']:.1f} ms; "
                f"{turn['captured']} graphs captured in {turn['capture_s']:.2f} s "
                f"({turn['pool_mib']:.1f} MiB pool); host s: prefill {perf['prefill']:.2f}, "
                f"dispatch {perf['h_dispatch']:.2f}, fetch {perf['h_fetch']:.2f}, emit "
                f"{perf['h_emit']:.2f}, first tokens {perf['p_finish']:.2f} ({card}; "
                f"depth {cfg.num_layers}, quant_compute {quant_compute}, stream kernel "
                f"{'on' if stream else 'off'})")
            del engine
            free_card()
        same = {}
        for graphs in (True, False):
            engine = make_engine(model, quant_compute, graphs)
            reset_counts()
            res = asyncio.run(serve(engine, [reqs]))
            torch.cuda.synchronize()
            same[graphs] = ([r["tokens"] for r in res], read_counts())
            del engine
            free_card()
        equal = same[True][0] == same[False][0]
        log(f"  one wave of 8 (6 greedy, 2 sampled): streams with graphs "
            f"{'equal' if equal else 'DIFFER from'} those without; launches "
            f"{same[True][1]} with, {same[False][1]} without")
        assert equal, [i for i, (a, b) in enumerate(zip(*[same[g][0] for g in (True, False)]))
                       if a != b]
        assert same[True][1] == same[False][1], same
        profile = {g: profile_serving(dev, model, card, quant_compute, graphs=g)
                   for g in (True, False)}
    finally:
        if old is None:
            os.environ.pop("BLAZR_TPU_STREAM_KERNEL")
        else:
            os.environ["BLAZR_TPU_STREAM_KERNEL"] = old
    launches = dict(launches, profile=profile, turns=turns)
    del model
    free_card()
    return launches


def serve_stream(dev, card: str) -> dict:
    """Phase 5c: the same 8 requests under w4a8-prefill with the stream
    kernel on: prefill groups of 256+ rows take B3, decode takes B4."""
    return full_depth(dev, card, quant_compute="w4a8-prefill", stream=True)


# ---------------------------------------------------------------------------
# phase 6: the prefix cache and its host tier (serve --continuous-batching)
# ---------------------------------------------------------------------------

PREFIX_TURNS = (True, False, False, True)       # the prefix cache on, off, off, on
PREFIX_LEN = 1024                               # the shared system prefix: 16 blocks
PREFIX_SUFFIXES = (32, 64, 96, 128, 160, 192, 224, 256)     # wave 1, then wave 2


def prefix_engine(model, prefix: bool, **inf):
    """A 32-layer BatchEngine as ``serve --continuous-batching`` builds it
    (w4a16, graphs on, block 64, max batch 8), the prefix cache on or off."""
    from blazr_tpu_torch.config import AppConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine

    app = AppConfig(model=model.cfg)
    app.inference.max_batch_size = 8
    app.inference.prefix_cache = prefix
    for key, value in inf.items():
        setattr(app.inference, key, value)
    return BatchEngine(model, StubTokenizer(), app)


def agreement(a: list, b: list) -> int:
    """Length of the common prefix of two token streams."""
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def prefill_logits(engine, waves) -> list:
    """Serve ``waves`` (each request alone, one token) and return the
    last-position logits of every prefill, in order (f32, on the host)."""
    import torch

    got = []
    fwd = engine._fwd

    def capture(*args, **kw):
        out = fwd(*args, **kw)
        if kw.get("last_idx") is not None:          # a prefill, never a decode step
            got.append(out[0][:, 0].float().cpu())
        return out

    engine._fwd = capture
    try:
        async def runs():
            for wave in waves:
                await serve(engine, [wave])
        asyncio.run(runs())
    finally:
        engine._fwd = fwd
    torch.cuda.synchronize()
    return got


def serve_prefix(dev, card: str) -> dict:
    """Phase 6: the 32-layer Mistral-7B AWQ BatchEngine with the prefix
    cache, warmed as ``cli serve`` warms it: 8 requests sharing one
    1024-token system prefix, each with its own 32-256-token suffix, 64
    greedy tokens each, in two waves of 4, with the prefix cache on and
    off in turns (PREFIX_TURNS). Per wave: TTFT, tok/s, the prompt tokens
    the prefills computed, hits and misses. Checks: one wave of misses on
    a warmed engine gives the streams of an unwarmed prefix-off engine
    exactly (the same schedule, the same computation); each wave-2 prompt
    served alone after the prefix is cached gives first-token logits
    within 5e-2 of the largest prefix-off logit; B1 and B2 launched. Then
    the host tier on a warmed engine: a pool just large enough for prefix
    B (2048 tokens) so that B evicts prefix A (1024 tokens) to host RAM, A
    restored from it with the stream of a device-tier hit (an unwarmed
    engine) exactly, the tier's pinned pool never reallocated; a block's
    save into the pool and restore from it timed on the device. Then wave
    2's prefill group profiled with the cache on and off."""
    import numpy as np
    import torch

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.kvcache.block_allocator import blocks_needed
    from blazr_tpu_torch.kvcache.host_tier import block_planes, restore_block

    model = mistral_model(dev)
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 13)
    system = rng.integers(0, cfg.vocab_size, PREFIX_LEN).tolist()
    prompts = [system + rng.integers(0, cfg.vocab_size, n).tolist() for n in PREFIX_SUFFIXES]

    def reqs(idx, tokens: int = 64):
        return [(prompts[i], GenerationConfig(max_tokens=tokens, temperature=0.0))
                for i in idx]

    waves = [reqs(range(4)), reqs(range(4, 8))]
    out: dict = dict(turns=[])
    streams: dict = {}
    for on in PREFIX_TURNS:
        engine = prefix_engine(model, on)
        warm_s = engine.warmup()
        warm = dict(warm_s=warm_s, **graph_stats(engine))
        marks = []

        def mark(_w=None, engine=engine):
            st = engine.prefix_cache.stats if engine.prefix_cache is not None else None
            marks.append((engine.perf["prefill_tokens"], st.hits if st else 0,
                          st.misses if st else 0))

        reset_counts()
        t0 = time.perf_counter()
        results = asyncio.run(serve(engine, waves, on_wave=mark))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        mark()
        assert counts["qmm"] > 0 and counts["paged_attention"] > 0, counts
        per_wave = []
        for w in range(2):
            recs = results[4 * w:4 * w + 4]
            for r in recs:
                assert len(r["tokens"]) == 64 and all(0 <= t < cfg.vocab_size
                                                      for t in r["tokens"])
            ttft = sorted(r["ttft"] for r in recs)
            span = max(r["t_done"] for r in recs) - min(r["t_submit"] for r in recs)
            per_wave.append(dict(
                ttft_ms_median=ttft[len(ttft) // 2] * 1e3, ttft_ms_max=ttft[-1] * 1e3,
                tok_s=sum(len(r["tokens"]) for r in recs) / span,
                prefill_tokens=int(marks[w + 1][0] - marks[w][0]),
                hits=marks[w + 1][1] - marks[w][1], misses=marks[w + 1][2] - marks[w][2]))
        turn = dict(prefix=on, tok_s=sum(len(r["tokens"]) for r in results) / wall,
                    waves=per_wave, launches=counts, **warm)
        out["turns"].append(turn)
        streams.setdefault(on, [r["tokens"] for r in results])
        log(f"  prefix cache {'on ' if on else 'off'}: warmed in {warm_s:.2f} s "
            f"({warm['captured']} decode graphs, {warm['pool_mib']:.1f} MiB pool); "
            f"{turn['tok_s']:.1f} tok/s over both waves; launches {counts} ({card})")
        for w, pw in enumerate(per_wave):
            log(f"    wave {w + 1}: TTFT median {pw['ttft_ms_median']:.1f} ms, max "
                f"{pw['ttft_ms_max']:.1f} ms; {pw['tok_s']:.1f} tok/s; prefill computed "
                f"{pw['prefill_tokens']} prompt tokens; hits {pw['hits']}, misses "
                f"{pw['misses']}")
        del engine, mark                    # mark holds the engine too
        free_card()
    on_turn = out["turns"][0]["waves"]
    assert on_turn[0]["hits"] == 0 and on_turn[1]["hits"] == 4 * PREFIX_LEN // 64, on_turn
    agree = [agreement(a, b) for a, b in zip(streams[True][4:], streams[False][4:])]
    log(f"  wave 2, prefix cache on vs off: greedy agreement {agree} of 64 tokens")
    out["wave2_agreement"] = agree

    # Misses: one wave of 4 (all misses with the cache on, the engine
    # warmed: its decode graphs captured on pad rows before any request)
    # equals the prefix-off streams of an engine never warmed exactly.
    same = {}
    for on in (True, False):
        engine = prefix_engine(model, on)
        if on:
            engine.warmup()
        same[on] = [r["tokens"] for r in asyncio.run(serve(engine, [waves[0]]))]
        if on:
            assert engine.prefix_cache.stats.hits == 0, engine.prefix_cache.stats
        del engine
        free_card()
    log(f"  one wave of 4 misses: streams with the prefix cache, warmed, "
        f"{'equal' if same[True] == same[False] else 'DIFFER from'} those without it, "
        f"not warmed")
    assert same[True] == same[False]

    # Hits: each wave-2 prompt alone, after request 0 has cached the prefix.
    alone = [[r] for r in reqs(range(4, 8), tokens=1)]
    engine = prefix_engine(model, True)
    hit = prefill_logits(engine, [reqs([0], tokens=1)] + alone)[1:]
    assert engine.prefix_cache.stats.hits == 4 * PREFIX_LEN // 64, engine.prefix_cache.stats
    del engine
    engine = prefix_engine(model, False)
    cold = prefill_logits(engine, alone)
    del engine
    free_card()
    errs = [float((h - c).abs().max() / c.abs().max()) for h, c in zip(hit, cold)]
    log(f"  wave-2 prompts alone: first-token logits of the prefix hit vs a cold "
        f"prefill, max abs diff over the largest logit {[f'{e:.2e}' for e in errs]} "
        f"(tolerance 5e-2, bf16)")
    assert max(errs) <= 5e-2, errs
    out["hit_logit_err"] = max(errs)

    # The host tier: B (2048-token prefix) evicts A (1024) to host RAM and
    # A comes back from it; then C decodes while D's admission evicts (the
    # pipe's stall), against the same history on a pool without the tier.
    a_prompt = system + rng.integers(0, cfg.vocab_size, 32).tolist()
    b_prompt = rng.integers(0, cfg.vocab_size, 2 * PREFIX_LEN + 64).tolist()
    c_prompt = rng.integers(0, cfg.vocab_size, 64).tolist()
    d_prompt = rng.integers(0, cfg.vocab_size, PREFIX_LEN).tolist()
    gen = GenerationConfig(max_tokens=64, temperature=0.0)
    nb = blocks_needed(len(b_prompt) + 64, 64)

    async def stall(engine) -> dict:
        """C decodes; once it has 24 tokens D (a new 1024-token prompt)
        arrives, and its admission evicts cached blocks. Returns C's gaps
        between rounds before D and the longest one from D's arrival to
        D's first token."""
        task = asyncio.create_task(engine.run())
        times: list = []
        hc = engine.submit(c_prompt, GenerationConfig(max_tokens=160, temperature=0.0))

        async def consume():
            async for _ in hc.tokens():
                times.append(time.perf_counter())
        consumer = asyncio.create_task(consume())
        while len(times) < 24:
            await asyncio.sleep(0.001)
        st = engine.prefix_cache.stats
        ev0 = st.evictions
        t_d = time.perf_counter()
        hd = engine.submit(d_prompt, GenerationConfig(max_tokens=1, temperature=0.0))
        async for _ in hd.tokens():
            pass
        t_first = time.perf_counter()
        await consumer
        engine.stop()
        await task
        gaps = [(b - a, b) for a, b in zip(times, times[1:]) if b - a > 1e-3]
        before = sorted(g for g, t in gaps if t < t_d)
        during = [g for g, t in gaps if t_d <= t <= t_first + 0.5]
        return dict(round_gap_ms=before[len(before) // 2] * 1e3,
                    max_gap_ms=max(during) * 1e3, d_ttft_ms=(t_first - t_d) * 1e3,
                    evicted=st.evictions - ev0)

    def history(engine):
        async def runs():
            res = [(await serve(engine, [[(p, gen)]]))[0]
                   for p in (a_prompt, b_prompt, a_prompt)]
            tier_ = engine.prefix_cache.host_tier
            s0 = (tier_.stats.saved, tier_.stats.save_s) if tier_ is not None else (0, 0.0)
            gap = await stall(engine)
            if tier_ is not None:
                gap.update(saved=tier_.stats.saved - s0[0],
                           save_host_ms=(tier_.stats.save_s - s0[1]) * 1e3)
            return res, gap
        return asyncio.run(runs())

    # Both engines warmed: no decode graph is captured inside the stall.
    engine = prefix_engine(model, True, num_blocks=nb)
    engine.warmup()
    _, plain_gap = history(engine)
    del engine
    free_card()
    t0 = time.perf_counter()
    engine = prefix_engine(model, True, gpu_prefix_cache=True, num_blocks=nb)
    build_s = time.perf_counter() - t0
    engine.warmup()
    host_tier = engine.prefix_cache.host_tier
    ptrs = [engine.cache.k.data_ptr(), engine.cache.v.data_ptr()]
    pool = [p.data_ptr() for p in host_tier._pool]
    tiered, tier_gap = history(engine)
    torch.cuda.synchronize()
    tier = host_tier.stats
    assert [engine.cache.k.data_ptr(), engine.cache.v.data_ptr()] == ptrs
    assert [p.data_ptr() for p in host_tier._pool] == pool
    assert tier.restored >= PREFIX_LEN // 64, tier
    log(f"  C decoding while D's admission evicts {tier_gap['evicted']} cached blocks: C's "
        f"round gap {tier_gap['round_gap_ms']:.1f} ms before D, longest "
        f"{tier_gap['max_gap_ms']:.1f} ms until D's first token ({tier_gap['d_ttft_ms']:.1f} "
        f"ms) with the host tier ({tier_gap['saved']} blocks saved, "
        f"{tier_gap['save_host_ms']:.1f} ms of host time queuing them); without it "
        f"{plain_gap['round_gap_ms']:.1f} / {plain_gap['max_gap_ms']:.1f} ms, D's TTFT "
        f"{plain_gap['d_ttft_ms']:.1f} ms, {plain_gap['evicted']} evicted ({card})")
    # A block's save (device -> a slot of the tier's pinned pool) and
    # restore, on the device's clock, twice over the same slots.
    cache = engine.cache
    blocks = list(range(PREFIX_LEN // 64))
    keys = [b"timed%d" % b for b in blocks]
    timed = []
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        for b, key in zip(blocks, keys):
            host_tier.save(key, *block_planes(cache, b))
        ev[1].record()
        t1 = time.perf_counter()
        for b, key in zip(blocks, keys):
            restore_block(cache, b, host_tier.take(key))
        ev[2].record()
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        timed.append((ev[0].elapsed_time(ev[1]) / len(blocks),
                      ev[1].elapsed_time(ev[2]) / len(blocks),
                      (t1 - t0) / len(blocks) * 1e3, (t2 - t1) / len(blocks) * 1e3))
    block_mib = host_tier.pool_bytes / host_tier.max_blocks / 2**20
    pool_gib = host_tier.pool_bytes / 2**30
    slots = host_tier.max_blocks
    (save_first_ms, restore_first_ms, _, _), (save_ms, restore_ms, save_host_ms,
                                              restore_host_ms) = timed
    del engine, cache, host_tier
    engine = prefix_engine(model, True)

    async def twice():
        return [(await serve(engine, [[(a_prompt, gen)]]))[0] for _ in range(2)]
    device_tier = asyncio.run(twice())
    del engine
    free_card()
    log(f"  host tier ({nb}-block device pool; {slots} host slots, "
        f"{pool_gib:.2f} GiB pinned once, engine built in {build_s:.2f} s): A, B, A, C + D: "
        f"{tier.saved} blocks saved, {tier.restored} restored, {tier.dropped} dropped; host "
        f"s queuing the copies inside scheduling: save {tier.save_s:.4f}, restore "
        f"{tier.restore_s:.4f}; a {block_mib:.1f} MiB block: save {save_ms:.3f} ms, restore "
        f"{restore_ms:.3f} ms on the device ({block_mib / 1024 / save_ms * 1e3:.1f} / "
        f"{block_mib / 1024 / restore_ms * 1e3:.1f} GiB/s), host {save_host_ms:.3f} / "
        f"{restore_host_ms:.3f} ms to queue; first use of the slots: save "
        f"{save_first_ms:.3f} ms, restore {restore_first_ms:.3f} ms on the device ({card})")
    log(f"  A restored from the host tier vs A as a device-tier hit: streams "
        f"{'equal' if tiered[2]['tokens'] == device_tier[1]['tokens'] else 'DIFFER'}; "
        f"A cold vs restored: agreement {agreement(tiered[0]['tokens'], tiered[2]['tokens'])}"
        f" of 64; TTFT cold {tiered[0]['ttft'] * 1e3:.1f} ms, restored "
        f"{tiered[2]['ttft'] * 1e3:.1f} ms, device hit {device_tier[1]['ttft'] * 1e3:.1f} ms")
    assert tiered[2]["tokens"] == device_tier[1]["tokens"]
    out["host_tier"] = dict(saved=tier.saved, restored=tier.restored, save_ms=save_ms,
                            restore_ms=restore_ms, save_first_ms=save_first_ms,
                            restore_first_ms=restore_first_ms, block_mib=block_mib,
                            slots=slots, pool_gib=pool_gib, build_s=build_s,
                            save_host_s=tier.save_s, restore_host_s=tier.restore_s,
                            ttft_ms=[r["ttft"] * 1e3 for r in tiered], stall=tier_gap,
                            stall_without_tier=plain_gap)

    # Wave 2's prefill group under the profiler, the cache on and off.
    out["profile"] = {}
    for on in (True, False):
        engine = prefix_engine(model, on)

        async def runs():
            await serve(engine, [reqs(range(4), tokens=1)])
            prof, t0 = start_profile()
            res = await serve(engine, [reqs(range(4, 8), tokens=1)])
            return stop_profile(prof, t0), res

        (wall, busy, events, names, _), res = asyncio.run(runs())
        idle = 1 - busy / wall if busy > 0 else None
        out["profile"][on] = dict(wall_ms=wall * 1e3, busy_ms=busy * 1e3, idle_share=idle,
                                  ttft_ms=max(r["ttft"] for r in res) * 1e3)
        log(f"  profiled wave-2 prefill group, prefix cache {'on' if on else 'off'}: "
            f"wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms over {events} "
            f"device events; idle share "
            + (f"{idle:.2f}" if idle is not None else "not measured (no device events)")
            + f"; top ops: " + "; ".join(f"{n} {sec * 1e3:.2f} ms/{calls}"
                                         for n, (sec, calls) in top_ops(names, 5)))
        del engine
        free_card()
    del model
    free_card()
    return out


# ---------------------------------------------------------------------------
# phase 7: the normal entry point (checkpoint on disk, tokenizer, HTTP, CLI)
# ---------------------------------------------------------------------------

HTTP_LAYERS = 8


def _prompt_text(tok, n_tokens: int, rng) -> str:
    """Text of about ``n_tokens`` tokens: words of the tokenizer's merged
    vocab, added until the encoding is long enough."""
    words: list[str] = []
    while True:
        ids = rng.integers(256, tok.vocab_size - 1, 32).tolist()
        words.append(tok.decode(ids))
        text = " ".join(words)
        ids = tok.encode(text)
        if len(ids) >= n_tokens:
            return tok.decode(ids[:n_tokens])


def _http(port: int, method: str, path: str, body=None, timeout: float = 600):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _stream_chat(port: int, body: dict) -> dict:
    """One streamed chat request over http.client: content deltas, the
    time to the first content delta, the finish chunk and [DONE]."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200, (resp.status, resp.read())
    assert resp.getheader("Content-Type") == "text/event-stream"
    out = dict(deltas=[], ttft=None, finish=None, usage=None, done=False, role=None)
    for raw in resp:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        data = line[len("data: "):]
        if data == "[DONE]":
            out["done"] = True
            continue
        ev = json.loads(data)
        choice = ev["choices"][0]
        if choice["delta"].get("role"):
            out["role"] = choice["delta"]["role"]
        elif choice["delta"].get("content"):
            if out["ttft"] is None:
                out["ttft"] = time.perf_counter() - t0
            out["deltas"].append(choice["delta"]["content"])
        if choice.get("finish_reason"):
            out["finish"] = choice["finish_reason"]
            out["usage"] = ev.get("usage")
    conn.close()
    out["wall"] = time.perf_counter() - t0
    return out


# Engine warmed and not, in turns within one call (ABBA).
HTTP_TURNS = (True, False, False, True)


def parse_metrics(text: str) -> dict:
    """(sample name, sorted labels) → value of a Prometheus text-format
    page; raises on a line that is not a comment, a blank or a sample."""
    import re

    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
    label = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = sample.match(line)
        if m is None:
            raise ValueError(f"not a sample line: {line!r}")
        labels = tuple(sorted(label.findall(m.group(3) or "")))
        out[(m.group(1), labels)] = float(m.group(4))
    return out


@contextlib.contextmanager
def http_server(sched, engine):
    """The port's HTTP server (``create_app`` + ``serve``) over ``engine`` on
    a free local port, in a thread with its own event loop; yields the port
    and stops the server on exit."""
    import threading

    from blazr_tpu_torch.config.server import ServerConfig
    from blazr_tpu_torch.server import create_app, serve

    app = create_app(sched, ServerConfig(host="127.0.0.1", port=0), batch_engine=engine)
    loop = asyncio.new_event_loop()
    stop = asyncio.Event()
    ready = threading.Event()
    bound: dict = {}

    def run_loop():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(serve(app, "127.0.0.1", 0, stop=stop,
                                      started=lambda p: (bound.update(port=p), ready.set())))

    server = threading.Thread(target=run_loop, daemon=True)
    server.start()
    try:
        assert ready.wait(60), "server did not start"
        yield bound["port"]
    finally:
        loop.call_soon_threadsafe(stop.set)
        server.join(120)
        loop.close()


def http_turn(sched, ex, texts: list, system: str, warm: bool, card: str) -> dict:
    """One engine (prefix cache on), warmed or not, behind the port's HTTP
    server: 8 concurrent requests over http.client (4 streamed chats that
    share the system message ``system``, 4 completions, 64 greedy tokens
    each), then one more streamed chat with that system message, whose
    prompt hits the blocks the first chats cached, then ``GET /metrics``,
    which must parse, count what was sent back and report the engine's
    prefix-cache hits (more than none)."""
    import threading

    import torch

    from blazr_tpu_torch.engine.batch_engine import BatchEngine

    engine = BatchEngine(ex.model, ex.tokenizer, ex.app_cfg)
    warm_s = engine.warmup() if warm else 0.0
    stats = graph_stats(engine)
    with http_server(sched, engine) as port:
        st, body = _http(port, "GET", "/health")
        assert st == 200 and json.loads(body)["status"] == "ok", body
        results: list = [None] * 8

        def chat(text: str) -> dict:
            return _stream_chat(port, {
                "messages": [{"role": "system", "content": system},
                             {"role": "user", "content": text}],
                "max_tokens": 64, "temperature": 0, "stream": True})

        def one(i: int) -> None:
            if i % 2 == 0:                 # streamed chat
                results[i] = chat(texts[i])
            else:                          # non-streamed completion
                t0 = time.perf_counter()
                st, body = _http(port, "POST", "/v1/completions", {
                    "prompt": texts[i], "max_tokens": 64, "temperature": 0})
                assert st == 200, (st, body)
                results[i] = dict(json.loads(body), wall=time.perf_counter() - t0)

        reset_counts()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        hits0 = engine.prefix_cache.stats.hits
        results.append(chat(texts[1]))     # the system message's blocks are cached now
        total, stopped, ttfts = 0, 0, []
        for i, r in enumerate(results):
            assert r is not None, f"request {i} did not finish"
            if i % 2 == 0:
                n = len(r["deltas"])
                assert r["role"] == "assistant" and r["done"] and r["finish"], r
                assert r["usage"]["completion_tokens"] == n, (r["usage"], n)
                assert r["finish"] == "stop" or n == 64, (r["finish"], n)
                stopped += r["finish"] == "stop"    # its EOS token is no delta
                if i < 8:
                    ttfts.append(r["ttft"])
                log(f"  request {i}: streamed chat, prompt {r['usage']['prompt_tokens']} "
                    f"tokens, {n} content deltas, finish {r['finish']}, client TTFT "
                    f"{r['ttft'] * 1e3:.1f} ms, done at {r['wall']:.2f} s")
            else:
                choice, usage = r["choices"][0], r["usage"]
                n = usage["completion_tokens"]
                st, body = _http(port, "POST", "/tokenize", {"content": texts[i]})
                assert usage["prompt_tokens"] == json.loads(body)["count"], usage
                assert choice["finish_reason"] in ("stop", "length"), choice
                assert choice["finish_reason"] == "stop" or n == 64, (choice, n)
                log(f"  request {i}: completion, prompt {usage['prompt_tokens']} tokens, "
                    f"{n} tokens, finish {choice['finish_reason']}, done at "
                    f"{r['wall']:.2f} s")
            total += n
        assert launches["qmm"] > 0 and launches["paged_attention"] > 0, launches
        st, body = _http(port, "GET", "/metrics")
        assert st == 200, st
        got = parse_metrics(body.decode())
        gen = got[("blazr_tpu_tokens_generated_total", ())]
        assert gen == total + stopped, (gen, total, stopped)
        for ep, n in (("chat", 5), ("completions", 4)):
            assert got[("blazr_tpu_requests_total", (("endpoint", ep), ("status", "200")))] == n
        assert got[("blazr_tpu_ttft_seconds_count", ())] == 5, got
        hits = got[("blazr_tpu_prefix_cache_hits_total", ())]
        assert hits == engine.prefix_cache.stats.hits > hits0, (hits, hits0)
        assert got[("blazr_tpu_hbm_used_bytes", ())] > 0
        turn = dict(warm=warm, warm_s=warm_s, ttft_ms=[t * 1e3 for t in ttfts],
                    ttft_ms_median=sorted(ttfts)[len(ttfts) // 2] * 1e3,
                    tok_s=total / wall, wall_s=wall, tokens=total, launches=launches,
                    metrics_tokens_generated=gen, prefix_hits=hits,
                    followup_hits=hits - hits0, followup_ttft_ms=results[8]["ttft"] * 1e3,
                    **stats)
        log(f"  {'warmed' if warm else 'not warmed'} (warmup {warm_s:.2f} s, "
            f"{stats['captured']} graphs after it, {stats['pool_mib']:.1f} MiB pool): served "
            f"{total} tokens for 8 HTTP requests in {wall:.2f} s: {total / wall:.1f} tok/s "
            f"aggregate; streamed-chat client TTFT median {turn['ttft_ms_median']:.1f} ms, "
            f"max {max(ttfts) * 1e3:.1f} ms ({card}); depth {HTTP_LAYERS} layers, f16")
        log(f"  request 8: streamed chat after the 8, prompt "
            f"{results[8]['usage']['prompt_tokens']} tokens, {hits - hits0:.0f} blocks hit, "
            f"client TTFT {results[8]['ttft'] * 1e3:.1f} ms")
        log(f"  launches during the 8 HTTP requests: {launches}; /metrics after the 9: "
            f"tokens_generated_total {gen:.0f}, prefix_cache_hits_total {hits:.0f}, misses "
            f"{got[('blazr_tpu_prefix_cache_misses_total', ())]:.0f}, hbm_used_bytes "
            f"{got[('blazr_tpu_hbm_used_bytes', ())]:.0f}")
    del engine
    free_card()
    return turn


@contextlib.contextmanager
def cli_serve(model: Path, stderr_path: Path, *extra: str):
    """``python -m blazr_tpu_torch.cli serve --model MODEL
    --continuous-batching`` (warmed) in its own process on a free local
    port; yields (port, seconds until /health answered, the stderr line that
    reports the warmup) and ends the process on exit."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(TREE))
    err = open(stderr_path, "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "blazr_tpu_torch.cli", "serve", "--model", str(model),
         "--continuous-batching", "--host", "127.0.0.1", "--port", str(port), *extra],
        cwd=TREE, env=env, stdout=subprocess.DEVNULL, stderr=err, text=True)
    try:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                err.seek(0)
                raise RuntimeError(f"cli serve exited {proc.returncode}: "
                                   f"{err.read()[-4000:]}")
            try:
                st, _ = _http(port, "GET", "/health", timeout=5)
                if st == 200:
                    break
            except OSError:
                pass
            assert time.perf_counter() - t0 < 300, "cli serve did not come up"
            time.sleep(1.0)
        up = time.perf_counter() - t0
        err.seek(0)
        warmed = [line for line in err.read().splitlines()
                  if line.startswith("batch engine warmed in")]
        assert warmed, "cli serve did not warm its batch engine"
        yield port, up, warmed[0]
    finally:
        os.kill(proc.pid, 15)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            os.kill(proc.pid, 9)
            proc.wait(60)
        err.close()


def serve_http(dev, card: str) -> dict:
    """Phase 7: write a full-width Mistral-7B AWQ-INT4 checkpoint (group
    128, 8 layers) and a 32000-token byte-level BPE tokenizer.json to a
    temporary directory; load it through ModelScheduler -> load_model (f16,
    the AWQ default) and serve it from the port's HTTP server with
    continuous batching and the prefix cache, as ``cli serve`` does; the
    engine warmed and not in turns (HTTP_TURNS), each turn 8 concurrent
    requests (``http_turn``) and ``/metrics``. Then ``python -m
    blazr_tpu_torch.cli serve`` (warmed) as a subprocess answers /health,
    one chat completion and /metrics."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from blazr_tpu_torch.engine.model_scheduler import ModelScheduler
    from blazr_tpu_torch.utils.synthetic import (mistral_7b_config, write_hf_checkpoint,
                                                 write_bpe_tokenizer_json)

    cfg = mistral_7b_config()
    cfg.num_layers = HTTP_LAYERS
    ckpt = Path(tempfile.mkdtemp(prefix="blazr_awq_"))
    out: dict = {}
    try:
        t0 = time.perf_counter()
        write_hf_checkpoint(ckpt, cfg, quant="awq", group_size=128, seed=SEED)
        write_bpe_tokenizer_json(ckpt, cfg.vocab_size, seed=SEED)
        size = sum(f.stat().st_size for f in ckpt.iterdir())
        log(f"  wrote {HTTP_LAYERS}-layer Mistral-7B AWQ-INT4 checkpoint ({size / 1e9:.2f} GB) "
            f"and tokenizer.json in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        sched = ModelScheduler(ckpt, device=dev)
        ex = sched.get_executor("default")
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        model = ex.model
        assert model.dtype == torch.float16 and model.num_layers == HTTP_LAYERS
        assert model.params["layers"][0]["q"].fmt == "awq"
        log(f"  load_model + tokenizer: {out['load_s']:.1f} s; dtype {model.dtype}; "
            f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated")
        inf = ex.app_cfg.inference
        inf.max_batch_size = 8
        inf.prefix_cache = True                  # as cli serve --continuous-batching
        rng = np.random.default_rng(SEED + 11)
        lens = [64, 512, 200, 333, 128, 480, 96, 256]
        texts = [_prompt_text(ex.tokenizer, n, rng) for n in lens]
        system = _prompt_text(ex.tokenizer, 200, rng)   # the chats' shared system message
        out["turns"] = []
        for warm in HTTP_TURNS:
            turn = http_turn(sched, ex, texts, system, warm, card)
            out["turns"].append(turn)
            if warm and "qmm" not in out:
                out.update(turn["launches"])
        ttft = {w: [t["ttft_ms_median"] for t in out["turns"] if t["warm"] == w]
                for w in (True, False)}
        log(f"  streamed-chat client TTFT median, warmed {ttft[True]} ms, not warmed "
            f"{ttft[False]} ms ({card})")
        out.update(ttft_ms=out["turns"][0]["ttft_ms"], tok_s=out["turns"][0]["tok_s"])
        del sched, ex, model
        torch.cuda.empty_cache()

        # The CLI entry point in its own process.
        with cli_serve(ckpt, ckpt / "cli_stderr.txt") as (cli_port, up, warmed):
            st, body = _http(cli_port, "POST", "/v1/chat/completions", {
                "messages": [{"role": "user", "content": texts[0]}], "max_tokens": 16,
                "temperature": 0})
            assert st == 200, (st, body)
            reply = json.loads(body)
            assert reply["choices"][0]["finish_reason"] in ("stop", "length"), reply
            st, body = _http(cli_port, "GET", "/metrics")
            assert st == 200, st
            cli_metrics = parse_metrics(body.decode())
            assert cli_metrics[("blazr_tpu_tokens_generated_total", ())] == \
                reply["usage"]["completion_tokens"], cli_metrics
            log(f"  cli serve: '{warmed}'; answered /health after {up:.1f} s, a chat "
                f"completion of {reply['usage']['completion_tokens']} tokens and /metrics")
            out["cli_up_s"] = up
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return out


def start_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof, time.perf_counter()


def stop_profile(prof, t0: float) -> tuple[float, float, int, dict, list]:
    """(wall s, device-busy s, device events, {name: [device s, calls]},
    the longest idle gaps) of the window from ``start_profile``. Busy is
    the union of the device events' spans; a gap is (ms, the device event
    before it, the host calls that overlap it, longest first)."""
    import torch

    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.stop()
    by_name: dict = {}
    spans, host = [], []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            entry = by_name.setdefault(ev.name, [0.0, 0])
            entry[0] += ev.time_range.elapsed_us() / 1e6
            entry[1] += 1
            spans.append((ev.time_range.start, ev.time_range.end, ev.name))
        else:
            host.append((ev.time_range.start, ev.time_range.end, ev.name))
    spans.sort()
    busy_us, reach, gaps = 0.0, None, []
    for start, end, name in spans:
        if reach is None or start >= reach[0]:
            if reach is not None and start > reach[0]:
                gaps.append((start - reach[0], reach[0], start, reach[1]))
            busy_us += end - start
            reach = (end, name)
        elif end > reach[0]:
            busy_us += end - reach[0]
            reach = (end, name)
    gaps.sort(reverse=True)
    top = []
    for us, lo, hi, name in gaps[:5]:
        calls: dict = {}
        for h0, h1, hname in host:
            inside = min(h1, hi) - max(h0, lo)
            if inside > 0:
                calls[hname] = calls.get(hname, 0.0) + inside
        top.append((us / 1e3, short_name(name), sorted(calls.items(), key=lambda kv: -kv[1])[:4]))
    return wall, busy_us / 1e6, len(spans), by_name, top


def device_busy(fn) -> tuple[float, float, int, dict, list]:
    """``stop_profile``'s numbers for a window around ``fn()``."""
    prof, t0 = start_profile()
    fn()
    return stop_profile(prof, t0)


def gap_line(gaps: list) -> str:
    return "; ".join(
        f"{ms:.2f} ms after {after} (host: "
        + (", ".join(f"{n} {us / 1e3:.2f}" for n, us in calls) or "no recorded call")
        + ")" for ms, after, calls in gaps)


def top_ops(names: dict, k: int = 8) -> list:
    rows: dict = {}
    for name, (sec, calls) in names.items():
        r = rows.setdefault(short_name(name), [0.0, 0])
        r[0] += sec
        r[1] += calls
    return sorted(rows.items(), key=lambda kv: -kv[1][0])[:k]


def decode_profile(tag: str, card: str, window: tuple, steps: int) -> dict:
    """Log and return a decode window's numbers: wall, busy and device events
    a step, the idle share under the profiler and the longest gaps."""
    wall, busy, events, names, gaps = window
    idle = 1 - busy / wall if busy > 0 else None
    log(f"  profiled {steps} decode steps ({tag}): wall {wall / steps * 1e3:.2f} ms/step, "
        f"device busy {busy / steps * 1e3:.2f} ms/step, {events / steps:.0f} device "
        f"events/step; device idle share "
        + (f"{idle:.2f}" if idle is not None else "not measured (no device events)")
        + f" ({card}; under the profiler)")
    log(f"  longest idle gaps ({tag}): {gap_line(gaps)}")
    log(f"  top device ops, per decode step ({tag}): " + "; ".join(
        f"{n} {sec / steps * 1e3:.3f} ms/{calls / steps:.0f}" for n, (sec, calls) in top_ops(names)))
    return dict(step_wall_ms=wall / steps * 1e3, step_busy_ms=busy / steps * 1e3,
                step_events=events / steps, step_idle_share=idle, steps=steps,
                gaps=[(ms, after) for ms, after, _ in gaps])


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and namespaces."""
    for key in ("qmm_wgmma_kernel", "qmm_splitk_kernel", "pa_split_kernel",
                "pa_combine_kernel", "reduce_splits", "round_to_bf16", "act_quant_kernel",
                "qmm_int8_wgmma_kernel", "qmm_int8_dec_kernel", "qmm_int8_kernel",
                "qmm_stream_kernel", "round_rows_kernel"):
        if key in name:
            return key
    return name[:60]


def profile_serving(dev, model, card: str, quant_compute: str = "w4a16",
                    graphs: bool = True, engine=None) -> dict:
    """Phases 5's and 5c's profile: one BatchEngine (decode graphs on or
    off; ``engine`` if given) under torch.profiler, first over one prefill
    group of 4 prompts (64-512 tokens) that stop after their first token,
    then over the decode steps of the same 4 run to 33 tokens: the window
    opens once every first token is in and closes when the last token is,
    so it holds decode rounds only (counted on the device: B2's kernels
    over the layers). A run to 2 tokens before them captures the decode
    graph."""
    import numpy as np

    from blazr_tpu_torch.config import GenerationConfig

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 9)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (64, 512, 200, 333)]
    engine = engine or make_engine(model, quant_compute, graphs)

    def wave(tokens: int):
        return [(p, GenerationConfig(max_tokens=tokens, temperature=0.0)) for p in prompts]

    async def decode_window():
        task = asyncio.create_task(engine.run())
        handles = [engine.submit(p, g) for p, g in wave(33)]
        for h in handles:
            await asyncio.wait_for(h.queue.get(), 600)
        prof, t0 = start_profile()
        h0 = engine.horizon_steps

        async def drain(h):
            async for _ in h.tokens():
                pass
        await asyncio.wait_for(asyncio.gather(*[drain(h) for h in handles]), 600)
        out = stop_profile(prof, t0)
        dispatched = engine.horizon_steps - h0
        engine.stop()
        await task
        return out, dispatched

    async def runs():
        # One event loop for the three runs: the engine's event is bound to it.
        await serve(engine, [wave(2)])          # warm the engine's first calls
        prof, t0 = start_profile()
        await serve(engine, [wave(1)])
        return stop_profile(prof, t0), await decode_window()

    (wall_p, busy_p, n_p, names_p, _), (window, dispatched) = asyncio.run(runs())
    tag = f"graphs {'on' if graphs else 'off'}"
    log(f"  profiled prefill group (4 prompts, 1109 tokens; {tag}): wall "
        f"{wall_p * 1e3:.1f} ms, device busy {busy_p * 1e3:.1f} ms over {n_p} device "
        f"events; idle share " + (f"{1 - busy_p / wall_p:.2f}" if busy_p > 0 else "not measured"))
    log(f"  top device ops, prefill group ({tag}): " + "; ".join(
        f"{n} {sec * 1e3:.2f} ms/{calls}" for n, (sec, calls) in top_ops(names_p)))
    # Decode steps: B2's kernels over the attention layers, or where no
    # layer runs B2 (MLA, Mamba2) the steps the engine dispatched.
    b2 = sum(c for name, (_, c) in window[3].items() if "pa_split_kernel" in name)
    attn_layers = sum(t == "attention" for t in cfg.layer_types())
    steps = max(1, round(b2 / attn_layers) if b2 else dispatched)
    out = decode_profile(f"batch 4, {tag}", card, window, steps)
    b1 = [(sec, c) for name, (sec, c) in window[3].items()
          if "qmm_wgmma_kernel" in name or "qmm_splitk_kernel" in name]
    out.update(b1_per_step=sum(c for _, c in b1) / steps,
               b1_ms_per_step=sum(sec for sec, _ in b1) / steps * 1e3)
    log(f"  B1 a decode step (batch 4, {tag}): {out['b1_per_step']:.0f} launches, "
        f"{out['b1_ms_per_step']:.3f} ms of {out['step_busy_ms']:.3f} ms busy")
    del engine
    free_card()
    return dict(out, prefill_wall_ms=wall_p * 1e3, prefill_busy_ms=busy_p * 1e3)


def serve_executor(dev, card: str, hold: bool = True) -> dict:
    """Phase 5b: the 32-layer single-stream Executor under w8a8: a 512-token
    prompt and 128 greedy tokens through collect_generation, with decode
    graphs and without in turns (GRAPH_TURNS): the streams must be equal.
    Every projection of every forward launches B3 (replays counted); B1
    never launches. Then under the profiler, both ways: 16 more tokens; and
    B3 alone on the model's gate+up weight at 1 and 512 rows, where every
    device kernel counts: at most 3 a call (``hold=False``, another
    checkout: reported only)."""
    import numpy as np
    import torch

    from blazr_tpu_torch.config import AppConfig, GenerationConfig
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.engine.generate_text import collect_generation

    model = mistral_model(dev)
    cfg = model.cfg
    prompt = np.random.default_rng(SEED + 7).integers(0, cfg.vocab_size, 512).tolist()
    per_forward = 4 * cfg.num_layers
    turns, streams, launches, profiled = [], [], None, {}
    for graphs in GRAPH_TURNS:
        app = AppConfig(model=cfg)
        app.inference.quant_compute = "w8a8"
        app.inference.graphs = graphs
        t0 = time.perf_counter()
        ex = Executor(model, StubTokenizer(), app)
        torch.cuda.synchronize()
        qkv = model.params["layers"][0]["qkv"]
        assert qkv.bits == 8 and qkv.act_quant
        if not turns:
            log(f"  widened to int8 in place in {time.perf_counter() - t0:.1f} s; "
                f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated")
        ex.warmup()
        reset_counts()
        t0 = time.perf_counter()
        res = collect_generation(ex, prompt, GenerationConfig(max_tokens=128,
                                                              temperature=0.0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        n = len(res.tokens)
        assert n == 128 and all(0 <= t < cfg.vocab_size for t in res.tokens), n
        # One prefill + n - 1 decode steps, every projection through B3.
        assert counts["qmm_int8"] == n * per_forward, counts
        assert counts["qmm"] == 0 and counts["qmm_stream"] == 0, counts
        streams.append(list(res.tokens))
        turn = dict(graphs=graphs, ttft_ms=res.prompt_eval_duration * 1e3,
                    ms_per_token=res.eval_duration / (n - 1) * 1e3, tok_s=n / wall,
                    **graph_stats(ex))
        turns.append(turn)
        log(f"  graphs {'on ' if graphs else 'off'}: Executor w8a8, {cfg.num_layers} layers, "
            f"prompt 512, {n} greedy tokens: TTFT {turn['ttft_ms']:.1f} ms, "
            f"{turn['ms_per_token']:.2f} ms per decode token, {turn['tok_s']:.1f} tok/s end "
            f"to end, {(n - 1) / res.eval_duration:.1f} tok/s decode; {turn['captured']} "
            f"graphs captured in {turn['capture_s']:.2f} s ({turn['pool_mib']:.1f} MiB pool) "
            f"({card})")
        if launches is None and graphs:
            launches = counts
            log(f"  launches: {counts} ({n} forwards x {per_forward} projections)")
        if graphs not in profiled:
            profiled[graphs] = profile_executor(ex, prompt, card, graphs)
        del ex
        free_card()
    assert all(st == streams[0] for st in streams), "graph and eager streams differ"
    log(f"  the {len(streams)} streams (graphs on, off, off, on) are equal")
    b3_kernels, b3_calls = profiled[True]["b3_kernels"], profiled[True]["b3_calls"]
    # Every device kernel of a B3 call, the activation quant included, on the
    # model's own gate+up weight: 8 calls profiled alone (CUDA activity only),
    # after a warm-up step of the profiler (a fresh trace drops its first
    # kernels).
    from torch.profiler import ProfilerActivity, profile, schedule

    from blazr_tpu_torch.quant.int8 import qmm_int8
    gu = model.params["layers"][0]["gateup"]
    per_call = {}
    for m in (1, 512):
        x = torch.randn((m, gu.in_features), device=dev).to(torch.bfloat16)

        def calls(n):
            for _ in range(n):
                qmm_int8(x, gu.qweight, gu.scales, gu.mins, bits=gu.bits,
                         group_size=gu.group_size, device=dev)
            torch.cuda.synchronize()

        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            calls(4)
            prof.step()
            calls(8)
        per_call[m] = sum(e.device_type == torch.autograd.DeviceType.CUDA
                          for e in prof.events()) / 8
    log(f"  B3 alone on gate+up: device kernels a call {per_call} (at most 3)")
    assert all(v > 0 for v in per_call.values()), per_call
    if hold:
        assert b3_kernels <= 3 * b3_calls, (b3_kernels, b3_calls)
        assert all(v <= 3 for v in per_call.values()), per_call
    del model
    free_card()
    first = turns[0]
    return dict(launches, ttft_ms=first["ttft_ms"], ms_per_token=first["ms_per_token"],
                tok_s=first["tok_s"], idle_share=profiled[True]["step_idle_share"],
                b3_kernels_per_call=per_call, turns=turns, profile=profiled)


def profile_executor(ex, prompt: list, card: str, graphs: bool) -> dict:
    """Where a decode token's time goes in phase 5b: a 16-token prompt run
    to 17 tokens, the profiler over the 16 decode tokens after the first
    (the window opens once the prefill's token is in); B3's own kernels a
    qmm_int8 call in that window."""
    from blazr_tpu_torch.config import GenerationConfig

    tag = f"graphs {'on' if graphs else 'off'}"
    gen = ex.generate(prompt[:16], GenerationConfig(max_tokens=17, temperature=0.0))
    next(gen)
    b3_before = read_counts()["qmm_int8"]
    prof, t0 = start_profile()
    steps = sum(1 for _ in gen)
    window = stop_profile(prof, t0)
    b3_calls = read_counts()["qmm_int8"] - b3_before
    assert window[2] > 0, "the profiler saw no device kernels"
    out = decode_profile(f"Executor, {tag}", card, window, steps)
    # B3's own kernels: the quant, a product and the split reduction (the
    # only reduce_splits under w8a8, where B1 and B4 never launch).
    b3_kernels = sum(calls for n, (_, calls) in top_ops(window[3], k=1000)
                     if n in ("act_quant_kernel", "qmm_int8_wgmma_kernel",
                              "qmm_int8_dec_kernel", "qmm_int8_kernel", "reduce_splits"))
    log(f"  B3 ({tag}): {b3_kernels} of its own device kernels over {b3_calls} qmm_int8 "
        f"calls ({b3_kernels / b3_calls:.2f} a call)")
    return dict(out, b3_kernels=b3_kernels, b3_calls=b3_calls)


def teacher_forced_w8a8(dev) -> None:
    """Phase 4b: 2-layer full-width Mistral-7B under w8a8 through the
    contiguous llama.forward: the card (bf16, B3) against the CPU (f32,
    plain versions) on the same widened weights, teacher-forced over a
    100-token prefill and 4 decode steps."""
    import numpy as np
    import torch

    from blazr_tpu_torch.kvcache.contiguous import init_kv_cache
    from blazr_tpu_torch.models.llama import forward
    from blazr_tpu_torch.quant.qtensor import apply_quant_compute

    model = mistral_model(dev, layers=2)
    cfg = model.cfg
    params = apply_quant_compute(model.params, "w8a8")
    cpu_params = to_cpu_f32(params)
    rng = np.random.default_rng(SEED + 1)
    n, steps = 100, 4
    toks = rng.integers(0, cfg.vocab_size, n + steps)
    inputs = [(toks[None, :n], np.arange(n)[None, :], np.array([n]))]
    inputs += [(toks[None, n + i:n + i + 1], np.array([[n + i]]), np.array([n + i + 1]))
               for i in range(steps)]
    caches = {name: init_kv_cache(2, 1, 256, model.num_kv_heads, model.head_dim,
                                  dtype=dt, device=d)
              for name, d, dt in (("gpu", dev, torch.bfloat16),
                                  ("cpu", torch.device("cpu"), torch.float32))}
    rel_tol = 5e-2                     # as phase 4: bf16 between every op
    reset_counts()
    for step, (tk, ps, sl) in enumerate(inputs):
        out = {}
        for name, d, pr in (("gpu", dev, params), ("cpu", torch.device("cpu"), cpu_params)):
            def tt(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(d)
            with torch.no_grad():
                logits, _ = forward(pr, cfg, tt(tk), caches[name], tt(ps),
                                    tt(sl.astype(np.int32)))
            out[name] = logits.float().cpu()
        g, c = out["gpu"], out["cpu"]
        assert g.shape == c.shape and torch.isfinite(g).all()
        rel = ((g - c).abs().max() / c.abs().max()).item()
        agree = (g.argmax(-1) == c.argmax(-1)).float().mean().item()
        log(f"  w8a8 forward step {step} ({'prefill' if step == 0 else 'decode'}): "
            f"max|gpu-cpu|/max|cpu| {rel:.4g} (tol {rel_tol}), argmax agreement {agree:.2f}")
        assert rel <= rel_tol, f"w8a8 teacher-forced step {step}: {rel} > {rel_tol}"
    launches = read_counts()
    assert launches["qmm_int8"] == 4 * 2 * len(inputs) and launches["qmm"] == 0, launches
    del model, params, caches
    torch.cuda.empty_cache()


def ppl_gate(dev) -> dict:
    """Phase 4c: the Δppl gate. A 2-layer full-width model on a fixed
    512-token stream in windows of 256: w4a8-prefill and w8a8 each within 2%
    of w4a16 (the JAX gate's bound, tests/test_int8_mxu.py:237)."""
    import numpy as np
    import torch

    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.quant.qtensor import apply_quant_compute
    from blazr_tpu_torch.utils.ppl import perplexity

    base = mistral_model(dev, layers=2)
    stream = (np.random.default_rng(SEED + 2).integers(1, base.cfg.vocab_size, 64)
              .tolist() * 8)[:512]
    out = {"w4a16": perplexity(base, stream, window=256)}
    for mode in ("w4a8-prefill", "w8a8"):
        m = Model(base.cfg, apply_quant_compute(base.params, mode), torch.bfloat16)
        reset_counts()
        out[mode] = perplexity(m, stream, window=256)
        b3 = read_counts()["qmm_int8"]
        rel = abs(out[mode] - out["w4a16"]) / out["w4a16"]
        log(f"  ppl {mode} {out[mode]:.4f} vs w4a16 {out['w4a16']:.4f}: "
            f"|dppl|/ppl {rel:.5f} (bound 0.02), B3 launches {b3}")
        assert b3 > 0 and np.isfinite(out[mode]) and rel < 0.02, (mode, out)
    del base
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 10 (families): the dense families
# ---------------------------------------------------------------------------

# The serving models: (family, depth, the engine's max_seq_len). Qwen3-8B at
# full depth with Mistral's 4096-token tables (64 slots); Gemma2-9B at its
# published 8192 (128 slots), so its window (66 slots) and its global layers
# walk different spans and take different B2 split plans.
# (family, published depth, the engine's max_seq_len, the depth a full run
# serves): a full run serves half of each, to leave phase 12 room in the
# 1200 s limit (on an H100, the full run took 1157.7 s with phases 10 and
# 11 at their depths before phase 12, and 862.6-937.7 s with these cuts);
# ``--phases build,families`` serves them whole.
FAMILY_SERVING = (("qwen3", 36, 4096, 6), ("gemma2", 42, 8192, 6))
FAMILY_REQUEST_LENS = (64, 512, 200, 333, 128, 480, 96, 256)


def family_forwards(dev) -> dict:
    """Phase 10, part 1: each dense family at its published width, 2 layers,
    written to disk in its HF layout (AWQ-INT4, group 128; Falcon plain
    bf16), loaded by load_model onto the card (bf16), a 64-token prefill
    and 4 decode steps against the port's CPU f32 forward on the same
    params; then Gemma2 past its window in a config copy whose window is cut
    to 64 (layer 0 slides, layer 1 does not). B1 and B2 launches counted
    per family."""
    import shutil
    import tempfile

    import torch

    from blazr_tpu_torch.loader import load_model
    from blazr_tpu_torch.utils.synthetic import FAMILY_CONFIGS, write_hf_checkpoint

    out = {}
    with tempfile.TemporaryDirectory(prefix="families-") as root:
        for family, make in FAMILY_CONFIGS.items():
            cfg = make()
            cfg.num_layers = 2
            d = Path(root) / family
            t0 = time.perf_counter()
            write_hf_checkpoint(d, cfg, quant="plain" if family == "falcon" else "awq",
                                seed=SEED, dtype="bfloat16")
            t1 = time.perf_counter()
            model, _ = load_model(d, dtype="bf16", device=dev)
            t2 = time.perf_counter()
            shutil.rmtree(d)
            # Dequantized once on the card: the CPU's f32 forward then runs
            # plain GEMMs, not B1's plain version (the same function) a call.
            cpu = to_cpu_f32(model.params, dense=True)
            reset_counts()
            err = card_vs_cpu(dev, model.cfg, model.params, cpu, [64, 37], family)
            counts = read_counts()
            assert counts["paged_attention"] == 2 * 4, counts
            assert counts["qmm"] > 0 or family == "falcon", counts
            row = dict(max_rel_err=err, qmm=counts["qmm"],
                       paged_attention=counts["paged_attention"])
            if family == "gemma2":
                att = dataclasses.replace(model.cfg.attention, sliding_window=64)
                cut = dataclasses.replace(model.cfg, attention=att)
                assert [att.layer_window(i) for i in range(2)] == [64, None]
                row["window_64_max_rel_err"] = card_vs_cpu(
                    dev, cut, model.params, cpu, [200, 130],
                    "gemma2 (config copy, window cut to 64: layer 0 slides, layer 1 not)")
            log(f"  {family}: {cfg.hidden_size}d, vocab {cfg.vocab_size}, 2 layers; "
                f"written in {t1 - t0:.1f} s, loaded in {t2 - t1:.1f} s; max rel err "
                f"{err:.4g}; launches B1 {counts['qmm']}, B2 {counts['paged_attention']}")
            out[family] = row
            del model, cpu
            free_card()
    return out


def family_engine(model, graphs: bool, max_seq_len: int):
    """A BatchEngine as ``serve --continuous-batching`` builds it (prefix
    cache on, w4a16, block 64, max batch 8, horizon 8, pipe depth 2),
    warmed; (engine, warmup s)."""
    engine = prefix_engine(model, True, graphs=graphs, max_seq_len=max_seq_len)
    return engine, engine.warmup()


def family_requests(cfg, greedy_only: bool = False) -> list:
    """Phase 5's 8 requests: prompts of FAMILY_REQUEST_LENS tokens, 64 new
    tokens each; requests 2 and 6 sampled unless ``greedy_only``."""
    import numpy as np

    from blazr_tpu_torch.config import GenerationConfig

    rng = np.random.default_rng(SEED + 5)
    out = []
    for i, n in enumerate(FAMILY_REQUEST_LENS):
        gen = (GenerationConfig(max_tokens=64, temperature=0.7, top_p=0.9, seed=100 + i)
               if i in (2, 6) and not greedy_only
               else GenerationConfig(max_tokens=64, temperature=0.0))
        out.append((rng.integers(0, cfg.vocab_size, n).tolist(), gen))
    return out


def llama_family_model(dev, family: str, layers: int):
    """A dense or MoE family's published-width model at ``layers`` layers,
    AWQ-INT4 synthesized on the card."""
    import torch

    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.utils.synthetic import (FAMILY_CONFIGS, MOE_CONFIGS,
                                                 synth_llama_params)

    cfg = {**FAMILY_CONFIGS, **MOE_CONFIGS}[family]()
    cfg.num_layers = layers
    t0 = time.perf_counter()
    model = Model(cfg, synth_llama_params(cfg, quant="awq", dtype=torch.bfloat16,
                                          seed=SEED, device=dev), torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  synthesized {layers}-layer {family} ({cfg.hidden_size}d, vocab "
        f"{cfg.vocab_size}) AWQ-INT4 on the card in {time.perf_counter() - t0:.1f} s")
    return model


def family_serving(dev, card: str, family: str, model, max_seq_len: int) -> dict:
    """Phases 10, 11, 13 and 14, serving: a family's published-width model
    on the card serving the 8 requests of phase 5 (family_requests) in one
    wave through a warmed engine (family_engine), with decode graphs and
    without: tok/s, ms a decode step, TTFT; the streams equal both ways; B1
    launched, and B2 where the family has paged attention, with graphs (the
    launch counts of that run, set to 0 just before it). Launches a decode
    step: those made inside the engine's decode rounds (prefills run in
    calls of their own) over the steps those rounds dispatched. Then 32
    decode steps profiled."""
    import torch

    from blazr_tpu_torch.models.registry import resolve_paged_kind

    cfg = model.cfg
    reqs = family_requests(cfg)
    has_b2 = resolve_paged_kind(cfg) in ("llama", "hybrid")
    turns, streams, launches = {}, {}, None
    for graphs in (True, False):
        engine, warm_s = family_engine(model, graphs, max_seq_len)
        decode = dict.fromkeys(("steps", "qmm", "paged_attention"), 0)

        def counted_round(decodes, inner=engine._horizon_round, engine=engine):
            c0, s0 = read_counts(), engine.horizon_steps
            inner(decodes)
            c1 = read_counts()
            decode["steps"] += engine.horizon_steps - s0
            for key in ("qmm", "paged_attention"):
                decode[key] += c1[key] - c0[key]
        engine._horizon_round = counted_round
        reset_counts()
        t0 = time.perf_counter()
        results = asyncio.run(serve(engine, [reqs]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        assert counts["qmm"] > 0 and (counts["paged_attention"] > 0 or not has_b2), counts
        assert all(len(r["tokens"]) == g.max_tokens and all(0 <= t < cfg.vocab_size
                                                            for t in r["tokens"])
                   for r, (_, g) in zip(results, reqs))
        streams[graphs] = [r["tokens"] for r in results]
        if graphs:
            launches = counts
        ttft = sorted(r["ttft"] for r in results)
        steps = engine.horizon_steps
        assert decode["steps"] == steps, (decode, steps)
        tokens = sum(len(t) for t in streams[graphs])
        turn = dict(tok_s=tokens / wall, ms_per_step=engine.perf["decode"] / steps * 1e3,
                    ttft_ms_median=ttft[len(ttft) // 2] * 1e3, ttft_ms_max=ttft[-1] * 1e3,
                    warmup_s=warm_s, steps=steps, b1_per_step=decode["qmm"] / steps,
                    b2_per_step=decode["paged_attention"] / steps, **graph_stats(engine))
        turns[graphs] = turn
        log(f"  {family} graphs {'on ' if graphs else 'off'}: {tokens} tokens in {wall:.2f} s, "
            f"{turn['tok_s']:.1f} tok/s; {turn['ms_per_step']:.2f} ms a decode step "
            f"({steps} steps, each launching B1 {turn['b1_per_step']:.1f} and B2 "
            f"{turn['b2_per_step']:.1f} times); TTFT median {turn['ttft_ms_median']:.1f} ms, max "
            f"{turn['ttft_ms_max']:.1f} ms; warmed in {warm_s:.2f} s ({turn['captured']} "
            f"graphs, {turn['pool_mib']:.1f} MiB pool); launches {counts} ({card}; depth "
            f"{cfg.num_layers}, max_seq_len {max_seq_len})")
        del engine
        free_card()
    equal = streams[True] == streams[False]
    log(f"  {family}: the 8 streams (6 greedy, 2 sampled) with graphs "
        f"{'equal' if equal else 'DIFFER from'} those without")
    assert equal, [i for i, (a, b) in enumerate(zip(streams[True], streams[False]))
                   if a != b]
    engine, _ = family_engine(model, True, max_seq_len)
    profile = profile_serving(dev, model, card, engine=engine)
    del engine
    free_card()
    return dict(launches, turns=turns, profile=profile)


def families(dev, card: str, full_run: bool) -> dict:
    """Phase 10: the dense families (family_forwards), then Qwen3-8B and
    Gemma2-9B served (family_serving) at the depth FAMILY_SERVING gives a
    full run when ``full_run``. The kernels line takes its family rows'
    launches from Qwen3-8B's run with graphs."""
    out = {"forwards": family_forwards(dev)}
    for family, layers, ctx, full_run_layers in FAMILY_SERVING:
        model = llama_family_model(dev, family, full_run_layers if full_run else layers)
        out[family] = family_serving(dev, card, family, model, ctx)
        del model
        free_card()
    out.update(qmm=out["qwen3"]["qmm"], paged_attention=out["qwen3"]["paged_attention"])
    return out


# ---------------------------------------------------------------------------
# phase 11 (moe): the MoE families
# ---------------------------------------------------------------------------

# B1 at the expert projections (K, N) of the three MoE families at their
# published widths (utils/synthetic.py::MOE_CONFIGS).
MOE_B1_SHAPES = {"mixtral gate/up": (4096, 14336), "mixtral down": (14336, 4096),
                 "qwen3-moe gate/up": (2048, 768), "qwen3-moe down": (768, 2048),
                 "qwen1.5-moe gate/up": (2048, 1408), "qwen1.5-moe down": (1408, 2048)}
# The rows an expert takes: a decode batch of 1-16 (every expert over every
# row) and a prefill group's routed rows.
MOE_B1_ROWS = (1, 2, 4, 8, 16, 512)
# The served models: (family, published depth, the engine's max_seq_len,
# the depth a full run serves). A full run holds Qwen3-30B-A3B to 4 of its
# 48 identical layers and Mixtral to 16 of 32: served whole on an H100,
# Qwen3-30B-A3B's warmup with graphs (72.5 s) and its graphs-off wave
# (121 s) alone leave the other phases too little of the 1200 s limit;
# ``--phases build,moe`` serves both whole.
MOE_SERVING = (("mixtral", 32, 4096, 4), ("qwen3_moe", 48, 4096, 2))
# A free-running forward with the card in f32 against the CPU f32: the same
# weights and arithmetic, f32 sums in another order (B1's split-K over K,
# B2's splits, cuBLAS's f32 GEMMs in attention): 1e-3 of the largest logit.
F32_FREE_TOL = 1e-3


def moe_b1(dev, gen) -> dict:
    """Phase 11 (a): B1 against its plain version at every MoE expert shape
    and row count (MOE_B1_SHAPES x MOE_B1_ROWS, tolerance as phase 2's), then
    timed: kernel, bound, plain version and torch.matmul on the
    bf16-dequantized weight."""
    import torch

    from blazr_tpu_torch.quant.kernels import qmm, qmm_reference
    from blazr_tpu_torch.quant.qtensor import dequantize_planes

    gs, rel_tol = 128, 8e-3
    rows, worst = {}, 0.0
    for pname, (k, n) in MOE_B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 4, gs, gen, dev)
        w = dequantize_planes(qw, s, mn, 4, True, gs, torch.bfloat16)
        for m in MOE_B1_ROWS:
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            got = qmm(x, qw, s, mn, bits=4, signed=True, group_size=gs, device=dev)
            ref = qmm_reference(x.float(), qw, s, mn, bits=4, signed=True, group_size=gs)
            torch.cuda.synchronize()
            assert got.shape == ref.shape and torch.isfinite(got).all(), pname
            err = (got.float() - ref).abs().max().item()
            tol = rel_tol * ref.abs().max().item()
            assert err <= tol, f"B1 {pname} m={m}: {err} > {tol}"
            worst = max(worst, err)
            ms = time_ms(lambda: qmm(x, qw, s, mn, bits=4, signed=True, group_size=gs,
                                     device=dev), iters=20)
            nbytes = qw.numel() * 4 + s.numel() * 8 + x.numel() * 2 + m * n * 2
            bms, by = bound(nbytes, 2.0 * m * k * n)
            row = dict(ms=ms, bound_ms=bms, bound_by=by, max_abs_err=err,
                       library_ms=time_ms(lambda: torch.matmul(x, w), iters=20),
                       plain_ms=time_eager(lambda: qmm_reference(
                           x, qw, s, mn, bits=4, signed=True, group_size=gs), iters=3,
                           warmup=1),
                       shape=f"{pname} m={m} K={k} N={n}")
            rows[(pname, m)] = row
            log(f"  B1 {pname} m={m} K={k} N={n}: max_abs_err {err:.4g} (tol {tol:.4g}); "
                f"kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}, x{ms / bms:.1f}), "
                f"torch.matmul(bf16 dequantized) {row['library_ms']:.4f} ms "
                f"(x{ms / row['library_ms']:.2f}), plain {row['plain_ms']:.4f} ms")
        del w
    return dict(rows=rows, max_abs_err=worst)


class RouteTape:
    """Holds the CPU reference to the card's routing. While it is active,
    each call of ``models.moe.route`` on the card records its top-k experts,
    and the CPU's next call (the same layer of the same step:
    ``card_vs_cpu`` runs the card first) takes them, weighted by its own f32
    scores, and counts how many of its own choices they match. One token
    whose k-th and (k+1)-th scores lie within bf16 noise of each other
    changes expert on the card, and its logits then differ with no kernel at
    fault; the share of decisions that agree is reported on its own."""

    def __enter__(self):
        from collections import deque

        from blazr_tpu_torch.models import moe

        self.module, self.real = moe, moe.route
        self.queue, self.agree, self.total = deque(), 0, 0
        moe.route = self
        return self

    def __exit__(self, *exc):
        self.module.route = self.real
        assert exc[0] is not None or not self.queue, "a card routing was not replayed"

    def __call__(self, x, router_w, moe, correction_bias=None):
        import torch

        idx, w = self.real(x, router_w, moe, correction_bias)
        if x.dtype != torch.float32:                   # the card's bf16 forward
            self.queue.append(idx.cpu())
            return idx, w
        # The three served MoE families route by softmax top-k alone.
        assert moe.scoring_func == "softmax" and moe.n_group == 1
        assert correction_bias is None
        card = self.queue.popleft()
        self.agree += int((card[:, :, None] == idx[:, None, :]).any(-1).sum())
        self.total += card.numel()
        scores = torch.softmax(x.to(torch.float32) @ router_w.to(torch.float32), dim=-1)
        cw = scores.gather(-1, card)
        if moe.norm_topk_prob:
            cw = cw / (cw.sum(dim=-1, keepdim=True) + 1e-20)
        return card, cw * moe.routed_scaling_factor

    @property
    def share(self) -> float:
        return self.agree / max(1, self.total)


class LayerTape:
    """Teacher-forces the CPU reference layer by layer. While it is active,
    each decoder layer and the head of the card's forward (bf16) record
    their input and output; the CPU's forward (f32) runs each layer and the
    head on the card's input instead of its own, and each layer's output is
    held to the card's at ``rel_tol`` of its largest magnitude. Free-running
    forwards of these random checkpoints drift up to about 5e-2 of the
    largest logit from f32 in 2 layers through bf16 rounding alone (PERF.md
    §6), which leaves a 5e-2 gate on the logits no margin; a layer computed
    from the same input holds every kernel of it to f32 with that margin."""

    def __init__(self, rel_tol: float = 5e-2, sites: tuple = ()):
        self.rel_tol = rel_tol
        self.worst = 0.0
        self.sites = sites          # (module, name) of other families' layers

    def __enter__(self):
        from collections import deque

        from blazr_tpu_torch.models import llama, llama_paged

        self.modules = (llama, llama_paged)
        self.real_layer, self.real_head = llama.decoder_layer, llama.forward_head
        self.queue = deque()
        for m in self.modules:
            m.decoder_layer, m.forward_head = self.layer, self.head
        self.saved = [(m, name, getattr(m, name)) for m, name in self.sites]
        for m, name, real in self.saved:
            setattr(m, name, lambda p, cfg, x, mixer, real=real: self.layer(
                p, cfg, x, mixer, real))
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.decoder_layer, m.forward_head = self.real_layer, self.real_head
        for m, name, real in self.saved:
            setattr(m, name, real)
        assert exc[0] is not None or not self.queue, "a card layer was not replayed"

    def _forced(self, x):
        """(the card's input to use, the card's output) on the CPU side."""
        x_card, out_card = self.queue.popleft()
        assert x_card.shape == x.shape
        return x_card, out_card

    def layer(self, p, cfg, x, attn, real=None):
        import torch

        real = real or self.real_layer
        if x.dtype != torch.float32:                   # the card's bf16 forward
            out = real(p, cfg, x, attn)
            self.queue.append((x.float().cpu(), out.float().cpu()))
            return out
        x_card, out_card = self._forced(x)
        out = real(p, cfg, x_card, attn)
        rel = ((out_card - out).abs().max() / out.abs().max()).item()
        self.worst = max(self.worst, rel)
        assert rel <= self.rel_tol, f"a decoder layer's output: {rel} > {self.rel_tol}"
        return out

    def head(self, params, cfg, hidden):
        import torch

        if hidden.dtype != torch.float32:
            self.queue.append((hidden.float().cpu(), None))
            return self.real_head(params, cfg, hidden)
        return self.real_head(params, cfg, self._forced(hidden)[0])


def card_vs_cpu_contiguous(dev, cfg, params, cpu_params, n: int, tag: str,
                           steps: int = 4, rel_tol: float = 5e-2) -> float:
    """``card_vs_cpu`` for the family's contiguous forward and cache (the
    Executor's: ``Model.forward``, ``Model.init_cache``): one n-token
    prefill, then ``steps`` teacher-forced decode steps; the worst relative
    error."""
    import numpy as np
    import torch

    from blazr_tpu_torch.models.registry import Model

    seq = np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (1, n + steps))
    sides = {"gpu": Model(cfg, params, torch.bfloat16),
             "cpu": Model(cfg, cpu_params, torch.float32)}
    caches = {k: m.init_cache(1, n + steps) for k, m in sides.items()}
    worst = 0.0
    for step, (lo, hi) in enumerate([(0, n)] + [(n + j, n + j + 1) for j in range(steps)]):
        out = {}
        for name, m in sides.items():
            d = m.device
            with torch.no_grad():
                logits, _ = m.forward(torch.from_numpy(seq[:, lo:hi]).to(d), caches[name],
                                      torch.arange(lo, hi, device=d)[None])
            out[name] = logits[:, -1].float().cpu()
        g, c = out["gpu"], out["cpu"]
        assert g.shape == c.shape and torch.isfinite(g).all()
        rel = ((g - c).abs().max() / c.abs().max()).item()
        log(f"  {tag} step {step} ({'prefill' if step == 0 else 'decode'}): "
            f"max|gpu-cpu|/max|cpu| {rel:.4g} (tol {rel_tol}), argmax "
            f"{'agrees' if int(g.argmax()) == int(c.argmax()) else 'differs'}")
        assert rel <= rel_tol, f"{tag} step {step}: {rel} > {rel_tol}"
        worst = max(worst, rel)
    return worst


def moe_forwards(dev) -> dict:
    """Phase 11 (b): each MoE family at its published width, 2 layers,
    written to disk as an AWQ-INT4 checkpoint (group 128) in its HF layout
    and loaded by load_model onto the card (bf16): the paged forward (a
    prefill of 64 and 37 tokens, 4 decode steps) and the contiguous one (a
    64-token prefill, 4 decode steps) against the port's CPU f32 forward on
    the same weights, the CPU taking the card's routing (RouteTape): each
    layer and the head on the card's input (LayerTape), held at 5e-2 of the
    largest logit and of each layer's largest output, then the paged one
    free-running (reported), and free-running with the card in f32 (each
    side routing itself), held at F32_FREE_TOL; B1 and B2 launches counted
    on the paged run."""
    import shutil
    import tempfile

    import torch

    from blazr_tpu_torch.loader import load_model
    from blazr_tpu_torch.utils.synthetic import MOE_CONFIGS, write_hf_checkpoint

    out = {}
    with tempfile.TemporaryDirectory(prefix="moe-") as root:
        for family, make in MOE_CONFIGS.items():
            cfg = make()
            cfg.num_layers = 2
            d = Path(root) / family
            t0 = time.perf_counter()
            write_hf_checkpoint(d, cfg, quant="awq", seed=SEED, dtype="bfloat16")
            t1 = time.perf_counter()
            model, _ = load_model(d, dtype="bf16", device=dev)
            t2 = time.perf_counter()
            shutil.rmtree(d)
            cpu = to_cpu_f32(model.params, dense=True)        # as in phase 10
            t3 = time.perf_counter()
            row = {}
            t4 = time.perf_counter()
            with RouteTape() as tape:
                with LayerTape() as layers:
                    reset_counts()
                    row["paged"] = card_vs_cpu(dev, model.cfg, model.params, cpu,
                                               [64, 37], f"{family} paged, by layer")
                    counts = read_counts()
                    row["contiguous"] = card_vs_cpu_contiguous(
                        dev, model.cfg, model.params, cpu, 64, f"{family} contiguous, by layer")
                row["paged_free"] = card_vs_cpu(dev, model.cfg, model.params, cpu, [64, 37],
                                                f"{family} paged, free-running", rel_tol=None)
            # The card in f32, free-running (each side routes itself): no
            # bf16 rounding, so only the order of f32 sums differs.
            row["paged_f32"] = card_vs_cpu(
                dev, model.cfg, card_f32(model.params), cpu, [64, 37],
                f"{family} paged, free-running, card in f32", rel_tol=F32_FREE_TOL,
                card_dtype=torch.float32)
            t5 = time.perf_counter()
            assert counts["paged_attention"] == 2 * 4 and counts["qmm"] > 0, counts
            # A sanity floor: a broken router agrees on about k/E of its picks.
            assert tape.share >= 0.9, f"{family}: routing agreement {tape.share}"
            moe = model.cfg.moe
            log(f"  {family}: {cfg.hidden_size}d, {moe.num_experts} experts of "
                f"{moe.intermediate_size}, top-{moe.experts_per_tok}, 2 layers; written in "
                f"{t1 - t0:.1f} s, loaded in {t2 - t1:.1f} s, CPU weights in "
                f"{t3 - t2:.1f} s, compared in {t5 - t4:.1f} s; max rel err of the logits "
                f"by layer: paged "
                f"{row['paged']:.4g}, contiguous {row['contiguous']:.4g}, of a layer's "
                f"output {layers.worst:.4g} (tol 5e-2); paged free-running "
                f"{row['paged_free']:.4g}, card in f32 {row['paged_f32']:.4g} (tol "
                f"{F32_FREE_TOL}); routing "
                f"agreement {tape.share:.4f} of {tape.total} decisions; launches B1 "
                f"{counts['qmm']}, B2 {counts['paged_attention']} (paged)")
            out[family] = dict({f"{k}_max_rel_err": v for k, v in row.items()},
                               layer_max_rel_err=layers.worst,
                               routing_agreement=tape.share, decisions=tape.total,
                               qmm=counts["qmm"], paged_attention=counts["paged_attention"])
            del model, cpu
            free_card()
    return out


def moe_phase(dev, gen, card: str, full_run: bool) -> dict:
    """Phase 11: B1 at the expert shapes (moe_b1), the 2-layer forwards
    (moe_forwards), then Mixtral-8x7B and Qwen3-30B-A3B served through the
    warmed engine (family_serving), at the depth MOE_SERVING gives a full
    run when ``full_run``. The kernels line takes its MoE row's launches
    from Mixtral's run with graphs."""
    out = {"b1": moe_b1(dev, gen), "forwards": moe_forwards(dev)}
    for family, layers, ctx, full_run_layers in MOE_SERVING:
        t0 = time.perf_counter()
        model = llama_family_model(dev, family, full_run_layers if full_run else layers)
        out[family] = family_serving(dev, card, family, model, ctx)
        del model
        free_card()
        log(f"  {family} served in {time.perf_counter() - t0:.1f} s")
    out.update(qmm=out["mixtral"]["qmm"], paged_attention=out["mixtral"]["paged_attention"])
    return out


# ---------------------------------------------------------------------------
# phase 12 (gguf): a llama.cpp-style GGUF file through the normal entry points
# ---------------------------------------------------------------------------

# Depth of the Mistral-7B-Instruct-v0.2 Q4_K_M file (of 32 layers): about
# 1.1 B parameters, a 0.6 GB file; the widths are the published ones.
GGUF_LAYERS = 4
GGUF_REQUEST_LENS = (64, 512, 200, 333, 128, 480, 96, 256)
# The rows B1 is timed at on the file's own weights: a decode step, a
# decode batch, a prefill group.
GGUF_B1_ROWS = (1, 8, 512)


def gguf_load(dev, path: Path) -> tuple:
    """The file through ModelScheduler (load_model, then the GGUF-embedded
    tokenizer), as ``cli serve --model FILE.gguf`` loads it; (scheduler,
    executor, seconds)."""
    import torch

    from blazr_tpu_torch.engine.model_scheduler import ModelScheduler

    t0 = time.perf_counter()
    sched = ModelScheduler(path, device=dev)
    ex = sched.get_executor("default")
    torch.cuda.synchronize()
    return sched, ex, time.perf_counter() - t0


def gguf_forwards(dev, model) -> dict:
    """The file's model on the card (bf16) against the CPU f32 forward of
    the same weights (dequantized on the card): the paged forward (64 and 37
    tokens, 4 decode steps) and the contiguous one (64 tokens, 4 decode
    steps) held layer by layer on the card's input at 5e-2 (LayerTape: the
    random weights' bf16 drift leaves a free-running 5e-2 gate no margin,
    PERF.md §6), the paged one free-running in bf16 (reported) and with the
    card in f32 (held at F32_FREE_TOL). B1 and B2 launches of the paged run."""
    import torch

    t0 = time.perf_counter()
    cpu = to_cpu_f32(model.params, dense=True)
    log(f"  CPU f32 weights (dequantized on the card) in {time.perf_counter() - t0:.1f} s")
    out = {}
    with LayerTape() as layers:
        reset_counts()
        out["paged"] = card_vs_cpu(dev, model.cfg, model.params, cpu, [64, 37],
                                   "gguf paged, by layer")
        counts = read_counts()
        out["contiguous"] = card_vs_cpu_contiguous(dev, model.cfg, model.params, cpu, 64,
                                                   "gguf contiguous, by layer")
    assert counts["paged_attention"] == GGUF_LAYERS * 4 and counts["qmm"] > 0, counts
    out["paged_free"] = card_vs_cpu(dev, model.cfg, model.params, cpu, [64, 37],
                                    "gguf paged, free-running", rel_tol=None)
    out["paged_f32"] = card_vs_cpu(dev, model.cfg, card_f32(model.params), cpu, [64, 37],
                                   "gguf paged, free-running, card in f32",
                                   rel_tol=F32_FREE_TOL, card_dtype=torch.float32)
    out["layer"] = layers.worst
    log(f"  max rel err of the logits by layer: paged {out['paged']:.4g}, contiguous "
        f"{out['contiguous']:.4g}, of a layer's output {layers.worst:.4g} (tol 5e-2); "
        f"free-running bf16 {out['paged_free']:.4g} (reported), card in f32 "
        f"{out['paged_f32']:.4g} (tol {F32_FREE_TOL}); launches {counts}")
    del cpu
    free_card()
    return dict({f"{k}_max_rel_err": v for k, v in out.items()}, **counts)


def gguf_b1(dev, gen, model) -> dict:
    """B1 on the file's own weights (Q4_K: 4-bit, groups of 32; Q6_K: 8-bit,
    groups of 16) at every projection kind and the Q6_K head, at
    GGUF_B1_ROWS: against its plain version (phase 11's tolerance), then
    timed with its bound (the packed words and both f32 planes read once,
    x read and y written once), the plain version and torch.matmul on the
    bf16-dequantized weight; B3 (w4a8) at 8 and 512 rows and B4 at 8 and 32
    (its largest) on the Q4_K gate weight."""
    import torch

    from blazr_tpu_torch.quant.int8 import qmm_int8, qmm_int8_reference
    from blazr_tpu_torch.quant.kernels import (STREAM_MAX_ROWS, qmm, qmm_reference,
                                               qmm_stream, qmm_stream_reference)
    from blazr_tpu_torch.quant.qtensor import dequantize

    layers = model.params["layers"]
    weights = {f"{kind} L{i} ({layers[i][kind].fmt[5:].upper()})": layers[i][kind]
               for i, kind in ((0, "q"), (0, "k"), (0, "gate"), (0, "down"), (3, "v"),
                               (3, "down"))}
    weights[f"head ({model.params['lm_head'].fmt[5:].upper()})"] = model.params["lm_head"]
    rel_tol, rows, worst = 8e-3, {}, 0.0
    for name, qt in weights.items():
        k, n, bits, gs = qt.in_features, qt.out_features, qt.bits, qt.group_size
        qw, s, mn = qt.qweight, qt.scales, qt.mins
        zero_mins = not bool(mn.any())
        w = dequantize(qt, torch.bfloat16)
        for m in GGUF_B1_ROWS:
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            kw = dict(bits=bits, signed=qt.signed, group_size=gs)
            got = qmm(x, qw, s, mn, device=dev, **kw)
            ref = qmm_reference(x.float(), qw, s, mn, **kw)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), name
            err = (got.float() - ref).abs().max().item()
            tol = rel_tol * ref.abs().max().item()
            assert err <= tol, f"B1 {name} m={m}: {err} > {tol}"
            worst = max(worst, err)
            ms = time_ms(lambda: qmm(x, qw, s, mn, device=dev, **kw), iters=20)
            nbytes = qw.numel() * 4 + s.numel() * 8 + x.numel() * 2 + m * n * 2
            bms, by = bound(nbytes, 2.0 * m * k * n)
            # A signed format's mins plane is all zero: the bound without it.
            bms_nz = bound(nbytes - mn.numel() * 4, 2.0 * m * k * n)[0] if zero_mins else None
            row = dict(ms=ms, bound_ms=bms, bound_by=by, max_abs_err=err,
                       bound_ms_without_zero_mins=bms_nz,
                       library_ms=time_ms(lambda: torch.matmul(x, w), iters=20),
                       plain_ms=time_eager(lambda: qmm_reference(x, qw, s, mn, **kw),
                                           iters=3, warmup=1),
                       planes_mb=s.numel() * 8 / 1e6, words_mb=qw.numel() * 4 / 1e6,
                       shape=f"{name} m={m} K={k} N={n} bits={bits} gs={gs}")
            rows[(name, m)] = row
            log(f"  B1 {name} m={m} K={k} N={n} (words {row['words_mb']:.1f} MB, planes "
                f"{row['planes_mb']:.1f} MB): max_abs_err {err:.4g} (tol {tol:.4g}); kernel "
                f"{ms:.4f} ms, bound {bms:.4f} ms ({by}, x{ms / bms:.1f}"
                f"{'' if bms_nz is None else f'; {bms_nz:.4f} ms without the zero mins plane'}"
                f"), torch.matmul(bf16 "
                f"dequantized) {row['library_ms']:.4f} ms (x{ms / row['library_ms']:.2f}), "
                f"plain {row['plain_ms']:.4f} ms")
        del w
    gate = layers[0]["gate"]
    k, n, gs = gate.in_features, gate.out_features, gate.group_size
    assert (gate.bits, gate.signed, gs) == (4, True, 32), gate
    qw, s, mn = gate.qweight, gate.scales, gate.mins
    w = dequantize(gate, torch.bfloat16)
    others = {}
    for kernel, m in (("B3 w4a8", 8), ("B3 w4a8", 512), ("B4", 8), ("B4", STREAM_MAX_ROWS)):
        x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
        if kernel == "B4":
            def fn():
                return qmm_stream(x, qw, s, mn, bits=4, group_size=gs, device=dev)
            ref = qmm_stream_reference(x, qw, s, mn, bits=4, group_size=gs)
            rate = H100_BF16_FLOPS
        else:
            def fn():
                return qmm_int8(x, qw, s, mn, bits=4, group_size=gs, device=dev)
            ref = qmm_int8_reference(x, qw, s, mn, bits=4, group_size=gs)
            rate = H100_INT8_OPS
        got = fn()
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = rel_tol * ref.float().abs().max().item()
        assert err <= tol, f"{kernel} Q4_K m={m}: {err} > {tol}"
        ms = time_ms(fn, iters=20)
        nbytes = qw.numel() * 4 + s.numel() * 8 + m * k * 2 + m * n * 2
        bms, by = bound(nbytes, 2.0 * m * k * n, rate)
        plain = (qmm_stream_reference if kernel == "B4" else qmm_int8_reference)
        row = dict(ms=ms, bound_ms=bms, bound_by=by, max_abs_err=err,
                   library_ms=time_ms(lambda: torch.matmul(x, w), iters=20),
                   plain_ms=time_eager(lambda: plain(x, qw, s, mn, bits=4, group_size=gs),
                                       iters=2, warmup=1),
                   shape=f"gate L0 (Q4_K) {kernel} m={m} K={k} N={n} gs={gs}")
        others[(kernel, m)] = row
        log(f"  {kernel} gate L0 (Q4_K) m={m}: max_abs_err {err:.4g} (tol {tol:.4g}); "
            f"kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}, x{ms / bms:.1f}), "
            f"torch.matmul(bf16 dequantized) {row['library_ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms")
    del w
    return dict(rows=rows, others=others, max_abs_err=worst)


def gguf_bench(path: Path, card: str) -> dict:
    """``python -m blazr_tpu_torch.cli bench FILE --prompt-lens 32,128,512``
    in its own process on the card (its default device): the JAX bench's
    dict, each prompt length's TTFT, decode tok/s and ITL percentiles."""
    env = dict(os.environ, PYTHONPATH=str(TREE))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "blazr_tpu_torch.cli", "bench", str(path),
         "--prompt-lens", "32,128,512"],
        cwd=TREE, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout)
    assert res["platform"] == "cuda" and sorted(res["profiles"]) == ["128", "32", "512"], res
    for plen, m in sorted(res["profiles"].items(), key=lambda kv: int(kv[0])):
        assert m["decode_tok_s"] > 0 and m["ttft_ms"] > 0, m
        log(f"  cli bench prompt {plen}: TTFT {m['ttft_ms']:.2f} ms, prefill "
            f"{m['prefill_tok_s']:.1f} tok/s, decode {m['decode_tok_s']:.1f} tok/s, ITL "
            f"p50/p95/p99 {m['itl_p50_ms']:.3f}/{m['itl_p95_ms']:.3f}/"
            f"{m['itl_p99_ms']:.3f} ms, e2e {m['e2e_ms']:.1f} ms ({m['runs']} runs of "
            f"{res['decode_tokens']} tokens; {card})")
    log(f"  cli bench: {wall:.1f} s in all, the file's load included")
    return dict(res, wall_s=wall)


def gguf_chats(port: int, texts: list, concurrent: bool) -> tuple[list, float]:
    """8 streamed greedy chats of 64 tokens, at once or one after another:
    (the replies, wall seconds)."""
    import threading

    out: list = [None] * len(texts)

    def one(i: int) -> None:
        out[i] = _stream_chat(port, {"messages": [{"role": "user", "content": texts[i]}],
                                     "max_tokens": 64, "temperature": 0, "stream": True})

    t0 = time.perf_counter()
    if concurrent:
        clients = [threading.Thread(target=one, args=(i,)) for i in range(len(texts))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(600)
    else:
        for i in range(len(texts)):
            one(i)
    wall = time.perf_counter() - t0
    for r in out:
        assert r is not None and r["done"] and r["finish"], r
        assert r["usage"]["completion_tokens"] == len(r["deltas"]), r["usage"]
    return out, wall


def gguf_turn(tag: str, port: int, seq_texts: list, wave_texts: list, card: str) -> dict:
    """On a fresh server: the 8 ``seq_texts`` chats one after another (each
    alone, so its stream depends on no other request), then the 8
    ``wave_texts`` chats at once (other prompts: no prefix-cache hits)."""
    seq, _ = gguf_chats(port, seq_texts, concurrent=False)
    replies, wall = gguf_chats(port, wave_texts, concurrent=True)
    tokens = sum(len(r["deltas"]) for r in replies)
    ttft = sorted(r["ttft"] for r in replies if r["ttft"] is not None)
    turn = dict(tok_s=tokens / wall, tokens=tokens, wall_s=wall,
                ttft_ms_median=ttft[len(ttft) // 2] * 1e3, ttft_ms_max=ttft[-1] * 1e3,
                ttft_ms=[r["ttft"] * 1e3 for r in replies],
                sequential=["".join(r["deltas"]) for r in seq],
                sequential_ttft_ms=[r["ttft"] * 1e3 for r in seq])
    log(f"  {tag}: 8 concurrent streamed chats, {tokens} tokens in {wall:.2f} s, "
        f"{turn['tok_s']:.1f} tok/s; client TTFT median {turn['ttft_ms_median']:.1f} ms, "
        f"max {turn['ttft_ms_max']:.1f} ms; one at a time TTFT median "
        f"{sorted(turn['sequential_ttft_ms'])[4]:.1f} ms ({card}; {GGUF_LAYERS} layers, "
        f"bf16)")
    return turn


def gguf_serve(dev, path: Path, sched, ex, card: str) -> dict:
    """``cli serve --model FILE.gguf --continuous-batching`` (warmed, decode
    graphs on) in its own process, and the same server in this process over
    the model already loaded, warmed with decode graphs off (``gguf_turn``:
    8 streamed chats one at a time, whose greedy streams must be equal both
    ways, then 8 others at once; prompts the file's tokenizer encodes to
    GGUF_REQUEST_LENS tokens, 64 greedy tokens each). Over HTTP a concurrent
    wave's batches depend on arrival order, so its prompts are also
    submitted in a fixed order to a warmed BatchEngine in this process, once
    with decode graphs and once without, whose 8 greedy streams must be
    equal. B1 and B2 launches of the in-process server's two passes."""
    import numpy as np

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine

    rng = np.random.default_rng(SEED + 12)
    seq_texts, wave_texts = ([_prompt_text(ex.tokenizer, n, rng) for n in GGUF_REQUEST_LENS]
                             for _ in range(2))
    out = {}
    with cli_serve(path, path.parent / "cli_stderr.txt") as (port, up, warmed):
        log(f"  cli serve {path.name}: '{warmed}'; /health after {up:.1f} s (the file's "
            f"load included)")
        out["on"] = gguf_turn("cli serve, graphs on", port, seq_texts, wave_texts, card)
        out["cli_up_s"] = up
    inf = ex.app_cfg.inference
    inf.max_batch_size, inf.prefix_cache, inf.decode_horizon = 8, True, 8
    greedy = GenerationConfig(max_tokens=64, temperature=0.0)
    wave = [(ex.tokenizer.encode(t), greedy) for t in wave_texts]
    streams = {}
    for graphs in (True, False):
        inf.graphs = graphs
        engine = BatchEngine(ex.model, ex.tokenizer, ex.app_cfg)
        engine.warmup()
        results = asyncio.run(serve(engine, [wave]))
        streams[graphs] = [r["tokens"] for r in results]
        assert all(0 < len(t) <= 64 for t in streams[graphs]), [len(t) for t in streams[graphs]]
        del engine
        free_card()
    equal = streams[True] == streams[False]
    log(f"  the 8 greedy streams of the concurrent wave, submitted at once in a fixed order "
        f"to the engine: with graphs {'equal' if equal else 'DIFFER from'} those without")
    assert equal, [i for i, (a, b) in enumerate(zip(streams[True], streams[False])) if a != b]
    engine = BatchEngine(ex.model, ex.tokenizer, ex.app_cfg)
    warm_s = engine.warmup()
    with http_server(sched, engine) as port:
        reset_counts()
        out["off"] = gguf_turn(f"in-process server, graphs off (warmed in {warm_s:.1f} s)",
                               port, seq_texts, wave_texts, card)
        counts = read_counts()
    assert counts["qmm"] > 0 and counts["paged_attention"] > 0, counts
    equal = out["on"]["sequential"] == out["off"]["sequential"]
    log(f"  the 8 greedy streams one at a time with graphs "
        f"{'equal' if equal else 'DIFFER from'} those without; launches of the in-process "
        f"server's two passes {counts}")
    assert equal, [i for i, (a, b) in enumerate(zip(out["on"]["sequential"],
                                                    out["off"]["sequential"])) if a != b]
    del engine
    free_card()
    return dict(out, wave_streams_equal=True, **counts)


def gguf_phase(dev, gen, card: str) -> dict:
    """Phase 12: write Mistral-7B-Instruct-v0.2 as a llama.cpp Q4_K_M GGUF
    file at its published width, GGUF_LAYERS layers, with an embedded
    32000-token SentencePiece tokenizer (``write_gguf_checkpoint``), alone
    in a directory; load it as ``cli serve`` does; hold its forwards to the
    CPU (gguf_forwards); B1, B3 and B4 at its layouts (gguf_b1); ``cli
    bench`` on it (gguf_bench); ``cli serve`` on it (gguf_serve)."""
    import shutil
    import tempfile

    import torch

    from blazr_tpu_torch.utils.synthetic import (mistral_7b_instruct_v02_config,
                                                 write_gguf_checkpoint)

    cfg = mistral_7b_instruct_v02_config()
    cfg.num_layers = GGUF_LAYERS
    root = Path(tempfile.mkdtemp(prefix="blazr_gguf_"))
    path = root / "mistral-7b-instruct-v0.2.Q4_K_M.gguf"
    out: dict = {}
    try:
        t0 = time.perf_counter()
        kinds = write_gguf_checkpoint(path, cfg, "Q4_K_M", seed=SEED)
        out["write_s"] = time.perf_counter() - t0
        out["file_gb"] = path.stat().st_size / 1e9
        mix = {t: sum(1 for v in kinds.values() if v == t) for t in sorted(set(kinds.values()))}
        log(f"  wrote {path.name} ({GGUF_LAYERS} of 32 layers, {out['file_gb']:.3f} GB; "
            f"tensors by type {mix}) in {out['write_s']:.1f} s")
        sched, ex, out["load_s"] = gguf_load(dev, path)
        model = ex.model
        assert model.dtype == torch.bfloat16 and model.cfg.model_type == "llama"
        assert model.cfg.attention.rope_theta == 1e6 and model.cfg.max_seq_len == 32768
        assert ex.tokenizer.vocab_size == 32000
        log(f"  loaded (load_model + the embedded tokenizer) in {out['load_s']:.1f} s: "
            f"{model.cfg.hidden_size}d, {model.num_layers} layers, vocab "
            f"{model.vocab_size}, rope theta {model.cfg.attention.rope_theta:g}; "
            f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated")
        out["forwards"] = gguf_forwards(dev, model)
        out["b1"] = gguf_b1(dev, gen, model)
        out["bench"] = gguf_bench(path, card)
        out["serve"] = gguf_serve(dev, path, sched, ex, card)
        out.update(qmm=out["serve"]["qmm"], paged_attention=out["serve"]["paged_attention"])
        del sched, ex, model
        free_card()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phases 13 (mla) and 14 (ssm): the MLA, Mamba2 and hybrid families
# ---------------------------------------------------------------------------

# B1 at the new families' projections (K, N, group) at their published
# widths (utils/synthetic.py::RECURRENT_CONFIGS): DeepSeek-V2-Lite in groups
# of 64 (its dense down has K 10944, no multiple of 128; kv_a has N 576),
# Mamba-Codestral-7B in groups of 128.
RECURRENT_B1_SHAPES = {"deepseek kv_a": (2048, 576, 64), "deepseek q": (2048, 3072, 64),
                       "deepseek expert gate/up": (2048, 1408, 64),
                       "deepseek expert down": (1408, 2048, 64),
                       "deepseek dense down": (10944, 2048, 64),
                       "codestral in_proj": (4096, 18560, 128),
                       "codestral out_proj": (8192, 4096, 128)}
RECURRENT_B1_ROWS = (1, 8, 512)
# The served models: family -> (published depth, the engine's max_seq_len,
# the depth a full run serves). ``--phases build,mla`` and ``build,ssm``
# serve them whole.
RECURRENT_SERVING = {"deepseek": (27, 4096, 2), "mamba2": (64, 4096, 4),
                     "bamba": (32, 4096, 4)}
# The families' 2-layer checkpoints: DeepSeek-V2-Lite's layer 0 dense and
# layer 1 with 64 experts; the hybrid's layers one Mamba2 mixer and one
# attention layer.
RECURRENT_GROUP = {"deepseek": 64, "mamba2": 128, "bamba": 128}


def recurrent_b1(dev, gen) -> dict:
    """Phase 2's B1 rows at the new families' shapes (RECURRENT_B1_SHAPES x
    RECURRENT_B1_ROWS), against the plain version at phase 2's tolerance,
    then timed as phase 11 times the expert shapes: kernel, bound, plain
    version and torch.matmul on the bf16-dequantized weight."""
    import torch

    from blazr_tpu_torch.quant.kernels import qmm, qmm_reference
    from blazr_tpu_torch.quant.qtensor import dequantize_planes

    rel_tol = 8e-3
    rows, worst = {}, 0.0
    for pname, (k, n, gs) in RECURRENT_B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 4, gs, gen, dev)
        w = dequantize_planes(qw, s, mn, 4, True, gs, torch.bfloat16)
        for m in RECURRENT_B1_ROWS:
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            got = qmm(x, qw, s, mn, bits=4, signed=True, group_size=gs, device=dev)
            ref = qmm_reference(x.float(), qw, s, mn, bits=4, signed=True, group_size=gs)
            torch.cuda.synchronize()
            assert got.shape == ref.shape and torch.isfinite(got).all(), pname
            err = (got.float() - ref).abs().max().item()
            tol = rel_tol * ref.abs().max().item()
            assert err <= tol, f"B1 {pname} m={m}: {err} > {tol}"
            worst = max(worst, err)
            ms = time_ms(lambda: qmm(x, qw, s, mn, bits=4, signed=True, group_size=gs,
                                     device=dev), iters=20)
            nbytes = qw.numel() * 4 + s.numel() * 8 + x.numel() * 2 + m * n * 2
            bms, by = bound(nbytes, 2.0 * m * k * n)
            row = dict(ms=ms, bound_ms=bms, bound_by=by, max_abs_err=err,
                       library_ms=time_ms(lambda: torch.matmul(x, w), iters=20),
                       plain_ms=time_eager(lambda: qmm_reference(
                           x, qw, s, mn, bits=4, signed=True, group_size=gs), iters=3,
                           warmup=1),
                       shape=f"{pname} m={m} K={k} N={n} group {gs}")
            rows[(pname, m)] = row
            log(f"  B1 {pname} m={m} K={k} N={n} gs={gs}: max_abs_err {err:.4g} (tol "
                f"{tol:.4g}); kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}, x{ms / bms:.1f}), "
                f"torch.matmul(bf16 dequantized) {row['library_ms']:.4f} ms "
                f"(x{ms / row['library_ms']:.2f}), plain {row['plain_ms']:.4f} ms")
        del w
    return dict(rows=rows, max_abs_err=worst)


def recurrent_config(family: str, layers: int):
    """The family's published config at ``layers`` layers."""
    from blazr_tpu_torch.utils.synthetic import RECURRENT_CONFIGS

    cfg = RECURRENT_CONFIGS[family]()
    if cfg.hybrid_layers is not None:
        # A cut hybrid keeps the attention layers below its depth, and makes
        # its last layer attention where none is.
        types = cfg.hybrid_layers[:layers]
        if "attention" not in types:
            types[-1] = "attention"
        cfg.hybrid_layers = types
    cfg.num_layers = layers
    return cfg


def recurrent_checkpoint(family: str, root: Path) -> tuple[Path, float]:
    """The family's 2-layer checkpoint at its published width, AWQ-INT4
    (RECURRENT_GROUP) in its HF layout, with a BPE tokenizer.json of its
    vocab, written once into ``root`` for every check that reads it."""
    from blazr_tpu_torch.utils.synthetic import write_bpe_tokenizer_json, write_hf_checkpoint

    d = root / family
    t0 = time.perf_counter()
    cfg = recurrent_config(family, 2)
    write_hf_checkpoint(d, cfg, quant="awq", group_size=RECURRENT_GROUP[family], seed=SEED,
                        dtype="bfloat16")
    write_bpe_tokenizer_json(d, cfg.vocab_size, seed=SEED)
    return d, time.perf_counter() - t0


def recurrent_forwards(dev, family: str, d: Path, lens: tuple, n: int) -> dict:
    """A family's 2-layer checkpoint loaded by load_model onto the card
    (bf16): the engine's step (``card_vs_cpu``: the prefills ``lens``,
    4 decode steps) and the contiguous forward (an n-token prefill, 4 decode
    steps) against the port's CPU f32 forward on the same weights, each
    layer and the head on the card's input (LayerTape) and, for DeepSeek,
    the card's routing (RouteTape), held at 5e-2 of the largest magnitude;
    the step again with int8 latents (DeepSeek, by layer), and free-running
    with the card in f32, held at F32_FREE_TOL. Launches counted on the
    step's first run."""
    import torch

    from blazr_tpu_torch.loader import load_model
    from blazr_tpu_torch.models import mamba2, mla

    t0 = time.perf_counter()
    model, _ = load_model(d, dtype="bf16", device=dev)
    t1 = time.perf_counter()
    cfg = model.cfg
    cpu = to_cpu_f32(model.params, dense=True)
    row: dict = {"load_s": t1 - t0, "cpu_weights_s": time.perf_counter() - t1}
    # The layer functions a LayerTape patches for this family.
    sites = ((mla if family == "deepseek" else mamba2, "decoder_layer"),)
    route = RouteTape() if family == "deepseek" else contextlib.nullcontext()
    with route as tape:
        with LayerTape(sites=sites) as layers:
            reset_counts()
            row["step"] = card_vs_cpu(dev, cfg, model.params, cpu, lens,
                                             f"{family} engine step, by layer")
            counts = read_counts()
            row["contiguous"] = card_vs_cpu_contiguous(
                dev, cfg, model.params, cpu, n, f"{family} contiguous, by layer")
            if family == "deepseek":
                row["int8_latents"] = card_vs_cpu(
                    dev, cfg, model.params, cpu, lens, f"{family} engine step, int8 latents, "
                    "by layer", quantized=True)
    row["step_f32"] = card_vs_cpu(
        dev, cfg, card_f32(model.params), cpu, lens,
        f"{family} engine step, free-running, card in f32", rel_tol=F32_FREE_TOL,
        card_dtype=torch.float32)
    assert counts["qmm"] > 0, counts
    if family == "bamba":
        assert counts["paged_attention"] == 4, counts        # one attention layer, 4 steps
    if family == "deepseek":
        assert tape.share >= 0.9, f"routing agreement {tape.share}"
        row.update(routing_agreement=tape.share, decisions=tape.total)
    row.update(layer_max_rel_err=layers.worst, qmm=counts["qmm"],
               paged_attention=counts["paged_attention"])
    log(f"  {family} 2 layers ({cfg.hidden_size}d, vocab {cfg.vocab_size}): loaded in "
        f"{row['load_s']:.1f} s; max rel err by layer: step {row['step']:.4g}, contiguous "
        f"{row['contiguous']:.4g}, a layer's output {layers.worst:.4g} (tol 5e-2)"
        + (f", int8 latents {row['int8_latents']:.4g}" if "int8_latents" in row else "")
        + f"; free-running with the card in f32 {row['step_f32']:.4g} (tol "
        f"{F32_FREE_TOL}); launches B1 {counts['qmm']}, B2 {counts['paged_attention']}")
    del model, cpu
    free_card()
    return row


def recurrent_model(dev, family: str, layers: int, dtype=None):
    """The family's published-width model at ``layers`` layers, AWQ-INT4
    (RECURRENT_GROUP) synthesized on the card."""
    import torch

    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.utils.synthetic import synth_recurrent_params

    cfg = recurrent_config(family, layers)
    t0 = time.perf_counter()
    params = synth_recurrent_params(cfg, quant="awq", dtype=torch.bfloat16,
                                    group_size=RECURRENT_GROUP[family], seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"  synthesized {layers}-layer {family} ({cfg.hidden_size}d, vocab "
        f"{cfg.vocab_size}) AWQ-INT4 on the card in {time.perf_counter() - t0:.1f} s")
    return Model(cfg, params if dtype is None else card_f32(params), dtype or torch.bfloat16)


def step_shares(dev, model, ms_per_step: float) -> dict:
    """The share of a batch-8 decode step that the family's plain-PyTorch
    mixer parts take, each timed alone as a CUDA graph at the served shapes
    and multiplied by its layers: for MLA the latent gather over tables 4096
    tokens wide (``_gather_latent_pages``) and the absorbed einsums with the
    softmax (``mla.absorbed_attention``); for Mamba2 layers the conv, the
    scan's step form and the gated norm, and the gather and scatter of the
    state rows."""
    import torch

    from blazr_tpu_torch.kvcache.ssm_state import init_ssm_state
    from blazr_tpu_torch.models import mamba2, mla
    from blazr_tpu_torch.models.paged_multi import (_gather_latent_pages,
                                                    init_paged_mla_cache)

    cfg = model.cfg
    b, width = 8, 4096
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    out: dict = {}
    if cfg.attention is not None and cfg.attention.is_mla:
        att = cfg.attention
        one = dataclasses.replace(cfg, num_layers=1)
        cache = init_paged_mla_cache(one, b * width // 64, 64, device=dev)
        bt = torch.arange(b * width // 64, dtype=torch.int32, device=dev).reshape(b, -1)
        p = model.params["layers"][-1]
        q_nope = torch.randn((b, 1, att.num_heads, att.d_nope), device=dev, generator=g)
        q_rope = torch.randn((b, 1, att.num_heads, att.d_rope), device=dev, generator=g)
        c_all, kr_all, _, _ = _gather_latent_pages(cache, 0, bt)
        mask = torch.ones((b, 1, width), dtype=torch.bool, device=dev)
        parts = {"latent gather": lambda: _gather_latent_pages(cache, 0, bt),
                 "absorbed einsums": lambda: mla.absorbed_attention(
                     p, cfg, q_nope, q_rope, c_all, kr_all, None, None, mask, torch.bfloat16)}
        layers = cfg.num_layers
    else:
        ssm = cfg.ssm
        one = dataclasses.replace(cfg, num_layers=1)
        pool = init_ssm_state(one, b + 1, device=dev)
        rows = torch.arange(b, device=dev)
        conv_dim = ssm.inner_size + 2 * ssm.n_groups * ssm.state_size
        p = next(lp for lp in model.params["layers"] if "in_proj" in lp)
        xbc = torch.randn((b, 1, conv_dim), device=dev, generator=g).to(torch.bfloat16)
        dt = torch.randn((b, 1, ssm.num_heads), device=dev, generator=g)
        y = torch.randn((b, 1, ssm.inner_size), device=dev, generator=g)
        gs = ssm.n_groups * ssm.state_size
        c0, s0 = pool.conv[0][:b], pool.ssm[0][:b]
        parts = {"state rows gather+scatter": lambda: (
                     pool.conv[0].index_copy_(0, rows, pool.conv[0].index_select(0, rows)),
                     pool.ssm[0].index_copy_(0, rows, pool.ssm[0].index_select(0, rows))),
                 "conv": lambda: mamba2._conv(xbc, c0, p["conv_w"], p["conv_b"]),
                 "scan (step form)": lambda: mamba2._ssm_scan(
                     cfg, y, y[..., :gs], y[..., :gs], dt, s0, p),
                 "gated norm": lambda: mamba2.gated_rms_norm(y, y, p["norm"], 1e-5)}
        layers = sum(t == "mamba2" for t in cfg.layer_types())
    for name, fn in parts.items():
        ms = time_ms(fn, iters=10) * layers
        out[name] = dict(ms=ms, share=ms / ms_per_step)
        log(f"  {name}: {ms:.3f} ms a batch-8 decode step over {layers} layers, "
            f"{ms / ms_per_step:.3f} of its {ms_per_step:.2f} ms")
    return out


def recurrent_serving(dev, card: str, family: str, layers: int, max_seq_len: int) -> dict:
    """Phases 13 and 14, serving: family_serving on the family's model
    (recurrent_model, ``layers`` layers), then the share of a decode step
    its plain-PyTorch mixer parts take (step_shares)."""
    model = recurrent_model(dev, family, layers)
    out = family_serving(dev, card, family, model, max_seq_len)
    out["shares"] = step_shares(dev, model, out["turns"][True]["ms_per_step"])
    del model
    free_card()
    return out


def isolation(dev, card: str, layers: int, max_seq_len: int) -> dict:
    """Phase 14: the state rows isolate sequences. Codestral with the card in
    f32 (B1's split-K variant at every row count, so the arithmetic of a row
    does not depend on its batch) serves the 8 greedy requests of phase 5
    in one wave and then one after another, each alone, through one warmed
    engine with graphs: the 8 streams equal."""
    import torch

    model = recurrent_model(dev, "mamba2", layers, dtype=torch.float32)
    reqs = family_requests(model.cfg, greedy_only=True)
    engine, _ = family_engine(model, True, max_seq_len)

    async def runs():           # one event loop: the engine's event is bound to it
        t0 = time.perf_counter()
        wave = [r["tokens"] for r in await serve(engine, [reqs])]
        t1 = time.perf_counter()
        alone = [(await serve(engine, [[r]]))[0]["tokens"] for r in reqs]
        return wave, alone, t0, t1, time.perf_counter()

    wave, alone, t0, t1, t2 = asyncio.run(runs())
    equal = wave == alone
    log(f"  mamba2 (card in f32, {layers} layers): the wave of 8 ({t1 - t0:.1f} s) "
        f"{'equals' if equal else 'DIFFERS from'} the 8 served one after another "
        f"({t2 - t1:.1f} s); rows free after: {sorted(engine._free_rows)}")
    assert equal, [i for i, (a, b) in enumerate(zip(wave, alone)) if a != b]
    assert sorted(engine._free_rows) == list(range(8)), engine._free_rows
    del engine, model
    free_card()
    return dict(equal=True, wave_s=t1 - t0, alone_s=t2 - t1)


def cli_chats(d: Path, n: int = 4) -> dict:
    """``python -m blazr_tpu_torch.cli serve --model DIR
    --continuous-batching`` (warmed) as a subprocess: ``n`` streamed chats
    of 16 tokens at once, each answered."""
    import threading

    import numpy as np

    from blazr_tpu_torch.tokenizer import load_tokenizer

    tok = load_tokenizer(d)
    rng = np.random.default_rng(SEED + 13)
    texts = [_prompt_text(tok, 40, rng) for _ in range(n)]
    replies: list = [None] * n
    with cli_serve(d, d / "cli_stderr.txt") as (port, up, warmed):
        def one(i):
            replies[i] = _stream_chat(port, {"messages": [{"role": "user", "content": texts[i]}],
                                             "max_tokens": 16, "temperature": 0,
                                             "stream": True})
        t0 = time.perf_counter()
        clients = [threading.Thread(target=one, args=(i,)) for i in range(n)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(600)
        wall = time.perf_counter() - t0
    for r in replies:
        assert r is not None and r["done"] and r["finish"] and r["deltas"], r
    log(f"  cli serve {d.name}: '{warmed}'; /health after {up:.1f} s; {n} streamed chats "
        f"at once answered in {wall:.2f} s ({sum(len(r['deltas']) for r in replies)} "
        f"tokens)")
    return dict(up_s=up, wall_s=wall)


def cli_run(d: Path) -> dict:
    """``python -m blazr_tpu_torch.cli run DIR --prompt ...`` as a subprocess
    (the Executor, on the card by default): 16 greedy tokens streamed to
    stdout and the summary line on stderr."""
    env = dict(os.environ, PYTHONPATH=str(TREE))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "blazr_tpu_torch.cli", "run", str(d), "--prompt",
         "the state of a recurrent model", "--max-tokens", "16", "--temperature", "0"],
        cwd=TREE, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    summary = [line for line in proc.stderr.splitlines() if line.startswith("[")
               and " tokens, " in line]
    assert proc.stdout.strip() and summary, (proc.stdout[-2000:], proc.stderr[-2000:])
    log(f"  cli run {d.name}: {summary[-1]} ({wall:.1f} s, the load included)")
    return dict(wall_s=wall, summary=summary[-1])


def mla_phase(dev, card: str, full_run: bool) -> dict:
    """Phase 13: DeepSeek-V2-Lite. Its 2-layer checkpoint written once
    (recurrent_checkpoint) and held to the CPU (recurrent_forwards: prefills
    of 64 and 37 tokens, a 64-token contiguous prefill; int8 latents), the
    model served (recurrent_serving, RECURRENT_SERVING's depth), ``cli serve``
    (cli_chats) and ``cli run`` (cli_run: the Executor's decode graph over
    the latent cache) on the checkpoint."""
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="blazr_mla_"))
    try:
        d, write_s = recurrent_checkpoint("deepseek", root)
        log(f"  wrote the 2-layer DeepSeek-V2-Lite checkpoint (AWQ-INT4, groups of 64) "
            f"and its tokenizer in {write_s:.1f} s")
        out = {"write_s": write_s, "forwards": recurrent_forwards(dev, "deepseek", d,
                                                                  (64, 37), 64)}
        depth, ctx, cut = RECURRENT_SERVING["deepseek"]
        out["serve"] = recurrent_serving(dev, card, "deepseek", cut if full_run else depth, ctx)
        out["cli"] = cli_chats(d)
        out["cli_run"] = cli_run(d)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out.update(qmm=out["serve"]["qmm"], paged_attention=out["serve"]["paged_attention"])
    return out


def ssm_phase(dev, card: str, full_run: bool) -> dict:
    """Phase 14: Mamba-Codestral-7B and the hybrid at Bamba-9B's widths.
    Each 2-layer checkpoint written once and held to the CPU (prefills of
    160 tokens, the chunked scan, and 64; a 160-token contiguous prefill);
    Codestral served (recurrent_serving) and its rows' isolation held
    (isolation); the hybrid served; ``cli run`` (the Executor's decode
    graph over the state, and the hybrid's over state and KV) on both
    checkpoints. The kernels line takes B1's launches of both served
    models and B2's of the hybrid."""
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="blazr_ssm_"))
    out: dict = {}
    try:
        for family in ("mamba2", "bamba"):
            d, write_s = recurrent_checkpoint(family, root)
            log(f"  wrote the 2-layer {family} checkpoint (AWQ-INT4, groups of 128) and "
                f"its tokenizer in {write_s:.1f} s")
            out[family] = {"write_s": write_s,
                           "forwards": recurrent_forwards(dev, family, d, (160, 64), 160)}
        for family in ("mamba2", "bamba"):
            depth, ctx, cut = RECURRENT_SERVING[family]
            out[family]["serve"] = recurrent_serving(dev, card, family,
                                                     cut if full_run else depth, ctx)
        depth, ctx, cut = RECURRENT_SERVING["mamba2"]
        out["isolation"] = isolation(dev, card, cut if full_run else depth, ctx)
        for family in ("mamba2", "bamba"):
            out[family]["cli_run"] = cli_run(root / family)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out.update(qmm=sum(out[f]["serve"]["qmm"] for f in ("mamba2", "bamba")),
               qmm_by_model={f: out[f]["serve"]["qmm"] for f in ("mamba2", "bamba")},
               paged_attention=out["bamba"]["serve"]["paged_attention"])
    return out


B3_TIMED_ROWS = (1, 8, 512)


def time_b3(dev, gen) -> dict:
    """B3 at the four projections, m ∈ B3_TIMED_ROWS, w4a8 and w8a8, plus
    gate+up at m=4096: the whole call (quant, product, split reduction), its
    bound, its plain version, torch.matmul on a bf16-dequantized weight of
    the same shape, torch._int_mm at the same (m, K, N) where m > 16 (the
    int8 GEMM rate: not the same function), and B1 (w4a16) on the 4-bit
    gate+up weight."""
    import torch

    from blazr_tpu_torch.quant.int8 import qmm_int8, qmm_int8_reference
    from blazr_tpu_torch.quant.kernels import qmm
    from blazr_tpu_torch.quant.qtensor import dequantize_planes, unpack

    gs = 128
    rows = {}
    for pname, (k, n) in B1_SHAPES.items():
        qw4, s, mn = rand_planes(k, n, 4, gs, gen, dev)
        w_bf16 = dequantize_planes(qw4, s, mn, 4, True, gs, torch.bfloat16)
        for mode, bits in (("w4a8", 4), ("w8a8", 8)):
            qw = qw4 if bits == 4 else rand_planes(k, n, 8, gs, gen, dev)[0]
            w_i8 = unpack(qw, bits, True).to(torch.int8).t().contiguous().t()
            for m in B3_TIMED_ROWS + ((4096,) if pname == "gateup" else ()):
                x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
                iters = 5 if m >= 4096 else 20
                ms = time_ms(lambda: qmm_int8(x, qw, s, mn, bits=bits, group_size=gs,
                                              device=dev), iters=iters)
                plain_ms = time_eager(lambda: qmm_int8_reference(x, qw, s, mn, bits=bits,
                                                              group_size=gs),
                                      iters=2, warmup=1)
                lib_ms = time_ms(lambda: torch.matmul(x, w_bf16), iters=iters)
                int_mm_ms = None
                if m > 16:
                    xq = torch.randint(-127, 128, (m, k), device=dev, generator=gen,
                                       dtype=torch.int8)
                    int_mm_ms = time_ms(lambda: torch._int_mm(xq, w_i8), iters=iters)
                b1_ms = (time_ms(lambda: qmm(x, qw4, s, mn, bits=4, signed=True,
                                             group_size=gs, device=dev), iters=iters)
                         if bits == 4 and pname == "gateup" else None)
                nbytes = qw.numel() * 4 + s.numel() * 8 + m * k * 2 + m * n * 2
                bms, by = bound(nbytes, 2.0 * m * k * n, H100_INT8_OPS)
                rows[(pname, mode, m)] = dict(
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms, int_mm_ms=int_mm_ms,
                    b1_ms=b1_ms, bound_ms=bms, bound_by=by,
                    shape=f"{pname} {mode} m={m} K={k} N={n}")
                log(f"  B3 {pname} {mode} m={m}: kernel {ms:.4f} ms "
                    f"({2.0 * m * k * n / ms / 1e9:.1f} TOP/s), bound {bms:.4f} ms ({by}, "
                    f"{nbytes / 1e6:.1f} MB, x{ms / bms:.1f}), plain {plain_ms:.3f} ms, "
                    f"torch.matmul(bf16 dequantized) {lib_ms:.4f} ms, torch._int_mm "
                    + ("n/a (m <= 16)" if int_mm_ms is None else f"{int_mm_ms:.4f} ms")
                    + ("" if b1_ms is None else f", B1 w4a16 {b1_ms:.4f} ms"))
            del w_i8
        del w_bf16
    return rows


def time_quant(dev, gen) -> dict:
    """B3's quant kernel at K=4096 (m ∈ {1, 512, 4096}) and K=14336 (m=1):
    time, plain time and the byte bound (x read once; xq, xs and the group
    sums written once). No single PyTorch call computes it."""
    import torch

    from blazr_tpu_torch.quant.int8 import quantize_activations, quantize_activations_reference

    rows = {}
    for m, k in ((1, 4096), (1, 14336), (512, 4096), (4096, 4096)):
        x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
        ms = time_ms(lambda: quantize_activations(x, group_size=128, device=dev), iters=50)
        plain_ms = time_eager(lambda: quantize_activations_reference(x, 128), iters=10)
        nbytes = m * k * 2 + m * k + m * 4 + m * (k // 128) * 4
        bms, by = bound(nbytes, 0.0)
        rows[(m, k)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                            library_ms=None, shape=f"m={m} K={k} gs=128")
        log(f"  B3 quant m={m} K={k}: kernel {ms:.4f} ms, bound {bms:.6f} ms ({by}, "
            f"{nbytes / 1e6:.2f} MB), plain {plain_ms:.4f} ms")
    return rows


B4_TIMED_ROWS = (1, 8, 16, 32)


def time_b4(dev, gen) -> dict:
    """B4 at the four projections, m ∈ B4_TIMED_ROWS, beside B1 on the same
    weights in turns (B4, B1, B1, B4), best of each pair; with its bound,
    its plain version and torch.matmul on a bf16-dequantized weight."""
    import torch

    from blazr_tpu_torch.quant.kernels import qmm, qmm_stream, qmm_stream_reference
    from blazr_tpu_torch.quant.qtensor import dequantize_planes

    gs = 128
    rows = {}
    for pname, (k, n) in B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 4, gs, gen, dev)
        w_bf16 = dequantize_planes(qw, s, mn, 4, True, gs, torch.bfloat16)
        line = []
        for m in B4_TIMED_ROWS:
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            t = turns({
                "b4": lambda: qmm_stream(x, qw, s, mn, bits=4, group_size=gs, device=dev),
                "b1": lambda: qmm(x, qw, s, mn, bits=4, signed=True, group_size=gs,
                                  device=dev)}, iters=50)
            nbytes = qw.numel() * 4 + s.numel() * 8 + m * k * 2 + m * n * 2
            bms, by = bound(nbytes, 2.0 * m * k * n)
            row = dict(ms=t["b4"], b1_ms=t["b1"], bound_ms=bms, bound_by=by,
                       shape=f"{pname} w4 m={m} K={k} N={n}")
            row["plain_ms"] = time_eager(lambda: qmm_stream_reference(
                x, qw, s, mn, bits=4, group_size=gs), iters=3, warmup=1)
            row["library_ms"] = time_ms(lambda: torch.matmul(x, w_bf16), iters=50)
            rows[(pname, m)] = row
            line.append(f"m={m} {row['ms']:.4f}/{row['b1_ms']:.4f}/{row['library_ms']:.4f} "
                        f"(bound {bms:.4f}, plain {row['plain_ms']:.3f})")
        log(f"  B4/B1/torch.matmul {pname} K={k} N={n} ms: " + ", ".join(line))
        del w_bf16
    return rows


def timings(dev, gen, res: dict, quant: bool = True, families: bool = True) -> list:
    """Phase 9: every kernel's time, bound, plain and library time, and the
    launches of the serving phase that ran it; returns the kernels line.
    Uses only the kernels' public wrappers, so ``--tree`` times another
    checkout's kernels; ``quant=False`` (a checkout from before B3's
    activation quant was one kernel) leaves that kernel out, and
    ``families=False`` (another checkout) the dense families' rows. Where
    phase 11 ran, B1's MoE row takes the expert shapes' times it measured."""
    t1 = time_b1(dev, gen)
    t2 = time_b2(dev, gen)
    t3 = time_b3(dev, gen)
    tq = time_quant(dev, gen) if quant else None
    t4 = time_b4(dev, gen)
    t5 = time_layout(dev, gen, "wide")
    t6 = time_layout(dev, gen, "headmajor")
    f1 = time_b1_families(dev, gen) if families else None
    f2 = time_b2_families(dev, gen) if families else None
    moe_b1 = res["moe"]["b1"]["rows"] if "moe" in res else None   # timed in phase 11
    rec_b1 = res.get("b1", {}).get("recurrent")                   # timed in phase 2
    gguf = res["gguf"]["b1"] if "gguf" in res else None          # timed in phase 12

    def got(phase, key):
        return res.get(phase, {}).get(key)

    b3p, b3d = t3[("gateup", "w8a8", 512)], t3[("gateup", "w8a8", 1)]
    b4 = t4[("gateup", 8)]
    k, n = B1_SHAPES["gateup"]
    b1p, b1d = t1[("gateup", 512)], t1[("gateup", 8)]
    b2 = t2[B2_SHAPES[0]]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    line = [
        dict(name="qmm_w4a16 (B1)", route="cuda", source="blazr_tpu_torch/csrc/qmm.cu",
             replaces="blazr_tpu/quant/pallas/int_matmul.py:69",
             launches=got("serve", "qmm"), max_abs_err=got("b1", "max_abs_err"),
             **{key: b1p[key] for key in keys},
             decode={key: b1d[key] for key in keys}),
        dict(name="paged_attention_decode (B2)", route="cuda",
             source="blazr_tpu_torch/csrc/paged_attention.cu",
             replaces="blazr_tpu/attention/paged_attention.py:34",
             launches=got("serve", "paged_attention"), max_abs_err=got("b2", "max_abs_err"),
             full_width_ms=b2.get("full_width_ms"), **{key: b2[key] for key in keys}),
        dict(name="qmm_int8 (B3)", route="cuda", source="blazr_tpu_torch/csrc/qmm_int8.cu",
             replaces="blazr_tpu/quant/pallas/int_matmul.py:276",
             launches=got("executor", "qmm_int8"), max_abs_err=got("b3", "max_abs_err"),
             int_mm_ms=b3p["int_mm_ms"], **{key: b3p[key] for key in keys},
             decode={key: b3d[key] for key in keys}),
    ] + ([
        dict(name="act_quant (B3's activation quant)", route="cuda",
             source="blazr_tpu_torch/csrc/qmm_int8.cu",
             replaces="blazr_tpu/quant/pallas/int_matmul.py:391",
             launches=got("executor", "act_quant"),
             max_abs_err=got("b3", "quant_max_abs_err"),
             **{key: tq[(1, 4096)][key] for key in keys}),
    ] if quant else []) + [
        dict(name="qmm_stream (B4)", route="cuda",
             source="blazr_tpu_torch/csrc/qmm_stream.cu",
             replaces="blazr_tpu/quant/pallas/int_matmul.py:170",
             launches=got("serve_int8", "qmm_stream"), max_abs_err=got("b4", "max_abs_err"),
             **{key: b4[key] for key in keys}),
        dict(name="pa_wide (B5)", route="cuda", source="blazr_tpu_torch/csrc/pa_wide.cu",
             replaces="tools/bench_pa_wide.py:31",
             launches=got("tools", "pa_wide"), max_abs_err=got("b5", "max_abs_err"),
             **{key: t5[B2_SHAPES[0]][key] for key in keys},
             at=[{key: t5[sh][key] for key in keys} for sh in B2_SHAPES[1:]]),
        dict(name="pa_headmajor (B6)", route="cuda",
             source="blazr_tpu_torch/csrc/pa_headmajor.cu",
             replaces="tools/bench_pa_headmajor.py:27",
             launches=got("tools", "pa_headmajor"), max_abs_err=got("b6", "max_abs_err"),
             **{key: t6[B2_SHAPES[0]][key] for key in keys},
             at=[{key: t6[sh][key] for key in keys} for sh in B2_SHAPES[1:]]),
    ] + ([
        dict(name="qmm_w4a16 (B1), dense families", route="cuda",
             source="blazr_tpu_torch/csrc/qmm.cu",
             replaces="blazr_tpu/quant/pallas/int_matmul.py:69",
             launches=got("families", "qmm"), max_abs_err=got("b1", "families_max_abs_err"),
             **{key: f1[("qwen3 gate+up", 512)][key] for key in keys},
             decode={key: f1[("qwen3 gate+up", 8)][key] for key in keys},
             at=[{key: row[key] for key in keys} for sh, row in f1.items()
                 if sh[0] != "qwen3 gate+up"]),
        dict(name="paged_attention_decode (B2), dense families", route="cuda",
             source="blazr_tpu_torch/csrc/paged_attention.cu",
             replaces="blazr_tpu/attention/paged_attention.py:34",
             launches=got("families", "paged_attention"),
             max_abs_err=got("b2", "families_max_abs_err"),
             **{key: f2[FAMILY_B2_POINTS[0][0]][key] for key in keys},
             at=[{key: f2[p[0]][key] for key in keys} for p in FAMILY_B2_POINTS[1:]]),
    ] if families else []) + ([
        dict(name="qmm_w4a16 (B1), MoE experts", route="cuda",
             source="blazr_tpu_torch/csrc/qmm.cu",
             replaces="blazr_tpu/quant/pallas/int_matmul.py:69",
             launches=got("moe", "qmm"), max_abs_err=res["moe"]["b1"]["max_abs_err"],
             **{key: moe_b1[("mixtral gate/up", 512)][key] for key in keys},
             decode={key: moe_b1[("mixtral gate/up", 8)][key] for key in keys},
             at=[{key: row[key] for key in keys} for sh, row in moe_b1.items()
                 if sh[0] != "mixtral gate/up" or sh[1] not in (8, 512)]),
    ] if moe_b1 else []) + ([
        dict(name="qmm_w4a16 (B1), GGUF Q4_K/Q6_K layouts", route="cuda",
             source="blazr_tpu_torch/csrc/qmm.cu",
             replaces="blazr_tpu/quant/pallas/int_matmul.py:69",
             launches=got("gguf", "qmm"), max_abs_err=gguf["max_abs_err"],
             **{key: gguf["rows"][("gate L0 (Q4_K)", 512)][key] for key in keys},
             decode={key: gguf["rows"][("gate L0 (Q4_K)", 8)][key] for key in keys},
             at=[{key: row[key] for key in keys} for sh, row in gguf["rows"].items()
                 if sh[0] != "gate L0 (Q4_K)" or sh[1] == 1]),
    ] if gguf else [])
    if rec_b1 and ("mla" in res or "ssm" in res):
        # Launches of each served model's run with graphs: DeepSeek-V2-Lite
        # (phase 13), Codestral and the hybrid (phase 14).
        by_model = dict({"deepseek": got("mla", "qmm")} if "mla" in res else {},
                        **got("ssm", "qmm_by_model") or {})
        rows = rec_b1["rows"]
        line.append(dict(
            name="qmm_w4a16 (B1), MLA, Mamba2 and hybrid projections", route="cuda",
            source="blazr_tpu_torch/csrc/qmm.cu",
            replaces="blazr_tpu/quant/pallas/int_matmul.py:69",
            launches=sum(by_model.values()), launches_by_model=by_model,
            max_abs_err=rec_b1["max_abs_err"],
            **{key: rows[("deepseek expert gate/up", 512)][key] for key in keys},
            decode={key: rows[("deepseek expert gate/up", 8)][key] for key in keys},
            at=[{key: row[key] for key in keys} for sh, row in rows.items()
                if sh[0] != "deepseek expert gate/up" or sh[1] == 1]))
    if "ssm" in res:   # the hybrid's attention layers: Mistral's B2 geometry (32/8 x 128)
        line.append(dict(
            name="paged_attention_decode (B2), hybrid attention layers", route="cuda",
            source="blazr_tpu_torch/csrc/paged_attention.cu",
            replaces="blazr_tpu/attention/paged_attention.py:34",
            launches=got("ssm", "paged_attention"), max_abs_err=got("b2", "max_abs_err"),
            **{key: b2[key] for key in keys}))
    if gguf:           # B3 and B4 on the file's Q4_K gate weight, beside their rows
        for row in line:
            kernel = row["name"].split("(")[-1].rstrip(")")
            if kernel in ("B3", "B4") and "," not in row["name"]:
                row["gguf"] = [{key: r[key] for key in keys}
                               for (k, _), r in gguf["others"].items() if k.startswith(kernel)]
    return line


PHASES = ("build", "b1", "b2", "b3", "b4", "b5", "b6", "tools", "forward",
          "forward_w8a8", "ppl", "serve", "executor", "serve_int8", "prefix", "http",
          "families", "moe", "gguf", "mla", "ssm", "sweep", "timings", "layout_times")
FULL_RUN = PHASES[:-1]              # layout_times repeats part of timings


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(FULL_RUN),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default: all but layout_times; a subset prints no result lines)")
    ap.add_argument("--tree", type=Path, default=REPO,
                    help="run these phases on the blazr_tpu_torch of another checkout "
                    "(a subset of phases; for an A/B against another commit)")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    global TREE, SERVE_LAYERS
    TREE = args.tree.resolve()
    if phases == list(FULL_RUN):
        SERVE_LAYERS = FULL_RUN_SERVE_LAYERS
    other = TREE != REPO
    if other and phases == list(FULL_RUN):
        ap.error("--tree runs a subset of phases")
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    if not (TREE / "blazr_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(blazr_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(TREE))
    from blazr_tpu_torch.quant import int8
    from blazr_tpu_torch.utils import cuda_build

    if other:
        log(f"blazr_tpu_torch from {TREE}")
    quant = not other or hasattr(int8, "quantize_activations")

    torch.backends.cuda.matmul.allow_tf32 = False      # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    log("phase 1: card and build")
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    sources = ["qmm", "paged_attention", "qmm_int8", "qmm_stream", "pa_wide",
               "pa_headmajor"]
    logs = cuda_build.build_all(sources)
    log(f"  built {', '.join(f'csrc/{n}.cu' for n in sources)} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    (cuda_build.BUILD_DIR / "build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    for name, text in logs.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = entry_name(line.split("'")[1])
            elif any(w in line for w in ("registers", "spill", "warning")):
                log(f"  ptxas[{name}] {entry}: {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    res: dict = {}
    steps = [
        ("b1", "phase 2: B1 fused dequant-matmul vs plain",
         lambda: dict(check_b1(dev, gen), recurrent=recurrent_b1(dev, gen))),
        ("b2", "phase 3: B2 paged decode attention vs plain", lambda: check_b2(dev, gen)),
        ("b3", "phase 3b: B3 int8-activation matmul vs plain", lambda: check_b3(dev, gen)),
        ("b4", "phase 3c: B4 streaming decode matmul vs plain", lambda: check_b4(dev, gen)),
        ("b5", "phase 3d: B5 wide-view paged attention vs plain",
         lambda: check_layout(dev, gen, "wide")),
        ("b6", "phase 3e: B6 head-major paged attention vs plain",
         lambda: check_layout(dev, gen, "headmajor")),
        ("tools", "phase 3f: the layout tools' sweeps (B2 vs B5, B2 vs B6)", run_tools),
        ("forward", "phase 4: 2-layer full-width paged forward, card (bf16) vs CPU (f32)",
         lambda: teacher_forced(dev)),
        ("forward_w8a8", "phase 4b: 2-layer full-width contiguous forward under w8a8, "
         "card (bf16, B3) vs CPU (f32, plain)", lambda: teacher_forced_w8a8(dev)),
        ("ppl", "phase 4c: delta-ppl gate of the int8 modes against w4a16",
         lambda: ppl_gate(dev)),
        ("serve", f"phase 5: {SERVE_LAYERS}-layer Mistral-7B AWQ BatchEngine (w4a16), "
         "8 requests "
         "in two waves", lambda: full_depth(dev, card)),
        ("executor", f"phase 5b: {SERVE_LAYERS}-layer Mistral-7B AWQ Executor under w8a8, "
         "512-token "
         "prompt, 128 greedy tokens", lambda: serve_executor(dev, card, hold=not other)),
        ("serve_int8", f"phase 5c: {SERVE_LAYERS}-layer BatchEngine under w4a8-prefill "
         "with "
         "BLAZR_TPU_STREAM_KERNEL=1", lambda: serve_stream(dev, card)),
        ("prefix", f"phase 6: {SERVE_LAYERS}-layer BatchEngine with the prefix cache and "
         "its host "
         "tier, warmed: 8 requests sharing a 1024-token prefix in two waves",
         lambda: serve_prefix(dev, card)),
        ("http", "phase 7: AWQ checkpoint on disk -> load_model -> OpenAI HTTP server "
         "(8 concurrent requests, warmed and not, /metrics) and the CLI serve subprocess",
         lambda: serve_http(dev, card)),
        ("families", "phase 10: the dense families (2-layer full-width forwards, card "
         "vs CPU), then Qwen3-8B and Gemma2-9B served through the warmed engine",
         lambda: families(dev, card, phases == list(FULL_RUN))),
        ("moe", "phase 11: the MoE families (B1 at the expert shapes, 2-layer full-width "
         "forwards card vs CPU), then Mixtral-8x7B and Qwen3-30B-A3B served through the "
         "warmed engine", lambda: moe_phase(dev, gen, card, phases == list(FULL_RUN))),
        ("gguf", "phase 12: Mistral-7B-Instruct-v0.2 as a Q4_K_M GGUF file (write, load, "
         "forwards card vs CPU, B1/B3/B4 at its layouts, cli bench, cli serve)",
         lambda: gguf_phase(dev, gen, card)),
        ("mla", "phase 13: DeepSeek-V2-Lite (MLA + MoE): the 2-layer checkpoint card vs "
         "CPU, served through the warmed engine, cli serve",
         lambda: mla_phase(dev, card, phases == list(FULL_RUN))),
        ("ssm", "phase 14: Mamba-Codestral-7B and the hybrid at Bamba-9B's widths: 2-layer "
         "checkpoints card vs CPU, served, rows isolated, cli run",
         lambda: ssm_phase(dev, card, phases == list(FULL_RUN))),
        ("sweep", "phase 8: the sweeps behind the launch plans of B1-B6",
         lambda: (b1_variants(dev, gen), b2_splits(dev, gen), b3_sweeps(dev, gen),
                  b4_splits(dev, gen), layout_splits(dev, gen))),
        ("timings", "phase 9: kernel timings",
         lambda: timings(dev, gen, res, quant, families=not other)),
        ("layout_times", "phase 9's B5 and B6 rows alone",
         lambda: layout_times(dev, gen)),
    ]
    for name, title, fn in steps:
        if name in phases:
            log(title)
            t0 = time.perf_counter()
            res[name] = fn()
            log(f"  ({name}: {time.perf_counter() - t0:.1f} s)")
    log(f"total {time.perf_counter() - t_start:.1f} s; card: {card}")
    if phases != list(FULL_RUN):
        log("subset of phases: no result lines")
        return 0
    print(json.dumps({"kernels": res["timings"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
