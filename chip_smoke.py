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
  7.  the normal entry point: an 8-layer full-width AWQ checkpoint (4 in a
      full run, HTTP_LAYERS) and a BPE tokenizer.json written to disk,
      loaded by load_model (f16) and served over HTTP with continuous
      batching and the prefix cache, the engine warmed and not in turns (8
      concurrent requests each, the chats sharing a system message, then
      one more chat that hits its cached blocks; ``GET /metrics`` parses,
      counts the tokens sent back and reports the engine's prefix-cache
      hits), then ``python -m blazr_tpu_torch.cli serve`` (warmed) as a
      subprocess (in phase 7b when it runs too, which takes over phase 7's
      loaded model);
  7b. (``routes``) phase 7's checkpoint (written once a run) served as in
      phase 7 (warmed, prefix cache): the chat, streamed chat, Anthropic
      ``/v1/messages`` (plain and streamed: the event order, the deltas
      equal to the plain reply), ``/v1/responses``, ``/v1/infill`` and
      ``/v1/completions`` routes, each ROUTE_REPS times alone, whose greedy
      replies must be one reply (TTFT and e2e at the client); a 512-token
      ``/v1/embeddings`` within 1e-3 of the host's f32 pooled vector,
      ``/rerank`` in the host's order, a chat with tools, the audio stubs
      (501), ``/v1/lora`` (400 without a path, an empty listing), slots,
      ``/api/tags|ps|show|copy|pull`` (pull with ``huggingface_hub``
      hidden: no download is tried), ``/metrics``
      counting the Anthropic requests, B1 and B2 launched; the model over
      HTTPS (a self-signed certificate, where there is an openssl binary),
      ``/api/delete``; ``cli serve`` (warmed) answering ``/v1/messages``
      and ``/api/ps``, ``cli ps`` printing the same JSON, ``cli generate``
      and ``cli info`` on the checkpoint;
  7c. (``constrained``) grammars, JSON mode, JSON schemas and the host
      samplers: ``native/pda.cpp`` built with g++ from the checkout; phase
      7's checkpoint (32 layers when the phase runs alone, CONSTRAINED_LAYERS;
      phase 7b's loaded model in a full run) served as in phase 7b: a
      JSON-mode and a JSON-schema request alone, each twice (client TTFT
      with the grammar's compile, then cached); 8 chats at once (2 free, 2
      under ``root ::= "yes" | "no"``, 2 with an enum-valued object's
      ``json_schema``, 1 ``json_object``, 1 seeded mirostat 2 + DRY +
      typical-p), every constrained reply inside its grammar, complete
      where it stopped (the schema's JSON parsed, its enum's value), B1 and
      B2 launched; ms a decode step of 8-row waves of free rows, with 2 rows
      stepping their DFA on the device, and with a PDA row and a
      host-sampler row in the T=1 side step; with the card in f32, the wave
      equal with graphs and without, a one-DFA wave equal under horizon 8
      (device tables) and 1 (host masks), the free rows equal served alone;
      the host's DFA compile, ``token_tables`` and mask seconds at the
      32000-token vocabulary; the Executor (a grammar, mirostat) and ``cli
      run --grammar --mirostat 2``;
  8.  the sweeps behind the launch plans, straight through the libraries:
      B1's two variants over rows (TC_MIN_ROWS) and over K splits at decode
      rows, B2 over its split count, B3's two variants over rows
      (DEC_MAX_ROWS) and K splits, B4's K splits, B5's and B6's split
      counts at B2's three points;
  10. (``families``) each dense family (qwen2, qwen3, phi3, gemma, gemma2,
      starcoder2, falcon) at its published width, 2 layers (1 in a full run
      but Gemma2's 2, FULL_RUN_FAMILY_FORWARD_LAYERS), written to disk
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
      512 rows; each family at its published width, 2 layers (1 in a full
      run, FULL_RUN_MOE_FORWARD_LAYERS), written to disk as an AWQ-INT4
      checkpoint and loaded by load_model onto the card:
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
      tokenizer) at its published width, GGUF_LAYERS layers (2 in a full
      run), alone in a
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
  15. (``vision``) image chats with LLaVA-1.5-7B at full width: B1 against
      its plain version and timed at its language model's shapes (1 and 600
      rows, LLAVA_B1_SHAPES); the host's PNG and baseline-JPEG decode and
      ``preprocess_image`` timed on 640x480 images (a PNG written here with
      zlib, the repository's JPEG); an HF LLaVA directory (AWQ-INT4
      Llama-2-7B, FULL_RUN_HTTP_LAYERS layers in a full run and 32 alone,
      the whole f16 CLIP ViT-L/14-336 tower: quick_gelu, feature layer -2)
      and a 2-layer text checkpoint with an F16 mmproj sidecar of 23 blocks
      written and loaded as ``cli serve`` loads them: the tower (f32) held
      to the CPU at 1e-3 of its largest output and timed an image, a 2-layer
      forward from the merged embeddings (f16 on the card, f32 on the CPU)
      at 5e-2, the merged prefill timed with its B1 launches and traced
      (top device ops; the Executor's ``attend`` timed at its shapes),
      greedy image chats equal with graphs on and off (TTFT from before the
      image's decode, beside a text chat's; ms a decode token); over HTTP
      with the batch engine on, a PNG chat and a streamed JPEG chat equal
      to the Executor in-process, a text chat unchanged around them, a GIF,
      a progressive JPEG and an audio part answering 400, ``/metrics``
      counting every token sent, then two image chats at once beside a
      wave of text chats (run one at a time, equal to the Executor
      in-process); the text checkpoint answering an image with 400, and
      200 with ``mmproj=``.
  16. (``spec``) speculative decoding with Mistral-7B AWQ-INT4
      (FULL_RUN_SPEC_LAYERS layers in a full run, 32 alone), 8 extractive
      greedy requests of 256-512 tokens, 64 new tokens each, max batch 8,
      block 64, k = 5: B1 at the verify step's 48 rows and B2 at its query
      rows (each row's table repeated, ``position + 1`` keys) against their
      plain versions and timed (B2 beside the engine's gather form and SDPA);
      with the card in f32, prompt lookup and an identical-weights draft
      equal to speculation off on a greedy and a mixed wave (a sampled, a
      DFA-grammar and a logprobs row), every identical draft accepted, the
      only partings exact ties (the plain run's top-2 logit gap below 1e-4,
      printed); in bf16 speculation off, prompt lookup and a
      TinyLlama-1.1B-width draft, each wave's decode profiled (tok/s, ms a
      round, acceptance, the device idle share, the host gap between a
      round's read and the next replay, launches); one verify replay beside
      one decode step, one chain replay and one draft prefill; no graph
      captured after warmup; ``cli run --prompt-lookup`` and
      ``--draft-model`` equal to greedy; ``cli serve --continuous-batching
      --prompt-lookup`` answering 3 chats, its ``/metrics`` spec gauges.
  17. (``lora``) LoRA adapters with Mistral-7B AWQ-INT4 (FULL_RUN_LORA_LAYERS
      layers in a full run, 32 alone): with the card in f32, adapter A
      (rank 16 on every projection) over the packed base against a plain
      forward over the dequantized weights with A merged (logits within
      1e-3, greedy tokens equal), and a dense bf16 base merged in place
      equal to ``merge_lora``'s; in bf16, 8 greedy requests of 64-512 tokens
      (64 new tokens, max batch 8, block 64, horizon 8, graphs on) served
      with no adapter, A, A2 (A's shapes: no graph captured), B (rank 8 on
      q/v) and the base again (its first streams exactly): ms a decode step,
      decode tok/s, the idle share, B1 launches and low-rank matmuls a step,
      each switch's ms and captures; the ``/v1/lora`` routes and a chat's
      ``lora_adapter`` over ``cli serve --continuous-batching``; the C++ BPE
      core's encode of ~32,000 tokens beside the Python merge loop's.
  18. (``offload``) MoE expert offload, layer offload, the Mamba3 mixer,
      data-parallel replicas and tracing, at full widths: (a) Mixtral-8x7B
      AWQ-INT4 (all 32 layers, 1 in a full run) under ``--moe-offload
      hybrid``, 4 of 8 experts on the card and a rebalance every 2 passes,
      serving 8 greedy requests of phase 5's prompt lengths through the
      BatchEngine (4 tokens each, 8 in a full run) and one through the
      Executor (both eager): B1 and B2 launches, the host term's calls, the
      cold cache's hits and misses against its cap, ms a step, the
      resident planes rewritten in place; with the card in f32 (2 layers)
      the logits after rebalances within 1e-4 of the resident model's and
      the greedy tokens equal. (b) Mistral-7B AWQ-INT4, 32 layers with 16
      streamed from pinned host memory (8 with 4 in a full run): logits
      equal the resident model's exactly, ms a token and tok/s beside the
      floor of the host layers' bytes, the copies' overlap with compute
      under torch.profiler, ``cli run --device-layers`` in this process
      (alone, its stream equal to ``cli run``'s). (c) The Mamba3 mixer at
      Mamba-Codestral-7B's widths (2 layers; rope with rank 0 and 2, conv
      off, and rank 2 with the conv alone): the card in f32 against the CPU
      within 1e-3, bf16 reported; both engines' greedy streams equal in f32,
      the BatchEngine's decode step timed in bf16. (d) Two warmed
      BatchEngine replicas of a 4-layer Mistral-7B (2 in a full run), the
      card in f32, behind a cache-aware DataParallelGroup, the trace spans
      captured; their 8 greedy streams equal one engine's.
  19. (``parallel``) tensor, expert and sequence parallelism over
      torch.distributed, AWQ-INT4 groups of 128, random weights from seed 0.
      Four rank processes (``parallel/multihost.py::RankPool``, running this
      script's ``rank_job``) share the card over gloo (the backend rule:
      ranks share a card); each job's ranks join a fresh world through a
      file store. (a) Mistral-7B at tp 2, 32 layers
      (4 in a full run): a LockstepEngine over BatchEngine on both ranks, 8
      greedy requests of phase 5's prompt lengths, 64 new tokens, twice (the
      second with the collectives timed): tok/s, ms a decode step, lockstep
      steps on each rank, collectives a forward and their ms, B1 and B2
      launches and the rank's shapes; the f32 check at 2 layers (tp 2
      prefill logits within PAR_F32_TOL of one rank's, the 8 streams equal);
      ``cli serve --tp 2 --continuous-batching`` on phase 7's checkpoint: 4
      chats at once over HTTP from rank 0, then SIGINT, both ranks' lockstep
      step counts equal. (b) Mixtral-8x7B widths, 2 layers (1), ep 2 and
      ep 2 x tp 2 (4 ranks): layer 0's moe_ffn_ep on 512 and 8 rows in f32
      against moe_ffn on the whole layer (EP_TOL), timed beside it; a capacity
      that drops, its count equal to the plain make_dispatch's; a 512-token
      and 7 short requests through the lockstep BatchEngine. (c) Mistral-7B
      in f32, 2 layers, sp 4: an 8192-token prompt's ring prefill (window
      4096: 3 hops of 4) timed against one rank's, its logits within
      PAR_F32_TOL, then 16 greedy tokens equal. (d) swarm: a leader and two
      workers (16 + 16 layers; 2 + 2 in a full run) over TcpMesh on
      127.0.0.1 in this process, Mistral-7B in f32 from phase 7's kind of
      checkpoint: 32 greedy tokens of a 128-token prompt equal the
      Executor's; ms a token and bytes a hop. (e) disagg: a router (its HTTP
      app), a prefill and a decode worker, 32 layers (2): one
      /v1/completions equal to the Executor's greedy tokens; the KV shipped
      and its ms. Parts (f)-(i) serve what entry 8 of ROADMAP queue A
      added, each at the published widths, 2 layers (LLaVA 4), in f32 on
      the card so that a rank's streams can equal one rank's: (f)
      DeepSeek-V2-Lite (layer 0 dense, layer 1 MoE) at tp 2 (AWQ groups of
      32: the dense down's K 10944 / 2 is no multiple of 64) and at ep 2
      (groups of 64); (g) Mamba-Codestral-7B, Bamba-9B (cut to a Mamba2 and
      an attention layer) and the Mamba3 mixer at Codestral's widths, each
      at tp 2; (h) Mistral-7B at tp 2 with k = 5, prompt-lookup drafts and
      then a 2-layer TinyLlama-width draft sliced like the target, on
      phase 16's extractive prompts; (i) LLaVA-1.5-7B (4 layers, an mmproj
      sidecar beside the text checkpoint on disk) at tp 2: a PNG image chat
      through the MultimodalExecutor on the ranks and the same chat through
      ``cli serve --tp 2`` (a lockstep op). Each part: phase 5's 8 greedy
      requests (32 new tokens) through the lockstep BatchEngine, their
      streams and the f32 prefill logits held to one rank's (MESH_TOL), ms a
      decode step beside one rank's, the collectives a step and their ms,
      B1 and B2 launches a rank (a tp pair's equal), and a LoRA adapter
      refused with the JAX ``ValueError``; a streamed model under tp 2 is
      refused after (e). Phase 9 adds B1 at a tp 2 rank's shapes and B2 at
      its 16/4 heads, with (a)'s launches, and B1 at DeepSeek-V2-Lite's and
      B2 at Bamba-9B's tp 2 rank shapes, with (f)-(i)'s.
Phases 7b, 7c and 10-19 run between phases 7 and 8.
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


def time_b2_families(dev, gen, points=FAMILY_B2_POINTS) -> dict:
    """B2 at ``points`` (FAMILY_B2_POINTS; phase 19's tensor-parallel heads):
    kernel, bound, plain version and SDPA on pre-gathered KV (none under a
    softcap: SDPA computes another function); each point's kernel output is
    held to the plain version at 1e-2 of its largest (bf16)."""
    from blazr_tpu_torch.attention.paged_attention import (
        paged_attention_decode, paged_attention_reference)
    from blazr_tpu_torch.kvcache.paged import page_slot_index

    b, ctx, bs = 8, 1024, 64
    rows = {}
    for name, h_q, h_kv, d, window, softcap, scale in points:
        s = pa_inputs(dev, gen, b=b, h_q=h_q, h_kv=h_kv, d=d, bs=bs, seq_lens=[ctx] * b)
        kw = dict(block_size=bs, sliding_window=window, logit_softcap=softcap, scale=scale)
        got = paged_attention_decode(s["q"], s["kc"], s["vc"], s["bt"], s["sl"],
                                     num_blocks=s["nb"], device=dev, **kw).float()
        want = paged_attention_reference(s["q"], s["kc"], s["vc"], s["bt"], s["sl"],
                                         **kw).float()
        err = (got - want).abs().max().item()
        assert err <= 1e-2 * want.abs().max().item(), f"B2 {name}: {err}"
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
        row = dict(ms=ms, library_ms=library_ms, bound_ms=bms, bound_by=by, max_abs_err=err,
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
    # The CPU's weights dequantized once on the card: its plain B1 would
    # dequantize every weight at every call (~15 s of the phase).
    card_vs_cpu(dev, cfg, params, to_cpu_f32(params, dense=True), [64, 100, 37, 128],
                "forward")
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
FULL_RUN_SERVE_LAYERS = 8             # cut from 16 for phase 19's time


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


def cli_here(*argv) -> tuple[str, str, float]:
    """(stdout, stderr, wall s) of ``python -m blazr_tpu_torch.cli ARGV``
    run in this process (the CLI's ``main``; on the card unless ARGV says
    otherwise): phase 18's ``cli run --device-layers``, without a new
    interpreter's imports and CUDA start (~15-25 s a process on the card's
    host). Fails unless it returns 0."""
    import io

    from blazr_tpu_torch.cli.main import main as cli_main

    stdout, stderr = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        rc = cli_main([str(a) for a in argv])
    wall = time.perf_counter() - t0
    assert rc == 0, (argv, stderr.getvalue()[-4000:])
    free_card()
    return stdout.getvalue(), stderr.getvalue(), wall


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

# The depth of phases 7 and 7b's checkpoint: 8 of Mistral-7B's 32 layers,
# FULL_RUN_HTTP_LAYERS in a full run (``main`` sets it), where its three
# loads (phase 7, 7b's ``cli serve`` and ``cli generate``) weigh on the limit.
HTTP_LAYERS = 8
FULL_RUN_HTTP_LAYERS = 4


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


def _http(port: int, method: str, path: str, body=None, timeout: float = 600,
          tls: bool = False):
    """(status, body) of one request to the local server on ``port``; over
    https (the certificate not checked) with ``tls``."""
    import http.client

    if tls:
        import ssl

        conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=timeout,
                                           context=ssl._create_unverified_context())
    else:
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
def http_server(sched, engine, tls: tuple = (None, None)):
    """The port's HTTP server (``create_app`` + ``serve``) over ``engine`` on
    a free local port, in a thread with its own event loop; yields the port
    and stops the server on exit. ``tls``: (certificate, key) for HTTPS."""
    import threading

    from blazr_tpu_torch.config.server import ServerConfig
    from blazr_tpu_torch.server import create_app, serve

    app = create_app(sched, ServerConfig(host="127.0.0.1", port=0, tls_cert=tls[0],
                                         tls_key=tls[1]), batch_engine=engine)
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


_HTTP_CKPT: dict = {}


def http_checkpoint(layers: int | None = None) -> Path:
    """Phase 7's checkpoint: a full-width Mistral-7B AWQ-INT4 checkpoint
    (group 128, HTTP_LAYERS layers unless ``layers``) and a 32000-token
    byte-level BPE tokenizer.json in a temporary directory, written once a
    run for each depth (phases 7, ``routes`` and ``constrained`` share it)
    and removed when the script ends."""
    import atexit
    import shutil
    import tempfile

    from blazr_tpu_torch.utils.synthetic import (mistral_7b_config, write_hf_checkpoint,
                                                 write_bpe_tokenizer_json)

    layers = layers or HTTP_LAYERS
    if layers not in _HTTP_CKPT:
        cfg = mistral_7b_config()
        cfg.num_layers = layers
        ckpt = Path(tempfile.mkdtemp(prefix="blazr_awq_"))
        atexit.register(shutil.rmtree, ckpt, True)
        t0 = time.perf_counter()
        write_hf_checkpoint(ckpt, cfg, quant="awq", group_size=128, seed=SEED)
        write_bpe_tokenizer_json(ckpt, cfg.vocab_size, seed=SEED)
        size = sum(f.stat().st_size for f in ckpt.iterdir())
        log(f"  wrote {layers}-layer Mistral-7B AWQ-INT4 checkpoint ({size / 1e9:.2f} GB) "
            f"and tokenizer.json in {time.perf_counter() - t0:.1f} s")
        _HTTP_CKPT[layers] = ckpt
    return _HTTP_CKPT[layers]


def serve_http(dev, card: str, hand_over: bool = False) -> dict:
    """Phase 7: write a full-width Mistral-7B AWQ-INT4 checkpoint (group
    128, HTTP_LAYERS layers) and a 32000-token byte-level BPE tokenizer.json to a
    temporary directory; load it through ModelScheduler -> load_model (f16,
    the AWQ default) and serve it from the port's HTTP server with
    continuous batching and the prefix cache, as ``cli serve`` does; the
    engine warmed and not in turns (HTTP_TURNS), each turn 8 concurrent
    requests (``http_turn``) and ``/metrics``. Then ``python -m
    blazr_tpu_torch.cli serve`` (warmed) as a subprocess answers /health,
    one chat completion and /metrics (``cli_chat_and_metrics``). With
    ``hand_over`` (phase 7b runs next) the loaded scheduler goes to phase
    7b under ``"sched"``, and phase 7b's ``cli serve`` makes those checks."""
    import numpy as np
    import torch

    from blazr_tpu_torch.engine.model_scheduler import ModelScheduler

    ckpt = http_checkpoint()
    out: dict = {}
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
    if hand_over:
        out["sched"] = sched
        return out
    del sched, ex, model
    torch.cuda.empty_cache()

    # The CLI entry point in its own process.
    with cli_serve(ckpt, ckpt / "cli_stderr.txt") as (cli_port, up, warmed):
        n = cli_chat_and_metrics(cli_port, texts[0], 0)
        log(f"  cli serve: '{warmed}'; answered /health after {up:.1f} s, a chat "
            f"completion of {n} tokens and /metrics")
        out["cli_up_s"] = up
    return out


def cli_chat_and_metrics(port: int, text: str, generated: int) -> int:
    """A greedy 16-token chat completion from ``cli serve`` on ``port``,
    then its /metrics, which must count the tokens it sent back on top of
    the ``generated`` ones before it; returns the chat's token count."""
    st, body = _http(port, "POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": text}], "max_tokens": 16,
        "temperature": 0})
    assert st == 200, (st, body)
    reply = json.loads(body)
    assert reply["choices"][0]["finish_reason"] in ("stop", "length"), reply
    n = reply["usage"]["completion_tokens"]
    st, body = _http(port, "GET", "/metrics")
    assert st == 200, st
    got = parse_metrics(body.decode())
    assert got[("blazr_tpu_tokens_generated_total", ())] == generated + n, got
    return n


# ---------------------------------------------------------------------------
# phase 7b (routes): every other route of the HTTP server, and the CLI
# ---------------------------------------------------------------------------

ROUTE_REPS = 3                      # each generating route timed this many times
ROUTE_TOKENS = 32                   # greedy tokens a generating request


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _stream_events(port: int, path: str, body: dict) -> dict:
    """A streamed ``/v1/messages`` request: its (event, data) pairs, the
    client's time to the first text delta and to the end."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200, (resp.status, resp.read())
    assert resp.getheader("Content-Type") == "text/event-stream"
    events, name, ttft = [], None, None
    for raw in resp:
        line = raw.decode().rstrip("\n")
        if line.startswith("event: "):
            name = line[len("event: "):]
        elif line.startswith("data: "):
            data = json.loads(line[len("data: "):])
            assert data["type"] == name, (name, data)
            if name == "content_block_delta" and ttft is None:
                ttft = time.perf_counter() - t0
            events.append((name, data))
    conn.close()
    return dict(events=events, ttft=ttft, wall=time.perf_counter() - t0)


def _self_signed(d: Path):
    """(certificate, key) made by the openssl binary in ``d``, or None
    without one."""
    import shutil

    if shutil.which("openssl") is None:
        return None
    cert, key = d / "cert.pem", d / "key.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "1",
                    "-subj", "/CN=127.0.0.1", "-keyout", str(key), "-out", str(cert)],
                   check=True, capture_output=True, timeout=120)
    return str(cert), str(key)


def _cpu_pooled(ckpt: Path, ids: list) -> "np.ndarray":
    """The mean-pooled, L2-normalized f32 vector of ``ids``' embedding rows,
    read from the checkpoint file on the host (numpy, f16 rows to f32)."""
    import numpy as np

    from blazr_tpu_torch.formats.safetensors import SafeTensorsReader

    with SafeTensorsReader(ckpt / "model.safetensors") as r:
        table = r.load_numpy("model.embed_tokens.weight")
    v = np.asarray(table[ids], dtype=np.float32).mean(axis=0)
    return v / np.linalg.norm(v)


def route_requests(port: int, ckpt: Path, ex, rng, card: str) -> dict:
    """The routes over the in-process server of ``ex``'s model: the
    generating ones timed (ROUTE_REPS each, served alone), then embeddings
    (and its parts: the gather and copy, the JSON body), rerank, tools,
    audio, LoRA, slots and management; returns the latencies and replies."""
    import numpy as np

    from blazr_tpu_torch.server.encoding import encode_embedding
    from blazr_tpu_torch.server.pooling import pool

    tok, cfg = ex.tokenizer, ex.model.cfg

    user = _prompt_text(tok, 40, rng)           # one block holds it: no prefix hit
    chat_body = {"messages": [{"role": "user", "content": user}],
                 "max_tokens": ROUTE_TOKENS, "temperature": 0}
    msg_body = dict(chat_body)
    out: dict = {"lat": {}}

    def post(path, body, **kw):
        st, data = _http(port, "POST", path, body, **kw)
        assert st == 200, (path, st, data[:2000])
        return json.loads(data)

    # Each generating route ROUTE_REPS times, alone, in turns.
    lat = {k: [] for k in ("chat", "chat_stream", "messages", "messages_stream",
                           "responses", "infill", "completions")}
    ttft = {"chat_stream": [], "messages_stream": []}
    for _ in range(ROUTE_REPS):
        chat, dt = _timed(lambda: post("/v1/chat/completions", chat_body))
        lat["chat"].append(dt)
        sc = _stream_chat(port, dict(chat_body, stream=True))
        lat["chat_stream"].append(sc["wall"])
        ttft["chat_stream"].append(sc["ttft"])
        msg, dt = _timed(lambda: post("/v1/messages", msg_body))
        lat["messages"].append(dt)
        ms = _stream_events(port, "/v1/messages", dict(msg_body, stream=True))
        lat["messages_stream"].append(ms["wall"])
        ttft["messages_stream"].append(ms["ttft"])
        resp, dt = _timed(lambda: post("/v1/responses", {
            "input": user, "max_output_tokens": ROUTE_TOKENS, "temperature": 0}))
        lat["responses"].append(dt)
        infill, dt = _timed(lambda: post("/v1/infill", {
            "input_prefix": user, "input_suffix": "", "max_tokens": ROUTE_TOKENS,
            "temperature": 0}))
        lat["infill"].append(dt)
        comp, dt = _timed(lambda: post("/v1/completions", {
            "prompt": user, "max_tokens": ROUTE_TOKENS, "temperature": 0}))
        lat["completions"].append(dt)
        # Greedy and alone: one reply whichever API asks.
        text = chat["choices"][0]["message"]["content"]
        assert msg["content"][0]["text"] == text, (msg, text)
        assert resp["output_text"] == text, (resp["output_text"], text)
        assert msg["usage"]["input_tokens"] == chat["usage"]["prompt_tokens"] == \
            resp["usage"]["input_tokens"]
        assert msg["usage"]["output_tokens"] == chat["usage"]["completion_tokens"]
        assert "".join(sc["deltas"]) == text
        names = [n for n, _ in ms["events"]]
        assert [n for n in names if n != "content_block_delta"] == [
            "message_start", "content_block_start", "content_block_stop", "message_delta",
            "message_stop"], names
        assert names[2:-3] == ["content_block_delta"] * (len(names) - 5), names
        assert "".join(d["delta"]["text"] for n, d in ms["events"]
                       if n == "content_block_delta") == msg["content"][0]["text"]
        assert ms["events"][-2][1]["usage"]["output_tokens"] == msg["usage"]["output_tokens"]
        # No FIM tokens in this tokenizer: the infill is the prefix's continuation.
        assert infill["content"] == comp["choices"][0]["text"], (infill, comp)
    out["text"] = text
    out["prompt_tokens"] = chat["usage"]["prompt_tokens"]
    out["completion_tokens"] = chat["usage"]["completion_tokens"]
    med = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in lat.items()}
    med_ttft = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in ttft.items()}
    out["lat"], out["ttft"] = med, med_ttft
    for k in lat:
        log(f"  {k}: e2e median {med[k]:.1f} ms over {ROUTE_REPS}"
            + (f", TTFT median {med_ttft[k]:.1f} ms" if k in med_ttft else "")
            + f" (prompt {out['prompt_tokens']} tokens, {out['completion_tokens']} "
            f"generated; {card})")

    # Embeddings of a 512-token input: the card's gather against the host's.
    ids = tok.encode(_prompt_text(tok, 512, rng))[:512]
    assert len(ids) == 512
    emb_lat = []
    for _ in range(ROUTE_REPS):
        emb, dt = _timed(lambda: post("/v1/embeddings", {"input": ids}))
        emb_lat.append(dt)
    b64, b64_dt = _timed(lambda: post("/v1/embeddings", {"input": ids,
                                                          "encoding_format": "base64"}))
    rows, gather_dt = _timed(lambda: ex.get_embeddings(ids))
    _, json_dt = _timed(lambda: json.dumps({"data": [{"embedding": encode_embedding(
        pool(rows, "mean", True), "float")}]}))
    dt = sorted(emb_lat)[len(emb_lat) // 2]
    vec = np.asarray(emb["data"][0]["embedding"], np.float32)
    ref = _cpu_pooled(ckpt, ids)
    err = float(np.abs(vec - ref).max())
    assert vec.shape == (cfg.hidden_size,) and err <= 1e-3, err
    assert emb["usage"]["prompt_tokens"] == 512
    import base64

    assert np.array_equal(np.frombuffer(base64.b64decode(b64["data"][0]["embedding"]),
                                        np.float32), vec)
    out["lat"]["embeddings_512"] = dt * 1e3
    out["lat"]["embeddings_512_base64"] = b64_dt * 1e3
    out["embedding_max_abs_err"] = err
    log(f"  embeddings: 512 tokens, e2e median {dt * 1e3:.1f} ms over {ROUTE_REPS} "
        f"({', '.join(f'{t * 1e3:.1f}' for t in emb_lat)}), base64 {b64_dt * 1e3:.1f} ms; "
        f"in process: gather and copy to the host {gather_dt * 1e3:.2f} ms, pooling and "
        f"the float JSON {json_dt * 1e3:.2f} ms; max |card - host f32| {err:.2e} "
        f"(tol 1e-3; {card})")
    # Rerank: the card's order equals the host's.
    docs = [_prompt_text(tok, n, rng) for n in (24, 48, 96, 12)]
    query = _prompt_text(tok, 16, rng)
    rr_lat = []
    for _ in range(ROUTE_REPS):
        rr, dt = _timed(lambda: post("/rerank", {"query": query, "documents": docs}))
        rr_lat.append(dt)
    dt = sorted(rr_lat)[len(rr_lat) // 2]
    q = _cpu_pooled(ckpt, tok.encode(query))
    scores = [float(np.dot(q, _cpu_pooled(ckpt, tok.encode(d)))) for d in docs]
    host_order = sorted(range(len(docs)), key=lambda i: -scores[i])
    assert [r["index"] for r in rr["results"]] == host_order, (rr, scores)
    np.testing.assert_allclose([r["relevance_score"] for r in rr["results"]],
                               [scores[i] for i in host_order], atol=1e-3)
    out["lat"]["rerank_4"] = dt * 1e3
    log(f"  rerank: 4 documents, e2e median {dt * 1e3:.1f} ms over {ROUTE_REPS} "
        f"({', '.join(f'{t * 1e3:.1f}' for t in rr_lat)}), order {host_order} as on the "
        f"host ({card})")
    # A chat with tools is served.
    tools = [{"type": "function", "function": {"name": "get_weather", "parameters": {
        "type": "object", "properties": {"city": {"type": "string"}}}}}]
    tc = post("/v1/chat/completions", dict(chat_body, tools=tools))
    assert tc["choices"][0]["finish_reason"] in ("stop", "length", "tool_calls"), tc
    # The audio stubs answer 501; the LoRA routes are served (phase 17 drives
    # them): a load without a path 400, an empty listing.
    for path in ("/v1/audio/speech", "/v1/audio/transcriptions"):
        st, data = _http(port, "POST", path, {})
        assert st == 501 and json.loads(data)["error"]["type"] == "not_implemented_error"
    st, _ = _http(port, "POST", "/v1/lora", {})
    assert st == 400, st
    st, data = _http(port, "GET", "/v1/lora")
    assert st == 200 and json.loads(data) == {"adapters": []}, data
    # Slots.
    st, data = _http(port, "POST", "/api/slots", {"model": "default"})
    assert st == 201, data
    sid = json.loads(data)["id"]
    post("/v1/completions", {"prompt": user, "max_tokens": 4, "temperature": 0,
                             "id_slot": sid})
    st, data = _http(port, "GET", "/api/slots")
    slot, = json.loads(data)["slots"]
    assert slot["id"] == sid and slot["generated_tokens"] > 0, slot
    assert _http(port, "DELETE", f"/api/slots/{sid}")[0] == 200
    assert _http(port, "DELETE", f"/api/slots/{sid}")[0] == 404
    # Management.
    st, data = _http(port, "GET", "/api/tags")
    tag, = json.loads(data)["models"]
    size = sum(f.stat().st_size for f in ckpt.iterdir() if f.is_file())
    assert tag["name"] == ckpt.name and tag["size"] == size, (tag, size)
    st, data = _http(port, "GET", "/api/ps")
    assert [m["name"] for m in json.loads(data)["models"]] == ["default"], data
    info = post("/api/show", {"name": "default"})["model_info"]
    assert (info["hidden_size"], info["num_layers"], info["num_heads"],
            info["num_kv_heads"], info["vocab_size"]) == (
        cfg.hidden_size, cfg.num_layers, cfg.attention.num_heads,
        cfg.attention.num_kv_heads, cfg.vocab_size), info
    assert _http(port, "POST", "/api/copy", {"source": ckpt.name,
                                             "destination": ckpt.name})[0] == 409
    assert _http(port, "POST", "/api/copy", {"source": "nope", "destination": "x"})[0] == 404
    # /api/pull: the machine may hold huggingface_hub, and there is no
    # network; hiding the package gives the JAX error line and no download.
    saved = sys.modules.get("huggingface_hub")
    sys.modules["huggingface_hub"] = None
    try:
        st, data = _http(port, "POST", "/api/pull", {"name": "org/model"})
    finally:
        if saved is None:
            del sys.modules["huggingface_hub"]
        else:
            sys.modules["huggingface_hub"] = saved
    lines = [json.loads(line) for line in data.decode().splitlines()]
    assert st == 200 and lines == [{"status": "pulling manifest for org/model"},
                                   {"error": "huggingface_hub is not installed"}], lines
    return out


def routes_phase(dev, card: str, sched=None, hand_over: bool = False) -> dict:
    """Phase 7b (``routes``): phase 7's checkpoint (written if phase 7 did
    not run) served through ModelScheduler (phase 7's ``sched`` where it
    handed it over) and a warmed BatchEngine with the prefix cache, as
    ``cli serve --continuous-batching`` serves it:
    ``route_requests`` over the port's server, ``/metrics`` counting the
    Anthropic requests; the model over HTTPS (a self-signed certificate from
    the openssl binary, through the Executor), ``/api/delete``; then
    ``cli serve`` (warmed) answering ``/v1/messages`` and ``/api/ps`` with
    ``cli ps`` printing the same JSON, and phase 7's chat and /metrics
    checks; ``cli generate`` and ``cli info``. With ``hand_over`` (phase 7c
    runs next) the loaded scheduler goes to phase 7c under ``"sched"``."""
    import tempfile

    import numpy as np
    import torch

    from blazr_tpu_torch.engine.batch_engine import BatchEngine
    from blazr_tpu_torch.engine.model_scheduler import ModelScheduler

    t_phase = time.perf_counter()
    ckpt = http_checkpoint()
    out: dict = {}
    t0 = time.perf_counter()
    handed = sched is not None
    sched = sched or ModelScheduler(ckpt, device=dev)
    ex = sched.get_executor("default")
    inf = ex.app_cfg.inference
    inf.max_batch_size = 8
    inf.prefix_cache = True
    engine = BatchEngine(ex.model, ex.tokenizer, ex.app_cfg)
    warm_s = engine.warmup()
    log(f"  {'phase 7' if handed else 'loaded'}'s model warmed in "
        f"{time.perf_counter() - t0:.1f} s (warmup {warm_s:.1f} s)")
    rng = np.random.default_rng(SEED + 17)
    with http_server(sched, engine) as port:
        reset_counts()
        out.update(route_requests(port, ckpt, ex, rng, card))
        torch.cuda.synchronize()
        launches = read_counts()
        assert launches["qmm"] > 0 and launches["paged_attention"] > 0, launches
        out["launches"] = launches
        log(f"  launches over the routes: {launches}")
        # /metrics counts what /v1/messages served, its stream too.
        before = parse_metrics(_http(port, "GET", "/metrics")[1].decode())
        body = {"messages": [{"role": "user", "content": "count these"}], "max_tokens": 8,
                "temperature": 0}
        plain = json.loads(_http(port, "POST", "/v1/messages", body)[1])
        streamed = _stream_events(port, "/v1/messages", dict(body, stream=True))
        after = parse_metrics(_http(port, "GET", "/metrics")[1].decode())

        def grew(name):
            return after[(name, ())] - before.get((name, ()), 0.0)
        n_out = plain["usage"]["output_tokens"]
        assert streamed["events"][-2][1]["usage"]["output_tokens"] == n_out
        assert grew("blazr_tpu_tokens_generated_total") == 2 * n_out
        assert grew("blazr_tpu_tokens_prompted_total") == 2 * plain["usage"]["input_tokens"]
        assert grew("blazr_tpu_ttft_seconds_count") == 1
        log(f"  /metrics: two /v1/messages (one streamed) added {2 * n_out} generated "
            f"and {2 * plain['usage']['input_tokens']} prompted tokens and one TTFT")
    certs = Path(tempfile.mkdtemp(prefix="blazr_tls_"))
    tls = _self_signed(certs)
    if tls is None:
        log("  no openssl binary: HTTPS not exercised")
    else:
        # A BatchEngine runs on one event loop: this server, on its own
        # loop, answers through the Executor.
        with http_server(sched, None, tls=tls) as port:
            st, data = _http(port, "GET", "/health", tls=True)
            assert st == 200 and json.loads(data)["status"] == "ok", data
            (st, data), dt = _timed(lambda: _http(port, "POST", "/v1/messages", {
                "messages": [{"role": "user", "content": "over tls"}], "max_tokens": 8,
                "temperature": 0}, tls=True))
            assert st == 200 and json.loads(data)["content"][0]["text"] is not None, data
            log(f"  HTTPS (self-signed): /health and /v1/messages answered, {dt * 1e3:.1f} ms")
        out["tls"] = True
    entry = sched._models.get("default")
    with http_server(sched, None) as port:
        st, data = _http(port, "DELETE", "/api/delete", {"name": "default"})
        assert st == 200 and json.loads(data) == {"unloaded": True}, data
        assert json.loads(_http(port, "GET", "/api/ps")[1]) == {"models": []}
    cfg = ex.model.cfg
    if hand_over:
        # Phase 7c serves the model this phase unloaded: put its entry back
        # (the Executor holds nothing that unloading released) instead of
        # loading the checkpoint again.
        sched._models["default"] = entry
        out["sched"] = sched
    del sched, ex, engine
    free_card()

    env = dict(os.environ, PYTHONPATH=str(TREE))

    def cli(*argv):
        proc = subprocess.run([sys.executable, "-m", "blazr_tpu_torch.cli", *argv],
                              cwd=TREE, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, (argv, proc.stderr[-4000:])
        return proc.stdout

    with cli_serve(ckpt, certs / "cli_stderr.txt") as (port, up, warmed):
        (st, data), dt = _timed(lambda: _http(port, "POST", "/v1/messages", {
            "messages": [{"role": "user", "content": out["text"][:200] or "hi"}],
            "max_tokens": 16, "temperature": 0}))
        assert st == 200 and json.loads(data)["type"] == "message", data
        cli_chat_and_metrics(port, out["text"][:200] or "hi",
                             json.loads(data)["usage"]["output_tokens"])
        st, data = _http(port, "GET", "/api/ps")
        assert st == 200
        ps, ps_s = _timed(lambda: cli("ps", "--host", "127.0.0.1", "--port", str(port)))
        assert json.loads(ps) == json.loads(data), (ps, data)
        log(f"  cli serve: '{warmed}'; /health after {up:.1f} s; /v1/messages "
            f"{dt * 1e3:.1f} ms; cli ps printed its /api/ps in {ps_s:.1f} s")
        out.update(cli_up_s=up, cli_ps_s=ps_s)
    gen, gen_s = _timed(lambda: cli("generate", str(ckpt), "the state of the art", "-n", "16",
                                    "-t", "0"))
    assert gen.strip(), gen
    info, info_s = _timed(lambda: cli("info", str(ckpt)))
    info = json.loads(info)
    assert (info["format"], info["quant"], info["architecture"], info["hidden_size"],
            info["num_layers"]) == ("safetensors", "awq", "mistral", cfg.hidden_size,
                                    cfg.num_layers), info
    log(f"  cli generate: {gen_s:.1f} s (load included); cli info: {info_s:.1f} s")
    out.update(cli_generate_s=gen_s, cli_info_s=info_s)
    import shutil

    shutil.rmtree(certs, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  routes phase: {out['phase_s']:.1f} s ({card})")
    return out


# Phase 7c (``constrained``): grammars, JSON mode, JSON schemas and the host
# samplers, served at Mistral-7B's full width.
CONSTRAINED_LAYERS = 32        # --phases build,constrained; a full run takes 7b's model
YES_NO = 'root ::= "yes" | "no"'
ENUM_SCHEMA = {"type": "object", "properties": {"answer": {"enum": ["yes", "no", "maybe"]}},
               "required": ["answer"]}
# The JSON rows' penalties: the JSON grammars allow whitespace without
# bound, and a random-weight model may keep picking it; the penalties make
# it move on, as a client of such a model would ask.
JSON_PENALTIES = dict(frequency_penalty=1.0, presence_penalty=1.0)
HOST_SAMPLER = dict(temperature=0.8, seed=11, mirostat=2, dry_multiplier=0.8, typical_p=0.9)
CLI_GRAMMAR = 'root ::= "answer: " ("yes" | "no") "."'


def constrained_bodies(texts: list) -> list:
    """The phase's wave of 8 chats, (kind, request body): 2 free greedy, 2
    under YES_NO, 2 under ENUM_SCHEMA's json_schema, 1 in JSON mode, 1
    seeded mirostat 2 + DRY + typical-p."""
    schema = {"type": "json_schema", "json_schema": {"name": "answer", "schema": ENUM_SCHEMA}}

    def chat(i, **kw):
        return dict({"messages": [{"role": "user", "content": texts[i]}], "max_tokens": 48,
                     "temperature": 0}, **kw)
    return [("free", chat(0)), ("free", chat(1)),
            ("yes_no", chat(2, grammar=YES_NO, max_tokens=8)),
            ("yes_no", chat(3, grammar=YES_NO, max_tokens=8)),
            ("schema", chat(4, max_tokens=96, response_format=schema, **JSON_PENALTIES)),
            ("schema", chat(5, max_tokens=96, response_format=schema, **JSON_PENALTIES)),
            ("json", chat(6, max_tokens=64, response_format={"type": "json_object"},
                          **JSON_PENALTIES)),
            ("host", chat(7, **HOST_SAMPLER))]


def grammar_source(kind: str):
    from blazr_tpu_torch.engine.grammar_json import JSON_GRAMMAR, json_schema_to_gbnf

    return {"yes_no": YES_NO, "schema": json_schema_to_gbnf(ENUM_SCHEMA),
            "json": JSON_GRAMMAR}.get(kind)


def accepted(src: str, tokens: list, vocab: list, eos: int) -> bool:
    """Whether ``tokens`` (ids; the last may be EOS) are a prefix the grammar
    accepts, complete where the last token is EOS (the tier ``cli serve``
    takes: the DFA, or the PDA for JSON mode)."""
    from blazr_tpu_torch.engine.grammar import make_grammar_state

    st = make_grammar_state(src, vocab, eos_token_id=eos)
    body = tokens[:-1] if tokens and tokens[-1] == eos else tokens
    if not all(st.accept_token(t) for t in body):
        return False
    return st.is_complete if len(body) < len(tokens) else True


@contextlib.contextmanager
def grammar_timers():
    """Host seconds of each DFA compile, ``token_tables`` build and host mask
    (DFA and PDA) while the block runs, by name."""
    from blazr_tpu_torch.engine import grammar, grammar_pda

    got: dict = {"dfa_compile": [], "token_tables": [], "pda_mask": [], "dfa_mask": []}
    saved = [(grammar, "_compile_uncached"), (grammar.GrammarDfa, "token_tables"),
             (grammar_pda.PdaGrammarState, "mask"), (grammar.GrammarState, "mask")]
    originals = [getattr(owner, name) for owner, name in saved]

    def timed(fn, key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                got[key].append(time.perf_counter() - t0)
        return call
    for (owner, name), fn, key in zip(saved, originals, got):
        setattr(owner, name, timed(fn, key))
    try:
        yield got
    finally:
        for (owner, name), fn in zip(saved, originals):
            setattr(owner, name, fn)


def median_ms(xs: list) -> float:
    return sorted(xs)[len(xs) // 2] * 1e3 if xs else float("nan")


def constrained_http(port: int, bodies: list, tok, card: str) -> dict:
    """The wave of 8 over HTTP at once; each reply checked against its
    grammar (texts: the JSON grammars allow any byte inside a string, so a
    replaced invalid UTF-8 byte keeps the text inside them)."""
    import threading

    import torch

    vocab = [bytes([i]) for i in range(256)]
    replies: list = [None] * len(bodies)

    def one(i):
        t0 = time.perf_counter()
        st, data = _http(port, "POST", "/v1/chat/completions", bodies[i][1])
        assert st == 200, (st, data)
        replies[i] = dict(json.loads(data), wall=time.perf_counter() - t0)
    reset_counts()
    t0 = time.perf_counter()
    clients = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for c in clients:
        c.start()
    for c in clients:
        c.join(900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    assert launches["qmm"] > 0 and launches["paged_attention"] > 0, launches
    out = dict(wall_s=wall, launches=launches, replies=[])
    for (kind, body), r in zip(bodies, replies):
        assert r is not None, f"{kind} request did not finish"
        text = r["choices"][0]["message"]["content"] or ""
        finish = r["choices"][0]["finish_reason"]
        n = r["usage"]["completion_tokens"]
        src = grammar_source(kind)
        if src is not None:
            data = text.encode()
            assert accepted(src, list(data) + ([256] if finish == "stop" else []),
                            vocab + [b""], 256), (kind, finish, text)
        if kind == "yes_no":
            assert finish == "stop" and text in ("yes", "no"), (finish, text)
        if kind == "schema":
            assert finish == "stop", (kind, finish, text)
            assert json.loads(text)["answer"] in ENUM_SCHEMA["properties"]["answer"]["enum"]
        if kind == "json" and finish == "stop":
            json.loads(text)
        assert n > 0 and finish in ("stop", "length"), r
        out["replies"].append(dict(kind=kind, finish=finish, tokens=n, text=text[:80]))
        log(f"  {kind:7s} {finish:6s} {n:3d} tokens, done at {r['wall']:.2f} s: {text[:72]!r}")
    log(f"  the wave of 8 over HTTP: {wall:.2f} s; launches {launches} ({card})")
    return out


def constrained_engine(model, tok, horizon: int = 8, graphs: bool = True):
    """A BatchEngine as ``serve --continuous-batching`` builds it over the
    checkpoint's tokenizer (max batch 8, horizon ``horizon``), 1024 tokens
    of context."""
    from blazr_tpu_torch.config import AppConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine

    app = AppConfig(model=model.cfg)
    app.inference.max_batch_size = 8
    app.inference.prefix_cache = True
    app.inference.max_seq_len = 1024
    app.inference.decode_horizon = horizon
    app.inference.graphs = graphs
    return BatchEngine(model, tok, app)


def wave_requests(tok, bodies: list, kinds=None) -> list:
    """(prompt ids, GenerationConfig) of the wave's bodies (all of
    ``kinds`` when given), the chat texts encoded as they are."""
    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.server.api_types import gen_config_from_body

    out = []
    for kind, body in bodies:
        if kinds is None or kind in kinds:
            out.append((tok.encode(body["messages"][0]["content"]),
                        gen_config_from_body(body, GenerationConfig())))
    return out


async def wave_timing(engine, reqs: list, label: str, card: str, free_rows: int) -> dict:
    """One wave through ``engine``: ms a decode step (the decode rounds'
    wall over the steps the horizon rounds advanced), the free rows'
    tokens/s, the side or host-mask steps' ms, B1 and B2 launches a step."""
    import torch

    p0 = dict(engine.perf)
    s0 = engine.horizon_steps
    reset_counts()
    t0 = time.perf_counter()
    res = await serve(engine, [reqs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    steps = engine.horizon_steps - s0
    perf = {k: engine.perf[k] - p0.get(k, 0.0) for k in engine.perf}
    single = perf.get("single_step_n", 0)
    free = res[:free_rows]
    # The free rows' decode: their tokens after the first over the span from
    # the first first token to the last finish (prefill left out).
    span = max(r["t_done"] for r in free) - min(r["t_submit"] + r["ttft"] for r in free)
    out = dict(ms_per_step=perf["decode"] / max(steps, 1) * 1e3, steps=steps,
               free_tok_s=sum(len(r["tokens"]) - 1 for r in free) / span, wall_s=wall,
               single_steps=single,
               single_ms=perf.get("single_step", 0.0) / max(single, 1) * 1e3,
               b1=launches["qmm"], b2=launches["paged_attention"],
               uploads=perf.get("grammar_uploads_n", 0))
    log(f"  {label}: {out['ms_per_step']:.2f} ms a decode step over {steps} horizon steps, "
        f"free rows' decode {out['free_tok_s']:.1f} tok/s; {single:.0f} T=1 steps of "
        f"{out['single_ms']:.2f} ms; B1 {launches['qmm']}, B2 {launches['paged_attention']}; "
        f"table uploads {out['uploads']:.0f} ({card})")
    return dict(out, streams=[r["tokens"] for r in res])


def constrained_checks(dev, model, tok, bodies: list, card: str) -> dict:
    """The equalities, with the card in f32 (B1's split-K variant at every
    row count, so a row's arithmetic does not depend on its batch): the
    wave of 8 with graphs and without; the 4 DFA rows and 4 free rows of a
    one-DFA wave under horizon 8 (device tables) and 1 (host masks); the
    wave's free rows served alone; every constrained row's tokens accepted
    by its grammar."""
    import torch

    from blazr_tpu_torch.models.registry import Model

    f32 = Model(model.cfg, card_f32(model.params), torch.float32)
    wave = wave_requests(tok, bodies)
    kinds = [k for k, _ in bodies]
    dfa_wave = (wave_requests(tok, bodies, ("free",)) * 2)[:4] + \
        wave_requests(tok, bodies, ("schema",)) * 2
    vocab, eos = tok.vocab_bytes(), tok.eos_token_id
    out = {}

    def run(engine, waves_):
        async def go():
            return [[r["tokens"] for r in await serve(engine, [w])] for w in waves_]
        return asyncio.run(go())
    on = constrained_engine(f32, tok)
    (wave_on, dfa_on, alone) = run(on, [wave, dfa_wave, wave[:2]])
    assert on.perf["grammar_uploads_n"] >= 1, dict(on.perf)
    del on
    free_card()
    off = constrained_engine(f32, tok, graphs=False)
    (wave_off,) = run(off, [wave])
    del off
    free_card()
    h1 = constrained_engine(f32, tok, horizon=1)
    (dfa_h1,) = run(h1, [dfa_wave])
    assert not h1._gram_dev, "horizon 1 took device tables"
    del h1
    free_card()
    for kind, toks in zip(kinds, wave_on):
        src = grammar_source(kind)
        assert src is None or accepted(src, toks, vocab, eos), (kind, toks)
    for toks in dfa_on[4:]:
        assert accepted(grammar_source("schema"), toks, vocab, eos), toks
    checks = {"graphs on == off (the wave of 8)": wave_on == wave_off,
              "horizon 8 (device tables) == 1 (host masks)": dfa_on == dfa_h1,
              "free rows alone == in the wave": alone == wave_on[:2]}
    for what, ok in checks.items():
        log(f"  card in f32: {what}: {'equal' if ok else 'DIFFERENT'}")
    assert all(checks.values()), checks
    out["checks"] = list(checks)
    del f32
    free_card()
    return out


def constrained_executor(ex, ckpt: Path, card: str) -> dict:
    """The Executor: a grammar (the step's mask variant) and mirostat (its
    raw-logits variant) in this process, then ``cli run`` with a grammar
    and mirostat at once as a subprocess; each reply inside its grammar."""
    import re

    from blazr_tpu_torch.config import GenerationConfig

    tok = ex.tokenizer
    prompt = tok.encode("the answer is")
    t0 = time.perf_counter()
    toks = [t.token_id for t in ex.generate(prompt, GenerationConfig(
        max_tokens=8, temperature=0.0, grammar=YES_NO))]
    assert accepted(YES_NO, toks, tok.vocab_bytes(), tok.eos_token_id), toks
    t1 = time.perf_counter()
    host = list(ex.generate(prompt, GenerationConfig(max_tokens=16, **HOST_SAMPLER)))
    assert len(host) > 0 and all(t.logprob is None for t in host)
    t2 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(TREE))
    proc = subprocess.run(
        [sys.executable, "-m", "blazr_tpu_torch.cli", "run", str(ckpt), "--prompt",
         "the answer is", "--max-tokens", "16", "--temperature", "0.8", "--seed", "3",
         "--grammar", CLI_GRAMMAR, "--mirostat", "2"],
        cwd=TREE, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t2
    assert proc.returncode == 0, proc.stderr[-4000:]
    text = proc.stdout.strip()
    assert re.fullmatch(r"answer: (yes|no)\.", text), (text, proc.stderr[-2000:])
    log(f"  Executor: yes/no greedy {toks} in {(t1 - t0) * 1e3:.0f} ms; mirostat+DRY+typical "
        f"{len(host)} tokens in {(t2 - t1) * 1e3:.0f} ms; cli run --grammar --mirostat 2: "
        f"{text!r} ({wall:.1f} s, the load included; {card})")
    return dict(cli_s=wall, cli_text=text)


def constrained_phase(dev, card: str, sched=None) -> dict:
    """Phase 7c (``constrained``): the PDA library built from the repo's
    source; phase 7's checkpoint (CONSTRAINED_LAYERS layers when the phase
    runs alone; phase 7b's loaded model in a full run) served as ``cli serve
    --continuous-batching`` serves it (warmed, prefix cache): a JSON-mode
    and a JSON-schema request alone, each twice (TTFT with the grammar's
    compile, then cached); the wave of 8 (``constrained_bodies``) at once
    over HTTP, every constrained reply inside its grammar (``yes``/``no``
    and the schema's JSON complete), B1 and B2 launched; ms a decode step of
    an 8-row wave of free rows, with 2 device-table (DFA) rows, and with a
    PDA and a host-sampler row in the side step (``wave_timing``); the
    equalities of ``constrained_checks`` with the card in f32; the DFA
    compile, ``token_tables`` and host mask seconds at the 32000-token
    vocabulary (``grammar_timers``); the Executor and ``cli run``."""
    import numpy as np
    import torch

    from blazr_tpu_torch import native
    from blazr_tpu_torch.engine.batch_engine import BatchEngine
    from blazr_tpu_torch.engine.grammar import (GrammarState, compile_grammar_to_dfa,
                                                make_grammar_state)
    from blazr_tpu_torch.engine.model_scheduler import ModelScheduler

    t_phase = time.perf_counter()
    out: dict = {}
    path = native.lib_path("pda")
    if path.exists():            # a copied build: build it on this machine
        path.unlink()
    t0 = time.perf_counter()
    native.load_library("pda")
    out["pda_build_s"] = time.perf_counter() - t0
    assert path.exists(), path
    log(f"  native/pda.cpp built with g++ from the checkout -> {path.name} in "
        f"{out['pda_build_s']:.2f} s")
    ckpt = http_checkpoint(HTTP_LAYERS if sched is not None else CONSTRAINED_LAYERS)
    t0 = time.perf_counter()
    handed = sched is not None
    sched = sched or ModelScheduler(ckpt, device=dev)
    ex = sched.get_executor("default")
    tok = ex.tokenizer
    inf = ex.app_cfg.inference
    inf.max_batch_size = 8
    inf.prefix_cache = True
    engine = BatchEngine(ex.model, tok, ex.app_cfg)
    warm_s = engine.warmup()
    layers = ex.model.num_layers
    log(f"  {'phase 7b' if handed else 'loaded'}'s {layers}-layer model warmed in "
        f"{time.perf_counter() - t0:.1f} s (warmup {warm_s:.1f} s); vocabulary "
        f"{len(tok.vocab_bytes())}")
    rng = np.random.default_rng(SEED + 19)
    texts = [_prompt_text(tok, int(n), rng) for n in rng.integers(48, 128, 8)]
    bodies = constrained_bodies(texts)
    with grammar_timers() as timers, http_server(sched, engine) as port:
        ttft = {}
        for kind in ("free", "json", "schema"):
            body = dict(next(b for k, b in bodies if k == kind), stream=True)
            for when in ("first", "cached", "cached", "cached"):
                n0 = len(timers["dfa_compile"])
                p0 = dict(engine.perf)
                r = _stream_chat(port, body)
                assert r["done"] and r["finish"], r
                ttft.setdefault(f"{kind}_{when}_ms", []).append((r["ttft"] or r["wall"]) * 1e3)
                compile_s = sum(timers["dfa_compile"][n0:])
                ms = {k: (engine.perf[k] - p0.get(k, 0.0)) * 1e3
                      for k in ("prefill", "p_finish", "decode")}
                log(f"  {kind} request alone, {when}: client TTFT {ttft[f'{kind}_{when}_ms'][-1]:.1f}"
                    f" ms (DFA compiles in it {compile_s:.2f} s), e2e {r['wall'] * 1e3:.1f} ms, "
                    f"{len(r['deltas'])} deltas; engine ms " +
                    ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
        out["ttft"] = ttft
        out["http"] = constrained_http(port, bodies, tok, card)
    vocab = tok.vocab_bytes()
    for kind in ("yes_no", "schema", "json"):
        st = make_grammar_state(grammar_source(kind), vocab, eos_token_id=tok.eos_token_id)
        dfa = compile_grammar_to_dfa(grammar_source(kind))
        tier = ("exact-PDA (host mask, side step)" if not isinstance(st, GrammarState) else
                "DFA, device tables" if dfa.num_states <= 512 else "DFA, host masks")
        log(f"  tier of {kind}: {tier}; its DFA {dfa.num_states} states "
            f"({'exact' if dfa.exact else 'depth-bounded'})")
    pda = make_grammar_state(grammar_source("json"), vocab, eos_token_id=tok.eos_token_id)
    for t in tok.encode('{"'):
        assert pda.accept_token(t)
    t0 = time.perf_counter()
    inside = pda.mask()
    out["pda_string_mask_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"  a PDA mask inside a JSON string (after '{{\"'): {out['pda_string_mask_ms']:.1f} ms, "
        f"{int(inside.sum())} of {len(inside)} tokens legal")
    out["timers"] = {k: (len(v), sum(v), median_ms(v)) for k, v in timers.items()}
    for key, (n, total, med) in out["timers"].items():
        log(f"  host {key}: {n} calls, {total:.3f} s in all, median {med:.3f} ms")
    tables = {h: (b[0].numel() * b[0].element_size() + b[1].numel() * b[1].element_size())
              for h, b in engine._gram_dev.items()}
    log(f"  device grammar tables: {[(h, round(n / 2**20, 1)) for h, n in tables.items()]} "
        f"(height, MiB), outside the KV pool")
    out["table_mib"] = sum(tables.values()) / 2**20
    del engine
    free_card()

    timing = constrained_engine(ex.model, tok)
    timing.warmup()
    free8 = wave_requests(tok, bodies, ("free",)) * 4
    dfa8 = free8[:6] + wave_requests(tok, bodies, ("schema",))
    side8 = free8[:6] + wave_requests(tok, bodies, ("json", "host"))
    for reqs in (free8, dfa8, side8):       # 8 horizon rounds of the free rows
        for _, g in reqs:
            g.max_tokens = 64
    for _, g in side8[6:]:                   # a side row takes one token a round
        g.max_tokens = 8

    async def waves():            # one event loop: the engine's event is bound to it
        got = {}
        for label, reqs in (("free rows only", free8), ("with 2 device-table rows", dfa8),
                            ("with a PDA and a host-sampler row", side8)):
            # First with the captures of the wave's new graph variants, then warm.
            await wave_timing(timing, reqs, label + ", first", card, 6)
            got[label] = await wave_timing(timing, reqs, label, card, 6)
        return got
    out["waves"] = asyncio.run(waves())
    del timing
    free_card()
    out.update(constrained_checks(dev, ex.model, tok, bodies, card))
    out["executor"] = constrained_executor(ex, ckpt, card)
    del sched, ex
    free_card()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  constrained phase: {out['phase_s']:.1f} s ({card}; {layers} layers)")
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
    # model's own gate+up weight: 8 calls profiled alone. A fresh trace drops
    # its first kernels, so 4 calls run first in the same window and only the
    # kernels that start inside the marked range of the 8 count.
    from blazr_tpu_torch.quant.int8 import qmm_int8
    gu = model.params["layers"][0]["gateup"]
    per_call = {m: b3_kernels_a_call(qmm_int8, gu, m, dev) for m in (1, 512)}
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


def b3_kernels_a_call(qmm_int8, w, m: int, dev, attempts: int = 3) -> float:
    """Device kernels a ``qmm_int8`` call on ``w`` launches at ``m`` rows: the
    kernels that start inside a ``record_function`` range around 8 calls,
    after 4 calls in the same profiler window. A window in which the
    profiler delivered no kernel of the 8 at all is taken again, up to
    ``attempts`` times (logged); 0 comes back only if every one was empty."""
    import torch

    x = torch.randn((m, w.in_features), device=dev).to(torch.bfloat16)
    tag = f"b3 alone m={m}"

    def calls(n):
        for _ in range(n):
            qmm_int8(x, w.qweight, w.scales, w.mins, bits=w.bits,
                     group_size=w.group_size, device=dev)
        torch.cuda.synchronize()

    seen = 0
    for attempt in range(attempts):
        prof, _ = start_profile()
        calls(4)
        with torch.profiler.record_function(tag):
            calls(8)
        prof.stop()
        events = list(prof.events())
        ranges = [e.time_range for e in events
                  if e.name == tag and e.device_type == torch.autograd.DeviceType.CPU]
        assert len(ranges) == 1, (tag, len(ranges))
        lo, hi = ranges[0].start, ranges[0].end
        seen = sum(e.device_type == torch.autograd.DeviceType.CUDA and e.name != tag
                   and lo <= e.time_range.start <= hi for e in events)
        if seen:
            break
        log(f"  {tag}: the profiler delivered no device kernel (attempt {attempt + 1} "
            f"of {attempts})")
    return seen / 8


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
FAMILY_SERVING = (("qwen3", 36, 4096, 2), ("gemma2", 42, 8192, 2))   # full run: 2, was 6
# The 2-layer forwards held to the CPU, 1 layer in a full run (the CPU's f32
# reference is host-bound); Gemma2 keeps 2 for its window check.
FAMILY_FORWARD_LAYERS = 2
FULL_RUN_FAMILY_FORWARD_LAYERS = 1
FAMILY_REQUEST_LENS = (64, 512, 200, 333, 128, 480, 96, 256)


def family_forwards(dev, depth: int = FAMILY_FORWARD_LAYERS) -> dict:
    """Phase 10, part 1: each dense family at its published width, ``depth``
    layers (Gemma2 always 2), written to disk in its HF layout (AWQ-INT4,
    group 128; Falcon plain bf16), loaded by load_model onto the card
    (bf16), a 64-token prefill and 4 decode steps against the port's CPU
    f32 forward on the same params; then Gemma2 past its window in a config
    copy whose window is cut to 64 (layer 0 slides, layer 1 does not). B1
    and B2 launches counted per family."""
    import shutil
    import tempfile

    import torch

    from blazr_tpu_torch.loader import load_model
    from blazr_tpu_torch.utils.synthetic import FAMILY_CONFIGS, write_hf_checkpoint

    out = {}
    with tempfile.TemporaryDirectory(prefix="families-") as root:
        for family, make in FAMILY_CONFIGS.items():
            cfg = make()
            cfg.num_layers = 2 if family == "gemma2" else depth
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
            assert counts["paged_attention"] == cfg.num_layers * 4, counts
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
            log(f"  {family}: {cfg.hidden_size}d, vocab {cfg.vocab_size}, {cfg.num_layers} "
                f"layers; "
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

        def counted_round(decodes, *args, inner=engine._horizon_round, engine=engine):
            c0, s0 = read_counts(), engine.horizon_steps
            inner(decodes, *args)
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
    out = {"forwards": family_forwards(
        dev, FULL_RUN_FAMILY_FORWARD_LAYERS if full_run else FAMILY_FORWARD_LAYERS)}
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
MOE_SERVING = (("mixtral", 32, 4096, 2), ("qwen3_moe", 48, 4096, 1))   # full run: was 4, 2
# A free-running forward with the card in f32 against the CPU f32: the same
# weights and arithmetic, f32 sums in another order (B1's split-K over K,
# B2's splits, cuBLAS's f32 GEMMs in attention): 1e-3 of the largest logit.
F32_FREE_TOL = 1e-3


def moe_b1(dev, gen) -> dict:
    """Phase 11 (a): B1 at every MoE expert shape and row count
    (MOE_B1_SHAPES x MOE_B1_ROWS; ``b1_at_shapes``)."""
    return b1_at_shapes(dev, gen, MOE_B1_SHAPES, MOE_B1_ROWS)


def b1_at_shapes(dev, gen, shapes: dict, row_counts: tuple) -> dict:
    """B1 against its plain version at each (K, N) of ``shapes`` and each row
    count (tolerance as phase 2's), then timed: kernel, bound, plain version
    and torch.matmul on the bf16-dequantized weight."""
    import torch

    from blazr_tpu_torch.quant.kernels import qmm, qmm_reference
    from blazr_tpu_torch.quant.qtensor import dequantize_planes

    rel_tol = 8e-3
    rows, worst = {}, 0.0
    for pname, spec in shapes.items():
        k, n, gs = (*spec, 128)[:3]           # (K, N) in groups of 128, or (K, N, group)
        qw, s, mn = rand_planes(k, n, 4, gs, gen, dev)
        w = dequantize_planes(qw, s, mn, 4, True, gs, torch.bfloat16)
        for m in row_counts:
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
            log(f"  B1 {pname} m={m} K={k} N={n} gs={gs}: max_abs_err {err:.4g} (tol {tol:.4g}); "
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
            setattr(m, name, lambda p, cfg, x, mixer, real=real, **kw: self.layer(
                p, cfg, x, mixer, real, **kw))
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

    def layer(self, p, cfg, x, attn, real=None, **kw):
        import torch

        real = real or self.real_layer
        if x.dtype != torch.float32:                   # the card's bf16 forward
            out = real(p, cfg, x, attn, **kw)
            self.queue.append((x.float().cpu(), out.float().cpu()))
            return out
        x_card, out_card = self._forced(x)
        out = real(p, cfg, x_card, attn, **kw)
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


# Depth of phase 11's reference checkpoints: 2 layers, 1 in a full run
# (the CPU f32 references are host-bound; every check stays).
MOE_FORWARD_LAYERS = 2
FULL_RUN_MOE_FORWARD_LAYERS = 1


def moe_forwards(dev, depth: int = MOE_FORWARD_LAYERS) -> dict:
    """Phase 11 (b): each MoE family at its published width, ``depth``
    layers, written to disk as an AWQ-INT4 checkpoint (group 128) in its HF layout
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
            cfg.num_layers = depth
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
            assert counts["paged_attention"] == depth * 4 and counts["qmm"] > 0, counts
            # A sanity floor: a broken router agrees on about k/E of its picks.
            assert tape.share >= 0.9, f"{family}: routing agreement {tape.share}"
            moe = model.cfg.moe
            log(f"  {family}: {cfg.hidden_size}d, {moe.num_experts} experts of "
                f"{moe.intermediate_size}, top-{moe.experts_per_tok}, {depth} layer(s); written in "
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
    (moe_forwards; 1 layer in a full run), then Mixtral-8x7B and
    Qwen3-30B-A3B served through the warmed engine (family_serving), at the
    depth MOE_SERVING gives a full run when ``full_run``. The kernels line
    takes its MoE row's launches from Mixtral's run with graphs."""
    out = {"b1": moe_b1(dev, gen), "forwards": moe_forwards(
        dev, FULL_RUN_MOE_FORWARD_LAYERS if full_run else MOE_FORWARD_LAYERS)}
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
FULL_RUN_GGUF_LAYERS = 2            # a full run's cut (PR 17, for phase 16's time)
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
    last = len(layers) - 1                  # llama.cpp's Q6_K layer at every depth
    weights = {f"{kind} L{i} ({layers[i][kind].fmt[5:].upper()})": layers[i][kind]
               for i, kind in ((0, "q"), (0, "k"), (0, "gate"), (0, "down"), (last, "v"),
                               (last, "down"))}
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
RECURRENT_SERVING = {"deepseek": (27, 4096, 2), "mamba2": (64, 4096, 2),   # full run: was 4
                     "bamba": (32, 4096, 2)}
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


# ---------------------------------------------------------------------------
# phase 15 (vision): image chats with LLaVA-1.5-7B
# ---------------------------------------------------------------------------

# B1 at LLaVA-1.5-7B's language-model projections (K, N): Llama-2-7B's q, k,
# v and o (one shape), gate and up (one shape) and down; its head is plain
# f16 in the AWQ checkpoint (cuBLAS). Rows: a decode step and an image
# chat's merged prefill (576 image rows and 24 text tokens).
LLAVA_B1_SHAPES = {"llava q/k/v/o": (4096, 4096), "llava gate/up": (4096, 11008),
                   "llava down": (11008, 4096)}
LLAVA_B1_ROWS = (1, 600)
VISION_TOKENS = 32                  # greedy tokens an image chat
VISION_TOWER_TOL = 1e-3             # the tower, card f32 vs CPU f32, of the largest output
# The mmproj form: a 2-layer text checkpoint and the tower's first 23 blocks,
# as llama.cpp's converter writes LLaVA-1.5's sidecar (feature layer -2).
VISION_MMPROJ_LAYERS, VISION_MMPROJ_BLOCKS = 2, 23


def write_png(rgb) -> bytes:
    """An RGB PNG of ``rgb`` [H, W, 3] uint8 with zlib alone, its rows
    filtered Sub, Up, Average and Paeth in turn (the decoder's slow path)."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = rgb.shape
    x = rgb.astype(np.int32)
    rows = []
    for r in range(h):
        t = 1 + r % 4
        cur, up = x[r], (x[r - 1] if r else np.zeros_like(x[r]))
        left = np.vstack([np.zeros((1, 3), np.int32), cur[:-1]])
        ul = np.vstack([np.zeros((1, 3), np.int32), up[:-1]])
        if t == 4:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        else:
            pred = (left, up, (left + up) >> 1)[t - 1]
        rows.append(bytes([t]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def vision_images() -> dict:
    """The phase's images: a 640x480 PNG written here (a smooth field and
    seeded noise), the repository's 640x480 baseline JPEG, and a GIF and a
    progressive JPEG that must be refused."""
    import numpy as np

    rng = np.random.default_rng(SEED + 15)
    y, x = np.mgrid[0:480, 0:640]
    field = np.stack([128 + 90 * np.sin(x / 37.0 + c) * np.cos(y / 23.0 + 2 * c)
                      for c in range(3)], -1)
    rgb = np.clip(field + rng.normal(0, 8, field.shape), 0, 255).astype(np.uint8)
    data = REPO / "tests" / "data"
    return {"png": write_png(rgb), "jpeg": (data / "vision_640x480.jpg").read_bytes(),
            "gif": (data / "vision.gif").read_bytes(),
            "progressive": (data / "vision_progressive.jpg").read_bytes()}


def host_preprocess(images: dict) -> dict:
    """Host ms per image: the decode alone and the whole ``preprocess_image``
    (decode, bicubic resize to 336, crop, normalise), median of 5."""
    from blazr_tpu_torch.utils.preprocess import decode_rgb, preprocess_image

    out = {}
    for kind in ("png", "jpeg"):
        data = images[kind]
        decode_rgb(data)                              # builds native/jpeg.cpp once
        dec, pre = [], []                             # seconds
        for _ in range(5):
            t0 = time.perf_counter()
            decode_rgb(data)
            dec.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            preprocess_image(data, 336)
            pre.append(time.perf_counter() - t0)
        out[kind] = dict(decode_ms=median_ms(dec), preprocess_ms=median_ms(pre),
                         bytes=len(data))
        log(f"  host {kind} 640x480 ({len(data)} B): decode {out[kind]['decode_ms']:.1f} ms, "
            f"preprocess_image(336) {out[kind]['preprocess_ms']:.1f} ms (median of 5)")
    return out


def vision_checkpoints(root: Path, layers: int) -> dict:
    """The two forms of LLaVA-1.5-7B at full width: an HF LLaVA directory
    (``layers`` layers of AWQ-INT4 Llama-2-7B, the whole f16 tower) and a
    VISION_MMPROJ_LAYERS-layer text checkpoint with an mmproj sidecar kept
    outside it (served with ``mmproj=``; without it the same directory is a
    text model), each with a 32064-token BPE tokenizer.json."""
    import dataclasses

    from blazr_tpu_torch.utils.synthetic import (llava_1_5_7b_config, write_bpe_tokenizer_json,
                                                 write_hf_checkpoint, write_llava_checkpoint,
                                                 write_mmproj_gguf)

    cfg = llava_1_5_7b_config()
    t0 = time.perf_counter()
    write_llava_checkpoint(root / "llava", dataclasses.replace(cfg, num_layers=layers),
                           seed=SEED)
    write_bpe_tokenizer_json(root / "llava", cfg.vocab_size, seed=SEED)
    t1 = time.perf_counter()
    write_hf_checkpoint(root / "text", dataclasses.replace(
        cfg, num_layers=VISION_MMPROJ_LAYERS, vision=None), seed=SEED)
    write_bpe_tokenizer_json(root / "text", cfg.vocab_size, seed=SEED)
    write_mmproj_gguf(root / "mmproj-llava-1.5-7b-f16.gguf", cfg.vision, cfg.hidden_size,
                      seed=SEED + 1, blocks=VISION_MMPROJ_BLOCKS)
    t2 = time.perf_counter()
    sizes = {k: sum(f.stat().st_size for f in (root / k).iterdir()) / 1e9
             for k in ("llava", "text")}
    log(f"  wrote the {layers}-layer HF LLaVA directory ({sizes['llava']:.2f} GB) in "
        f"{t1 - t0:.1f} s; the {VISION_MMPROJ_LAYERS}-layer text checkpoint "
        f"({sizes['text']:.2f} GB) and its F16 mmproj ({VISION_MMPROJ_BLOCKS} blocks, "
        f"{(root / 'mmproj-llava-1.5-7b-f16.gguf').stat().st_size / 1e9:.2f} GB) in "
        f"{t2 - t1:.1f} s")
    return dict(llava=root / "llava", text=root / "text",
                mmproj=root / "mmproj-llava-1.5-7b-f16.gguf", write_s=t2 - t0)


def vision_tower_check(dev, model, pixels) -> dict:
    """The tower at full width on the card (f32) against the CPU (f32) on one
    image at VISION_TOWER_TOL of the largest output; then its device ms per
    image at batch 1 and 4, beside its bound (f32 on the CUDA cores)."""
    import torch

    from blazr_tpu_torch.models.vision import encode_images, vision_flops

    params, vcfg = model.vision_params, model.vision_cfg
    x = torch.from_numpy(pixels[:1]).to(dev)
    got = encode_images(params, vcfg, x).cpu()
    t0 = time.perf_counter()
    ref = encode_images(to_cpu_f32(params), vcfg, x.cpu())
    cpu_s = time.perf_counter() - t0
    assert got.shape == ref.shape == (1, 576, 4096) and torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    tol = VISION_TOWER_TOL * ref.abs().max().item()
    assert err <= tol, f"tower: {err} > {tol}"
    out = dict(max_abs_err=err, tol=tol, cpu_s=cpu_s)
    nbytes = sum(t.numel() * 4 for t in _leaves(params))
    for n in (1, 4):
        xb = torch.from_numpy(pixels[[i % len(pixels) for i in range(n)]]).to(dev)
        ms = time_eager(lambda: encode_images(params, vcfg, xb), iters=5, warmup=1)
        bms, by = bound(nbytes + xb.numel() * 4 + n * 576 * 4096 * 4, vision_flops(vcfg, n),
                        H100_F32_FLOPS)
        out[f"batch{n}"] = dict(ms=ms, ms_per_image=ms / n, bound_ms=bms, bound_by=by)
        log(f"  tower (24 blocks, feature layer -2, f32) batch {n}: {ms / n:.2f} ms an image "
            f"on the card, bound {bms / n:.2f} ms ({by}, {vision_flops(vcfg) / 1e9:.0f} "
            f"GFLOP an image)")
    log(f"  tower card vs CPU f32: max_abs_err {err:.4g} (tol {tol:.4g}); CPU {cpu_s:.1f} s")
    return out


def _leaves(tree):
    import torch

    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def vision_forward_check(dev, model, hidden) -> dict:
    """The first 2 decoder layers and the head from the merged embeddings
    (an image's 576 rows and the text), the card (f16, B1) against the CPU
    (f32, the weights dequantized on the card): every position's hidden
    state and the last position's logits at 5e-2 of their largest."""
    import dataclasses

    import torch

    from blazr_tpu_torch.kvcache.contiguous import init_kv_cache
    from blazr_tpu_torch.models.llama import forward_head, forward_layers_range

    cfg = dataclasses.replace(model.cfg, num_layers=2)
    params = dict(model.params, layers=model.params["layers"][:2])
    cpu = to_cpu_f32(params, dense=True)
    t = hidden.shape[1]
    out = {}
    for name, d, pr, x, dt in (("gpu", dev, params, hidden, model.dtype),
                               ("cpu", torch.device("cpu"), cpu, hidden.float().cpu(),
                                torch.float32)):
        cache = init_kv_cache(2, 1, t + 1, cfg.attention.kv_heads(), model.head_dim, dtype=dt,
                              device=d)
        pos = torch.arange(t, device=d)[None]
        with torch.no_grad():
            h, _ = forward_layers_range(pr, cfg, x, cache, pos, 0, 2)
            logits = forward_head(pr, cfg, h[:, -1:])
        out[name] = (h.float().cpu(), logits.float().cpu())
    errs = {}
    for i, what in enumerate(("hidden", "logits")):
        g, c = out["gpu"][i], out["cpu"][i]
        assert g.shape == c.shape and torch.isfinite(g).all(), what
        errs[what] = ((g - c).abs().max() / c.abs().max()).item()
        assert errs[what] <= 5e-2, f"merged forward {what}: {errs[what]} > 5e-2"
    log(f"  2-layer forward from {t} merged rows, card f16 vs CPU f32: hidden "
        f"{errs['hidden']:.4g}, logits {errs['logits']:.4g} of the largest (tol 5e-2)")
    return errs


def vision_prefill_trace(ex, step, hidden, card: str) -> dict:
    """One merged prefill under torch.profiler: its device-busy ms, B1's
    share and the top device ops; then the Executor's attention alone at
    the prefill's shapes (``attend``: the T rows' queries over the whole
    cache, f32 sums, its mask and softmax), timed a layer and times the
    layers."""
    import torch

    from blazr_tpu_torch.models.layers import attend

    model = ex.model
    step.cache.length.zero_()
    wall, busy, events, names, _ = device_busy(lambda: ex.prefill_embeddings(step.cache,
                                                                             hidden))
    ops = top_ops(names, 8)
    b1 = sum(sec for name, (sec, _) in names.items() if short_name(name).startswith("qmm")
             or short_name(name) == "reduce_splits")
    t, heads, d = hidden.shape[1], model.cfg.attention.num_heads, model.head_dim
    kv_heads, cap = model.cfg.attention.kv_heads(), ex.capacity
    g = torch.Generator(device=model.device).manual_seed(SEED)
    q = torch.randn(1, t, heads, d, device=model.device, dtype=model.dtype, generator=g)
    k, v = (torch.randn(1, cap, kv_heads, d, device=model.device, dtype=model.dtype,
                        generator=g) for _ in range(2))
    pos = torch.arange(t, device=model.device)[None]
    kv_len = torch.tensor([t], device=model.device)
    attn_ms = time_eager(lambda: attend(q, k, v, q_positions=pos, kv_len=kv_len), iters=5,
                         warmup=1)
    out = dict(wall_ms=wall * 1e3, busy_ms=busy * 1e3, events=events, b1_ms=b1 * 1e3,
               attend_ms_layer=attn_ms, attend_ms=attn_ms * model.num_layers,
               top=[(n, sec * 1e3, calls) for n, (sec, calls) in ops])
    log(f"  profiled merged prefill ({t} rows, {model.num_layers} layers, cache of {cap}): "
        f"wall {out['wall_ms']:.2f} ms, device busy {out['busy_ms']:.2f} ms over {events} "
        f"device events, B1 {out['b1_ms']:.2f} ms ({card}; under the profiler)")
    log("  top device ops of the merged prefill: " + "; ".join(
        f"{n} {ms:.2f} ms/{calls}" for n, ms, calls in out["top"]))
    log(f"  attend over the whole cache at the prefill's shapes: {attn_ms:.3f} ms a layer, "
        f"{out['attend_ms']:.2f} ms for {model.num_layers} layers ({card})")
    return out


def vision_chats(dev, ex, images: dict, card: str) -> dict:
    """The Executor (decode graphs on, and a second one with them off):
    the merged prefill's device ms and B1 launches, and its trace; an
    image chat's TTFT (the clock started before the images are decoded)
    beside a text chat's with the same text, and ms a decode token; greedy
    image chats equal with graphs on and off."""
    import torch

    from blazr_tpu_torch.config import AppConfig, GenerationConfig
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.engine.executor_multimodal import MultimodalExecutor

    model, tok = ex.model, ex.tokenizer
    text = "Describe this picture in one short paragraph, naming its main colours."
    prompt = tok.encode(text)
    mm = MultimodalExecutor(ex, model.vision_params, model.vision_cfg)
    hidden = mm.merged_embeddings(prompt, [images["jpeg"]])
    out = dict(rows=hidden.shape[1], forward=vision_forward_check(dev, model, hidden))
    step, _ = ex._take(prompt, reuse=False)
    try:
        ex.prefill_embeddings(step.cache, hidden)
        torch.cuda.synchronize()
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step.cache.length.zero_()
        ex.prefill_embeddings(step.cache, hidden)
        end.record()
        torch.cuda.synchronize()
        out["prefill_ms"] = start.elapsed_time(end)
        out["prefill_qmm"] = read_counts()["qmm"]
        out["prefill_trace"] = vision_prefill_trace(ex, step, hidden, card)
    finally:
        ex._give_back(None, step)
    assert out["prefill_qmm"] == 7 * model.num_layers, out
    log(f"  merged prefill of {out['rows']} rows ({model.num_layers} layers): "
        f"{out['prefill_ms']:.2f} ms, {out['prefill_qmm']} B1 launches")

    def first_and_rest(start) -> tuple[list, float, float]:
        """``start()`` makes the generation; the clock runs from before it."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, t1 = [], None
        for g in start():
            toks.append(g.token_id)
            if t1 is None:
                t1 = time.perf_counter()
        t2 = time.perf_counter()
        return toks, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / max(1, len(toks) - 1)

    off_app = AppConfig.from_dict(ex.app_cfg.to_dict())
    off_app.inference.graphs = False
    ex_off = Executor(model, tok, off_app)
    runs = {}
    for graphs, e in ((True, ex), (False, ex_off), (False, ex_off), (True, ex)):
        m = MultimodalExecutor(e, model.vision_params, model.vision_cfg)
        for kind in ("png", "jpeg"):
            cfg = GenerationConfig(max_tokens=VISION_TOKENS, temperature=0.0)
            toks, ttft, per = first_and_rest(lambda: m.generate_multimodal(
                prompt, images=[images[kind]], gen_cfg=cfg))
            runs.setdefault((graphs, kind), []).append(dict(tokens=toks, ttft_ms=ttft,
                                                           ms_per_token=per))
        cfg = GenerationConfig(max_tokens=VISION_TOKENS, temperature=0.0)
        toks, ttft, per = first_and_rest(lambda: e.generate(prompt, cfg))
        runs.setdefault((graphs, "text"), []).append(dict(tokens=toks, ttft_ms=ttft,
                                                         ms_per_token=per))
    for kind in ("png", "jpeg", "text"):
        streams = [r["tokens"] for g in (True, False) for r in runs[(g, kind)]]
        assert all(s == streams[0] for s in streams), f"{kind}: graphs on != off"
        assert len(streams[0]) == VISION_TOKENS, kind
    warm = {k: runs[(True, k)][-1] for k in ("png", "jpeg", "text")}
    out.update(ttft_ms={k: v["ttft_ms"] for k, v in warm.items()},
               ms_per_token={k: v["ms_per_token"] for k, v in warm.items()},
               ms_per_token_off={k: runs[(False, k)][-1]["ms_per_token"]
                                 for k in ("png", "jpeg", "text")})
    log(f"  Executor, graphs on (the second pass): TTFT image, host decode and tower included, "
        f"(PNG) {warm['png']['ttft_ms']:.1f}"
        f" / (JPEG) {warm['jpeg']['ttft_ms']:.1f} ms vs text {warm['text']['ttft_ms']:.1f} ms; "
        f"ms a decode token {warm['png']['ms_per_token']:.3f} (image) / "
        f"{warm['text']['ms_per_token']:.3f} (text); graphs off "
        f"{out['ms_per_token_off']['png']:.3f}; greedy streams equal on/off ({card})")
    return out


def _image_chat(url: str, text: str, stream: bool = False) -> dict:
    return {"messages": [{"role": "user", "content": [
        {"type": "text", "text": text}, {"type": "image_url", "image_url": {"url": url}}]}],
        "max_tokens": VISION_TOKENS, "temperature": 0, "stream": stream}


def _data_uri(data: bytes, mime: str) -> str:
    import base64

    return f"data:{mime};base64," + base64.b64encode(data).decode()


def vision_http(dev, sched, images: dict, card: str) -> dict:
    """The model behind the port's HTTP server with the batch engine (not
    warmed; its prefix cache off, so that the text chat sent twice
    prefills twice: a whole-prompt hit recomputes the last token on other
    shapes, and f16 greedy tokens may then differ): a text chat (the
    engine), a PNG chat and a streamed JPEG chat (the Executor), the text
    chat again (the same reply), a GIF, a progressive JPEG and an audio
    part (400). Each image reply equals the same request through the
    Executor in-process; ``/metrics`` counts every reply's tokens. Then a
    wave of text chats alone and beside two image chats at once
    (``vision_concurrent``). Launch counts are set to 0 just before and
    read just after."""
    from blazr_tpu_torch.engine.batch_engine import BatchEngine
    from blazr_tpu_torch.engine.executor_multimodal import MediaBoundExecutor, MultimodalExecutor
    from blazr_tpu_torch.engine.generate_text import collect_generation
    from blazr_tpu_torch.server.api_types import gen_config_from_body
    from blazr_tpu_torch.server.app import _build_prompt

    ex = sched.get_executor("default")
    engine = BatchEngine(ex.model, ex.tokenizer, ex.app_cfg)
    assert engine.prefix_cache is None
    text = "Describe this picture in one short paragraph, naming its main colours."
    png_req = _image_chat(_data_uri(images["png"], "image/png"), text)
    jpeg_req = _image_chat(_data_uri(images["jpeg"], "image/jpeg"), text, stream=True)
    text_req = {"messages": [{"role": "user", "content": text}],
                "max_tokens": VISION_TOKENS, "temperature": 0}
    audio_req = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": text},
        {"type": "input_audio", "input_audio": {"data": "AAAA", "format": "pcm16"}}]}],
        "max_tokens": 4}
    want = {}                                         # the Executor in-process
    for kind, req in (("png", png_req), ("jpeg", jpeg_req)):
        cfg = gen_config_from_body(req, ex.app_cfg.generation)
        ids = ex.tokenizer.encode(_build_prompt(req, ex.model.cfg))
        mm = MediaBoundExecutor(MultimodalExecutor(ex, ex.model.vision_params,
                                                   ex.model.vision_cfg), [images[kind]], [])
        want[kind] = collect_generation(mm, ids, cfg)
    out: dict = {}
    sent = 0                                          # completion tokens sent back
    reset_counts()
    with http_server(sched, engine) as port:
        st, body = _http(port, "POST", "/v1/chat/completions", text_req)
        assert st == 200, (st, body)
        text_reply = json.loads(body)["choices"][0]["message"]["content"]
        sent += json.loads(body)["usage"]["completion_tokens"]
        t0 = time.perf_counter()
        st, body = _http(port, "POST", "/v1/chat/completions", png_req)
        out["png_e2e_ms"] = (time.perf_counter() - t0) * 1e3
        assert st == 200, (st, body)
        png_reply = json.loads(body)
        streamed = _stream_chat(port, jpeg_req)
        assert streamed["done"] and streamed["role"] == "assistant", streamed
        out["jpeg_stream_ttft_ms"] = streamed["ttft"] * 1e3
        out["jpeg_stream_e2e_ms"] = streamed["wall"] * 1e3
        st, body = _http(port, "POST", "/v1/chat/completions", text_req)
        assert st == 200 and json.loads(body)["choices"][0]["message"]["content"] \
            == text_reply, "the text chat changed around the image chats"
        sent += json.loads(body)["usage"]["completion_tokens"]
        refused = {}
        for name, req in (("gif", _image_chat(_data_uri(images["gif"], "image/gif"), text)),
                          ("progressive", _image_chat(_data_uri(
                              images["progressive"], "image/jpeg"), text)),
                          ("audio", audio_req)):
            st, body = _http(port, "POST", "/v1/chat/completions", req)
            assert st == 400, (name, st, body)
            refused[name] = json.loads(body)["error"]["message"]
        st, body = _http(port, "GET", "/metrics")
        assert st == 200
        generated = parse_metrics(body.decode())[("blazr_tpu_tokens_generated_total", ())]
        out["concurrent"] = vision_concurrent(port, png_req, dict(jpeg_req, stream=False),
                                              text_req, want, card)
    out.update(read_counts())
    assert out["qmm"] > 0 and out["paged_attention"] > 0, out
    sent += png_reply["usage"]["completion_tokens"] + len(want["jpeg"].tokens)
    assert generated == sent, (generated, sent)
    for kind, got in (("png", png_reply["choices"][0]["message"]["content"]),
                      ("jpeg", "".join(streamed["deltas"]))):
        assert got == want[kind].text, (kind, got[:200], want[kind].text[:200])
    log(f"  HTTP (batch engine on): PNG chat e2e {out['png_e2e_ms']:.1f} ms, streamed JPEG "
        f"chat TTFT {out['jpeg_stream_ttft_ms']:.1f} ms / e2e {out['jpeg_stream_e2e_ms']:.1f} "
        f"ms; both equal the Executor in-process; the text chat unchanged; 400 for "
        f"{sorted(refused)}; /metrics {generated:.0f} tokens; launches B1 {out['qmm']}, "
        f"B2 {out['paged_attention']} ({card})")
    out["refused"] = refused
    return out


VISION_WAVE_TEXT_CHATS = 4


def vision_concurrent(port: int, png_req: dict, jpeg_req: dict, text_req: dict, want: dict,
                      card: str) -> dict:
    """A wave of VISION_WAVE_TEXT_CHATS text chats (the batch engine) alone,
    twice (the first pass carries the wave's graph captures; the second is
    the baseline), then the same wave with two image chats sent at once
    beside it: the
    server runs the image chats on the Executor one at a time, each reply
    equal to the Executor in-process; the text chats answer 200 with
    VISION_TOKENS tokens. Each reply's e2e, and the card's allocated
    memory before and after the mixed wave."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    texts = [(f"text{i}", text_req) for i in range(VISION_WAVE_TEXT_CHATS)]
    reqs = [("png", png_req), ("jpeg", jpeg_req)] + texts

    def send(item):
        t0 = time.perf_counter()
        st, body = _http(port, "POST", "/v1/chat/completions", item[1])
        return item[0], st, body, (time.perf_counter() - t0) * 1e3

    for _ in range(2):
        with ThreadPoolExecutor(len(texts)) as pool:
            alone = list(pool.map(send, texts))
    assert all(st == 200 and json.loads(body)["usage"]["completion_tokens"] == VISION_TOKENS
               for _, st, body, _ in alone), alone
    alone_ms = sorted(ms for _, _, _, ms in alone)
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(reqs)) as pool:
        got = list(pool.map(send, reqs))
    wall = (time.perf_counter() - t0) * 1e3
    e2e = {}
    for name, st, body, ms in got:
        assert st == 200, (name, st, body)
        reply = json.loads(body)
        e2e[name] = ms
        if name in want:
            assert reply["choices"][0]["message"]["content"] == want[name].text, name
        else:
            assert reply["usage"]["completion_tokens"] == VISION_TOKENS, reply["usage"]
    mem1 = torch.cuda.memory_allocated()
    text_ms = sorted(v for k, v in e2e.items() if k.startswith("text"))
    log(f"  HTTP, two image chats at once beside {VISION_WAVE_TEXT_CHATS} text chats: wall "
        f"{wall:.1f} ms; e2e PNG {e2e['png']:.1f} / JPEG {e2e['jpeg']:.1f} ms (one at a time "
        f"on the Executor; both equal the Executor in-process), text {text_ms[0]:.1f}-"
        f"{text_ms[-1]:.1f} ms (the wave alone, warm, {alone_ms[0]:.1f}-{alone_ms[-1]:.1f} ms); "
        f"allocated {mem0 / 2**30:.2f} -> {mem1 / 2**30:.2f} GiB ({card})")
    return dict(wall_ms=wall, e2e_ms=e2e, text_alone_ms=alone_ms,
                mem_gib=(mem0 / 2**30, mem1 / 2**30))


def vision_mmproj(dev, ckpts: dict, images: dict) -> dict:
    """The mmproj form: the text checkpoint alone answers an image chat with
    400 (a text model, before any fetch); with ``mmproj=`` (``serve
    --mmproj``) it attaches the sidecar's 23 blocks and answers 200."""
    from blazr_tpu_torch.engine.model_scheduler import ModelScheduler

    req = _image_chat(_data_uri(images["png"], "image/png"), "What is in this image?")
    out = {}
    for name, mmproj in (("text", None), ("mmproj", str(ckpts["mmproj"]))):
        sched = ModelScheduler(ckpts["text"], device=dev, mmproj=mmproj)
        ex = sched.get_executor("default")
        assert ex.model.is_multimodal == (mmproj is not None)
        with http_server(sched, None) as port:
            st, body = _http(port, "POST", "/v1/chat/completions", req)
        out[name] = st
        if mmproj is not None:
            assert st == 200 and ex.model.vision_cfg.num_layers == VISION_MMPROJ_BLOCKS, body
        else:
            assert st == 400 and b"does not support" in body, body
        del sched, ex
        free_card()
    log(f"  text checkpoint: an image chat answers {out['text']}; with its mmproj sidecar "
        f"({VISION_MMPROJ_BLOCKS} blocks) {out['mmproj']}")
    return out


def vision_phase(dev, gen, card: str, full_run: bool) -> dict:
    """Phase 15: B1 at LLaVA-1.5-7B's shapes against its plain version and
    timed; the two checkpoint forms written; the host's image preprocessing
    timed; the HF LLaVA directory loaded as ``cli serve`` loads it (f16,
    the tower f32) at FULL_RUN_HTTP_LAYERS layers in a full run (32 alone):
    the tower and a 2-layer merged forward held to the CPU, the Executor's
    image chats (graphs on and off), the HTTP route, then the mmproj form."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from blazr_tpu_torch.engine.model_scheduler import ModelScheduler
    from blazr_tpu_torch.utils.preprocess import preprocess_image

    out = {"b1": b1_at_shapes(dev, gen, LLAVA_B1_SHAPES, LLAVA_B1_ROWS)}
    images = vision_images()
    out["host"] = host_preprocess(images)
    layers = FULL_RUN_HTTP_LAYERS if full_run else 32
    root = Path(tempfile.mkdtemp(prefix="blazr_llava_"))
    try:
        ckpts = vision_checkpoints(root, layers)
        t0 = time.perf_counter()
        sched = ModelScheduler(ckpts["llava"], device=dev)
        ex = sched.get_executor("default")
        torch.cuda.synchronize()
        model = ex.model
        out["load_s"] = time.perf_counter() - t0
        vcfg = model.vision_cfg
        assert model.is_multimodal and model.dtype == torch.float16
        assert (vcfg.hidden_act, vcfg.feature_layer, vcfg.num_layers) == ("quick_gelu", -2, 24)
        log(f"  loaded the {layers}-layer LLaVA-1.5-7B (AWQ-INT4 f16, tower f32) in "
            f"{out['load_s']:.1f} s; {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
            "allocated")
        pixels = np.stack([preprocess_image(images[k], 336) for k in ("png", "jpeg")])
        out["tower"] = vision_tower_check(dev, model, pixels)
        out["chats"] = vision_chats(dev, ex, images, card)
        out["http"] = vision_http(dev, sched, images, card)
        del sched, ex, model
        free_card()
        out["mmproj"] = vision_mmproj(dev, ckpts, images)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out.update(qmm=out["http"]["qmm"], paged_attention=out["http"]["paged_attention"])
    return out


# ---------------------------------------------------------------------------
# phase 16: speculative decoding
# ---------------------------------------------------------------------------

FULL_RUN_SPEC_LAYERS = 2            # --phases build,spec serves all 32 (was 4)
FULL_RUN_SPEC_DRAFT_LAYERS = 2      # the TinyLlama-width draft's 22, cut alike
SPEC_CLI_LAYERS = 1                 # the checkpoint cli run and cli serve load (5 times)
SPEC_K = 5                          # num_speculative_tokens
SPEC_TOKENS = 64                    # greedy tokens a request
SPEC_TIE = 1e-4                     # the one allowed parting: a plain top-2 logit gap below it
# The B1 shapes of the verify step (8 rows x (k+1) = 48 rows).
SPEC_B1_ROWS = (48,)


def tinyllama_config():
    """TinyLlama-1.1B's published widths (TinyLlama/TinyLlama-1.1B-intermediate-
    step-1431k-3T config.json): Llama-2's 32,000-token vocabulary, so it can
    draft for Mistral-7B."""
    from blazr_tpu_torch.config.model_config import AttentionConfig, UniversalConfig

    return UniversalConfig(
        model_type="llama", vocab_size=32000, hidden_size=2048, num_layers=22,
        max_seq_len=2048, intermediate_size=5632, rms_norm_eps=1e-5,
        attention=AttentionConfig(num_heads=32, num_kv_heads=4, head_dim=64,
                                  rope_theta=10000.0))


def spec_prompts(rng, n: int = 8) -> list:
    """``n`` extractive prompts of 256-512 tokens: a passage of 64-128
    tokens, other text around it, then its first 16 or more tokens quoted
    again at the end (the traffic prompt lookup drafts from)."""
    out = []
    for _ in range(n):
        total = int(rng.integers(256, 513))
        passage = rng.integers(3, 32000, int(rng.integers(64, 129))).tolist()
        quote = passage[:int(rng.integers(16, len(passage)))]
        other = rng.integers(3, 32000, total - len(passage) - len(quote)).tolist()
        cut = int(rng.integers(0, len(other) + 1))
        out.append(other[:cut] + passage + other[cut:] + quote)
    return out


def spec_greedy():
    from blazr_tpu_torch.config import GenerationConfig

    return GenerationConfig(max_tokens=SPEC_TOKENS, temperature=0.0, repeat_penalty=1.0)


def spec_engine(model, tok, spec: bool, draft=None):
    """The BatchEngine as ``serve --continuous-batching`` builds it (max batch
    8, block 64, horizon 8, graphs on), speculating with k = SPEC_K under
    ``spec`` (a draft model's chain with ``draft``, else prompt lookup)."""
    from blazr_tpu_torch.config import AppConfig
    from blazr_tpu_torch.config.inference import SpeculativeDecodingConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine

    app = AppConfig(model=model.cfg)
    app.inference.max_batch_size = 8
    if spec:
        app.inference.speculative = SpeculativeDecodingConfig(num_speculative_tokens=SPEC_K)
    return BatchEngine(model, tok, app, draft_model=draft)


def top2_gap(model, ids: list) -> float:
    """The top-2 logit gap of ``model``'s next token after ``ids`` (one
    contiguous forward)."""
    import torch

    dev = model.device
    cache = model.init_cache(1, len(ids) + 1)
    logits, _ = model.forward(torch.tensor([ids], device=dev), cache,
                              torch.arange(len(ids), device=dev)[None])
    top = logits[0, -1].float().topk(2).values
    return float(top[0] - top[1])


def record_drafts(engine) -> list:
    """Wrap the engine's draft chain: each round's rows as (seq id, length)
    and its [bmax, k] drafts."""
    rounds: list = []
    inner = engine._device_drafts

    def wrapped(rows):
        drafts = inner(rows)
        rounds.append(([None if s is None else (s.seq_id, s.total_len) for s in rows],
                       drafts.copy()))
        return drafts
    engine._device_drafts = wrapped
    return rounds


def rejections(rounds: list, seqs: dict) -> list:
    """(seq id, position) of each round's first draft that the final stream
    (``seqs``: id -> prompt + tokens) does not take: where a row rejected
    its draft. Drafts past a stream's end are never compared (there the
    budget cut them)."""
    out = []
    for rows, drafts in rounds:
        for i, row in enumerate(rows):
            if row is None or row[0] not in seqs:
                continue
            sid, total = row
            toks = seqs[sid]
            for j, d in enumerate(drafts[i]):
                if total + j >= len(toks):
                    break
                if int(d) != toks[total + j]:
                    out.append((sid, total + j))
                    break
    return out


def spec_checks(dev, model, tok, prompts: list, card: str) -> dict:
    """The equalities, the card in f32 (B1's split-K variant at every row
    count): a greedy wave and a mixed wave (a seeded sampled row, a
    DFA-grammar row, a logprobs row beside 5 greedy rows), served with
    prompt lookup and with an identical-weights draft (the target's own
    params, its own cache), equal the same engine's with speculation off on
    every row; the identical draft accepts every draft. The one difference
    allowed is an exact tie in rounding (the verify's 48-row products may
    sum in another order than a decode step's): where a stream parts from
    the plain one, or the identical draft is rejected, the plain run's top-2
    logit gap there is printed and must be below SPEC_TIE. No graph but a
    grammar table's horizon step is captured after warmup."""
    import torch

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.models.registry import Model

    f32 = Model(model.cfg, card_f32(model.params), torch.float32)
    greedy = [(p, spec_greedy()) for p in prompts]
    mixed = greedy[:5] + [
        (prompts[5], GenerationConfig(max_tokens=SPEC_TOKENS, temperature=0.8, seed=11)),
        (prompts[6], GenerationConfig(max_tokens=16, temperature=0.0, repeat_penalty=1.0,
                                      grammar=YES_NO)),
        (prompts[7], GenerationConfig(max_tokens=SPEC_TOKENS, temperature=0.0,
                                      repeat_penalty=1.0, logprobs=True, top_logprobs=5))]
    waves = {"greedy": greedy, "mixed": mixed}
    streams, out = {}, {}
    for name, spec, draft in (("plain", False, None), ("lookup", True, None),
                              ("draft", True, f32)):
        eng = spec_engine(f32, tok, spec, draft)
        eng.warmup()
        before = set(eng.graphs._graphs)
        rounds = record_drafts(eng) if draft is not None else None

        async def go():
            return {w: await serve(eng, [reqs]) for w, reqs in waves.items()}
        recs = asyncio.run(go())
        streams[name] = {w: [r["tokens"] for r in rs] for w, rs in recs.items()}
        late = [key for key in set(eng.graphs._graphs) - before
                if not (isinstance(key[0], int) and key[4] is not None)]
        assert not late, f"{name}: graphs captured after warmup {late}"
        out[name] = dict(drafted=eng.spec_drafted, accepted=eng.spec_accepted)
        if rounds is not None:
            # The rows that draft: the greedy ones without logprobs or a grammar.
            seqs = {r["handle"].seq_id: list(reqs[i][0]) + r["tokens"]
                    for w, reqs in waves.items() for i, r in enumerate(recs[w])
                    if reqs[i][1].temperature == 0.0 and not reqs[i][1].logprobs
                    and not reqs[i][1].grammar}
            out[name]["rejections"] = [
                (w, i, pos - len(reqs[i][0])) for sid, pos in rejections(rounds, seqs)
                for w, reqs in waves.items() for i, r in enumerate(recs[w])
                if r["handle"].seq_id == sid]
        del eng
        free_card()
    ties = []
    for name in ("lookup", "draft"):
        for w, reqs in waves.items():
            for i, (got, want) in enumerate(zip(streams[name][w], streams["plain"][w])):
                if got == want:
                    continue
                t = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                         min(len(got), len(want)))
                gap = top2_gap(f32, list(reqs[i][0]) + want[:t])
                log(f"  card in f32: {name}, {w} wave, row {i} parts from the plain run at "
                    f"token {t}: the plain run's top-2 logit gap there {gap:.3g}")
                ties.append(gap)
                assert gap < SPEC_TIE, (name, w, i, t, gap)
    d = out["draft"]
    for w, i, t in d["rejections"]:
        gap = top2_gap(f32, list(waves[w][i][0]) + streams["plain"][w][i][:t])
        log(f"  card in f32: the identical draft was rejected in the {w} wave, row {i}, at "
            f"token {t}: the plain run's top-2 logit gap there {gap:.3g}")
        ties.append(gap)
        assert gap < SPEC_TIE, (w, i, t, gap)
    assert (d["accepted"] == d["drafted"]) == (not d["rejections"]), d
    assert d["drafted"] > 0 and out["lookup"]["drafted"] > 0, out
    log(f"  card in f32: prompt lookup and the identical draft == speculation off on every "
        f"row of the greedy and the mixed wave ({len(ties) - len(d['rejections'])} partings, "
        f"each at an exact tie); the identical draft accepted {d['accepted']} of "
        f"{d['drafted']} ({len(d['rejections'])} rejections, each at an exact tie); prompt "
        f"lookup {out['lookup']['accepted']} of {out['lookup']['drafted']}; no graph but "
        f"grammar tables' captured after warmup")
    out["ties"] = ties
    out["distinct"] = [len(set(t)) for t in streams["plain"]["greedy"]]
    log(f"  card in f32: distinct tokens in each greedy stream of {SPEC_TOKENS}: "
        f"{out['distinct']} (random weights)")
    del f32
    free_card()
    return out


async def profiled_decode(engine, reqs: list, profile: bool) -> tuple[list, tuple]:
    """Serve ``reqs`` at once; with ``profile`` the profiler window opens once
    every request has its first token (the prefills done), so it holds
    decode rounds only."""
    task = asyncio.create_task(engine.run())
    recs = []

    async def consume(rec):
        async for t in rec["handle"].tokens():
            if rec["ttft"] is None:
                rec["ttft"] = time.perf_counter() - rec["t_submit"]
                rec["first"].set()
            rec["tokens"].append(t.token_id)
        rec["t_done"] = time.perf_counter()

    for prompt, gen in reqs:
        recs.append(dict(handle=engine.submit(prompt, gen), t_submit=time.perf_counter(),
                         ttft=None, tokens=[], first=asyncio.Event()))
    consumers = [asyncio.create_task(consume(r)) for r in recs]
    await asyncio.wait_for(asyncio.gather(*[r["first"].wait() for r in recs]), 600)
    prof, t0 = start_profile() if profile else (None, None)
    await asyncio.wait_for(asyncio.gather(*consumers), 900)
    window = stop_profile(prof, t0) if profile else None
    engine.stop()
    await task
    return recs, window


def replay_ms(engine, key, iters: int = 20) -> float:
    """Device time (ms) of one replay of the engine's captured graph ``key``
    (a step that reads no step counter: the verify step, spec_finish, the
    chain)."""
    import torch

    graph = engine.graphs._graphs[key][0]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def decode_step_ms(engine, bmax: int = 8, rounds: int = 4) -> float:
    """Device time (ms) of one plain decode step at ``bmax`` rows: whole
    rounds of the horizon graph replayed over the last round's table, its
    step counter set back to 0 before each round (a step writes its output
    at that index)."""
    import torch

    step = engine._step(bmax)
    graph = engine.graphs._graphs[(bmax, False, False, False, None, False, False)][0]
    tab0 = step.tab.clone()
    tab0[:, step.lay["i"]] = 0
    horizon = step.out[False].shape[0]

    def one_round():
        step.tab.copy_(tab0)
        for _ in range(horizon):
            graph.replay()
    one_round()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        one_round()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * horizon)


def spec_wave(engine, reqs: list, label: str, card: str, steps_key: str) -> dict:
    """``reqs`` at once through a warmed engine, twice: first timed, with the
    launch counts set to 0 just before and read just after (decode tokens/s,
    ms a round, ms a token a row, speculation's counters, the host gap from
    a round's read to the next round's first replay), then with its decode
    rounds profiled (the device idle share under the profiler)."""
    import torch

    p0 = dict(engine.perf)
    d0, a0 = engine.spec_drafted, engine.spec_accepted
    s0 = engine.horizon_steps
    got: dict = {}

    async def waves():            # one event loop: the engine's event is bound to it
        reset_counts()
        recs, _ = await profiled_decode(engine, reqs, profile=False)
        torch.cuda.synchronize()
        got.update(launches=read_counts(), perf=dict(engine.perf),
                   drafted=engine.spec_drafted, accepted=engine.spec_accepted,
                   steps=engine.horizon_steps)
        _, window = await profiled_decode(engine, reqs, profile=True)
        return recs, window
    recs, window = asyncio.run(waves())
    launches = got["launches"]
    perf = {k: got["perf"][k] - p0.get(k, 0.0) for k in got["perf"]}
    decoded = sum(len(r["tokens"]) - 1 for r in recs)
    span = max(r["t_done"] for r in recs) - max(r["t_submit"] + r["ttft"] for r in recs)
    rounds = perf.get(steps_key + "_n", 0)
    out = dict(tok_s=decoded / span, decoded=decoded, rounds=rounds,
               ms_round=perf.get(steps_key, 0.0) / max(rounds, 1) * 1e3,
               b1=launches["qmm"], b2=launches["paged_attention"],
               drafted=got["drafted"] - d0, accepted=got["accepted"] - a0,
               steps=got["steps"] - s0,
               gap_ms=perf.get("spec_gap", 0.0) / max(perf.get("spec_gap_n", 0), 1) * 1e3,
               streams=[r["tokens"] for r in recs])
    wall, busy = window[0], window[1]
    out.update(idle=1 - busy / wall if busy > 0 else None, profiled_wall_s=wall,
               profiled_busy_s=busy)
    acc = out["accepted"] / out["drafted"] if out["drafted"] else 0.0
    log(f"  {label}: {out['tok_s']:.1f} decode tok/s over {decoded} tokens, {rounds:.0f} "
        f"rounds of {out['ms_round']:.2f} ms"
        + (f" ({out['steps']} horizon steps, "
           f"{perf.get('decode', 0.0) * 1e3 / max(out['steps'], 1):.2f} ms a step)"
           if steps_key == "decode" else
           f"; accepted {out['accepted']} of {out['drafted']} drafts ({acc:.2f}), "
           f"{decoded / max(rounds, 1):.2f} tokens emitted a verify (of up to 8 rows), host "
           f"{out['gap_ms']:.2f} ms from a round's read to the next round's first replay")
        + f"; B1 {out['b1']}, B2 {out['b2']}; profiled again: decode window {wall:.3f} s, "
        f"device busy {busy:.3f} s, idle share "
        + (f"{out['idle']:.3f}" if out["idle"] is not None else "not measured")
        + f" ({card})")
    return out


def spec_b2(dev, gen, ctx: list) -> dict:
    """B2 as the verify step calls it (8 rows of ``ctx`` keys before k+1 =
    6 query positions, each row's 64-slot table repeated, ``position + 1``
    keys; Mistral's 32/8 heads, D 128, window 4096, bf16) against its plain
    version, and timed beside the engine's plain gather form (``attend`` over
    each row's whole table) and SDPA over the gathered KV with a causal
    mask."""
    import torch
    import torch.nn.functional as F

    from blazr_tpu_torch.attention.paged_attention import (
        paged_attention_decode, paged_attention_reference)
    from blazr_tpu_torch.kvcache.paged import page_slot_index
    from blazr_tpu_torch.models.layers import attend

    h_q, h_kv, d, bs, window, k1 = 32, 8, 128, 64, 4096, SPEC_K + 1
    b = len(ctx)
    s = pa_inputs(dev, gen, b=b, h_q=h_q, h_kv=h_kv, d=d, bs=bs,
                  seq_lens=[c + k1 for c in ctx], width=64)
    pos = torch.tensor([[c + j for j in range(k1)] for c in ctx], device=dev)
    lens = (pos + 1).reshape(-1).to(torch.int32)
    q = torch.randn((b * k1, h_q, d), device=dev, generator=gen).to(torch.bfloat16)
    tables = s["bt"].repeat_interleave(k1, dim=0)
    kw = dict(block_size=bs, sliding_window=window)
    got = paged_attention_decode(q, s["kc"], s["vc"], tables, lens, num_blocks=s["nb"],
                                 device=dev, **kw)
    ref = paged_attention_reference(q.float(), s["kc"], s["vc"], tables, lens, **kw)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    tol = 1e-2 * max(1.0, ref.abs().max().item())
    assert torch.isfinite(got).all() and err <= tol, (err, tol)
    ms = time_ms(lambda: paged_attention_decode(q, s["kc"], s["vc"], tables, lens,
                                                num_blocks=s["nb"], device=dev, **kw),
                 iters=50)
    plain_ms = time_eager(lambda: paged_attention_reference(q, s["kc"], s["vc"], tables,
                                                            lens, **kw), iters=3, warmup=1)
    idx = page_slot_index(bs, s["bt"])                               # [B, 64 x 64]
    q4 = q.reshape(b, k1, h_q, d)
    kv_len = torch.tensor([c + k1 for c in ctx], dtype=torch.int32, device=dev)
    gather_ms = time_ms(lambda: attend(q4, s["kc"][idx], s["vc"][idx], q_positions=pos,
                                       kv_len=kv_len, sliding_window=window), iters=10)
    k = s["kc"][idx].permute(0, 2, 1, 3).contiguous()                # [B, H_kv, S, D]
    v = s["vc"][idx].permute(0, 2, 1, 3).contiguous()
    kv_pos = torch.arange(k.shape[2], device=dev)
    mask = (kv_pos[None, None, :] <= pos[:, :, None])[:, None]       # [B, 1, k+1, S]
    qs = q4.permute(0, 2, 1, 3)                                      # [B, H_q, k+1, D]
    try:
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask, enable_gqa=True), iters=50)
    except TypeError:                    # PyTorch without enable_gqa
        ke, ve = (x.repeat_interleave(h_q // h_kv, dim=1) for x in (k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ke, ve, attn_mask=mask), iters=50)
    keys = sum(c + k1 for c in ctx)
    nbytes = 2 * keys * h_kv * d * 2 + 2 * q.numel() * 2 + s["bt"].numel() * 4
    bms, by = bound(nbytes, 4.0 * h_q * d * float(lens.sum()))
    log(f"  B2 at the verify step (B={b} x {k1} query rows, ctx {min(ctx)}-{max(ctx)}, "
        f"tables 64 slots repeated): max_abs_err {err:.4g} (tol {tol:.4g}); kernel "
        f"{ms:.4f} ms, bound {bms:.4f} ms ({by}, x{ms / bms:.1f}), the gather form "
        f"(attend over the whole table) {gather_ms:.4f} ms (x{gather_ms / ms:.1f} B2's), "
        f"SDPA (GQA, gathered KV, causal mask) {library_ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms,
                gather_ms=gather_ms, max_abs_err=err,
                shape=f"B={b}x{k1} ctx {min(ctx)}-{max(ctx)} tables 64")


def spec_cli(dev, ckpt: Path, card: str) -> dict:
    """``cli run --prompt-lookup`` and ``--draft-model`` (the checkpoint as
    its own draft) in this process, f32, each stream the Executor's
    penalty-free greedy one; then ``cli serve --continuous-batching
    --prompt-lookup`` answering 3 greedy chats over HTTP, its replies and
    its ``/metrics`` spec gauges equal to those of the same engine built
    in this process as ``cli serve`` builds it (the kernels are
    deterministic), behind the in-process server."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from blazr_tpu_torch.cli.main import main as cli_main
    from blazr_tpu_torch.config.inference import SpeculativeDecodingConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.engine.model_scheduler import ModelScheduler
    from blazr_tpu_torch.loader import load_model
    from blazr_tpu_torch.tokenizer import load_tokenizer

    out: dict = {}
    tok = load_tokenizer(ckpt)
    rng = np.random.default_rng(SEED + 16)
    passage = _prompt_text(tok, 48, rng)
    text = passage + " " + _prompt_text(tok, 32, rng) + " " + passage
    ids = tok.encode(text)
    t0 = time.perf_counter()
    model, app = load_model(ckpt, dtype="f32", device=dev)
    want = [t.token_id for t in Executor(model, tok, app).generate(ids, spec_greedy())][:16]
    del model
    free_card()
    want_text = "".join(tok.decode([t]) for t in want)
    log(f"  the Executor's greedy reference (f32, 16 tokens) in "
        f"{time.perf_counter() - t0:.1f} s with the load")
    for flags in (["--prompt-lookup"], ["--draft-model", str(ckpt)]):
        stdout, stderr = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
            rc = cli_main(["run", str(ckpt), "--prompt", text, "-n", "16", "-t", "0",
                           "--dtype", "f32", "--no-warmup", *flags])
        wall = time.perf_counter() - t0
        accept = [line for line in stderr.getvalue().splitlines() if "acceptance" in line]
        assert rc == 0 and accept, stderr.getvalue()[-2000:]
        got = stdout.getvalue()
        if got != want_text:
            t = next(j for j in range(len(want))
                     if not got.startswith("".join(tok.decode([x]) for x in want[:j + 1])))
            m, _ = load_model(ckpt, dtype="f32", device=dev)
            gap = top2_gap(m, ids + want[:t])
            del m
            free_card()
            log(f"  cli run {flags[0]} parts from greedy at token {t}: top-2 gap {gap:.3g}")
            assert gap < SPEC_TIE, (flags, t, gap)
        out[flags[0]] = dict(wall_s=wall, accept=accept[-1])
        log(f"  cli run {flags[0]}: the Executor's greedy stream; {accept[-1].strip()} "
            f"({wall:.1f} s with the load; {card})")
    bodies = [{"messages": [{"role": "user", "content": c}], "max_tokens": 64,
               "temperature": 0, "repeat_penalty": 1.0, "stream": True}
              for c in (text, passage + " " + passage, _prompt_text(tok, 200, rng))]

    def chats(port) -> list:
        replies = []
        for body in bodies:
            r = _stream_chat(port, body)
            assert r["done"] and r["finish"] and r["deltas"], r
            replies.append("".join(r["deltas"]))
        return replies
    t0 = time.perf_counter()
    sched = ModelScheduler(ckpt, device=dev)
    ex = sched.get_executor("default")
    inf = ex.app_cfg.inference
    inf.max_batch_size = 8
    inf.prefix_cache = True
    inf.speculative = SpeculativeDecodingConfig(num_speculative_tokens=SPEC_K)
    engine = BatchEngine(ex.model, ex.tokenizer, ex.app_cfg)
    engine.warmup()
    with http_server(sched, engine) as port:
        twin = chats(port)
    want_g = {"spec_drafted_total": engine.spec_drafted,
              "spec_accepted_total": engine.spec_accepted, "spec_depth": engine._spec_depth}
    log(f"  the in-process twin of cli serve: 3 chats, drafted {engine.spec_drafted}, "
        f"accepted {engine.spec_accepted} ({time.perf_counter() - t0:.1f} s with the load "
        "and warmup)")
    del engine, ex, sched
    free_card()
    with tempfile.TemporaryDirectory() as d:
        with cli_serve(ckpt, Path(d) / "serve.err", "--prompt-lookup") as (port, up, warmed):
            replies = chats(port)
            st, body = _http(port, "GET", "/metrics")
            assert st == 200, st
            m = parse_metrics(body.decode())
    g = {k: m[(f"blazr_tpu_{k}", ())] for k in (
        "spec_drafted_total", "spec_accepted_total", "spec_acceptance_rate", "spec_depth")}
    assert replies == twin, (replies, twin)
    assert all(g[k] == v for k, v in want_g.items()), (g, want_g)
    rate = want_g["spec_accepted_total"] / want_g["spec_drafted_total"] \
        if want_g["spec_drafted_total"] else 0.0
    assert abs(g["spec_acceptance_rate"] - rate) < 1e-9, g
    out["serve"] = dict(up_s=up, metrics=g)
    log(f"  cli serve --continuous-batching --prompt-lookup: up in {up:.1f} s ({warmed}); "
        "3 greedy chats equal to the twin's; /metrics "
        + ", ".join(f"{k} {v:g}" for k, v in g.items()) + " = the twin engine's counters")
    return out


def spec_phase(dev, gen, card: str, full_run: bool) -> dict:
    """Phase 16 (``spec``): Mistral-7B AWQ-INT4 (FULL_RUN_SPEC_LAYERS layers in
    a full run, 32 alone) served by the warmed BatchEngine with k = SPEC_K,
    8 extractive greedy requests of 256-512 tokens and SPEC_TOKENS new
    tokens in one wave: B1 at the verify's 48 rows and B2 at its query rows
    against their plain versions; the f32 equalities (``spec_checks``); in
    bf16, speculation off, prompt lookup and a TinyLlama-1.1B-width draft
    (random weights), each wave's decode profiled (tok/s, ms a round, idle
    share, acceptance, launches); one verify replay against one decode step,
    the verify's attention both ways, the chain and the draft prefill timed;
    no graph captured after warmup; then ``cli run`` and ``cli serve``."""
    import numpy as np
    import torch

    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.tokenizer import load_tokenizer
    from blazr_tpu_torch.utils.synthetic import synth_llama_params

    t_phase = time.perf_counter()
    layers = FULL_RUN_SPEC_LAYERS if full_run else 32
    k, n = B1_SHAPES["gateup"]
    out = {"b1": b1_at_shapes(dev, gen, {"gate+up": (k, n), "qkv": B1_SHAPES["qkv"],
                                          "o": B1_SHAPES["o"], "down": B1_SHAPES["down"]},
                              SPEC_B1_ROWS)}
    rng = np.random.default_rng(SEED + 16)
    prompts = spec_prompts(rng)
    out["b2"] = spec_b2(dev, gen, [len(p) + SPEC_TOKENS // 2 for p in prompts])
    ckpt = http_checkpoint(SPEC_CLI_LAYERS)
    tok = load_tokenizer(ckpt)
    model = mistral_model(dev, layers)
    t0 = time.perf_counter()
    out["checks"] = spec_checks(dev, model, tok, prompts, card)
    log(f"  (the f32 checks: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()

    reqs = [(p, spec_greedy()) for p in prompts]
    plain = spec_engine(model, tok, spec=False)
    plain.warmup()
    out["off"] = spec_wave(plain, reqs, f"speculation off ({layers} layers)", card, "decode")
    out["decode_step_ms"] = decode_step_ms(plain)
    del plain
    free_card()

    eng = spec_engine(model, tok, spec=True)
    t0 = time.perf_counter()
    warm_s = eng.warmup()
    n_warm = eng.graphs.captured
    log(f"  prompt-lookup engine warmed in {warm_s:.1f} s: {n_warm} graphs "
        f"({eng.graphs.capture_s:.1f} s of captures, "
        f"{eng.graphs.pool_bytes / 2**20:.1f} MiB pool)")
    lookup = out["lookup"] = spec_wave(eng, reqs, f"prompt lookup ({layers} layers)", card,
                                       "spec")
    same = sum(a == b for a, b in zip(lookup["streams"], out["off"]["streams"]))
    log(f"  bf16: {same} of 8 prompt-lookup streams equal speculation off's (the f32 "
        "checks hold the equality; bf16 rounds the 48-row and 8-row products apart)")
    out["verify_ms"] = replay_ms(eng, ("verify", 8))
    tally = {w.__name__: c for w, c in eng.graphs._graphs[("verify", 8)][1]}
    out["verify_b1"], out["verify_b2"] = tally.get("qmm", 0), tally.get(
        "paged_attention_decode", 0)
    assert out["verify_b2"] == layers, tally          # B2 once a layer, every position
    out["finish_ms"] = replay_ms(eng, ("spec_finish", 8, False, False, False))
    assert eng.graphs.captured == n_warm, "a graph was captured after warmup"
    out["warm"] = dict(s=warm_s, graphs=n_warm, pool_mib=eng.graphs.pool_bytes / 2**20)
    log(f"  one verify replay {out['verify_ms']:.3f} ms (B1 {out['verify_b1']}, B2 "
        f"{out['verify_b2']} launches), spec_finish {out['finish_ms']:.3f} ms, against one "
        f"plain decode step {out['decode_step_ms']:.3f} ms "
        f"(x{out['verify_ms'] / out['decode_step_ms']:.2f}; {card})")
    del eng
    free_card()

    log(f"  (speculation off and prompt lookup in bf16: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    dcfg = tinyllama_config()
    dcfg.num_layers = FULL_RUN_SPEC_DRAFT_LAYERS if full_run else dcfg.num_layers
    dparams = synth_llama_params(dcfg, quant="awq", dtype=torch.bfloat16, seed=SEED + 1,
                                 device=dev)
    draft = Model(dcfg, dparams, torch.bfloat16)
    eng = spec_engine(model, tok, spec=True, draft=draft)
    eng.warmup()
    n_warm = eng.graphs.captured
    out["draft"] = spec_wave(eng, reqs, f"TinyLlama-1.1B-width draft ({layers}-layer "
                             "target)", card, "spec")
    same = sum(a == b for a, b in zip(out["draft"]["streams"], out["off"]["streams"]))
    log(f"  bf16: {same} of 8 draft-model streams equal speculation off's")
    assert eng.graphs.captured == n_warm, "a graph was captured after warmup"
    out["chain_ms"] = replay_ms(eng, ("chain", 8))
    t = 512
    dprefill = (torch.zeros((1, t), dtype=torch.long, device=dev),
                torch.arange(t, device=dev)[None],
                torch.full((1, t), eng._trash, dtype=torch.long, device=dev),
                torch.full((1, t // 64), 0x7FFFFFFF, dtype=torch.int32, device=dev),
                torch.tensor([t], dtype=torch.int32, device=dev),
                torch.tensor([t - 1], device=dev))
    out["draft_prefill_ms"] = time_eager(lambda: eng._draft_prefill(*dprefill), iters=5)
    log(f"  TinyLlama-width draft ({dcfg.num_layers} layers, 2048 wide, random weights): "
        f"one chain replay "
        f"(k+1 = {SPEC_K + 1} T=1 steps at 8 rows) {out['chain_ms']:.3f} ms, one 512-token "
        f"draft prefill {out['draft_prefill_ms']:.3f} ms ({card})")
    del eng, draft, dparams
    free_card()
    # The main path's launches: the prompt-lookup and draft waves' (counted
    # from 0 before each).
    out["qmm"] = lookup["b1"] + out["draft"]["b1"]
    out["paged_attention"] = lookup["b2"] + out["draft"]["b2"]
    assert out["qmm"] > 0 and out["paged_attention"] > 0, out
    del model
    free_card()
    log(f"  (the TinyLlama-width draft: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out["cli"] = spec_cli(dev, ckpt, card)
    log(f"  (cli run and cli serve: {time.perf_counter() - t0:.1f} s)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  spec phase: {out['phase_s']:.1f} s ({card}; {layers} layers)")
    return out


# ---------------------------------------------------------------------------
# phase 17: LoRA adapters and the C++ BPE core
# ---------------------------------------------------------------------------

FULL_RUN_LORA_LAYERS = 2            # --phases build,lora serves all 32 (was 4)
LORA_CHECK_LAYERS = 2               # the f32 and the dense-merge checks
LORA_TOKENS = 64                    # greedy tokens a request
LORA_SCALE = 0.05                   # std of the adapters' random A and B
LORA_TIE = 1e-4                     # the one allowed parting: a top-2 logit gap below it
LORA_F32_TOL = 1e-3                 # f32 logits: max |diff| / max |logit|
PEFT_ALL = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def write_peft_adapter(path: Path, cfg, modules, rank: int, alpha: float, seed: int,
                       layers: int | None = None) -> Path:
    """An HF-PEFT adapter directory (``adapter_model.safetensors`` with
    PEFT's tensor names and ``adapter_config.json``) over ``modules`` of the
    first ``layers`` layers (default all) of ``cfg``, random A and B of std
    LORA_SCALE from ``seed``."""
    import numpy as np

    from blazr_tpu_torch.formats.safetensors import write_safetensors

    att = cfg.attention
    hd = att.resolved_head_dim(cfg.hidden_size)
    h, q, kv = cfg.hidden_size, att.num_heads * hd, att.kv_heads() * hd
    inter = cfg.resolved_intermediate_size()
    dims = {"q_proj": (h, q), "k_proj": (h, kv), "v_proj": (h, kv), "o_proj": (q, h),
            "gate_proj": (h, inter), "up_proj": (h, inter), "down_proj": (inter, h)}
    rng = np.random.default_rng(seed)
    weights = {}
    for i in range(cfg.num_layers if layers is None else layers):
        for m in modules:
            name = (f"base_model.model.model.layers.{i}."
                    f"{'self_attn' if m[0] in 'qkvo' else 'mlp'}.{m}")
            k, n = dims[m]
            weights[f"{name}.lora_A.weight"] = (
                rng.standard_normal((rank, k), dtype=np.float32) * LORA_SCALE)
            weights[f"{name}.lora_B.weight"] = (
                rng.standard_normal((n, rank), dtype=np.float32) * LORA_SCALE)
    path.mkdir(parents=True, exist_ok=True)
    write_safetensors(path / "adapter_model.safetensors", weights)
    (path / "adapter_config.json").write_text(json.dumps(
        {"r": rank, "lora_alpha": alpha, "target_modules": list(modules)}))
    return path


def lora_adapters(root: Path, cfg) -> dict:
    """A (rank 16, alpha 32, every projection), A2 (A's shapes, other
    values) and B (rank 8 on q_proj and v_proj, PEFT's default targets),
    written and loaded."""
    from blazr_tpu_torch.engine.lora import load_lora_adapter

    t0 = time.perf_counter()
    paths = {"A": write_peft_adapter(root / "A", cfg, PEFT_ALL, 16, 32.0, SEED + 17),
             "A2": write_peft_adapter(root / "A2", cfg, PEFT_ALL, 16, 32.0, SEED + 18),
             "B": write_peft_adapter(root / "B", cfg, ("q_proj", "v_proj"), 8, 16.0,
                                     SEED + 19)}
    out = {k: load_lora_adapter(p) for k, p in paths.items()}
    size = sum((p / "adapter_model.safetensors").stat().st_size for p in paths.values())
    log(f"  wrote and loaded adapters A, A2 (rank 16, 7 projections) and B (rank 8, "
        f"q/v) over {cfg.num_layers} layers ({size / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def dense_on_card(tree):
    """``tree`` with every QuantTensor dequantized to a dense f32 [K, N]
    weight on the card and every other float tensor in f32: the plain
    forward's params."""
    import torch

    from blazr_tpu_torch.quant.qtensor import QuantTensor, dequantize

    if isinstance(tree, dict):
        return {k: dense_on_card(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [dense_on_card(v) for v in tree]
    if isinstance(tree, QuantTensor):
        return dequantize(tree).float()
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.float()
    return tree


def lora_checks(dev, model, adapters: dict, tok, card: str) -> dict:
    """The f32 equalities on LORA_CHECK_LAYERS layers of ``model``: adapter A
    switched in by the Executor over the packed base (B1 and the low-rank
    matmuls) against a plain forward over the dequantized weights with A's
    delta merged (logits within LORA_F32_TOL of the largest, 16 greedy
    tokens equal but at an exact tie); then a dense bf16 base merged in
    place against the same base merged by ``merge_lora`` (every weight and
    the logits bit for bit), and back to the base bit for bit."""
    import numpy as np
    import torch

    from blazr_tpu_torch.config import AppConfig, GenerationConfig
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.engine.lora import lora_state, merge_lora
    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.utils.synthetic import synth_llama_params

    cfg = dataclasses.replace(model.cfg, num_layers=LORA_CHECK_LAYERS)
    cut = dict(model.params, layers=model.params["layers"][:LORA_CHECK_LAYERS])
    a = adapters["A"]                       # its modules of the first layers
    a = dataclasses.replace(a, weights={m: w for m, w in a.weights.items()
                                        if int(m.split(".")[2]) < LORA_CHECK_LAYERS})
    adapters = {"A": a}
    packed = Model(cfg, card_f32(cut), torch.float32)
    plain = Model(cfg, merge_lora(dense_on_card(cut), adapters["A"], model_cfg=cfg),
                  torch.float32)
    ex = Executor(packed, tok, AppConfig(model=cfg))
    ex.set_lora(adapters["A"])
    rng = np.random.default_rng(SEED + 17)
    ids = rng.integers(3, cfg.vocab_size, 96).tolist()

    def logits(m):
        with torch.no_grad():
            out, _ = m.forward(torch.tensor([ids], device=dev), m.init_cache(1, 128),
                               torch.arange(len(ids), device=dev)[None])
        return out[0].float()
    got, want = logits(packed), logits(plain)
    err = float((got - want).abs().max() / want.abs().max())
    base = logits(Model(cfg, dense_on_card(cut), torch.float32))
    moved = float((want - base).abs().max() / want.abs().max())
    assert err < LORA_F32_TOL < moved, (err, moved)
    gen = GenerationConfig(max_tokens=16, temperature=0.0, repeat_penalty=1.0)
    s_got = [t.token_id for t in ex.generate(ids, gen)]
    s_want = [t.token_id for t in Executor(plain, tok, AppConfig(model=cfg)).generate(ids,
                                                                                     gen)]
    gap = None
    if s_got != s_want:
        t = next(j for j, (a, b) in enumerate(zip(s_got, s_want)) if a != b)
        gap = top2_gap(plain, ids + s_want[:t])
        log(f"  card in f32: the adapter's stream parts from the plain one at token {t}: "
            f"its top-2 logit gap there {gap:.3g}")
        assert gap < LORA_TIE, (t, gap)
    log(f"  card in f32, {LORA_CHECK_LAYERS} layers: adapter A over the packed base (B1 + "
        f"low-rank matmuls) vs a plain forward over the dequantized weights with A merged: "
        f"max |diff| / max |logit| {err:.2e} (tolerance {LORA_F32_TOL:g}; A moves the "
        f"plain logits by {moved:.2e} of the largest); 16 greedy tokens "
        + ("equal" if gap is None else "equal up to an exact tie"))
    del ex, packed, plain
    free_card()

    dense = synth_llama_params(cfg, quant="dense", dtype=torch.bfloat16, seed=SEED + 2,
                               device=dev)
    clean = {k: v.clone() for k, v in dense["layers"][1].items()}
    want_params = merge_lora(dense, adapters["A"], model_cfg=cfg)
    live = Model(cfg, dense, torch.bfloat16)
    ids_before = {k: v.data_ptr() for k, v in dense["layers"][1].items()}
    t0 = time.perf_counter()
    lora_state(live).activate(adapters["A"])
    torch.cuda.synchronize()
    dense_switch_ms = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(live.params["layers"][i][k], want_params["layers"][i][k])
               for i in range(cfg.num_layers) for k in want_params["layers"][i])
    in_place = all(v.data_ptr() == ids_before[k] for k, v in live.params["layers"][1].items())
    l_live = logits(live)
    l_want = logits(Model(cfg, want_params, torch.bfloat16))
    assert same and in_place and torch.equal(l_live, l_want), (same, in_place)
    lora_state(live).activate(None)
    restored = all(torch.equal(live.params["layers"][1][k], v) for k, v in clean.items())
    assert restored
    log(f"  dense bf16 base, {LORA_CHECK_LAYERS} layers: A merged in place (the same "
        f"tensors, {dense_switch_ms:.1f} ms) == merge_lora's params and logits bit for bit; "
        "the base restored bit for bit")
    del dense, want_params, live, clean
    free_card()
    return dict(f32_rel_err=err, f32_moved=moved, f32_tie_gap=gap,
                dense_switch_ms=dense_switch_ms)


def lora_greedy(n: int):
    from blazr_tpu_torch.config import GenerationConfig

    return GenerationConfig(max_tokens=n, temperature=0.0, repeat_penalty=1.0)


def lora_engine(model, tok):
    """The BatchEngine as ``serve --continuous-batching`` builds it: max batch
    8, block 64, horizon 8, graphs on."""
    from blazr_tpu_torch.config import AppConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine

    app = AppConfig(model=model.cfg)
    app.inference.max_batch_size = 8
    app.inference.block_size = 64
    app.inference.decode_horizon = 8
    return BatchEngine(model, tok, app)


def step_tally(engine, bmax: int = 8) -> dict:
    """Launches a decode step of the captured plain step at ``bmax`` rows:
    {wrapper name: count}."""
    key = (bmax, False, False, False, None, False, False)
    return {w.__name__: n for w, n in engine.graphs._graphs[key][1]}


def lora_switch(engine, adapter, label: str) -> dict:
    """Switch the idle engine to ``adapter`` (None: the base): host ms of
    the switch (its device writes waited for)."""
    import torch

    from blazr_tpu_torch.engine.lora import lora_state

    st = lora_state(engine.model)
    sig = st.sig
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.set_lora(adapter).result()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return dict(label=label, ms=ms, replaced=st.sig != sig)


def lora_http(ckpt: Path, cfg, root: Path, card: str) -> dict:
    """``cli serve --continuous-batching`` on the 1-layer checkpoint: POST
    /v1/lora (201), a greedy chat with ``lora_adapter`` that differs from the
    base chat, GET listing it, DELETE (200), the next chat equal to the base
    reply, and 404 for a name that is not loaded (a chat and a DELETE)."""
    one = dataclasses.replace(cfg, num_layers=1)
    ad = write_peft_adapter(root / "http", one, PEFT_ALL, 16, 32.0, SEED + 20)
    chat = {"messages": [{"role": "user", "content": "Tell me about the weather."}],
            "max_tokens": 16, "temperature": 0, "repeat_penalty": 1.0}

    def reply(port, body):
        st, data = _http(port, "POST", "/v1/chat/completions", body)
        assert st == 200, (st, data[:500])
        return json.loads(data)["choices"][0]["message"]["content"]
    t0 = time.perf_counter()
    with tempfile_dir() as d:
        with cli_serve(ckpt, Path(d) / "serve.err") as (port, up, warmed):
            base = reply(port, chat)
            st, data = _http(port, "POST", "/v1/lora", {"path": str(ad), "name": "style"})
            assert st == 201, (st, data)
            loaded = json.loads(data)
            with_a = reply(port, dict(chat, lora_adapter="style"))
            st, data = _http(port, "GET", "/v1/lora")
            listed = json.loads(data)["adapters"]
            assert st == 200 and [a["name"] for a in listed] == ["style"], data
            st, data = _http(port, "DELETE", "/v1/lora/style")
            assert st == 200, (st, data)
            after = reply(port, chat)
            st_chat, _ = _http(port, "POST", "/v1/chat/completions",
                               dict(chat, lora_adapter="nope"))
            st_del, _ = _http(port, "DELETE", "/v1/lora/nope")
    assert with_a != base, "the adapter did not change the greedy reply"
    assert after == base, (after, base)
    assert st_chat == 404 and st_del == 404, (st_chat, st_del)
    log(f"  cli serve --continuous-batching (1 layer; up in {up:.1f} s, {warmed}): POST "
        f"/v1/lora 201 (rank {loaded['rank']}, {loaded['modules']} modules); the chat with "
        "lora_adapter differs from the base chat; GET lists it; DELETE 200 and the next chat "
        f"equals the base reply; an unknown name 404 ({time.perf_counter() - t0:.1f} s; "
        f"{card})")
    return dict(up_s=up, status=dict(post=201, delete=200, unknown=[st_chat, st_del]))


def tempfile_dir():
    import tempfile

    return tempfile.TemporaryDirectory()


def bpe_times(ckpt: Path, card: str) -> dict:
    """Host ms to encode a text of about 32,000 tokens with phase 7's
    32,000-token tokenizer.json: the C++ core (pre-tokenizer and merges in
    one call) and the Python merge loop, best of 3 each; ids equal."""
    import numpy as np

    from blazr_tpu_torch.tokenizer import load_tokenizer
    from blazr_tpu_torch.tokenizer.bpe import BpeTokenizer

    t0 = time.perf_counter()
    core = load_tokenizer(ckpt)
    load_s = time.perf_counter() - t0
    plain = BpeTokenizer(core.ranks, pattern=core._pattern_str,
                         special_tokens=core.special_tokens,
                         bos_token_id=core.bos_token_id, eos_token_id=core.eos_token_id,
                         native=False)
    rng = np.random.default_rng(SEED + 17)
    text = core.decode(core.encode(core.decode(
        rng.integers(256, core.vocab_size - 1, 36000).tolist()))[:32000])
    out = {}
    for name, tk in (("cpp", core), ("python", plain)):
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            ids = tk.encode(text)
            dt = (time.perf_counter() - t0) * 1e3
            best = dt if best is None else min(best, dt)
        out[name] = dict(ms=best, ids=ids)
    assert out["cpp"]["ids"] == out["python"]["ids"]
    n = len(out["cpp"]["ids"])
    log(f"  BPE encode of {len(text.encode())} bytes -> {n} tokens (32,000-token "
        f"tokenizer.json, GPT-2 pattern): C++ core {out['cpp']['ms']:.1f} ms, Python merge "
        f"loop {out['python']['ms']:.1f} ms (x{out['python']['ms'] / out['cpp']['ms']:.1f}); "
        f"ids equal; tokenizer load {load_s:.2f} s (host; {card})")
    return dict(tokens=n, bytes=len(text.encode()), cpp_ms=out["cpp"]["ms"],
                python_ms=out["python"]["ms"], load_s=load_s)


def lora_phase(dev, card: str, full_run: bool) -> dict:
    """Phase 17 (``lora``): Mistral-7B AWQ-INT4 (FULL_RUN_LORA_LAYERS layers in
    a full run, 32 alone) served by the warmed BatchEngine, 8 greedy
    requests of 64-512 tokens and LORA_TOKENS new tokens in one wave: with
    no adapter, with A (rank 16 on every projection), with A2 (A's shapes:
    written in place, no graph captured), with B (rank 8 on q/v: the
    graphs captured again) and with the base again (its first streams
    exactly): ms a decode step, decode tok/s, the idle share, B1 launches
    and low-rank matmuls a step, each switch's ms and captures; the f32
    and dense-merge equalities (``lora_checks``); the /v1/lora routes over
    ``cli serve`` (``lora_http``); and the C++ BPE core's encode time beside
    the Python loop's (``bpe_times``)."""
    import shutil
    import tempfile

    import numpy as np

    from blazr_tpu_torch.engine.lora import lora_state
    from blazr_tpu_torch.tokenizer import load_tokenizer

    t_phase = time.perf_counter()
    layers = FULL_RUN_LORA_LAYERS if full_run else 32
    root = Path(tempfile.mkdtemp(prefix="blazr_lora_"))
    out: dict = {}
    try:
        ckpt = http_checkpoint(SPEC_CLI_LAYERS)
        tok = load_tokenizer(ckpt)
        model = mistral_model(dev, layers)
        adapters = lora_adapters(root, model.cfg)
        t0 = time.perf_counter()
        out["checks"] = lora_checks(dev, model, adapters, tok, card)
        log(f"  (the f32 and dense checks: {time.perf_counter() - t0:.1f} s)")

        rng = np.random.default_rng(SEED + 17)
        reqs = [(rng.integers(3, 32000, int(n)).tolist(), lora_greedy(LORA_TOKENS))
                for n in rng.integers(64, 513, 8)]
        eng = lora_engine(model, tok)
        warm_s = eng.warmup()
        log(f"  engine warmed in {warm_s:.1f} s: {eng.graphs.captured} graphs")
        st = lora_state(model)
        out["switches"] = []
        waves = {}
        for label, adapter in (("base", None), ("A", adapters["A"]), ("A2", adapters["A2"]),
                               ("B", adapters["B"]), ("base again", None)):
            captures = eng.graphs.captures
            if label != "base":
                sw = lora_switch(eng, adapter, label)
                # A short pass first: a wave's first pass carries the
                # captures the switch made due.
                asyncio.run(serve(eng, [[(p, lora_greedy(16)) for p, _ in reqs]]))
            wave = spec_wave(eng, reqs, f"{label} ({layers} layers)", card, "decode")
            wave["captures"] = eng.graphs.captures - captures
            wave["step_ms"] = decode_step_ms(eng)
            tally = step_tally(eng)
            wave["b1_step"], wave["lora_step"] = tally.get("qmm", 0), tally.get(
                "lora_matmul", 0)
            if label != "base":
                sw["captures"] = wave["captures"]
                out["switches"].append(sw)
                log(f"  switch to {label}: {sw['ms']:.2f} ms host (device writes waited "
                    f"for), buffers {'replaced' if sw['replaced'] else 'written in place'}, "
                    f"{sw['captures']} graphs captured in the waves after it")
            log(f"  {label}: one decode step {wave['step_ms']:.3f} ms at 8 rows (B1 "
                f"{wave['b1_step']}, low-rank matmuls {wave['lora_step']} a step); "
                f"{wave['tok_s']:.1f} decode tok/s; idle share "
                + (f"{wave['idle']:.3f}" if wave["idle"] is not None else "not measured")
                + f" ({card})")
            waves[label] = wave
        assert [s["captures"] for s in out["switches"] if s["label"] == "A2"] == [0]
        assert all(s["captures"] > 0 for s in out["switches"] if s["replaced"])
        assert waves["base again"]["streams"] == waves["base"]["streams"], \
            "base -> A -> A2 -> B -> base did not give the first base streams"
        moved = sum(a != b for a, b in zip(waves["A"]["streams"], waves["base"]["streams"]))
        assert all(w["b1_step"] == waves["base"]["b1_step"] for w in waves.values())
        assert waves["A"]["lora_step"] == 8 * layers and waves["B"]["lora_step"] == 2 * layers
        assert st.active is None
        out["waves"] = {k: {f: v for f, v in w.items() if f != "streams"}
                        for k, w in waves.items()}
        log(f"  base -> A -> A2 -> B -> base: the last wave's streams equal the first's "
            f"exactly; {moved} of 8 streams under A differ from the base's; A adds {waves['A']['step_ms'] - waves['base']['step_ms']:.3f} ms a "
            f"step, B {waves['B']['step_ms'] - waves['base']['step_ms']:.3f} ms ({card})")
        # The main path's launches: every wave's, counted from 0 before each.
        out["qmm"] = sum(w["b1"] for w in waves.values())
        out["paged_attention"] = sum(w["b2"] for w in waves.values())
        assert out["qmm"] > 0 and out["paged_attention"] > 0, out
        del eng, model, adapters
        free_card()
        t0 = time.perf_counter()
        out["http"] = lora_http(ckpt, tok_cfg(), root, card)
        log(f"  (HTTP: {time.perf_counter() - t0:.1f} s)")
        out["bpe"] = bpe_times(ckpt, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  lora phase: {out['phase_s']:.1f} s ({card}; {layers} layers)")
    return out


# ---------------------------------------------------------------------------
# phase 18 (offload): MoE expert offload, layer offload, the Mamba3 mixer,
# data-parallel replicas and the trace spans
# ---------------------------------------------------------------------------

OFFLOAD_MIXTRAL_LAYERS = 32         # Mixtral-8x7B's depth: 128 cold experts, 90 GB in
                                    # f32, against the host term's 8 GiB cache
FULL_RUN_OFFLOAD_MIXTRAL_LAYERS = 1
OFFLOAD_F32_LAYERS = 2              # the f32 check (a resident twin in f32 beside it)
OFFLOAD_RESIDENT = 4                # experts a layer on the card, of 8 (hybrid's half)
OFFLOAD_REBALANCE = 2               # forward passes (engine steps) between rebalances
OFFLOAD_TOKENS = 4                  # greedy tokens a request at 32 layers
FULL_RUN_OFFLOAD_TOKENS = 8         # at 1 layer
OFFLOAD_PROMPTS = FAMILY_REQUEST_LENS
STREAM_DEPTH = (32, 16)             # Mistral-7B layers, of which on the card
FULL_RUN_STREAM_DEPTH = (8, 4)
STREAM_TOKENS = 32                  # greedy tokens of the streamed Executor
PCIE_PRACTICAL_BYTES_PER_S = 50e9   # pinned host-to-device copies, a practical rate
MAMBA3_LAYERS = 2                   # Codestral's 64; the card-vs-CPU checks and the engines
MAMBA3_TOKENS = 16
MAMBA3_TOL = 1e-3                   # the card in f32 against the CPU in f32 (F32_FREE_TOL)
DP_LAYERS = 4                       # the replicas' Mistral-7B (2 in a full run)
DP_TOKENS = 32


def offload_requests(vocab: int, n_new: int) -> list:
    import numpy as np

    from blazr_tpu_torch.config import GenerationConfig

    rng = np.random.default_rng(SEED + 18)
    return [(rng.integers(0, vocab, n).tolist(),
             GenerationConfig(max_tokens=n_new, temperature=0.0)) for n in OFFLOAD_PROMPTS]


def offload_app(cfg, **inf):
    from blazr_tpu_torch.config import AppConfig

    app = AppConfig(model=cfg)
    app.inference.max_seq_len = 1024
    app.inference.max_batch_size = 8
    for k, v in inf.items():
        setattr(app.inference, k, v)
    return app


def _plane_ptrs(rt) -> dict:
    from blazr_tpu_torch.engine.moe_offload import _EXPERT_KEYS, _planes

    return {layer: [t.data_ptr() for key in _EXPERT_KEYS for t in _planes(p[key])]
            + [p["resident_ids"].data_ptr()] for layer, p in rt.params.items()}


def offload_f32_check(dev, layers: int) -> dict:
    """Mixtral-8x7B at ``layers`` layers with the card in f32: the model with every
    expert on the card and the same weights under the hybrid offload (4 of
    8 resident, a rebalance every pass) serve one greedy prompt through the
    Executor; after the rebalances the offloaded model's logits over a
    64-token prefill and 4 decode steps equal the resident model's within
    1e-4 of their largest, and the greedy tokens are equal."""
    import numpy as np
    import torch

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.models.registry import Model

    synth = llama_family_model(dev, "mixtral", layers)
    cfg = synth.cfg
    ref = Model(cfg, card_f32(synth.params), torch.float32)
    off = Model(cfg, card_f32(synth.params), torch.float32)
    del synth
    rng = np.random.default_rng(SEED + 19)
    prompt = rng.integers(0, cfg.vocab_size, 48).tolist()
    gen = GenerationConfig(max_tokens=8, temperature=0.0)
    want = [t.token_id for t in Executor(ref, StubTokenizer(), offload_app(cfg)).generate(
        prompt, gen)]
    ex = Executor(off, StubTokenizer(), offload_app(
        cfg, moe_offload="hybrid", moe_device_experts=OFFLOAD_RESIDENT,
        moe_rebalance_interval=1))
    got = [t.token_id for t in ex.generate(prompt, gen)]
    rt = ex._moe_rt
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 68))).to(dev)
    pos = torch.arange(68, device=dev)[None]
    errs = []
    with torch.no_grad():
        caches = [m.init_cache(1, 128) for m in (ref, off)]
        for lo, hi in ((0, 64), (64, 65), (65, 66), (66, 67), (67, 68)):
            a, b = (m.forward(toks[:, lo:hi], c, pos[:, lo:hi])[0]
                    for m, c in zip((ref, off), caches))
            errs.append(float((a - b).abs().max() / a.abs().max()))
    err = max(errs)
    moved, rebalances = rt.moved, rt.manager.rebalances
    log(f"  f32 check ({layers} layers, {rebalances} rebalances, {moved} experts moved): max rel "
        f"err of the logits {err:.3g} (tol 1e-4); greedy tokens "
        f"{'equal' if got == want else 'DIFFER'}")
    assert moved > 0 and err <= 1e-4 and got == want, (moved, err, got, want)
    del ex, ref, off, rt
    free_card()
    return dict(max_rel_err=err, moved=moved, rebalances=rebalances, tokens_equal=True)


def offload_mixtral(dev, card: str, full_run: bool) -> dict:
    """Part (a): Mixtral-8x7B AWQ-INT4 at full width and depth (1 layer in a
    full run) under ``--moe-offload hybrid`` (4 of 8 experts resident, a
    rebalance every 2 passes): 8 greedy requests of phase 5's prompt lengths
    through the BatchEngine (eager), then one through the Executor. B1 and
    B2 launches, the host term's calls and expert terms, the cold cache's
    hits and misses, ms a step; the resident planes rewritten in place
    (their data pointers unchanged); then the f32 check."""
    import torch

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine
    from blazr_tpu_torch.engine.executor import Executor

    n_new = FULL_RUN_OFFLOAD_TOKENS if full_run else OFFLOAD_TOKENS
    layers = FULL_RUN_OFFLOAD_MIXTRAL_LAYERS if full_run else OFFLOAD_MIXTRAL_LAYERS
    model = llama_family_model(dev, "mixtral", layers)
    app = offload_app(model.cfg, moe_offload="hybrid", moe_device_experts=OFFLOAD_RESIDENT,
                      moe_rebalance_interval=OFFLOAD_REBALANCE)
    t0 = time.perf_counter()
    ex = Executor(model, StubTokenizer(), app)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    rt = ex._moe_rt
    assert rt is not None and all(len(r) == OFFLOAD_RESIDENT for r in rt.resident.values())
    host_gb = sum(t.numel() * t.element_size() for lay in rt.host.values()
                  for w in lay.values() for t in (w.qweight, w.scales, w.mins)) / 1e9
    ptrs = _plane_ptrs(rt)
    engine = BatchEngine(model, StubTokenizer(), app)
    assert engine._moe_rt is rt and not engine.graphs.enabled
    reqs = offload_requests(model.cfg.vocab_size, n_new)
    cache = rt.cold_cache

    def tallies():
        return (rt.cold_accesses, rt.cold_experts, rt.manager.rebalances, rt.moved,
                cache.hits, cache.misses)

    before = tallies()
    reset_counts()
    t0 = time.perf_counter()
    results = asyncio.run(serve(engine, [reqs]))
    wall = time.perf_counter() - t0
    counts = read_counts()
    torch.cuda.synchronize()
    for r in results:
        assert len(r["tokens"]) == n_new, r["tokens"]
    steps = engine.horizon_steps
    calls, experts, rebal, moved, hits, misses = (a - b for a, b in zip(tallies(), before))
    ms_step = engine.perf["decode"] * 1e3 / max(steps, 1)
    assert counts["qmm"] > 0 and counts["paged_attention"] > 0, counts
    assert rebal > 0 and calls > 0 and _plane_ptrs(rt) == ptrs, (rebal, calls)
    assert cache.peak_bytes <= cache.max_bytes, (cache.peak_bytes, cache.max_bytes)
    engine_out = dict(layers=layers, wall_s=wall, decode_steps=steps, ms_per_step=ms_step,
                      decode_s=engine.perf["decode"], prefill_s=engine.perf["prefill"],
                      tok_s=8 * n_new / wall, host_calls=calls, host_experts=experts,
                      cache_hits=hits, cache_misses=misses, rebalances=rebal, moved=moved,
                      **counts)
    log(f"  BatchEngine, {layers} layers, 8 greedy requests ({min(OFFLOAD_PROMPTS)}-"
        f"{max(OFFLOAD_PROMPTS)}-token prompts) x {n_new} tokens: {wall:.1f} s, {steps} "
        f"decode steps at {ms_step:.1f} ms ({engine.perf['decode']:.2f} s decode, "
        f"{engine.perf['prefill']:.2f} s prefill), B1 {counts['qmm']}, B2 "
        f"{counts['paged_attention']}; host term {calls} calls, {experts} expert terms, "
        f"cold cache {hits} hits and {misses} misses; {rebal} rebalances moved {moved} "
        f"experts in place; {card}")
    prompt = reqs[1][0]
    reset_counts()
    stamps = []
    t0 = time.perf_counter()
    before = tallies()
    for _ in ex.generate(prompt, GenerationConfig(max_tokens=n_new, temperature=0.0)):
        stamps.append(time.perf_counter())
    counts = read_counts()
    calls, experts, _, _, hits, misses = (a - b for a, b in zip(tallies(), before))
    ms_tok = (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)
    ex_out = dict(ttft_s=stamps[0] - t0, ms_per_token=ms_tok, qmm=counts["qmm"],
                  host_calls=calls, host_experts=experts, cache_hits=hits, cache_misses=misses)
    log(f"  Executor, {len(prompt)}-token prompt: TTFT {ex_out['ttft_s'] * 1e3:.0f} ms, "
        f"{ms_tok:.1f} ms a token, B1 {counts['qmm']}, host term {calls} calls, {experts} "
        f"expert terms, {hits} hits and {misses} misses; cold cache keeps "
        f"{cache.bytes / 2**30:.2f} GiB (peak with its scratch {cache.peak_bytes / 2**30:.2f} "
        f"of {cache.max_bytes / 2**30:.0f} GiB); install {install_s:.1f} s, host mirror "
        f"{host_gb:.2f} GB pinned")
    assert counts["qmm"] > 0 and cache.peak_bytes <= cache.max_bytes
    out = dict(engine=engine_out, executor=ex_out, install_s=install_s, host_gb=host_gb,
               cold_kept_gib=cache.bytes / 2**30, cold_peak_gib=cache.peak_bytes / 2**30)
    del engine, ex, model, rt, cache
    free_card()
    out["f32"] = offload_f32_check(dev, OFFLOAD_F32_LAYERS)
    return out


def _union(spans: list) -> list:
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def copy_overlap(prof) -> dict:
    """From a profiler window: the host-to-device copies' device time and
    the share of it during which a kernel ran (the union of the copies'
    spans against the union of the kernels')."""
    import torch

    copies, kernels = [], []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (ev.time_range.start, ev.time_range.end)
        if "Memcpy HtoD" in ev.name:
            copies.append(span)
        elif "Memcpy" not in ev.name and "Memset" not in ev.name:
            kernels.append(span)
    cu, ku = _union(copies), _union(kernels)
    inter = 0.0
    for lo, hi in cu:
        for klo, khi in ku:
            inter += max(0.0, min(hi, khi) - max(lo, klo))
    copy_us = sum(hi - lo for lo, hi in cu)
    return dict(copy_ms=copy_us / 1e3, kernel_ms=sum(hi - lo for lo, hi in ku) / 1e3,
                overlap=inter / copy_us if copy_us else 0.0, copies=len(copies))


def stream_cli(full_run: bool) -> dict:
    """``cli run CKPT --device-layers N`` (``cli_here``) on phase 7's
    checkpoint (written here if phase 7 did not run), half its layers on
    the card: 16 greedy tokens; alone, its stream equals ``cli run``'s
    without the flag."""
    d = http_checkpoint()
    argv = ("run", d, "--prompt", "layers that live in host memory", "--max-tokens", "16",
            "--temperature", "0")
    stdout, stderr, wall = cli_here(*argv, "--device-layers", HTTP_LAYERS // 2)
    summary = [line for line in stderr.splitlines() if line.startswith("[")
               and " tokens, " in line]
    assert stdout.strip() and summary, (stdout[-2000:], stderr[-2000:])
    log(f"  cli run --device-layers {HTTP_LAYERS // 2} ({HTTP_LAYERS}-layer checkpoint): "
        f"{summary[-1]} ({wall:.1f} s, the load included)")
    if not full_run:
        resident, _, _ = cli_here(*argv)
        assert stdout == resident, (stdout, resident)
    return dict(wall_s=wall, summary=summary[-1])


def offload_stream(dev, card: str, full_run: bool) -> dict:
    """Part (b): Mistral-7B AWQ-INT4 with STREAM_DEPTH (FULL_RUN_STREAM_DEPTH)
    layers, the second half streamed from pinned host memory through the
    card's two slots. The logits of a 128-token prefill and 4 decode steps
    equal the fully resident model's exactly; the Executor's ms a token and
    tok/s, streamed and resident (both eager), beside the floor of the host
    layers' bytes at the measured pinned copy rate and at 50 GB/s; the
    copies' overlap with compute under torch.profiler; cli run."""
    import numpy as np
    import torch

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.engine.offload_stream import _tensors, stream_model
    from blazr_tpu_torch.loader.offloading import LayerDeviceMap

    layers, on_card = FULL_RUN_STREAM_DEPTH if full_run else STREAM_DEPTH
    model = mistral_model(dev, layers)
    rng = np.random.default_rng(SEED + 20)
    prompt = rng.integers(0, model.cfg.vocab_size, 128).tolist()
    feed = torch.tensor([prompt + rng.integers(0, 32000, 4).tolist()], device=dev)
    pos = torch.arange(132, device=dev)[None]
    gen = GenerationConfig(max_tokens=STREAM_TOKENS, temperature=0.0)

    def logits(m):
        cache = m.init_cache(1, 256)
        with torch.no_grad():
            out = [m.forward(feed[:, :128], cache, pos[:, :128])[0][:, -1]]
            out += [m.forward(feed[:, i:i + 1], cache, pos[:, i:i + 1])[0][:, -1]
                    for i in range(128, 132)]
        return torch.cat(out)

    def run(ex):
        stamps = []
        t0 = time.perf_counter()
        toks = []
        for t in ex.generate(prompt, gen):
            stamps.append(time.perf_counter())
            toks.append(t.token_id)
        return toks, stamps[0] - t0, (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)

    want = logits(model)
    app = offload_app(model.cfg)
    app.inference.graphs = False
    res_toks, res_ttft, res_ms = run(Executor(model, StubTokenizer(), app))
    t0 = time.perf_counter()
    streamed = stream_model(model, LayerDeviceMap.with_device_layers(layers, on_card))
    torch.cuda.synchronize()
    pin_s = time.perf_counter() - t0
    del model
    free_card()
    got = logits(streamed)
    err = float((got - want).abs().max())
    host_bytes = len(streamed.host_layers) * streamed.layer_bytes
    # The pinned copy rate: one host layer into a slot, timed with events.
    src, dst = _tensors(streamed.host_layers[0]), _tensors(streamed._slots[0])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        start.record()
        for d, h in zip(dst, src):
            d.copy_(h, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
    rate = streamed.layer_bytes / (start.elapsed_time(end) / 1e3)
    ex = Executor(streamed, StubTokenizer(), offload_app(streamed.cfg))
    assert not ex.graphs.enabled
    reset_counts()
    toks, ttft, ms_tok = run(ex)
    counts = read_counts()
    assert counts["qmm"] > 0 and toks == res_toks, (counts, toks, res_toks)
    prof, t0 = start_profile()
    for _ in ex.generate(prompt, GenerationConfig(max_tokens=5, temperature=0.0)):
        pass
    wall, busy, _, _, _ = stop_profile(prof, t0)
    ov = copy_overlap(prof)
    floor_ms, floor50_ms = host_bytes / rate * 1e3, host_bytes / PCIE_PRACTICAL_BYTES_PER_S * 1e3
    log(f"  {layers} layers, {on_card} on the card: logits max |diff| {err:.3g} against the "
        f"resident model; {len(streamed.host_layers)} host layers of "
        f"{streamed.layer_bytes / 1e6:.1f} MB ({host_bytes / 1e9:.2f} GB a token, pinned in "
        f"{pin_s:.1f} s); pinned copy {rate / 1e9:.1f} GB/s")
    log(f"  Executor streamed: TTFT {ttft * 1e3:.0f} ms, {ms_tok:.2f} ms a token "
        f"({1e3 / ms_tok:.1f} tok/s) against floors of {floor_ms:.2f} ms (measured rate) "
        f"and {floor50_ms:.2f} ms (50 GB/s); resident, eager: {res_ms:.2f} ms a token; "
        f"B1 {counts['qmm']}; greedy tokens equal; {card}")
    log(f"  profiled 5 tokens: copies {ov['copy_ms']:.1f} ms of device time ({ov['copies']} "
        f"copies), kernels {ov['kernel_ms']:.1f} ms, {ov['overlap']:.3f} of the copy time "
        f"under a kernel; device busy {busy / wall:.3f} of {wall * 1e3:.0f} ms")
    assert err == 0.0, err
    del ex, streamed
    free_card()
    return dict(layers=layers, on_card=on_card, max_abs_err=err, host_gb=host_bytes / 1e9,
                copy_gb_s=rate / 1e9, ms_per_token=ms_tok, tok_s=1e3 / ms_tok, ttft_s=ttft,
                floor_ms=floor_ms, floor50_ms=floor50_ms, resident_ms_per_token=res_ms,
                overlap=ov, busy=busy / wall, qmm=counts["qmm"], cli=stream_cli(full_run))


MAMBA3_VARIANTS = {"rope, rank 0, no conv": dict(complex_rope=True, mimo_rank=0, use_conv=False),
                   "rope, rank 2, no conv": dict(complex_rope=True, mimo_rank=2, use_conv=False),
                   "rope, rank 2, conv": dict(complex_rope=True, mimo_rank=2, use_conv=True)}


def mamba3_model(dev, flags: dict, layers: int):
    """Codestral's published widths with the Mamba3 mixer (bf16): the
    phase-14 model's params, each layer's in_proj widened for the rank (a
    new random AWQ-INT4 weight, groups of 128), the conv where it is on, and
    random ``lam`` [H] and ``omega`` [H, N/2]."""
    return to_mamba3(recurrent_model(dev, "mamba2", layers), flags, dev)


def to_mamba3(model, flags: dict, dev):
    """``mamba3_model``'s change of a Mamba2 model, in place: the Mamba3
    flags on its config and each layer's widened in_proj, conv, ``lam`` and
    ``omega`` from seed SEED + 21, in the model's dtype."""
    import torch

    from blazr_tpu_torch.models.mamba2 import _m3_widths
    from blazr_tpu_torch.utils.synthetic import _rand_awq_qt

    cfg = model.cfg
    cfg.ssm = dataclasses.replace(cfg.ssm, variant="mamba3", **flags)
    ssm = cfg.ssm
    _, x_w, b_w, c_w = _m3_widths(ssm)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 21)
    for p in model.params["layers"]:
        p["in_proj"] = _rand_awq_qt(g, cfg.hidden_size, ssm.inner_size + x_w + b_w + c_w
                                    + ssm.num_heads, min(128, cfg.hidden_size), dev)
        p["conv_w"] = (torch.randn((x_w + b_w + c_w, ssm.conv_kernel), device=dev,
                                   generator=g) * 0.2).to(model.dtype) \
            if flags["use_conv"] else None
        p["conv_b"] = None
        p["lam"] = torch.randn((ssm.num_heads,), device=dev, generator=g)
        p["omega"] = torch.rand((ssm.num_heads, ssm.state_size // 2), device=dev,
                                generator=g) + 0.1
    return model


def in_f32(model):
    """The same weights with the card in f32 (QuantTensors shared)."""
    import torch

    from blazr_tpu_torch.models.registry import Model

    return Model(model.cfg, card_f32(model.params), torch.float32)


def mamba3_check(dev, name: str, flags: dict) -> dict:
    """A 2-layer model of ``flags``: the card's contiguous forward (a
    96-token prefill of two rows, the chunked scan, then 4 single-token
    steps, the step form) against the CPU f32 forward on the same weights
    dequantized: with the card in f32 within MAMBA3_TOL of the largest
    logit, in bf16 reported."""
    import numpy as np
    import torch

    from blazr_tpu_torch.kvcache.ssm_state import init_ssm_state

    out = {}
    rng = np.random.default_rng(SEED + 22)
    bf16 = mamba3_model(dev, flags, MAMBA3_LAYERS)
    cpu = to_cpu_f32(bf16.params, dense=True)
    toks = rng.integers(0, bf16.cfg.vocab_size, (2, 100))
    for dtype, model in (("f32", in_f32(bf16)), ("bf16", bf16)):
        errs = []
        states = [model.init_cache(2, 128), init_ssm_state(model.cfg, 2, device="cpu")]
        with torch.no_grad():
            for lo, hi in ((0, 96), (96, 97), (97, 98), (98, 99), (99, 100)):
                t = torch.from_numpy(toks[:, lo:hi])
                p = torch.arange(lo, hi)[None].expand(2, -1)
                a = model.forward_fn(model.params, model.cfg, t.to(dev), states[0],
                                     p.to(dev))[0].float().cpu()
                b = model.forward_fn(cpu, model.cfg, t, states[1], p)[0]
                errs.append(float((a - b).abs().max() / b.abs().max()))
        out[dtype] = max(errs)
        del model, states
    del bf16, cpu
    free_card()
    log(f"  mamba3 {name}: card vs CPU (96-token prefill, 4 steps), max rel err "
        f"{out['f32']:.3g} with the card in f32 (tol {MAMBA3_TOL}), {out['bf16']:.3g} in bf16")
    assert out["f32"] <= MAMBA3_TOL, out
    return out


def mamba3_engines(dev, card: str) -> dict:
    """The rank-2 Mamba3 model (2 layers, card in f32) serving 8 greedy
    requests through the BatchEngine (its state rows, graphs on) and each
    through the Executor: equal streams; then in bf16, the BatchEngine's ms
    a decode step and its B1 launches."""
    import torch

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.engine.executor import Executor

    flags = MAMBA3_VARIANTS["rope, rank 2, no conv"]
    reqs = [(p, GenerationConfig(max_tokens=MAMBA3_TOKENS, temperature=0.0))
            for p, _ in offload_requests(32000, 1)]
    model = mamba3_model(dev, flags, MAMBA3_LAYERS)
    f32 = in_f32(model)
    engine, _ = family_engine(f32, True, 1024)
    wave = [r["tokens"] for r in asyncio.run(serve(engine, [reqs]))]
    ex = Executor(f32, StubTokenizer(), offload_app(f32.cfg))
    alone = [[t.token_id for t in ex.generate(p, g)] for p, g in reqs]
    assert wave == alone, [i for i, (a, b) in enumerate(zip(wave, alone)) if a != b]
    del engine, ex, f32
    free_card()
    engine, _ = family_engine(model, True, 1024)
    reset_counts()
    t0 = time.perf_counter()
    results = asyncio.run(serve(engine, [reqs]))
    wall = time.perf_counter() - t0
    counts = read_counts()
    assert counts["qmm"] > 0 and all(len(r["tokens"]) == MAMBA3_TOKENS for r in results)
    ms_step = decode_step_ms(engine)
    log(f"  mamba3 rank 2: the BatchEngine's 8 streams (card in f32) equal the Executor's; "
        f"bf16: 8 x {MAMBA3_TOKENS} tokens in {wall:.2f} s, a batch-8 decode step "
        f"{ms_step:.3f} ms (a replayed graph), B1 {counts['qmm']}; {card}")
    del engine, model
    free_card()
    return dict(streams_equal=True, wall_s=wall, ms_per_step=ms_step, qmm=counts["qmm"])


def offload_dp(dev, card: str, full_run: bool) -> dict:
    """Part (d): two BatchEngine replicas of one Mistral-7B model (DP_LAYERS
    layers, 2 in a full run; the card in f32; each its own KV pool, warmed)
    behind a cache-aware DataParallelGroup serve 8 greedy requests of two
    prompt families at once, with the trace spans captured; then one engine
    serves them alone, and every stream must equal the replicas' (state
    shared between replicas would show). Spans counted, requests per
    replica, tok/s both ways."""
    import logging

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.engine.data_parallel import DataParallelGroup
    from blazr_tpu_torch.utils import tracing

    model = in_f32(mistral_model(dev, 2 if full_run else DP_LAYERS))
    engines = [family_engine(model, True, 1024)[0] for _ in range(3)]
    group = DataParallelGroup(engines[:2])
    texts = [("the first family of prompts " * 8 + str(i)) for i in range(4)]
    texts += [("another family, of other prompts " * 8 + str(i)) for i in range(4)]
    reqs = [(p, GenerationConfig(max_tokens=DP_TOKENS, temperature=0.0))
            for p, _ in offload_requests(model.cfg.vocab_size, 1)]

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__(logging.DEBUG)
            self.lines: list = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    handler = Lines()
    tracing.logger.addHandler(handler)
    tracing.logger.setLevel(logging.DEBUG)

    async def both():
        tasks = [asyncio.create_task(r.engine.run()) for r in group.replicas]
        picks, handles = [], []
        for text, (prompt, gen) in zip(texts, reqs):
            r = group.select(text)
            picks.append(r)
            handles.append(r.engine.submit(prompt, gen))

        async def collect(h):
            return [t.token_id async for t in h.tokens()]

        out = await asyncio.wait_for(asyncio.gather(*[collect(h) for h in handles]), 600)
        for r in picks:
            group.release(r)
        for r in group.replicas:
            r.engine.stop()
        await asyncio.gather(*tasks)
        return out, [r.index for r in picks]

    reset_counts()
    t0 = time.perf_counter()
    streams, picked = asyncio.run(both())
    wall = time.perf_counter() - t0
    counts = read_counts()
    tracing.logger.removeHandler(handler)
    tracing.logger.setLevel(logging.NOTSET)
    t0 = time.perf_counter()
    alone = [r["tokens"] for r in asyncio.run(serve(engines[2], [reqs]))]
    wall1 = time.perf_counter() - t0
    starts = [line for line in handler.lines if "_start" in line]
    ends = [line for line in handler.lines if "_end" in line and "elapsed_ms=" in line]
    agree = sum(a == b for a, b in zip(streams, alone))
    log(f"  two replicas ({model.cfg.num_layers} layers, the card in f32): requests per "
        f"replica {[picked.count(i) for i in (0, 1)]}, 8 x {DP_TOKENS} tokens in {wall:.2f} s "
        f"({8 * DP_TOKENS / wall:.0f} tok/s) against {wall1:.2f} s on one engine; "
        f"{agree} of 8 streams equal one engine's; B1 "
        f"{counts['qmm']}, B2 {counts['paged_attention']}; {len(starts)} span starts, "
        f"{len(ends)} ends, e.g. '{ends[0] if ends else ''}'; {card}")
    assert len(set(picked)) == 2 and all(len(s) == DP_TOKENS for s in streams)
    assert streams == alone, [i for i, (a, b) in enumerate(zip(streams, alone)) if a != b]
    assert starts and len(starts) == len(ends), (len(starts), len(ends))
    assert counts["qmm"] > 0 and counts["paged_attention"] > 0, counts
    assert [s["active"] for s in group.stats()] == [0, 0]
    del engines, group, model
    free_card()
    return dict(per_replica=[picked.count(i) for i in (0, 1)], wall_s=wall, alone_s=wall1,
                agree=agree, spans=len(starts), qmm=counts["qmm"],
                paged_attention=counts["paged_attention"])


def offload_phase(dev, card: str, full_run: bool) -> dict:
    """Phase 18: (a) Mixtral-8x7B under the hybrid expert offload, (b)
    Mistral-7B with half its layers streamed from host memory, (c) the
    Mamba3 mixer at Codestral's widths, (d) two BatchEngine replicas behind
    a DataParallelGroup with the trace spans."""
    out = {}
    for part, fn in (("moe", lambda: offload_mixtral(dev, card, full_run)),
                     ("stream", lambda: offload_stream(dev, card, full_run)),
                     ("mamba3", lambda: dict(
                         {name: mamba3_check(dev, name, flags)
                          for name, flags in MAMBA3_VARIANTS.items()
                          if not (full_run and flags["use_conv"])},
                         engines=mamba3_engines(dev, card))),
                     ("dp", lambda: offload_dp(dev, card, full_run))):
        t0 = time.perf_counter()
        out[part] = fn()
        log(f"  ({part}: {time.perf_counter() - t0:.1f} s)")
    return out


def tok_cfg():
    """Mistral-7B's config: the widths of phase 7's checkpoint."""
    from blazr_tpu_torch.utils.synthetic import mistral_7b_config

    return mistral_7b_config()


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
    if "vision" in res:   # B1 at LLaVA-1.5-7B's shapes, timed in phase 15
        rows = res["vision"]["b1"]["rows"]
        line.append(dict(
            name="qmm_w4a16 (B1), LLaVA-1.5-7B image chats", route="cuda",
            source="blazr_tpu_torch/csrc/qmm.cu",
            replaces="blazr_tpu/quant/pallas/int_matmul.py:69",
            launches=got("vision", "qmm"), max_abs_err=res["vision"]["b1"]["max_abs_err"],
            **{key: rows[("llava gate/up", 600)][key] for key in keys},
            decode={key: rows[("llava gate/up", 1)][key] for key in keys},
            at=[{key: row[key] for key in keys} for sh, row in rows.items()
                if sh[0] != "llava gate/up"]))
    if "spec" in res:  # B1 at the verify's 48 rows and B2 at its query rows, phase 16
        sp = res["spec"]
        rows = sp["b1"]["rows"]
        line.append(dict(
            name="qmm_w4a16 (B1), speculative verify (48 rows) and draft chain", route="cuda",
            source="blazr_tpu_torch/csrc/qmm.cu",
            replaces="blazr_tpu/quant/pallas/int_matmul.py:69",
            launches=got("spec", "qmm"), max_abs_err=sp["b1"]["max_abs_err"],
            **{key: rows[("gate+up", 48)][key] for key in keys},
            at=[{key: row[key] for key in keys} for sh, row in rows.items()
                if sh[0] != "gate+up"]))
        line.append(dict(
            name="paged_attention_decode (B2), speculative verify (a query row a position)",
            route="cuda", source="blazr_tpu_torch/csrc/paged_attention.cu",
            replaces="blazr_tpu/attention/paged_attention.py:34",
            launches=got("spec", "paged_attention"), max_abs_err=sp["b2"]["max_abs_err"],
            gather_ms=sp["b2"]["gather_ms"], **{key: sp["b2"][key] for key in keys}))
    # B1 at a tp 2 rank's Mistral-7B shapes and B2 at its 16/4 heads, with
    # phase 19's launches on rank 0 (its tensor- and expert-parallel runs).
    tb1 = b1_at_shapes(dev, gen, TP_B1_SHAPES, (8, 512))
    tb2 = time_b2_families(dev, gen, TP_B2_POINTS)[TP_B2_POINTS[0][0]]
    par = res.get("parallel")
    by_part = None
    if par:
        by_part = {"tp 2 (a), rank 0": par["tp"]["qmm"],
                   **{f"{k} (b), rank 0": v["qmm"] for k, v in par["ep"].items()}}
    rows = tb1["rows"]
    line.append(dict(
        name="qmm_w4a16 (B1), tensor- and expert-parallel ranks (tp 2 rank shapes)",
        route="cuda", source="blazr_tpu_torch/csrc/qmm.cu",
        replaces="blazr_tpu/quant/pallas/int_matmul.py:69",
        launches=got("parallel", "qmm"), launches_by_part=by_part,
        max_abs_err=tb1["max_abs_err"],
        **{key: rows[("gate/up tp2", 512)][key] for key in keys},
        decode={key: rows[("gate/up tp2", 8)][key] for key in keys},
        at=[{key: row[key] for key in keys} for sh, row in rows.items()
            if sh[0] != "gate/up tp2"]))
    line.append(dict(
        name="paged_attention_decode (B2), tensor-parallel rank heads (16/4)", route="cuda",
        source="blazr_tpu_torch/csrc/paged_attention.cu",
        replaces="blazr_tpu/attention/paged_attention.py:34",
        launches=got("parallel", "paged_attention"), max_abs_err=tb2["max_abs_err"],
        **{key: tb2[key] for key in keys}))
    # B1 at DeepSeek-V2-Lite's tp 2 rank shapes and B2 at Bamba-9B's rank
    # heads, with the launches of phase 19's parts (f)-(i) on rank 0.
    mb1 = b1_at_shapes(dev, gen, MESH_B1_SHAPES, (8, 512))
    mb2 = time_b2_families(dev, gen, MESH_B2_POINTS)[MESH_B2_POINTS[0][0]]
    mesh = (par or {}).get("mesh")
    by_part = None
    if mesh:
        by_part = {f"{label}{', ' + run if run else ''}": r["launches_per_rank"][0]
                   for label, rep in mesh.items() if isinstance(rep, dict)
                   for run, r in rep.items() if run in ("", "lookup", "draft")}
    rows = mb1["rows"]
    line.append(dict(
        name="qmm_w4a16 (B1), the families' mesh ranks (DeepSeek-V2-Lite tp 2 rank shapes)",
        route="cuda", source="blazr_tpu_torch/csrc/qmm.cu",
        replaces="blazr_tpu/quant/pallas/int_matmul.py:69",
        launches=got("parallel", "mesh_qmm"), launches_by_part=by_part,
        max_abs_err=mb1["max_abs_err"],
        **{key: rows[("deepseek dense gate/up tp2", 512)][key] for key in keys},
        decode={key: rows[("deepseek dense gate/up tp2", 8)][key] for key in keys},
        at=[{key: row[key] for key in keys} for sh, row in rows.items()
            if sh[0] != "deepseek dense gate/up tp2"]))
    line.append(dict(
        name="paged_attention_decode (B2), the families' mesh ranks (Bamba-9B tp 2 heads, "
             "16/4)", route="cuda", source="blazr_tpu_torch/csrc/paged_attention.cu",
        replaces="blazr_tpu/attention/paged_attention.py:34",
        launches=got("parallel", "mesh_paged_attention"), max_abs_err=mb2["max_abs_err"],
        **{key: mb2[key] for key in keys}))
    if gguf:           # B3 and B4 on the file's Q4_K gate weight, beside their rows
        for row in line:
            kernel = row["name"].split("(")[-1].rstrip(")")
            if kernel in ("B3", "B4") and "," not in row["name"]:
                row["gguf"] = [{key: r[key] for key in keys}
                               for (k, _), r in gguf["others"].items() if k.startswith(kernel)]
    return line


# ---------------------------------------------------------------------------
# phase 19: tensor, expert and sequence parallelism; lockstep; swarm; disagg
# ---------------------------------------------------------------------------

# Depths of phase 19: --phases build,parallel serves the first of each pair,
# a full run the second (``main`` sets PAR_DEPTH).
PAR_DEPTHS = {"tp": (32, 4), "ep": (2, 1), "sp": (2, 2), "swarm": (32, 4), "disagg": (32, 2)}
PAR_DEPTH = {k: v[0] for k, v in PAR_DEPTHS.items()}
PAR_CHECK_LAYERS = 2                # (a)'s f32 check
PAR_TOKENS = 64                     # (a)'s greedy tokens a request
SP_PROMPT, SP_TOKENS = 8192, 16     # (c): one prompt past Mistral's 4096 window
PIPE_PROMPT, PIPE_TOKENS = 128, 32  # (d), (e)
PAR_F32_TOL = 1e-3                  # f32 logits of a mesh vs one rank, of the largest
EP_TOL = 1e-3                       # moe_ffn_ep vs moe_ffn in f32, of the largest
# The rank shapes of Mistral-7B at tp 2 (K, N): phase 9's B1 rows.
TP_B1_SHAPES = {"q tp2": (4096, 2048), "k/v tp2": (4096, 512), "o tp2": (2048, 4096),
                "gate/up tp2": (4096, 7168), "down tp2": (7168, 4096)}
TP_B2_POINTS = (("mistral tp2 d=128 16/4", 16, 4, 128, 4096, None, None),)
# What the rank processes run on, and configs standing in for the published
# ones (a CPU rehearsal sets both; a RankPool job carries them to its ranks).
PAR_RUN = {"device": "cuda", "configs": {}}


def _config(name: str):
    import copy

    from blazr_tpu_torch.utils.synthetic import mistral_7b_config, mixtral_8x7b_config

    cfg = PAR_RUN["configs"].get(name)
    if cfg is not None:
        return copy.deepcopy(cfg)
    return {"mistral": mistral_7b_config, "mixtral": mixtral_8x7b_config}[name]()


def _sync() -> None:
    import torch

    if PAR_RUN["device"] == "cuda":
        torch.cuda.synchronize()


def _wall_ms(fn, iters: int = 3) -> float:
    """Wall ms of one ``fn()`` (after one warm call), the device drained on
    each side: a MoE FFN reads its routing to the host, so its wall is what
    a step pays."""
    fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def rank_job(a: dict):
    """A phase 19 job on one rank of a ``multihost.RankPool`` of four
    processes sharing the card: PAR_RUN as the phase set it, f32 references
    in f32, the card's cache emptied after."""
    import faulthandler

    import torch

    PAR_RUN.update(a["run"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # A job near its deadline (a rank waiting in a collective its peer never
    # joins) writes every thread's stack to the rank's log, which the pool's
    # error carries.
    faulthandler.dump_traceback_later(a["dump_s"], exit=False)
    try:
        return PAR_JOBS[a["job"]](a)
    finally:
        faulthandler.cancel_dump_traceback_later()
        free_card()


def _par_app(cfg, mesh: dict, **inf):
    from blazr_tpu_torch.config import AppConfig

    app = AppConfig(model=cfg)
    app.inference.tensor_parallel_size = mesh.get("tp", 1)
    app.inference.expert_parallel_size = mesh.get("ep", 1)
    app.inference.sequence_parallel_size = mesh.get("sp", 1)
    for k, v in inf.items():
        setattr(app.inference, k, v)
    return app


def _mistral(layers: int, dtype, max_seq_len: int | None = None):
    """Mistral-7B at ``layers`` layers, AWQ-INT4 from seed 0 on the ranks'
    device; ``max_seq_len`` past the synthetic config's 4096 (the model's
    32,768 positions) for (c)'s prompt."""
    import torch

    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.utils.synthetic import synth_llama_params

    cfg = _config("mistral")
    cfg.num_layers = layers
    cfg.max_seq_len = max_seq_len or cfg.max_seq_len
    return Model(cfg, synth_llama_params(cfg, quant="awq", dtype=dtype, seed=SEED,
                                         device=torch.device(PAR_RUN["device"])), dtype)


def _lockstep_waves(engine, waves: list, timed_wave: int = -1) -> dict:
    """Every rank drives ``engine`` through a LockstepEngine; rank 0 submits
    ``waves`` of (prompt, GenerationConfig), each after the previous wave
    ended, and times each; ``comm.stats.timed`` is on during wave
    ``timed_wave`` only (its collectives' ms; a device sync each side)."""
    import torch
    import torch.distributed as dist

    from blazr_tpu_torch.distributed.lockstep import LockstepEngine
    from blazr_tpu_torch.parallel import comm

    ls = LockstepEngine(engine, heartbeat_s=2.0)
    out: dict = {"waves": []}

    async def beside(aw, task):
        """``aw``'s result, or the loop task's error if it ends first (a
        step that raised leaves every stream waiting)."""
        fut = asyncio.ensure_future(aw)
        done, _ = await asyncio.wait({fut, task}, timeout=1500,
                                     return_when=asyncio.FIRST_COMPLETED)
        if fut in done:
            return fut.result()
        fut.cancel()
        if task in done:
            task.result()
            raise RuntimeError("the lockstep loop ended before its requests")
        raise TimeoutError("a lockstep wave did not end within 1500 s")

    async def primary():
        task = asyncio.create_task(ls.run())
        for w, wave in enumerate(waves):
            comm.stats.timed = w == timed_wave
            counts0 = read_counts()
            comm.stats.reset()
            steps0, hsteps0 = ls.steps, engine.horizon_steps
            dec0, pre0 = engine.perf["decode"], engine.perf["prefill"]
            spec0 = (engine.perf["spec"], engine.perf["spec_n"], engine.spec_drafted,
                     engine.spec_accepted)
            t0 = time.perf_counter()
            handles = await beside(asyncio.gather(*[ls.submit(p, g) for p, g in wave]), task)

            async def collect(h):
                return [t.token_id async for t in h.tokens()]

            streams = await beside(asyncio.gather(*[collect(h) for h in handles]), task)
            _sync()
            wall = time.perf_counter() - t0
            hsteps = engine.horizon_steps - hsteps0
            out["waves"].append(dict(
                streams=streams, wall=wall, tokens=sum(len(s) for s in streams),
                engine_steps=ls.steps - steps0, decode_steps=hsteps,
                decode_ms=(engine.perf["decode"] - dec0) * 1e3 / max(1, hsteps),
                prefill_s=engine.perf["prefill"] - pre0,
                spec_rounds=engine.perf["spec_n"] - spec0[1],
                spec_ms=(engine.perf["spec"] - spec0[0]) * 1e3
                / max(1, engine.perf["spec_n"] - spec0[1]),
                drafted=engine.spec_drafted - spec0[2], accepted=engine.spec_accepted - spec0[3],
                counts={k: v - counts0[k] for k, v in read_counts().items()},
                comm=comm.stats.snapshot()))
        comm.stats.timed = False
        ls.stop()
        await task

    reset_counts()
    if not dist.is_initialized() or dist.get_rank() == 0:     # a world of one: no group
        asyncio.run(primary())
    else:
        asyncio.run(ls.run())
    out["steps"] = ls.steps
    out["counts_total"] = read_counts()           # this rank's, every wave: the
    # ranks reset together, run the same steps, and read after the last
    return out


def _rank_shapes(model) -> dict:
    """The (K, N) of each B1 projection of a rank (its first layer that has
    one), and its attention heads."""
    from blazr_tpu_torch.models.layers import RowParallel

    out = {}
    for layer in model.params["layers"]:          # each key's first layer (a hybrid's
        for key in ("q", "q_b", "k", "v", "o", "gate", "up", "down", "in_proj",
                    "out_proj"):                  # attention layer is not layer 0)
            w = layer.get(key)
            if isinstance(w, RowParallel):
                w = w.weight
            if w is not None and key not in out and hasattr(w, "in_features"):
                out[key] = (w.in_features, w.out_features)
    att = model.cfg.attention
    if att is not None:
        out["heads"] = (att.num_heads, att.kv_heads())
    return out


def job_tp_serve(a: dict) -> dict:
    """(a): Mistral-7B at tp 2, bf16, lockstep over BatchEngine: phase 5's 8
    greedy requests (64 tokens), then again with the collectives timed."""
    import torch
    import torch.distributed as dist

    from blazr_tpu_torch.engine.batch_engine import BatchEngine

    model = _mistral(a["layers"], torch.bfloat16)
    reqs = family_requests(model.cfg, greedy_only=True)
    eng = BatchEngine(model, StubTokenizer(), _par_app(model.cfg, {"tp": 2}))
    out = _lockstep_waves(eng, [reqs, reqs], timed_wave=1)
    out.update(shapes=_rank_shapes(model), backend=dist.get_backend(),
               graphs=eng.graphs.enabled)
    return out


def job_tp_f32(a: dict) -> dict:
    """(a)'s f32 check: 2-layer Mistral-7B in f32 at tp 2: a prefill's logits
    through the Executor and the 8 greedy streams (16 tokens) through the
    lockstep BatchEngine."""
    import torch

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine
    from blazr_tpu_torch.engine.executor import Executor

    model = _mistral(PAR_CHECK_LAYERS, torch.float32)
    reqs = [(p, GenerationConfig(max_tokens=16, temperature=0.0))
            for p, _ in family_requests(model.cfg, greedy_only=True)]
    ex = Executor(model, StubTokenizer(), _par_app(model.cfg, {"tp": 2}))
    last, _ = ex.prefill(ex._init_cache(1), reqs[1][0])
    eng = BatchEngine(model, StubTokenizer(), _par_app(model.cfg, {"tp": 2}))
    out = _lockstep_waves(eng, [reqs])
    out["logits"] = last.float().cpu()
    return out


def job_ep(a: dict) -> dict:
    """(b): Mixtral-8x7B widths on an ep (x tp) mesh, f32 activations: layer
    0's moe_ffn_ep on 512 prefill rows and 8 decode rows at a capacity that
    drops nothing, against moe_ffn on the whole layer (rank 0), timed; a
    capacity that drops, its count against the plain make_dispatch's; then
    one 512-token and 7 short requests through the lockstep BatchEngine."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine
    from blazr_tpu_torch.models.moe import moe_ffn, route
    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.parallel.ep import DROPPED_TOKENS, make_dispatch, moe_ffn_ep
    from blazr_tpu_torch.utils.synthetic import synth_llama_params

    dev = torch.device(PAR_RUN["device"])
    cfg = _config("mixtral")
    cfg.num_layers = a["layers"]
    params = synth_llama_params(cfg, quant="awq", dtype=torch.float32, seed=SEED, device=dev)
    whole = params["layers"][0]["moe"]          # layer 0 unsliced (rank 0's reference)
    model = Model(cfg, params, torch.float32)
    eng = BatchEngine(model, StubTokenizer(), _par_app(model.cfg, a["mesh"]))
    rank = dist.get_rank()
    mine, moe = model.params["layers"][0]["moe"], model.cfg.moe
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    out: dict = {"experts": (mine["mesh"].first, mine["mesh"].count),
                 "rows": {}, "backend": dist.get_backend()}
    if rank != 0:
        whole = None
    for rows in (512, 8):
        x = torch.randn((1 if rows == 512 else 8, rows if rows == 512 else 1, cfg.hidden_size),
                        device=dev, generator=g) * 0.5
        cap = x.shape[0] * x.shape[1] * moe.experts_per_tok      # no expert can overflow
        reset_counts()
        got = moe_ffn_ep(x, mine, moe, capacity=cap)
        launches = read_counts()["qmm"]
        ms = _wall_ms(lambda: moe_ffn_ep(x, mine, moe, capacity=cap))
        row = dict(ms=ms, qmm=launches)
        if whole is not None:
            want = moe_ffn(x, whole, cfg.moe)
            row["err"] = ((got - want).abs().max() / want.abs().max()).item()
            row["one_rank_ms"] = _wall_ms(lambda: moe_ffn(x, whole, cfg.moe))
        out["rows"][rows] = row
        if rows == 512:
            moe.ep_count_drops = True
            before = DROPPED_TOKENS["count"]
            moe_ffn_ep(x, mine, moe, capacity=64)
            out["dropped"] = DROPPED_TOKENS["count"] - before
            moe.ep_count_drops = False
            if whole is not None:
                idx, w = route(x.reshape(-1, cfg.hidden_size), whole["router"], cfg.moe)
                out["plain_dropped"] = int(make_dispatch(idx, w, moe.num_experts, 64)[2])
    del whole
    rng = np.random.default_rng(SEED + 11)
    reqs = [(rng.integers(0, cfg.vocab_size, n).tolist(),
             GenerationConfig(max_tokens=8, temperature=0.0)) for n in [512] + [64] * 7]
    out.update(_lockstep_waves(eng, [reqs]))
    return out


def job_sp(a: dict) -> dict:
    """(c): 2-layer Mistral-7B in f32 at sp 4: an 8192-token prompt through
    the Executor's ring prefill (timed, its logits), then 16 greedy
    tokens."""
    import torch

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.parallel import comm

    model = _mistral(a["layers"], torch.float32, SP_PROMPT + 64)
    ex = Executor(model, StubTokenizer(), _par_app(model.cfg, {"sp": 4}))
    prompt = a["prompt"]
    cache = ex._init_cache(1)
    ex.prefill(cache, prompt[:512])                 # a first ring (allocations)
    comm.stats.reset()
    _sync()
    t0 = time.perf_counter()
    last, _ = ex.prefill(ex._init_cache(1), prompt)
    _sync()
    ring_ms = (time.perf_counter() - t0) * 1e3
    stats = comm.stats.snapshot()
    reset_counts()
    toks = [t.token_id for t in ex.generate(prompt, GenerationConfig(
        max_tokens=SP_TOKENS, temperature=0.0))]
    return dict(logits=last.float().cpu(), ms=ring_ms, comm=stats, tokens=toks,
                counts=read_counts())


# Parts (f)-(i): what entry 8 of ROADMAP queue A serves under a mesh, at the
# published widths, in f32 on the card (a rank's greedy streams can then be
# held to one rank's), AWQ-INT4 from seed 0.
MESH_LAYERS = 2                     # (f)-(h); DeepSeek's dense layer 0 and MoE layer 1
MESH_LLAVA_LAYERS = 4               # (i), as phase 15 cuts LLaVA-1.5-7B
MESH_TOKENS = 32                    # greedy tokens a request
MESH_SPEC_K = 5                     # (h)'s num_speculative_tokens
MESH_JOB_S = 600                    # a part's job deadline (seconds)
# f32 prefill logits of a rank against one rank's, of the largest (the SSM
# scans' sums run in another order on a rank's fewer columns: 1e-4).
MESH_TOL = {"deepseek": 1e-5, "mistral": 1e-5, "llava": 1e-5, "mamba2": 1e-4,
            "bamba": 1e-4, "mamba3": 1e-4}
# (part, label, family, AWQ group, mesh): DeepSeek's dense down (K 10944)
# splits at tp 2 only in groups of 32.
MESH_PARTS = (("f", "DeepSeek-V2-Lite tp 2", "deepseek", 32, {"tp": 2}),
              ("f", "DeepSeek-V2-Lite ep 2", "deepseek", 64, {"ep": 2}),
              ("g", "Mamba-Codestral-7B tp 2", "mamba2", 128, {"tp": 2}),
              ("g", "Bamba-9B tp 2", "bamba", 128, {"tp": 2}),
              ("g", "Mamba3 mixer (Codestral widths) tp 2", "mamba3", 128, {"tp": 2}),
              ("h", "Mistral-7B tp 2, speculative (k = 5)", "mistral", 128, {"tp": 2}))
LORA_REFUSAL = "LoRA under mesh-sharded serving is not supported yet"
# Phase 9's rows at the parts' rank shapes: DeepSeek-V2-Lite at tp 2 in groups
# of 32 (K, N, group) and Bamba-9B's B2 at a rank's 16 of 32 heads, 4 of 8 kv.
MESH_B1_SHAPES = {"deepseek q tp2": (2048, 1536, 32), "deepseek o tp2": (1024, 2048, 32),
                  "deepseek dense gate/up tp2": (2048, 5472, 32),
                  "deepseek dense down tp2": (5472, 2048, 32),
                  "deepseek expert gate/up tp2": (2048, 704, 32)}
MESH_B2_POINTS = (("bamba tp2 d=128 16/4", 16, 4, 128, None, None, None),)


def _mesh_config(fam: str, layers: int):
    """A part's config at ``layers`` layers: PAR_RUN's stand-in where a
    rehearsal set one, else the published one (a hybrid cut as phase 14
    cuts it: an attention layer kept)."""
    import copy

    from blazr_tpu_torch.utils.synthetic import mistral_7b_config

    base = "mamba2" if fam == "mamba3" else fam
    cfg = PAR_RUN["configs"].get(base)
    if cfg is None:
        if base in ("deepseek", "mamba2", "bamba"):
            return recurrent_config(base, layers)
        cfg = {"mistral": mistral_7b_config, "tinyllama": tinyllama_config}[base]()
    cfg = copy.deepcopy(cfg)
    cfg.num_layers = layers
    if cfg.hybrid_layers is not None:
        cfg.hybrid_layers = cfg.hybrid_layers[:layers]
    return cfg


def _mesh_model(fam: str, group: int, layers: int = MESH_LAYERS):
    """A part's model in f32 on the ranks' device, AWQ-INT4 in groups of
    ``group`` from seed 0 (Mamba3: Codestral's with ``to_mamba3``)."""
    import torch

    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.utils.synthetic import synth_llama_params, synth_recurrent_params

    dev = torch.device(PAR_RUN["device"])
    cfg = _mesh_config(fam, layers)
    synth = synth_llama_params if fam in ("mistral", "tinyllama") else synth_recurrent_params
    params = synth(cfg, quant="awq", dtype=torch.float32, group_size=group, seed=SEED,
                   device=dev)
    model = Model(cfg, params, torch.float32)
    if fam == "mamba3":
        to_mamba3(model, MAMBA3_VARIANTS["rope, rank 2, no conv"], dev)
    return model


def _mesh_inf(mesh: dict, **inf) -> dict:
    """The engines' knobs of parts (f)-(i): 8 rows, contexts of 1024."""
    return dict(max_batch_size=8, max_seq_len=1024, **inf)


def _lora_refusal(ex) -> str | None:
    """A LoRA adapter on a sliced model: the error's text, or None."""
    try:
        ex.set_lora(object())
    except ValueError as e:
        return str(e)
    return None


def job_mesh_family(a: dict) -> dict:
    """Parts (f)-(h) on one rank of ``a["mesh"]`` (``{}``: the one-rank
    reference, a world of one; ``use_ep``: the expert-parallel function
    there, as an ep part's reference): the f32 prefill logits of request 1 through
    the Executor and, on a mesh, the LoRA refusal; then the 8 greedy
    requests (32 tokens) through the lockstep BatchEngine, and again at 4
    tokens with the collectives timed. (h) serves phase 16's extractive
    prompts with prompt-lookup drafts, then with the TinyLlama-width draft."""
    import numpy as np
    import torch.distributed as dist

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.config.inference import SpeculativeDecodingConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine
    from blazr_tpu_torch.engine.executor import Executor

    fam, mesh = a["fam"], a["mesh"]
    model = _mesh_model(fam, a["group"])
    if a.get("use_ep"):
        # An ep part's one-rank reference computes the expert-parallel
        # function (capacity drops included) on every expert, eagerly as
        # under a mesh: it reads its routing to the host in every step.
        model.cfg.moe.use_ep = True
        mesh_inf = dict(graphs=False)
    else:
        mesh_inf = {}
    spec = fam == "mistral"
    prompts = (spec_prompts(np.random.default_rng(SEED + 16)) if spec
               else [p for p, _ in family_requests(model.cfg, greedy_only=True)])

    def reqs(n):
        return [(p, GenerationConfig(max_tokens=n, temperature=0.0, repeat_penalty=1.0))
                for p in prompts]

    ex = Executor(model, StubTokenizer(),
                  _par_app(model.cfg, mesh, **_mesh_inf(mesh, **mesh_inf)))
    last, _ = ex.prefill(ex._init_cache(1), prompts[1])
    out = {"logits": last.float().cpu(), "shapes": _rank_shapes(model),
           "lora": _lora_refusal(ex) if mesh else None,
           "backend": dist.get_backend() if dist.is_initialized() else None}
    del ex
    runs = {"": None} if not spec else {"lookup": None,
                                         "draft": _mesh_model("tinyllama", a["group"])}
    for name, draft in runs.items():
        inf = dict(mesh_inf, **({"speculative": SpeculativeDecodingConfig(
            num_speculative_tokens=MESH_SPEC_K)} if spec else {}))
        eng = BatchEngine(model, StubTokenizer(),
                          _par_app(model.cfg, mesh, **_mesh_inf(mesh, **inf)),
                          draft_model=draft)
        res = _lockstep_waves(eng, [reqs(MESH_TOKENS), reqs(4)], timed_wave=1)
        res["draft_sliced"] = draft is not None and draft.mesh is not None
        out[name] = res
        del eng
    return out


def job_mesh_llava(a: dict) -> dict:
    """Part (i) on one rank of ``a["mesh"]``: the 4-layer LLaVA-1.5-7B from
    disk in f32 (its mmproj sidecar found beside it), the f32 prefill logits
    of its first MESH_LAYERS layers, a PNG image chat built
    as the chat route builds it (the template, the body's config) through
    the MultimodalExecutor over the rank's Executor, its text and ms a
    token; then the 8 greedy requests through the lockstep BatchEngine."""
    import torch.distributed as dist

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.engine.executor_multimodal import (MediaBoundExecutor,
                                                             MultimodalExecutor)
    from blazr_tpu_torch.engine.generate_text import collect_generation
    from blazr_tpu_torch.loader import load_model
    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.server import app as server_app
    from blazr_tpu_torch.tokenizer import load_tokenizer

    mesh = a["mesh"]
    model, app = load_model(a["dir"], dtype="f32", device=PAR_RUN["device"])
    assert model.is_multimodal
    for k, v in _mesh_inf(mesh).items():
        setattr(app.inference, k, v)
    app.inference.tensor_parallel_size = mesh.get("tp", 1)
    tok = load_tokenizer(a["dir"])
    reqs = [(p, GenerationConfig(max_tokens=n, temperature=0.0, repeat_penalty=1.0))
            for n in (MESH_TOKENS, 4)
            for p, _ in family_requests(model.cfg, greedy_only=True)]
    # The f32 logits check at the other parts' depth: the first MESH_LAYERS
    # layers of the same weights as a model of their own, sliced on its own.
    view = Model(dataclasses.replace(model.cfg, num_layers=MESH_LAYERS),
                 dict(model.params, layers=model.params["layers"][:MESH_LAYERS]), model.dtype)
    check = Executor(view, tok, app)
    last, _ = check.prefill(check._init_cache(1), reqs[1][0])
    del check, view
    ex = Executor(model, tok, app)
    body = a["body"]
    ids = tok.encode(server_app._build_prompt(body, model.cfg))
    cfg = server_app.gen_config_from_body(body, app.generation)
    bound = MediaBoundExecutor(MultimodalExecutor(ex, model.vision_params, model.vision_cfg),
                               [a["png"]], [])
    reset_counts()
    _sync()
    t0 = time.perf_counter()
    chat = collect_generation(bound, ids, cfg, True)
    _sync()
    chat_s = time.perf_counter() - t0
    out = {"logits": last.float().cpu(), "chat": chat.text, "chat_tokens": chat.tokens,
           "chat_s": chat_s,
           "chat_counts": read_counts(), "rows": bound.rows,
           "lora": _lora_refusal(ex) if mesh else None,
           "backend": dist.get_backend() if dist.is_initialized() else None}
    eng = BatchEngine(model, StubTokenizer(), app)
    out[""] = _lockstep_waves(eng, [reqs[:8], reqs[8:]], timed_wave=1)
    out["shapes"] = _rank_shapes(model)
    return out


PAR_JOBS = {"tp_serve": job_tp_serve, "tp_f32": job_tp_f32, "ep": job_ep, "sp": job_sp,
            "mesh_family": job_mesh_family, "mesh_llava": job_mesh_llava}


def _one_rank_f32(dev) -> dict:
    """(a)'s reference: the 2-layer f32 model on one rank, in this process."""
    import torch

    from blazr_tpu_torch.config import AppConfig, GenerationConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine
    from blazr_tpu_torch.engine.executor import Executor

    model = _mistral(PAR_CHECK_LAYERS, torch.float32)
    reqs = [(p, GenerationConfig(max_tokens=16, temperature=0.0))
            for p, _ in family_requests(model.cfg, greedy_only=True)]
    ex = Executor(model, StubTokenizer(), AppConfig(model=model.cfg))
    last, _ = ex.prefill(ex._init_cache(1), reqs[1][0])
    recs = asyncio.run(serve(BatchEngine(model, StubTokenizer(), AppConfig(model=model.cfg)),
                             [reqs]))
    out = dict(logits=last.float().cpu(), streams=[r["tokens"] for r in recs])
    del model, ex
    free_card()
    return out


def _cli_serve_tp2_start(ckpt: Path, root: Path, extra: tuple = (),
                         name: str = "cli_serve_tp2") -> dict:
    """Start ``cli serve --tp 2 --continuous-batching`` (warmed unless
    ``extra`` says otherwise) on phase 7's checkpoint, or (i)'s; it comes up
    while the rank pool's jobs run (``_cli_serve_tp2_finish`` and
    ``_cli_serve_llava_finish`` wait for it)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    errp = root / f"{name}.log"
    err = open(errp, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "blazr_tpu_torch.cli", "--device", PAR_RUN["device"], "serve",
         "--model", str(ckpt), "--continuous-batching", "--tp", "2", "--host", "127.0.0.1",
         "--port", str(port), *extra],
        cwd=TREE, env=dict(os.environ, PYTHONPATH=str(TREE)), stdout=subprocess.DEVNULL,
        stderr=err)
    return dict(proc=proc, port=port, errp=errp, err=err, t0=time.perf_counter())


def _cli_serve_tp2_finish(st: dict, card: str) -> dict:
    """4 chats at once from rank 0 over HTTP, their embeddings, one more
    chat, then SIGINT; both ranks log the steps
    they ran (rank 1 shares rank 0's stderr) and must agree."""
    import concurrent.futures
    import re
    import signal

    import numpy as np

    proc, port, errp = st["proc"], st["port"], st["errp"]
    try:
        while True:
            assert proc.poll() is None, errp.read_text()[-4000:]
            try:
                if _http(port, "GET", "/health", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            assert time.perf_counter() - st["t0"] < 600, "cli serve --tp 2 did not come up"
            time.sleep(1.0)
        up = time.perf_counter() - st["t0"]
        texts = [f"Question {i}: say something about the number {i * 7}." for i in range(4)]
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            chats = list(pool.map(lambda t: _stream_chat(port, {
                "messages": [{"role": "user", "content": t}], "max_tokens": 32,
                "temperature": 0.0, "stream": True}), texts))
        wall = time.perf_counter() - t1
        assert all(c["done"] and c["finish"] and c["deltas"] for c in chats), chats
        # The embedding lookup of a sharded vocab: a lockstep op on both ranks.
        status, body = _http(port, "POST", "/v1/embeddings", {"input": texts})
        assert status == 200, body[-2000:]
        vecs = np.array([d["embedding"] for d in json.loads(body)["data"]])
        assert vecs.shape == (4, _config("mistral").hidden_size), vecs.shape
        assert np.isfinite(vecs).all() and np.allclose(np.linalg.norm(vecs, axis=1), 1, atol=1e-4)
        again = _stream_chat(port, {"messages": [{"role": "user", "content": texts[0]}],
                                    "max_tokens": 32, "temperature": 0.0, "stream": True})
        assert again["done"] and again["finish"] and again["deltas"], again
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
        st["err"].close()
    text = errp.read_text()
    assert rc == 0, text[-4000:]
    steps = [int(n) for n in re.findall(r"lockstep engine stopped after (\d+) steps", text)]
    assert len(steps) == 2 and steps[0] == steps[1] > 0, (steps, text[-3000:])
    assert "lockstep follower" in text and "over gloo" in text
    tokens = sum(c["usage"]["completion_tokens"] for c in chats if c.get("usage")) or sum(
        len(c["deltas"]) for c in chats)
    log(f"  cli serve --tp 2 --continuous-batching: up in {up:.1f} s (two ranks on the card "
        f"over gloo, warmed; started beside the pool's jobs); 4 streamed chats at once "
        f"answered from rank 0 in {wall:.2f} s ({tokens} tokens); /v1/embeddings of the 4 "
        f"(the sharded lookup a lockstep op) unit-norm, then one more chat answered; "
        f"SIGINT: both ranks ran "
        f"{steps[0]} lockstep steps ({card})")
    return dict(up=up, wall=wall, steps=steps)


def _swarm(dev, ckpt: Path, layers: int, card: str) -> dict:
    """(d): leader and one worker over TcpMesh on 127.0.0.1 (this process,
    two threads), Mistral-7B from disk in f32 split into two stages: the
    greedy tokens of a 128-token prompt against the one-process Executor's."""
    import threading

    import numpy as np

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.distributed.swarm import SwarmLeader, SwarmWorker
    from blazr_tpu_torch.distributed.transport import TcpMesh
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.loader import load_model
    from blazr_tpu_torch.parallel.multihost import free_port

    prompt = np.random.default_rng(SEED + 3).integers(0, 32000, PIPE_PROMPT).tolist()
    model, app = load_model(ckpt, dtype="f32", device=dev)
    ex = Executor(model, StubTokenizer(), app)
    t0 = time.perf_counter()
    want = [t.token_id for t in ex.generate(prompt, GenerationConfig(
        max_tokens=PIPE_TOKENS, temperature=0.0, repeat_penalty=1.0))]
    one_ms = (time.perf_counter() - t0) * 1e3 / PIPE_TOKENS
    capacity = ex.capacity
    del ex, model
    free_card()
    port = free_port()

    workers = []

    def worker():
        mesh = TcpMesh.bootstrap_worker(("127.0.0.1", port))
        w = SwarmWorker(mesh, capacity=capacity, dtype="f32", device=str(dev))
        workers.append(w)
        w.receive_assignment()
        w.run_compute_loop()
        mesh.close()

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(2)]
    for th in threads:
        th.start()
    mesh = TcpMesh.bootstrap_leader(3, seed_port=port)
    leader = SwarmLeader(mesh, str(ckpt), num_layers=layers)
    leader.start_workers()
    got = leader.generate_greedy(prompt, 4)            # allocations, then timed
    t0 = time.perf_counter()
    got = leader.generate_greedy(prompt, PIPE_TOKENS)
    ms = (time.perf_counter() - t0) * 1e3 / PIPE_TOKENS
    hop = leader.hop_bytes / PIPE_TOKENS
    stages = [(st.start_layer, st.end_layer) for st in leader.schedule.stages]
    first = next(w for w in workers if w.stage.has_embedding)
    stage_hop = first.sent_bytes / PIPE_TOKENS
    leader.shutdown()
    for th in threads:
        th.join(120)
        assert not th.is_alive()
    mesh.close()
    free_card()
    assert got == want, (got, want)
    log(f"  swarm: leader and two workers over TcpMesh on 127.0.0.1, stages {stages} of "
        f"{layers}-layer Mistral-7B (f32, from disk): {PIPE_TOKENS} greedy tokens of a "
        f"{PIPE_PROMPT}-token prompt equal the one-process Executor's; {ms:.2f} ms a token "
        f"(Executor {one_ms:.2f}); bytes a token: stage 0 to stage 1 {stage_hop / 1e3:.1f} kB "
        f"(f32 hidden rows), leader to and from the pipeline {hop / 1e3:.1f} kB (tokens up, "
        f"f32 logits back); the prefill's {PIPE_PROMPT} rows included ({card})")
    return dict(ms=ms, one_ms=one_ms, hop_bytes=hop, stage_hop_bytes=stage_hop, stages=stages)


def _disagg(dev, ckpt: Path, layers: int, card: str) -> dict:
    """(e): router, one prefill and one decode worker (this process, two
    threads and the router's HTTP app), Mistral-7B from disk in f32: one
    /v1/completions answered with the one-process Executor's greedy
    tokens; the KV bytes shipped once and the time to serialize and send
    them."""
    import threading

    import numpy as np

    from blazr_tpu_torch.config import GenerationConfig
    from blazr_tpu_torch.distributed.disagg import (DecodeWorker, DisaggConfig, DisaggRouter,
                                                    PrefillWorker, make_router_app)
    from blazr_tpu_torch.distributed.transport import TcpMesh
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.loader import load_model
    from blazr_tpu_torch.parallel.multihost import free_port
    from blazr_tpu_torch.server.app import serve as http_serve
    from blazr_tpu_torch.tokenizer import load_tokenizer

    prompt = np.random.default_rng(SEED + 4).integers(0, 32000, PIPE_PROMPT).tolist()
    model, app = load_model(ckpt, dtype="f32", device=dev)
    ex = Executor(model, StubTokenizer(), app)
    want = [t.token_id for t in ex.generate(prompt, GenerationConfig(
        max_tokens=PIPE_TOKENS, temperature=0.0, repeat_penalty=1.0))]
    capacity = ex.capacity
    del ex, model
    free_card()
    port = free_port()
    workers = {}

    def worker(role):
        def run():
            mesh = TcpMesh.bootstrap_worker(("127.0.0.1", port))
            cls = PrefillWorker if role == "prefill" else DecodeWorker
            workers[role] = cls(mesh, str(ckpt), capacity=capacity, dtype="f32",
                                device=str(dev))
            workers[role].run_loop()
            mesh.close()
        return run

    threads = [threading.Thread(target=worker(r), daemon=True) for r in ("prefill", "decode")]
    for th in threads:
        th.start()
    mesh = TcpMesh.bootstrap_leader(3, seed_port=port)
    router = DisaggRouter(mesh, DisaggConfig())
    router.wait_workers()
    app = make_router_app(router, load_tokenizer(ckpt))
    http = free_port()

    async def client():
        stop = asyncio.Event()
        started = asyncio.get_running_loop().create_future()
        task = asyncio.create_task(http_serve(app, "127.0.0.1", http, started.set_result,
                                              stop))
        await started
        t0 = time.perf_counter()
        st, body = await asyncio.to_thread(_http, http, "POST", "/v1/completions",
                                           {"prompt": prompt, "max_tokens": PIPE_TOKENS})
        wall = time.perf_counter() - t0
        stop.set()
        await task
        assert st == 200, body
        return json.loads(body), wall

    res, wall = asyncio.run(client())
    router.shutdown()
    for th in threads:
        th.join(120)
        assert not th.is_alive()
    mesh.close()
    free_card()
    got = res["choices"][0]["tokens"]
    assert got == want, (got, want)
    kv, ship = workers["prefill"].kv_bytes, workers["prefill"].ship_ms
    log(f"  disagg: router (HTTP /v1/completions), a prefill and a decode worker over "
        f"TcpMesh, {layers}-layer Mistral-7B (f32, from disk): {PIPE_TOKENS} tokens equal "
        f"the one-process Executor's in {wall:.2f} s; KV shipped once: {kv / 1e6:.1f} MB "
        f"(a {capacity}-slot f32 cache), serialized and sent in {ship:.1f} ms ({card})")
    return dict(wall=wall, kv_bytes=kv, ship_ms=ship)


def _mesh_llava_checkpoint(root: Path) -> Path:
    """(i)'s checkpoint: LLaVA-1.5-7B's text model at MESH_LLAVA_LAYERS
    layers (AWQ-INT4, groups of 128), its BPE tokenizer.json, and an F16
    mmproj sidecar of VISION_MMPROJ_BLOCKS blocks beside it."""
    import dataclasses

    from blazr_tpu_torch.utils.synthetic import (llava_1_5_7b_config, write_bpe_tokenizer_json,
                                                 write_hf_checkpoint, write_mmproj_gguf)

    cfg = PAR_RUN["configs"].get("llava") or llava_1_5_7b_config()
    d = root / "llava_text"
    t0 = time.perf_counter()
    write_hf_checkpoint(d, dataclasses.replace(cfg, num_layers=MESH_LLAVA_LAYERS, vision=None),
                        group_size=min(128, cfg.hidden_size // 4), seed=SEED)
    write_bpe_tokenizer_json(d, cfg.vocab_size, seed=SEED)
    write_mmproj_gguf(d / "mmproj-llava-1.5-7b-f16.gguf", cfg.vision, cfg.hidden_size,
                      seed=SEED + 1, blocks=min(VISION_MMPROJ_BLOCKS, cfg.vision.num_layers))
    log(f"  (i) wrote the {MESH_LLAVA_LAYERS}-layer LLaVA-1.5-7B text checkpoint with its "
        f"mmproj sidecar ({sum(f.stat().st_size for f in d.iterdir()) / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    return d


def _mesh_report(part: str, label: str, fam: str, ranks: list, one: dict, card: str,
                 secs: float) -> dict:
    """Hold a part's ranks to one rank's and log what they measured."""
    tp = len(ranks)
    out: dict = {}
    want = one["logits"]
    err = max(((r["logits"] - want).abs().max() / want.abs().max()).item() for r in ranks)
    assert err <= MESH_TOL[fam], f"({part}) {label}: f32 logits {err} > {MESH_TOL[fam]}"
    assert all(r["lora"] == LORA_REFUSAL for r in ranks), [r["lora"] for r in ranks]
    for run in [k for k in one if k in ("", "lookup", "draft")]:
        rs = [r[run] for r in ranks]
        w0, w1 = rs[0]["waves"]
        streams = w0["streams"]
        assert all(len(st) == MESH_TOKENS for st in streams), [len(st) for st in streams]
        assert streams == one[run]["waves"][0]["streams"], \
            f"({part}) {label} {run}: the streams differ from one rank's"
        assert len({r["steps"] for r in rs}) == 1, [r["steps"] for r in rs]
        per_rank = [(r["counts_total"]["qmm"], r["counts_total"]["paged_attention"])
                    for r in rs]
        if "ep" not in label:
            assert len(set(per_rank)) == 1, f"({part}) {label}: ranks launched {per_rank}"
        attention = fam in ("bamba", "mistral", "llava")
        assert PAR_RUN["device"] != "cuda" or (per_rank[0][0] > 0 and (
            per_rank[0][1] > 0) == attention), per_rank
        c, steps = w1["comm"], max(1, w1["engine_steps"])
        calls = {k: v["calls"] / steps for k, v in c.items()}
        each = {k: v["ms"] / max(1, v["calls"]) for k, v in c.items()}
        one_w0 = one[run]["waves"][0]
        tag = f"{label}{', ' + run if run else ''}"
        spec = ""
        if run:
            # A random draft seldom agrees with a random target: its drafts
            # are counted, prompt lookup's must also be accepted.
            assert w0["drafted"] > 0 and (w0["accepted"] > 0 or run == "draft"), (
                w0["drafted"], w0["accepted"])
            assert rs[0]["draft_sliced"] is (run == "draft")
            spec = (f"; accepted {w0['accepted']} of {w0['drafted']} drafts "
                    f"({w0['accepted'] / w0['drafted']:.2f}; one rank "
                    f"{one_w0['accepted']} of {one_w0['drafted']}), {w0['spec_rounds']} "
                    f"verify rounds of {w0['spec_ms']:.2f} ms (one rank "
                    f"{one_w0['spec_ms']:.2f})"
                    + (", the draft sliced like the target" if run == "draft" else ""))
        log(f"  ({part}) {tag}, {tp} ranks on the card over {ranks[0]['backend']}, f32: "
            f"prefill logits within {err:.3g} of the largest of one rank's (tol "
            f"{MESH_TOL[fam]}); the 8 greedy streams ({MESH_TOKENS} tokens) equal one rank's; "
            + (f"{w0['decode_ms']:.2f} ms a decode step ({w0['decode_steps']} steps; one rank "
               f"{one_w0['decode_ms']:.2f})" if w0["decode_steps"] else "no plain decode step")
            + f", prefill {w0['prefill_s']:.2f} s (one rank "
            f"{one_w0['prefill_s']:.2f}){spec}; collectives a step "
            + ", ".join(f"{k} {v:.1f} ({each[k]:.3f} ms each)" for k, v in calls.items())
            + f" (timed wave, {steps} steps); B1, B2 launches a rank "
            + ", ".join(f"rank {i} {pr}" for i, pr in enumerate(per_rank))
            + f"; LoRA refused with the JAX ValueError ({secs:.1f} s; {card})")
        out[run] = dict(decode_ms=w0["decode_ms"], one_rank_decode_ms=one_w0["decode_ms"],
                        prefill_s=w0["prefill_s"], one_rank_prefill_s=one_w0["prefill_s"],
                        calls_a_step=calls, ms_each=each, launches_per_rank=per_rank,
                        drafted=w0["drafted"], accepted=w0["accepted"],
                        spec_ms=w0["spec_ms"], one_rank_spec_ms=one_w0["spec_ms"],
                        streams=streams)
    out.update(err=err, shapes=ranks[0]["shapes"])
    return out


def _cli_serve_llava_finish(st: dict, body: dict, want: str, card: str) -> dict:
    """(i) over HTTP: the PNG image chat through ``cli serve --tp 2`` (a
    lockstep op on both ranks) answers ``want``; a text chat after it; then
    SIGINT, both ranks' lockstep step counts equal."""
    import re
    import signal

    proc, port, errp = st["proc"], st["port"], st["errp"]
    try:
        while True:
            assert proc.poll() is None, errp.read_text()[-4000:]
            try:
                if _http(port, "GET", "/health", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            assert time.perf_counter() - st["t0"] < 600, "(i) cli serve --tp 2 did not come up"
            time.sleep(1.0)
        up = time.perf_counter() - st["t0"]
        t1 = time.perf_counter()
        status, text = _http(port, "POST", "/v1/chat/completions", body)
        chat_s = time.perf_counter() - t1
        assert status == 200, text[-2000:]
        reply = json.loads(text)
        content = reply["choices"][0]["message"]["content"]
        assert content == want, (content, want)
        status, text = _http(port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "and in words?"}], "max_tokens": 8,
            "temperature": 0})
        assert status == 200, text[-2000:]
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(60)
        st["err"].close()
    log_text = errp.read_text()
    assert rc == 0, log_text[-4000:]
    steps = [int(n) for n in re.findall(r"lockstep engine stopped after (\d+) steps", log_text)]
    assert len(steps) == 2 and steps[0] == steps[1] > 0, (steps, log_text[-3000:])
    log(f"  (i) cli serve --tp 2 --dtype f32 (two ranks over gloo, the mmproj sidecar found "
        f"beside the checkpoint): up in {up:.1f} s; the PNG image chat, a lockstep op on both "
        f"ranks, answered in {chat_s:.2f} s with the ranks' and one rank's text "
        f"({reply['usage']['completion_tokens']} tokens); a text chat after it; SIGINT: both "
        f"ranks ran {steps[0]} lockstep steps ({card})")
    return dict(up=up, chat_s=chat_s, steps=steps)


def mesh_parts(dev, card: str, pool_run, root: Path) -> dict:
    """Parts (f)-(i) on the phase's RankPool: each part's ranks, then its
    one-rank reference (a world of one), then (i)'s chat over HTTP."""
    import numpy as np

    out: dict = {}
    llava = _mesh_llava_checkpoint(root)
    cli = _cli_serve_tp2_start(llava, root, ("--dtype", "f32", "--no-warmup"),
                               "cli_serve_llava")
    try:
        for part, label, fam, group, mesh in MESH_PARTS:
            t0 = time.perf_counter()
            ranks = pool_run("mesh_family", 2, MESH_JOB_S, fam=fam, group=group, mesh=mesh)
            one = pool_run("mesh_family", 1, MESH_JOB_S, fam=fam, group=group, mesh={},
                           use_ep="ep" in mesh)[0]
            out[label] = _mesh_report(part, label, fam, ranks, one, card,
                                      time.perf_counter() - t0)
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED + 19)
        y, x = np.mgrid[0:336, 0:336]
        field = np.stack([128 + 90 * np.sin(x / 29.0 + c) * np.cos(y / 17.0 + c)
                          for c in range(3)], -1)
        png = write_png(np.clip(field + rng.normal(0, 8, field.shape), 0, 255)
                        .astype(np.uint8))
        body = _image_chat(_data_uri(png, "image/png"), "What is in this image?")
        body["max_tokens"] = MESH_TOKENS
        args = dict(dir=str(llava), png=png, body=body)
        ranks = pool_run("mesh_llava", 2, MESH_JOB_S, mesh={"tp": 2}, **args)
        one = pool_run("mesh_llava", 1, MESH_JOB_S, mesh={}, **args)[0]
        label = f"LLaVA-1.5-7B ({MESH_LLAVA_LAYERS} layers) tp 2"
        rep = _mesh_report("i", label, "llava", ranks, one, card, time.perf_counter() - t0)
        assert all(r["chat"] == one["chat"] and r["chat_tokens"] == one["chat_tokens"]
                   for r in ranks), [r["chat_tokens"] for r in ranks]
        n = len(one["chat_tokens"])
        log(f"  (i) the PNG image chat ({ranks[0]['rows']} image rows, {n} greedy tokens "
            f"through the MultimodalExecutor, the tower whole on each rank): tokens equal one "
            f"rank's; {ranks[0]['chat_s'] * 1e3 / max(1, n):.1f} ms a token with the merged "
            f"prefill (one rank {one['chat_s'] * 1e3 / max(1, n):.1f}); B1 {ranks[0]['chat_counts']['qmm']} "
            f"launches on rank 0 ({card})")
        rep.update(chat_s=ranks[0]["chat_s"], one_rank_chat_s=one["chat_s"], chat_tokens=n,
                   chat_qmm=[r["chat_counts"]["qmm"] for r in ranks])
        rep["http"] = _cli_serve_llava_finish(cli, body, one["chat"], card)
        out[label] = rep
    finally:
        if cli["proc"].poll() is None:
            cli["proc"].kill()
            cli["proc"].wait(60)
    # The kernels line: B1 and B2 launches on rank 0 over every part's mesh run.
    runs = [r for rep in out.values() for k, r in rep.items() if k in ("", "lookup", "draft")]
    out["qmm"] = sum(r["launches_per_rank"][0][0] for r in runs)
    out["paged_attention"] = sum(r["launches_per_rank"][0][1] for r in runs)
    return out


def _mesh_streamed_refusal(dev, ckpt: Path, card: str) -> str:
    """A model with a layer streamed from host RAM under tp 2: the Executor
    refuses it before any process group is needed, naming ROADMAP §C."""
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.loader import load_model

    part, app = load_model(ckpt, dtype="f32", device=dev, device_layers=1)
    assert part.is_streaming
    app.inference.tensor_parallel_size = 2
    try:
        Executor(part, StubTokenizer(), app)
    except NotImplementedError as e:
        msg = str(e)
    else:
        raise AssertionError("a streamed model was served under tp 2")
    assert "ROADMAP §C" in msg and "queue A" not in msg, msg
    del part
    free_card()
    log(f"  a streamed model (1 of its layers on the card) under tp 2: refused, naming "
        f"ROADMAP §C ({card})")
    return msg


def parallel_phase(dev, card: str) -> dict:
    """Phase 19 (``parallel``)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from blazr_tpu_torch.parallel.ring_attention import ring_hops

    t_phase = time.perf_counter()
    PAR_RUN["device"] = dev.type
    on_card = dev.type == "cuda"        # launches are counted on the card only
    free_card()
    root = Path(tempfile.mkdtemp(prefix="blazr_ranks_"))
    res: dict = {}
    from blazr_tpu_torch.parallel.multihost import RankPool

    ranks_pool = RankPool(4, root, dev.type, dict(os.environ, PYTHONPATH=str(TREE)))

    def pool_run(job: str, world: int, timeout: float = 1500, **args) -> list:
        return ranks_pool.run(f"{Path(__file__).resolve()}:rank_job", world,
                              dict(args, job=job, run=PAR_RUN, dump_s=0.9 * timeout),
                              timeout=timeout)

    cli = _cli_serve_tp2_start(http_checkpoint(), root)
    try:
        # (a) tensor parallel, lockstep serving
        layers = PAR_DEPTH["tp"]
        t0 = time.perf_counter()
        r0, r1 = pool_run("tp_serve", 2, layers=layers)
        assert r0["steps"] == r1["steps"] > 0, (r0["steps"], r1["steps"])
        for w, wave in enumerate(r0["waves"]):
            assert all(len(s) == PAR_TOKENS for s in wave["streams"])
            assert on_card <= (wave["counts"]["qmm"] > 0 and wave["counts"]["paged_attention"] > 0)
        w0, w1 = r0["waves"]
        assert w0["streams"] == w1["streams"]
        per_rank = [(r["counts_total"]["qmm"], r["counts_total"]["paged_attention"])
                    for r in (r0, r1)]
        assert per_rank[0] == per_rank[1], f"tp ranks launched differently: {per_rank}"
        c = w1["comm"]
        fwd = c["all_gather"]["calls"]
        log(f"  (a) Mistral-7B {layers} layers at tp 2: two ranks on the card over "
            f"{r0['backend']} (2 ranks a card), lockstep over BatchEngine, steps eager; "
            f"rank 0's shapes {r0['shapes']}")
        log(f"  (a) 8 greedy requests (64-512-token prompts, {PAR_TOKENS} tokens): "
            f"{w0['tokens'] / w0['wall']:.1f} tok/s, {w0['decode_ms']:.2f} ms a decode step "
            f"({w0['decode_steps']} steps, prefill {w0['prefill_s']:.2f} s), "
            f"{r0['steps']} lockstep steps on each rank; launches on rank 0 B1 "
            f"{w0['counts']['qmm']}, B2 {w0['counts']['paged_attention']}; over both "
            f"waves (B1, B2) a rank: " + ", ".join(
                f"rank {i} {c}" for i, c in enumerate(per_rank)) + " (equal)")
        log(f"  (a) collectives a forward: all_reduce {c['all_reduce']['calls'] / fwd:.1f} "
            f"(2 a layer + the embedding), all_gather 1 (the logits); timed wave: all_reduce "
            f"{c['all_reduce']['ms'] / max(1, c['all_reduce']['calls']):.3f} ms each, "
            f"all_gather {c['all_gather']['ms'] / fwd:.3f} ms each; "
            f"{(c['all_reduce']['ms'] + c['all_gather']['ms']) / max(1, w1['decode_steps'] + 1):.2f} "
            f"ms of collectives a step of {w1['decode_ms']:.2f} ({card})")
        res["tp"] = dict(tok_s=w0["tokens"] / w0["wall"], decode_ms=w0["decode_ms"],
                         qmm=w0["counts"]["qmm"], paged_attention=w0["counts"]["paged_attention"],
                         launches_per_rank=per_rank, comm=c, steps=r0["steps"])
        log(f"  ((a) serving: {time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        ranks = pool_run("tp_f32", 2)
        ref = _one_rank_f32(dev)
        want = ref["logits"]
        for r in ranks:
            err = ((r["logits"] - want).abs().max() / want.abs().max()).item()
            assert err <= PAR_F32_TOL, f"tp 2 f32 logits: {err} > {PAR_F32_TOL}"
        streams = ranks[0]["waves"][0]["streams"]
        assert streams == ref["streams"], "tp 2 streams differ from one rank's (f32)"
        log(f"  (a) f32 check, {PAR_CHECK_LAYERS} layers: tp 2 prefill logits within "
            f"{err:.3g} of the largest of one rank's (tol {PAR_F32_TOL}); the 8 greedy "
            f"streams (16 tokens) equal one rank's ({time.perf_counter() - t0:.1f} s)")
        res["tp"]["f32_err"] = err

        # (b) expert parallel
        t0 = time.perf_counter()
        res["ep"] = {}
        for name, world, mesh in (("ep 2", 2, {"ep": 2}), ("ep 2 x tp 2", 4, {"ep": 2, "tp": 2})):
            ranks = pool_run("ep", world, layers=PAR_DEPTH["ep"], mesh=mesh)
            r0 = ranks[0]
            for rows, row in r0["rows"].items():
                assert row["err"] <= EP_TOL, f"{name} moe_ffn_ep {rows} rows: {row['err']}"
            assert r0["dropped"] == r0["plain_dropped"] > 0, (r0["dropped"],
                                                             r0["plain_dropped"])
            assert all(r["dropped"] == r0["dropped"] for r in ranks)
            wave = r0["waves"][0]
            assert on_card <= (wave["counts"]["qmm"] > 0)
            per_rank = [(r["rows"][512]["qmm"], r["rows"][8]["qmm"],
                         r["counts_total"]["qmm"], r["counts_total"]["paged_attention"])
                        for r in ranks]
            tp = mesh.get("tp", 1)
            for r in range(0, world, tp):          # the tp ranks of one ep index
                assert len(set(per_rank[r:r + tp])) == 1, f"{name}: {per_rank}"
            log(f"  (b) Mixtral-8x7B widths, {PAR_DEPTH['ep']} layer(s), {name} ({world} ranks "
                f"on the card over {r0['backend']}; experts a rank "
                f"{[r['experts'] for r in ranks]}): layer 0's moe_ffn_ep within "
                f"{max(row['err'] for row in r0['rows'].values()):.3g} of moe_ffn (f32, no "
                f"drops); 512 rows {r0['rows'][512]['ms']:.2f} ms (one rank "
                f"{r0['rows'][512]['one_rank_ms']:.2f}), 8 rows {r0['rows'][8]['ms']:.2f} ms "
                f"(one rank {r0['rows'][8]['one_rank_ms']:.2f}); B1 launches on rank 0 "
                f"{r0['rows'][512]['qmm']} and {r0['rows'][8]['qmm']}; capacity 64 drops "
                f"{r0['dropped']} = make_dispatch's {r0['plain_dropped']}")
            log(f"  (b) {name} served: a 512-token and 7 short prompts, 8 tokens: "
                f"{wave['decode_ms']:.2f} ms a decode step of 8 rows, prefill "
                f"{wave['prefill_s']:.2f} s, B1 {wave['counts']['qmm']} and B2 "
                f"{wave['counts']['paged_attention']} launches on rank 0")
            log(f"  (b) {name} launches a rank (B1 in moe_ffn_ep at 512 and 8 rows; B1, B2 "
                f"served): " + ", ".join(f"rank {i} {c}" for i, c in enumerate(per_rank))
                + (" (equal across each ep index's tp ranks)" if tp > 1 else ""))
            res["ep"][name] = dict(rows=r0["rows"], dropped=r0["dropped"],
                                   decode_ms=wave["decode_ms"], qmm=wave["counts"]["qmm"],
                                   launches_per_rank=per_rank)
        log(f"  ((b): {time.perf_counter() - t0:.1f} s)")

        # (c) sequence parallel
        t0 = time.perf_counter()
        prompt = np.random.default_rng(SEED + 8).integers(0, _config("mistral").vocab_size, SP_PROMPT).tolist()
        ranks = pool_run("sp", 4, layers=PAR_DEPTH["sp"], prompt=prompt)
        window = _config("mistral").attention.sliding_window
        hops = ring_hops(4, SP_PROMPT // 4, window)
        ref = _one_rank_sp(dev, prompt)
        for r in ranks:
            err = ((r["logits"] - ref["logits"]).abs().max() / ref["logits"].abs().max()).item()
            assert err <= PAR_F32_TOL, f"sp 4 logits: {err}"
            assert r["tokens"] == ref["tokens"], (r["tokens"], ref["tokens"])
        st = ranks[0]["comm"]
        log(f"  (c) Mistral-7B {PAR_DEPTH['sp']} layers in f32 at sp 4 (4 ranks on the card "
            f"over gloo): an {SP_PROMPT}-token prompt, window {window}: ring_hops {hops} of 4; "
            f"ring prefill {ranks[0]['ms']:.1f} ms against one rank's {ref['ms']:.1f} ms "
            f"(chunks of 2048); shifts {st.get('shift', {}).get('calls', 0)}, K/V all-gathers "
            f"{st.get('all_gather', {}).get('calls', 0)}; logits within {err:.3g} of the "
            f"largest of one rank's (tol {PAR_F32_TOL}); {SP_TOKENS} greedy tokens equal; "
            f"B1 {ranks[0]['counts']['qmm']} and B2 {ranks[0]['counts']['paged_attention']} "
            f"launches on rank 0 in the decode ({card})")
        res["sp"] = dict(ms=ranks[0]["ms"], one_rank_ms=ref["ms"], hops=hops, err=err)
        log(f"  ((c): {time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        res["cli"] = _cli_serve_tp2_finish(cli, card)
        log(f"  ((a) cli serve, after (c): {time.perf_counter() - t0:.1f} s)")

        # (f)-(i) the families and features of ROADMAP queue A entry 8
        t0 = time.perf_counter()
        res["mesh"] = mesh_parts(dev, card, pool_run, root)
        log(f"  ((f)-(i): {time.perf_counter() - t0:.1f} s)")
    finally:
        ranks_pool.close()
        if cli["proc"].poll() is None:
            cli["proc"].kill()
            cli["proc"].wait(60)
        shutil.rmtree(root, ignore_errors=True)

    # (d) swarm and (e) disagg, in this process
    t0 = time.perf_counter()
    res["swarm"] = _swarm(dev, http_checkpoint(PAR_DEPTH["swarm"]), PAR_DEPTH["swarm"], card)
    log(f"  ((d): {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    res["disagg"] = _disagg(dev, http_checkpoint(PAR_DEPTH["disagg"]), PAR_DEPTH["disagg"],
                            card)
    log(f"  ((e): {time.perf_counter() - t0:.1f} s)")
    res["mesh"]["streamed"] = _mesh_streamed_refusal(
        dev, http_checkpoint(PAR_DEPTH["disagg"]), card)
    log(f"  parallel phase: {time.perf_counter() - t_phase:.1f} s ({card})")
    res.update(qmm=res["tp"]["qmm"], paged_attention=res["tp"]["paged_attention"],
               mesh_qmm=res["mesh"]["qmm"], mesh_paged_attention=res["mesh"]["paged_attention"])
    return res


def _one_rank_sp(dev, prompt: list) -> dict:
    """(c)'s reference: the prompt's prefill on one rank (chunks of 2048),
    its logits and 16 greedy tokens."""
    import torch

    from blazr_tpu_torch.config import AppConfig, GenerationConfig
    from blazr_tpu_torch.engine.executor import Executor

    model = _mistral(PAR_DEPTH["sp"], torch.float32, SP_PROMPT + 64)
    app = AppConfig(model=model.cfg)
    app.inference.prefill_chunk_size = 2048
    ex = Executor(model, StubTokenizer(), app)
    ex.prefill(ex._init_cache(1), prompt[:512])
    _sync()
    t0 = time.perf_counter()
    last, _ = ex.prefill(ex._init_cache(1), prompt)
    _sync()
    ms = (time.perf_counter() - t0) * 1e3
    toks = [t.token_id for t in ex.generate(prompt, GenerationConfig(
        max_tokens=SP_TOKENS, temperature=0.0))]
    out = dict(logits=last.float().cpu(), ms=ms, tokens=toks)
    del ex, model
    free_card()
    return out


PHASES = ("build", "b1", "b2", "b3", "b4", "b5", "b6", "tools", "forward",
          "forward_w8a8", "ppl", "serve", "executor", "serve_int8", "prefix", "http",
          "routes", "constrained", "families", "moe", "gguf", "mla", "ssm", "vision", "spec",
          "lora", "offload", "parallel", "sweep", "timings", "layout_times")
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
    global TREE, SERVE_LAYERS, HTTP_LAYERS, GGUF_LAYERS, GRAPH_TURNS, PREFIX_TURNS, HTTP_TURNS
    TREE = args.tree.resolve()
    if phases == list(FULL_RUN):
        SERVE_LAYERS = FULL_RUN_SERVE_LAYERS
        # One turn each way in a full run (for phase 19's time): the
        # equalities across turns hold on a pair as on four.
        GRAPH_TURNS = PREFIX_TURNS = HTTP_TURNS = (True, False)
        HTTP_LAYERS = FULL_RUN_HTTP_LAYERS
        GGUF_LAYERS = FULL_RUN_GGUF_LAYERS
        PAR_DEPTH.update({k: v[1] for k, v in PAR_DEPTHS.items()})
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
         lambda: serve_http(dev, card, hand_over="routes" in phases)),
        ("routes", "phase 7b: the other routes of the HTTP server (Anthropic messages, "
         "responses, infill, embeddings, rerank, tools, slots, management, TLS) and the "
         "CLI (serve, ps, generate, info) on phase 7's checkpoint",
         lambda: routes_phase(dev, card, res.get("http", {}).pop("sched", None),
                              hand_over="constrained" in phases)),
        ("constrained", "phase 7c: grammars, JSON mode, JSON schemas and the host samplers "
         "(mirostat, DRY, typical-p) over HTTP, the device-table and side-step paths timed, "
         "the Executor and cli run", lambda: constrained_phase(
             dev, card, (res.get("routes") or res.get("http") or {}).pop("sched", None))),
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
        ("vision", "phase 15: image chats with LLaVA-1.5-7B (B1 at its shapes, the host's "
         "image decode, the tower and a merged forward card vs CPU, the Executor, HTTP, "
         "the mmproj sidecar)", lambda: vision_phase(dev, gen, card, phases == list(FULL_RUN))),
        ("spec", "phase 16: speculative decoding with Mistral-7B (prompt-lookup and "
         "draft-model drafts verified in one [8, k+1] step; B1 and B2 at the verify's "
         "shapes, the f32 equalities, spec on/off timed, cli run and cli serve)",
         lambda: spec_phase(dev, gen, card, phases == list(FULL_RUN))),
        ("lora", "phase 17: LoRA adapters with Mistral-7B (no adapter, A, A2, B and the base "
         "again through the warmed engine, the switches' cost and captures, the f32 and "
         "dense-merge equalities, the /v1/lora routes over cli serve) and the C++ BPE core",
         lambda: lora_phase(dev, card, phases == list(FULL_RUN))),
        ("offload", "phase 18: MoE expert offload (Mixtral-8x7B, hybrid, the host term), "
         "layer offload (Mistral-7B, half its layers streamed), the Mamba3 mixer at "
         "Codestral's widths, two BatchEngine replicas behind a DataParallelGroup with "
         "the trace spans", lambda: offload_phase(dev, card, phases == list(FULL_RUN))),
        ("parallel", "phase 19: tensor, expert and sequence parallelism over "
         "torch.distributed (ranks sharing the card over gloo), lockstep serving and cli "
         "serve --tp 2, swarm and disagg", lambda: parallel_phase(dev, card)),
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
