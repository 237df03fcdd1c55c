#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``blazr_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. print the card (name, power limit) and build csrc/*.cu with nvcc,
     one process per source, all started together;
  2. kernel B1 (fused dequant-matmul) against its plain version at the
     Mistral-7B projection shapes and small edge cases;
  3. kernel B2 (paged decode attention) against its plain version at the
     Mistral geometry and edge cases;
  4. a full-width 2-layer Mistral-7B AWQ forward_paged, prefill + 4
     teacher-forced decode steps, on the card (bf16, kernels) against the
     CPU (f32, plain versions) on the same weights;
  5. the 32-layer Mistral-7B AWQ BatchEngine serving 8 requests in two
     waves, with the kernels' launch counts read around the run;
  6. one ``{"kernels": [...]}`` JSON line with each kernel's launches, max
     error, time, bound, plain time and library-call time.
The last line is ``{"ok": true, "device": {...}}``. Without CUDA, or run
outside a checkout that holds ``blazr_tpu_torch/``, it prints no result and
exits non-zero. The compiler's full report goes to
``blazr_tpu_torch/csrc/_build/build.log``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12            # dense bf16 tensor-core peak

# Mistral-7B projections (K, N): fused qkv, o, fused gate+up, down.
B1_SHAPES = {"qkv": (4096, 6144), "o": (4096, 4096), "gateup": (4096, 28672),
             "down": (14336, 4096)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_BF16_FLOPS * 1e3
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
        ref = qmm_reference(x.float(), qw, s, m, bits=bits, signed=signed,
                            group_size=gs)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got).all(), name
        err = (got.float() - ref).abs().max().item()
        tol = rel_tol * ref.abs().max().item()
        log(f"  B1 {name:34s} max_abs_err {err:.4g}  tol {tol:.4g}")
        assert err <= tol, f"B1 {name}: {err} > {tol}"
        worst = max(worst, err)

    for pname, (k, n) in B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 4, 128, gen, dev)
        for m in (1, 8, 64, 512):
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            one(f"{pname} K={k} N={n} m={m}", x, qw, s, mn, 4, True, 128)
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
        ("ragged N=200 K=384 m=37", 37, 384, 200, 4, True, 128, torch.bfloat16),
        ("ragged N=70 m=1", 1, 256, 70, 4, True, 64, torch.bfloat16),
        ("f32 activations", 6, 512, 256, 4, True, 128, torch.float32),
        ("f32 activations m=40", 40, 512, 256, 4, True, 128, torch.float32),
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
    return {"max_abs_err": max(worst, err)}


def time_b1(dev, gen) -> dict:
    """B1 at every projection's decode shape (m=8); the fused gate+up one
    also against the plain version and the library call."""
    import torch

    from blazr_tpu_torch.quant.kernels import qmm, qmm_reference
    from blazr_tpu_torch.quant.qtensor import dequantize_planes

    gs = 128
    for pname, (k, n) in B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 4, gs, gen, dev)
        for m in (1, 8, 512):
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            ms = time_ms(lambda: qmm(x, qw, s, mn, bits=4, signed=True,
                                     group_size=gs, device=dev), iters=20)
            nbytes = qw.numel() * 4 + s.numel() * 8 + x.numel() * 2 + m * n * 2
            bms, by = bound(nbytes, 2.0 * m * k * n)
            log(f"  B1 {pname} m={m} K={k} N={n}: kernel {ms:.4f} ms, bound "
                f"{bms:.4f} ms ({by}), {2.0 * m * k * n / ms / 1e9:.1f} TFLOP/s")
    m = 8
    k, n = B1_SHAPES["gateup"]
    qw, s, mn = rand_planes(k, n, 4, gs, gen, dev)
    x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
    ms = time_ms(lambda: qmm(x, qw, s, mn, bits=4, signed=True, group_size=gs,
                             device=dev), iters=50)
    plain_ms = time_ms(lambda: qmm_reference(x, qw, s, mn, bits=4, signed=True,
                                             group_size=gs), iters=5, warmup=1)
    w = dequantize_planes(qw, s, mn, 4, True, gs, torch.bfloat16)
    library_ms = time_ms(lambda: torch.matmul(x, w), iters=50)
    nbytes = qw.numel() * 4 + s.numel() * 4 + mn.numel() * 4 + x.numel() * 2 + m * n * 2
    bound_ms, bound_by = bound(nbytes, 2.0 * m * k * n)
    log(f"  B1 gateup m={m}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.matmul(bf16 dequantized) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}, {nbytes / 1e6:.1f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, shape=f"m={m} K={k} N={n}")


def b1_variants(dev, gen) -> None:
    """B1's two variants against each other at the Mistral projections, in
    turns (CUDA-core, WMMA, WMMA, CUDA-core), best of each pair: the
    measurement behind the wrapper's TC_MIN_ROWS. Calls the library directly,
    so these launches do not count."""
    import torch

    from blazr_tpu_torch.quant import kernels

    lib = kernels._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for pname, (k, n) in B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 4, 128, gen, dev)
        row = []
        for m in (8, 16, 64, 512):
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
            args = (x.data_ptr(), qw.data_ptr(), s.data_ptr(), mn.data_ptr(),
                    y.data_ptr(), m, k, n, 4, 1, 128)

            def simt():
                assert lib.qmm_launch(*args, 0, stream) == 0

            def wmma():
                assert lib.qmm_tc_launch(*args, stream) == 0

            t = {"simt": [], "wmma": []}
            for name, fn in (("simt", simt), ("wmma", wmma), ("wmma", wmma),
                             ("simt", simt)):
                t[name].append(time_ms(fn, iters=20))
            row.append(f"m={m} {min(t['simt']):.4f}/{min(t['wmma']):.4f}")
        log(f"  B1 {pname} CUDA-core/WMMA ms: " + ", ".join(row))


# ---------------------------------------------------------------------------
# phase 3: B2
# ---------------------------------------------------------------------------

def pa_inputs(dev, gen, *, b, h_q, h_kv, d, bs, seq_lens, int8=False, nb_extra=8):
    import torch

    mb = max(-(-int(s) // bs) for s in seq_lens)
    nb = b * mb + nb_extra
    perm = torch.randperm(nb, device=dev, generator=gen)[: b * mb]
    tables = perm.reshape(b, mb).to(torch.int32)
    shape = (nb * bs + 1, h_kv, d)
    ks = vs = None
    if int8:
        kc = torch.randint(-127, 128, shape, device=dev, generator=gen).to(torch.int8)
        vc = torch.randint(-127, 128, shape, device=dev, generator=gen).to(torch.int8)
        ks = torch.rand(shape[:2], device=dev, generator=gen) / 64 + 1 / 128
        vs = torch.rand(shape[:2], device=dev, generator=gen) / 64 + 1 / 128
    else:
        kc = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
        vc = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
    q = torch.randn((b, h_q, d), device=dev, generator=gen).to(torch.bfloat16)
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
    ]
    worst = 0.0
    for name, geo, opt in cases:
        s = pa_inputs(dev, gen, b=8, h_q=32, h_kv=8, seq_lens=ragged, **geo)
        opt = dict(opt)
        if opt.pop("alibi", False):
            opt["alibi"] = alibi_slopes(32, dev) * geo["d"] ** -0.5
        kw = dict(block_size=s["bs"], k_scale=s["ks"], v_scale=s["vs"], **opt)
        got = paged_attention_decode(s["q"], s["kc"], s["vc"], s["bt"], s["sl"],
                                     num_blocks=s["nb"], device=dev, **kw)
        ref = paged_attention_reference(s["q"].float(), s["kc"], s["vc"], s["bt"],
                                        s["sl"], **kw)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got).all(), name
        err = (got.float() - ref).abs().max().item()
        # Probabilities drop to bf16 before the AV product and the output is
        # bf16: 2^-9 relative each, against outputs of order max|v|.
        tol = 1e-2 * max(1.0, ref.abs().max().item())
        log(f"  B2 {name:34s} max_abs_err {err:.4g}  tol {tol:.4g}")
        assert err <= tol, f"B2 {name}: {err} > {tol}"
        worst = max(worst, err)
    return {"max_abs_err": worst}


def time_b2(dev, gen) -> dict:
    """Mistral decode attention, B=8 at 1024 tokens each, bf16 KV."""
    import torch
    import torch.nn.functional as F

    from blazr_tpu_torch.attention.paged_attention import (
        paged_attention_decode, paged_attention_reference)
    from blazr_tpu_torch.kvcache.paged import page_slot_index

    b, h_q, h_kv, d, bs, ctx = 8, 32, 8, 128, 64, 1024
    s = pa_inputs(dev, gen, b=b, h_q=h_q, h_kv=h_kv, d=d, bs=bs, seq_lens=[ctx] * b)
    kw = dict(block_size=bs, sliding_window=4096)
    ms = time_ms(lambda: paged_attention_decode(
        s["q"], s["kc"], s["vc"], s["bt"], s["sl"], num_blocks=s["nb"],
        device=dev, **kw), iters=100)
    plain_ms = time_ms(lambda: paged_attention_reference(
        s["q"], s["kc"], s["vc"], s["bt"], s["sl"], **kw), iters=10)
    idx = page_slot_index(bs, s["bt"])                         # [B, ctx]
    k = s["kc"][idx].permute(0, 2, 1, 3).contiguous()          # [B, H_kv, S, D]
    v = s["vc"][idx].permute(0, 2, 1, 3).contiguous()
    q = s["q"][:, :, None, :]                                  # [B, H_q, 1, D]
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True), iters=100)
    except TypeError:                   # PyTorch without enable_gqa
        ke = k.repeat_interleave(h_q // h_kv, dim=1)
        ve = v.repeat_interleave(h_q // h_kv, dim=1)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, ke, ve),
                             iters=100)
    nbytes = (2 * b * ctx * h_kv * d * 2 + 2 * b * h_q * d * 2
              + s["bt"].numel() * 4 + b * 4)
    bound_ms, bound_by = bound(nbytes, 4.0 * b * h_q * ctx * d)
    log(f"  B2 B={b} ctx={ctx}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA(GQA, gathered KV) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}, {nbytes / 1e6:.1f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, shape=f"B={b} ctx={ctx}")


# ---------------------------------------------------------------------------
# phase 4: teacher-forced 2-layer full-width forward, card vs CPU
# ---------------------------------------------------------------------------

def to_cpu_f32(tree):
    import torch

    from blazr_tpu_torch.quant.qtensor import QuantTensor

    if isinstance(tree, dict):
        return {k: to_cpu_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu_f32(v) for v in tree]
    if isinstance(tree, QuantTensor):
        return dataclasses.replace(
            tree, qweight=tree.qweight.cpu(), scales=tree.scales.cpu(),
            mins=tree.mins.cpu(), perm=None if tree.perm is None else tree.perm.cpu())
    if isinstance(tree, torch.Tensor):
        return tree.float().cpu()
    return tree


def teacher_forced(dev) -> None:
    import numpy as np
    import torch

    from blazr_tpu_torch.kvcache.paged import (compute_slot_mapping,
                                               init_paged_cache, pad_block_table)
    from blazr_tpu_torch.models.llama_paged import forward_paged
    from blazr_tpu_torch.utils.synthetic import mistral_7b_config, synth_llama_params

    cfg = mistral_7b_config()
    cfg.num_layers = 2
    params = synth_llama_params(cfg, quant="awq", dtype=torch.bfloat16, seed=SEED,
                                device=dev)
    cpu_params = to_cpu_f32(params)
    rng = np.random.default_rng(SEED)
    lens, bs, steps = [64, 100, 37, 128], 64, 4
    blocks = [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
    tables = np.stack([pad_block_table(b, 4) for b in blocks])
    seqs = [rng.integers(0, cfg.vocab_size, n + steps) for n in lens]

    def cache(d, dtype):
        return init_paged_cache(2, 12, bs, 8, 128, dtype=dtype, device=d)

    caches = {"gpu": cache(dev, torch.bfloat16),
              "cpu": cache(torch.device("cpu"), torch.float32)}
    trash = caches["cpu"].trash_slot
    t = 128
    tok = np.zeros((4, t), np.int64)
    pos = np.zeros((4, t), np.int64)
    slots = np.full((4, t), trash, np.int64)
    for i, n in enumerate(lens):
        tok[i, :n] = seqs[i][:n]
        pos[i, :n] = np.arange(n)
        slots[i, :n] = compute_slot_mapping(blocks[i], 0, n, bs, trash)
    inputs = [(tok, pos, slots, np.array(lens, np.int32),
               np.array([n - 1 for n in lens], np.int64))]
    for j in range(steps):
        p = np.array([[n + j] for n in lens], np.int64)
        inputs.append((np.array([[seqs[i][n + j]] for i, n in enumerate(lens)]), p,
                       np.stack([compute_slot_mapping(blocks[i], int(p[i, 0]), 1, bs,
                                                      trash) for i in range(4)]).astype(np.int64),
                       (p[:, 0] + 1).astype(np.int32), None))
    # Card in bf16 against the CPU in f32: activations are rounded to bf16
    # between every op on the card, so the logits agree to a few 1e-2 of
    # their largest magnitude, not to f32 precision.
    rel_tol = 5e-2
    for step, (tk, ps, sl, lens_, last) in enumerate(inputs):
        out = {}
        for name, d, pr in (("gpu", dev, params), ("cpu", torch.device("cpu"), cpu_params)):
            def tt(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(d)
            logits, _ = forward_paged(pr, cfg, tt(tk), caches[name], tt(ps), tt(sl),
                                      tt(tables), tt(lens_),
                                      last_idx=None if last is None else tt(last),
                                      device=d)
            out[name] = logits.float().cpu()
        g, c = out["gpu"], out["cpu"]
        assert g.shape == c.shape and torch.isfinite(g).all()
        rel = ((g - c).abs().max() / c.abs().max()).item()
        agree = (g.argmax(-1) == c.argmax(-1)).float().mean().item()
        log(f"  forward step {step} ({'prefill' if step == 0 else 'decode'}): "
            f"max|gpu-cpu|/max|cpu| {rel:.4g} (tol {rel_tol}), argmax agreement {agree:.2f}")
        assert rel <= rel_tol, f"teacher-forced step {step}: {rel} > {rel_tol}"
    del params, caches
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


async def serve(engine, waves) -> list[dict]:
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
    for wave in waves:
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


def full_depth(dev, card: str) -> dict:
    import numpy as np
    import torch

    from blazr_tpu_torch.attention.paged_attention import paged_attention_decode
    from blazr_tpu_torch.config import AppConfig, GenerationConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine
    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.quant.kernels import qmm
    from blazr_tpu_torch.utils.synthetic import mistral_7b_config, synth_llama_params

    cfg = mistral_7b_config()
    t0 = time.perf_counter()
    params = synth_llama_params(cfg, quant="awq", dtype=torch.bfloat16, seed=SEED,
                                device=dev)
    torch.cuda.synchronize()
    log(f"  synthesized {cfg.num_layers}-layer Mistral-7B AWQ-INT4 on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    model = Model(cfg, params, torch.bfloat16)
    app = AppConfig(model=cfg)
    engine = BatchEngine(model, StubTokenizer(), app)
    rng = np.random.default_rng(SEED + 5)
    lens = [64, 512, 200, 333, 128, 480, 96, 256]
    reqs = []
    for i, n in enumerate(lens):
        prompt = rng.integers(0, cfg.vocab_size, n).tolist()
        gen = (GenerationConfig(max_tokens=64, temperature=0.7, top_p=0.9, seed=100 + i)
               if i in (2, 6) else GenerationConfig(max_tokens=64, temperature=0.0))
        reqs.append((prompt, gen))
    qmm.launches = 0
    paged_attention_decode.launches = 0
    t0 = time.perf_counter()
    results = asyncio.run(serve(engine, [reqs[:4], reqs[4:]]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"qmm": qmm.launches, "paged_attention": paged_attention_decode.launches}
    total = 0
    for i, r in enumerate(results):
        toks = r["tokens"]
        assert len(toks) == 64, f"request {i}: {len(toks)} tokens"
        assert all(0 <= t < cfg.vocab_size for t in toks)
        total += len(toks)
        log(f"  request {i}: prompt {r['prompt_len']:4d}, temperature "
            f"{r['temperature']}, tokens {len(toks)}, TTFT {r['ttft'] * 1e3:.1f} ms, "
            f"done at {r['wall']:.2f} s")
    log(f"  served {total} tokens for {len(results)} requests in {wall:.2f} s: "
        f"{total / wall:.1f} tok/s aggregate ({card}); depth {cfg.num_layers} layers; "
        f"horizon rounds {engine.horizon_dispatches}, steps {engine.horizon_steps}")
    perf = engine.perf
    log(f"  engine wall: prefill dispatch {perf['prefill']:.2f} s over "
        f"{int(perf['prefill_n'])} steps, decode {perf['decode']:.2f} s over "
        f"{engine.horizon_steps} steps ({perf['decode'] / engine.horizon_steps * 1e3:.1f} "
        f"ms/step), first-token fetch {perf['p_finish']:.2f} s")
    log(f"  launches during serving: {launches}")
    assert launches["qmm"] > 0 and launches["paged_attention"] > 0, launches
    del engine, model, params
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    if not (REPO / "blazr_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(blazr_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from blazr_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False      # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    log("phase 1: card and build")
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    logs = cuda_build.build_all(["qmm", "paged_attention"])
    log(f"  built csrc/qmm.cu and csrc/paged_attention.cu for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s (in parallel)")
    (cuda_build.BUILD_DIR / "build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    log("phase 2: B1 fused dequant-matmul vs plain")
    b1 = check_b1(dev, gen)
    log("phase 3: B2 paged decode attention vs plain")
    b2 = check_b2(dev, gen)
    log("phase 4: 2-layer full-width forward, card (bf16) vs CPU (f32)")
    teacher_forced(dev)
    log("phase 5: 32-layer Mistral-7B AWQ BatchEngine, 8 requests in two waves")
    launches = full_depth(dev, card)
    log("phase 6: kernel timings")
    t1 = time_b1(dev, gen)
    b1_variants(dev, gen)
    t2 = time_b2(dev, gen)
    kernels = [
        dict(name="qmm_w4a16 (B1)", route="cuda", source="blazr_tpu_torch/csrc/qmm.cu",
             replaces="blazr_tpu/quant/pallas/int_matmul.py:69",
             launches=launches["qmm"], max_abs_err=b1["max_abs_err"],
             ms=t1["ms"], plain_ms=t1["plain_ms"], bound_ms=t1["bound_ms"],
             bound_by=t1["bound_by"], library_ms=t1["library_ms"], shape=t1["shape"]),
        dict(name="paged_attention_decode (B2)", route="cuda",
             source="blazr_tpu_torch/csrc/paged_attention.cu",
             replaces="blazr_tpu/attention/paged_attention.py:34",
             launches=launches["paged_attention"], max_abs_err=b2["max_abs_err"],
             ms=t2["ms"], plain_ms=t2["plain_ms"], bound_ms=t2["bound_ms"],
             bound_by=t2["bound_by"], library_ms=t2["library_ms"], shape=t2["shape"]),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s; card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
