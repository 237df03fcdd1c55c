#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``blazr_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                      # every phase, result lines
    python3 chip_smoke.py --phases build,b3    # a subset, no result lines

Phases, in order; any failure raises and the script exits non-zero:
  1.  print the card (name, power limit) and build csrc/*.cu (B1-B6) with
      nvcc, one process per source, all started together;
  2.  kernel B1 (fused dequant-matmul) against its plain version at the
      Mistral-7B projection shapes and small edge cases, f16 included;
  3.  kernel B2 (paged decode attention) against its plain version;
  3b. kernel B3 (int8-activation matmul) against its plain version: the four
      projections at m ∈ {1, 8, 256, 512}, w4a8 and w8a8, bf16, f32 and f16,
      a GPTQ desc-act perm, all-zero rows, integer-equal activation quant;
  3c. kernel B4 (streaming decode matmul) against its plain version;
  3d. kernel B5 (wide KV view) and 3e. kernel B6 (head-major KV cache)
      against their plain versions, bf16 and f32, bs 64/128, B 8/32;
  3f. the layout tools' sweeps (their main path): B2 vs B5, B2 vs B6;
  4.  a full-width 2-layer Mistral-7B AWQ forward_paged, prefill + 4
      teacher-forced decode steps, on the card (bf16) against the CPU (f32);
  4b. the same for the contiguous llama.forward under w8a8 (B3 on the card);
  4c. the Δppl gate: w4a8-prefill and w8a8 within 2% of w4a16;
  5.  the 32-layer Mistral-7B AWQ BatchEngine serving 8 requests (w4a16);
  5b. the 32-layer Executor under w8a8: a 512-token prompt, 128 greedy
      tokens, B3 launched 128 times per forward and B1 never;
  5c. the 8 requests of phase 5 under w4a8-prefill with
      BLAZR_TPU_STREAM_KERNEL=1: B3 (prefill), B4 (decode) and B2 launched;
  7.  the normal entry point: an 8-layer full-width AWQ checkpoint and a
      BPE tokenizer.json written to disk, loaded by load_model (f16) and
      served over HTTP with continuous batching (8 concurrent requests), then
      ``python -m blazr_tpu_torch.cli serve`` as a subprocess;
  8.  timings, and one ``{"kernels": [...]}`` JSON line with each kernel's
      launches in its serving phase, max error, time, bound, plain time and
      library-call time.
Each serving phase sets the launch counts to 0 just before it and reads
them just after. The last line is ``{"ok": true, "device": {...}}``. Without
CUDA, or run outside a checkout that holds ``blazr_tpu_torch/``, it prints no
result and exits non-zero. The compiler's full report goes to
``blazr_tpu_torch/csrc/_build/build.log``.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
H100_INT8_OPS = 1979e12             # dense int8 tensor-core peak

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
    x16 = x.to(torch.float16)
    f16_ms = time_ms(lambda: qmm(x16, qw, s, mn, bits=4, signed=True, group_size=gs,
                                 device=dev), iters=50)
    log(f"  B1 gateup m={m}: kernel {ms:.4f} ms (f16 x: {f16_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, torch.matmul(bf16 dequantized) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, shape=f"m={m} K={k} N={n}",
                f16_ms=f16_ms)


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
                assert lib.qmm_tc_launch(*args, 0, stream) == 0

            t = {"simt": [], "wmma": []}
            for name, fn in (("simt", simt), ("wmma", wmma), ("wmma", wmma),
                             ("simt", simt)):
                t[name].append(time_ms(fn, iters=20))
            row.append(f"m={m} {min(t['simt']):.4f}/{min(t['wmma']):.4f}")
        log(f"  B1 {pname} CUDA-core/WMMA ms: " + ", ".join(row))


# ---------------------------------------------------------------------------
# phase 3b/3c: B3 and B4
# ---------------------------------------------------------------------------

def check_b3(dev, gen) -> dict:
    """B3 against its plain version: the four Mistral-7B projections at
    m ∈ {1, 8, 256, 512}, w4a8 and w8a8 weights, bf16 and f32 activations
    (from m=8 with one all-zero row), and a GPTQ desc-act permutation. The
    activation quant is plain PyTorch on both sides; its integers must be
    equal on the card and on the CPU."""
    import numpy as np
    import torch

    from blazr_tpu_torch.quant import qtensor
    from blazr_tpu_torch.quant.int8 import qmm_int8, qmm_int8_reference, quantize_rows
    from blazr_tpu_torch.quant.matmul import quant_matmul

    # Both sides sum exact int32 group partials; they differ by the order of
    # the f32 affine sums (f32: 1e-3 of the largest output) and, in bf16, by
    # the output rounding (2^-9 relative; 8e-3 leaves room for the sums).
    tols = {torch.float32: 1e-3, torch.bfloat16: 8e-3, torch.float16: 8e-3}
    worst = 0.0

    def one(name, x, qw, s, mn, bits, gs):
        nonlocal worst
        got = qmm_int8(x, qw, s, mn, bits=bits, group_size=gs, device=dev)
        ref = qmm_int8_reference(x.float(), qw, s, mn, bits=bits, group_size=gs)
        xq, xs = quantize_rows(x)
        xq_cpu, xs_cpu = quantize_rows(x.cpu())
        torch.cuda.synchronize()
        assert torch.equal(xq.cpu(), xq_cpu) and torch.equal(xs.cpu(), xs_cpu), \
            f"B3 {name}: activation quant differs between card and CPU"
        assert got.shape == ref.shape and torch.isfinite(got).all(), name
        err = (got.float() - ref).abs().max().item()
        tol = tols[x.dtype] * ref.abs().max().item()
        log(f"  B3 {name:40s} max_abs_err {err:.4g}  tol {tol:.4g}")
        assert err <= tol, f"B3 {name}: {err} > {tol}"
        worst = max(worst, err)

    for pname, (k, n) in B1_SHAPES.items():
        for mode, bits in (("w4a8", 4), ("w8a8", 8)):
            qw, s, mn = rand_planes(k, n, bits, 128, gen, dev)
            for m in (1, 8, 256, 512):
                for dt in (torch.bfloat16, torch.float32):
                    x = torch.randn((m, k), device=dev, generator=gen).to(dt)
                    if m > 1:
                        x[m // 2] = 0
                    one(f"{pname} {mode} m={m} {str(dt)[6:]}", x, qw, s, mn, bits, 128)
            for m in (8, 512):
                x = torch.randn((m, k), device=dev, generator=gen).to(torch.float16)
                one(f"{pname} {mode} m={m} float16", x, qw, s, mn, bits, 128)
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
    return {"max_abs_err": max(worst, err)}


def check_b4(dev, gen) -> dict:
    """B4 against its plain version: m ∈ {1, 8, 32}, signed 4- and 8-bit
    weights, the four Mistral-7B projections, and f32 activations once."""
    import torch

    from blazr_tpu_torch.quant.kernels import qmm_stream, qmm_stream_reference

    rel_tol = 8e-3                       # as B1: bf16 output, f32 sums
    worst = 0.0
    cases = [(pname, k, n, bits, m, torch.bfloat16)
             for pname, (k, n) in B1_SHAPES.items() for bits in (4, 8)
             for m in (1, 8, 32)]
    cases += [("o f32", 4096, 4096, 4, 5, torch.float32),
              ("o f16", 4096, 4096, 4, 5, torch.float16),
              ("gateup f16", 4096, 28672, 4, 32, torch.float16)]
    for pname, k, n, bits, m, dt in cases:
        qw, s, mn = rand_planes(k, n, bits, 128, gen, dev)
        x = torch.randn((m, k), device=dev, generator=gen).to(dt)
        got = qmm_stream(x, qw, s, mn, bits=bits, group_size=128, device=dev)
        ref = qmm_stream_reference(x.float(), qw, s, mn, bits=bits, group_size=128)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and torch.isfinite(got).all(), pname
        err = (got.float() - ref).abs().max().item()
        tol = rel_tol * ref.abs().max().item()
        log(f"  B4 {pname} {bits}-bit m={m:<3d} {str(dt)[6:]:9s} max_abs_err "
            f"{err:.4g}  tol {tol:.4g}")
        assert err <= tol, f"B4 {pname} {bits}-bit m={m}: {err} > {tol}"
        worst = max(worst, err)
    return {"max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 3: B2
# ---------------------------------------------------------------------------

def pa_inputs(dev, gen, *, b, h_q, h_kv, d, bs, seq_lens, int8=False, nb_extra=8,
              dtype=None):
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
        # Probabilities drop to bf16 (f16) before the AV product and the
        # output is bf16 (f16): 2^-9 (2^-11) relative each, against outputs
        # of order max|v|.
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
    q16, k16, v16 = (s[n].to(torch.float16) for n in ("q", "kc", "vc"))
    f16_ms = time_ms(lambda: paged_attention_decode(
        q16, k16, v16, s["bt"], s["sl"], num_blocks=s["nb"], device=dev, **kw), iters=100)
    log(f"  B2 B={b} ctx={ctx}: kernel {ms:.4f} ms (f16: {f16_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, SDPA(GQA, gathered KV) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, shape=f"B={b} ctx={ctx}",
                f16_ms=f16_ms)


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


def check_layout(dev, gen, layout: str) -> dict:
    """B5 or B6 against its plain version at the tools' geometry (G=8, 4
    query heads each, D=128): bf16 and f32, bs 64 and 128, B 8 and 32,
    ragged seq_lens with 1 and partial last blocks. The probabilities stay
    f32 on both sides: 2e-2 absolute in bf16 (output rounding on outputs of
    order max|v|), 1e-4 in f32 (sum order)."""
    import torch

    from blazr_tpu_torch.tools.bench_pa_wide import pa_wide_reference

    fn, prepare = layout_kernel(layout)
    tols = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for bs in (64, 128):
            for b in (8, 32):
                lens = torch.randint(1, 1025, (b,), device=dev, generator=gen)
                lens[0], lens[1], lens[2] = 1, 1024, bs + 5
                s = pa_inputs(dev, gen, b=b, h_q=32, h_kv=8, d=128, bs=bs,
                              seq_lens=lens.tolist(), dtype=dtype)
                k, v = prepare(s["kc"], s["vc"])
                got = fn(s["q"], k, v, s["bt"], s["sl"], block_size=bs,
                         num_blocks=s["nb"], device=dev)
                ref = pa_wide_reference(s["q"].float(), s["kc"].float(), s["vc"].float(),
                                        s["bt"], s["sl"], block_size=bs)
                torch.cuda.synchronize()
                assert got.shape == ref.shape and torch.isfinite(got).all()
                err = (got.float() - ref).abs().max().item()
                name = f"{layout} {str(dtype)[6:]} bs={bs} B={b}"
                log(f"  {name:34s} max_abs_err {err:.4g}  tol {tols[dtype]}")
                assert err <= tols[dtype], f"{name}: {err} > {tols[dtype]}"
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
    """B5 or B6 at B=8, ctx 1024 (seq_len 1023), bs 64, bf16: time, plain
    time, SDPA over pre-gathered KV (the library call) and the bound."""
    import torch
    import torch.nn.functional as F

    from blazr_tpu_torch.kvcache.paged import page_slot_index
    from blazr_tpu_torch.tools.bench_pa_wide import pa_wide_reference

    fn, prepare = layout_kernel(layout)
    b, h_q, h_kv, d, bs, ctx = 8, 32, 8, 128, 64, 1023
    s = pa_inputs(dev, gen, b=b, h_q=h_q, h_kv=h_kv, d=d, bs=bs, seq_lens=[ctx] * b,
                  nb_extra=0)
    k, v = prepare(s["kc"], s["vc"])
    ms = time_ms(lambda: fn(s["q"], k, v, s["bt"], s["sl"], block_size=bs,
                            num_blocks=s["nb"], device=dev), iters=100)
    plain_ms = time_ms(lambda: pa_wide_reference(s["q"], s["kc"], s["vc"], s["bt"],
                                                 s["sl"], block_size=bs), iters=10)
    idx = page_slot_index(bs, s["bt"])[:, :ctx]
    kg = s["kc"][idx].permute(0, 2, 1, 3).contiguous()
    vg = s["vc"][idx].permute(0, 2, 1, 3).contiguous()
    qg = s["q"][:, :, None, :]
    try:
        F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qg, kg, vg, enable_gqa=True), iters=100)
    except TypeError:                   # PyTorch without enable_gqa
        ke = kg.repeat_interleave(h_q // h_kv, dim=1)
        ve = vg.repeat_interleave(h_q // h_kv, dim=1)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qg, ke, ve),
                             iters=100)
    nbytes = (2 * b * ctx * h_kv * d * 2 + 2 * b * h_q * d * 2
              + s["bt"].numel() * 4 + b * 4)
    bound_ms, bound_by = bound(nbytes, 4.0 * b * h_q * ctx * d)
    log(f"  {layout} B={b} seq_len={ctx} bs={bs}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA(GQA, gathered KV) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, shape=f"B={b} seq_len={ctx} bs={bs}")


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


def counted() -> dict:
    """Every kernel wrapper of the port by the key its launches go under."""
    from blazr_tpu_torch.attention.paged_attention import paged_attention_decode
    from blazr_tpu_torch.quant.int8 import qmm_int8
    from blazr_tpu_torch.quant.kernels import qmm, qmm_stream
    from blazr_tpu_torch.tools.bench_pa_headmajor import pa_headmajor
    from blazr_tpu_torch.tools.bench_pa_wide import pa_wide

    return {"qmm": qmm, "paged_attention": paged_attention_decode,
            "qmm_int8": qmm_int8, "qmm_stream": qmm_stream, "pa_wide": pa_wide,
            "pa_headmajor": pa_headmajor}


def reset_counts() -> None:
    for fn in counted().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in counted().items()}


def mistral_model(dev, layers: int | None = None):
    import torch

    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.utils.synthetic import mistral_7b_config, synth_llama_params

    cfg = mistral_7b_config()
    if layers is not None:
        cfg.num_layers = layers
    t0 = time.perf_counter()
    params = synth_llama_params(cfg, quant="awq", dtype=torch.bfloat16, seed=SEED,
                                device=dev)
    torch.cuda.synchronize()
    log(f"  synthesized {cfg.num_layers}-layer Mistral-7B AWQ-INT4 on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    return Model(cfg, params, torch.bfloat16)


def full_depth(dev, card: str, quant_compute: str = "w4a16",
               stream: bool = False) -> dict:
    """The 32-layer BatchEngine serving 8 requests in two waves; returns the
    kernels' launch counts over the run."""
    import numpy as np
    import torch

    from blazr_tpu_torch.config import AppConfig, GenerationConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine

    model = mistral_model(dev)
    cfg = model.cfg
    app = AppConfig(model=cfg)
    app.inference.quant_compute = quant_compute
    engine = BatchEngine(model, StubTokenizer(), app)
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
    try:
        reset_counts()
        t0 = time.perf_counter()
        results = asyncio.run(serve(engine, [reqs[:4], reqs[4:]]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        if old is None:
            os.environ.pop("BLAZR_TPU_STREAM_KERNEL")
        else:
            os.environ["BLAZR_TPU_STREAM_KERNEL"] = old
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
        f"quant_compute {quant_compute}, stream kernel {'on' if stream else 'off'}; "
        f"horizon rounds {engine.horizon_dispatches}, steps {engine.horizon_steps}")
    perf = engine.perf
    log(f"  engine wall: prefill dispatch {perf['prefill']:.2f} s over "
        f"{int(perf['prefill_n'])} steps, decode {perf['decode']:.2f} s over "
        f"{engine.horizon_steps} steps ({perf['decode'] / engine.horizon_steps * 1e3:.1f} "
        f"ms/step), first-token fetch {perf['p_finish']:.2f} s")
    log(f"  launches during serving: {launches}")
    assert launches["paged_attention"] > 0, launches
    if stream:
        assert launches["qmm_int8"] > 0 and launches["qmm_stream"] > 0, launches
    else:
        assert launches["qmm"] > 0, launches
    del engine, model
    torch.cuda.empty_cache()
    return launches


def serve_stream(dev, card: str) -> dict:
    """Phase 5c: the same 8 requests under w4a8-prefill with the stream
    kernel on: prefill groups of 256+ rows take B3, decode takes B4."""
    return full_depth(dev, card, quant_compute="w4a8-prefill", stream=True)


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


def serve_http(dev, card: str) -> dict:
    """Phase 7: write a full-width Mistral-7B AWQ-INT4 checkpoint (group
    128, 8 layers) and a 32000-token byte-level BPE tokenizer.json to a
    temporary directory; load it through ModelScheduler -> load_model (f16,
    the AWQ default) and serve it from the port's HTTP server with
    continuous batching; 8 concurrent requests over http.client (4 streamed
    chats, 4 completions, prompts of 64-512 tokens, 64 greedy tokens each).
    Then ``python -m blazr_tpu_torch.cli serve`` as a subprocess answers
    /health and one chat completion."""
    import shutil
    import socket
    import tempfile
    import threading

    import numpy as np
    import torch

    from blazr_tpu_torch.config.server import ServerConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine
    from blazr_tpu_torch.engine.model_scheduler import ModelScheduler
    from blazr_tpu_torch.server import create_app, serve
    from blazr_tpu_torch.utils.synthetic import (mistral_7b_config, write_awq_checkpoint,
                                                 write_bpe_tokenizer_json)

    cfg = mistral_7b_config()
    cfg.num_layers = HTTP_LAYERS
    ckpt = Path(tempfile.mkdtemp(prefix="blazr_awq_"))
    out: dict = {}
    try:
        t0 = time.perf_counter()
        write_awq_checkpoint(ckpt, cfg, group_size=128, seed=SEED)
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
        inf.prefix_cache = False
        engine = BatchEngine(model, ex.tokenizer, ex.app_cfg)
        app = create_app(sched, ServerConfig(host="127.0.0.1", port=0),
                         batch_engine=engine)
        loop = asyncio.new_event_loop()
        stop = asyncio.Event()
        ready = threading.Event()
        bound: dict = {}

        def run_loop():
            asyncio.set_event_loop(loop)
            loop.run_until_complete(serve(app, "127.0.0.1", 0, stop=stop,
                                          started=lambda p: (bound.update(port=p),
                                                             ready.set())))

        server = threading.Thread(target=run_loop, daemon=True)
        server.start()
        assert ready.wait(60), "server did not start"
        port = bound["port"]
        st, body = _http(port, "GET", "/health")
        assert st == 200 and json.loads(body)["status"] == "ok", body

        rng = np.random.default_rng(SEED + 11)
        lens = [64, 512, 200, 333, 128, 480, 96, 256]
        texts = [_prompt_text(ex.tokenizer, n, rng) for n in lens]
        results: list = [None] * 8

        def one(i: int) -> None:
            if i % 2 == 0:                 # streamed chat
                results[i] = _stream_chat(port, {
                    "messages": [{"role": "user", "content": texts[i]}],
                    "max_tokens": 64, "temperature": 0, "stream": True})
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
        total = 0
        ttfts = []
        for i, r in enumerate(results):
            assert r is not None, f"request {i} did not finish"
            if i % 2 == 0:
                n = len(r["deltas"])
                assert r["role"] == "assistant" and r["done"] and r["finish"], r
                assert r["usage"]["completion_tokens"] == n, (r["usage"], n)
                assert r["finish"] == "stop" or n == 64, (r["finish"], n)
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
        out.update(ttft_ms=[t * 1e3 for t in ttfts], tok_s=total / wall, wall_s=wall,
                   tokens=total, **launches)
        log(f"  served {total} tokens for 8 HTTP requests in {wall:.2f} s: "
            f"{total / wall:.1f} tok/s aggregate; streamed-chat client TTFT "
            f"median {sorted(ttfts)[len(ttfts) // 2] * 1e3:.1f} ms, max "
            f"{max(ttfts) * 1e3:.1f} ms ({card}); depth {HTTP_LAYERS} layers, f16")
        log(f"  launches during the HTTP run: {launches}")
        assert launches["qmm"] > 0 and launches["paged_attention"] > 0, launches
        st, _ = _http(port, "GET", "/metrics")
        assert st == 501, st
        loop.call_soon_threadsafe(stop.set)
        server.join(120)
        del engine, app, sched, ex, model
        torch.cuda.empty_cache()

        # The CLI entry point in its own process.
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            cli_port = s.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=str(REPO))
        proc = subprocess.Popen(
            [sys.executable, "-m", "blazr_tpu_torch.cli", "serve", "--model", str(ckpt),
             "--continuous-batching", "--host", "127.0.0.1", "--port", str(cli_port),
             "--no-warmup"], cwd=REPO, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        try:
            t0 = time.perf_counter()
            while True:
                if proc.poll() is not None:
                    raise RuntimeError(f"cli serve exited {proc.returncode}: "
                                       f"{proc.stderr.read()[-4000:]}")
                try:
                    st, body = _http(cli_port, "GET", "/health", timeout=5)
                    if st == 200:
                        break
                except OSError:
                    pass
                assert time.perf_counter() - t0 < 300, "cli serve did not come up"
                time.sleep(1.0)
            up = time.perf_counter() - t0
            st, body = _http(cli_port, "POST", "/v1/chat/completions", {
                "messages": [{"role": "user", "content": texts[0]}], "max_tokens": 16,
                "temperature": 0})
            assert st == 200, (st, body)
            reply = json.loads(body)
            assert reply["choices"][0]["finish_reason"] in ("stop", "length"), reply
            log(f"  cli serve (pid {proc.pid}) answered /health after {up:.1f} s and a "
                f"chat completion of {reply['usage']['completion_tokens']} tokens")
            out["cli_up_s"] = up
        finally:
            os.kill(proc.pid, 15)
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                os.kill(proc.pid, 9)
                proc.wait(60)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return out


def device_busy(fn) -> tuple[float, float, int]:
    """(wall s, summed device time s, device events) of ``fn()`` under
    torch.profiler (kernels and copies on one stream do not overlap); the
    device time is 0 where the profiler sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, count = 0.0, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += ev.time_range.elapsed_us()
            count += 1
    return wall, busy_us / 1e6, count


def serve_executor(dev, card: str) -> dict:
    """Phase 5b: the 32-layer single-stream Executor under w8a8: a 512-token
    prompt and 128 greedy tokens through collect_generation. Every
    projection of every forward launches B3; B1 never launches."""
    import numpy as np
    import torch

    from blazr_tpu_torch.config import AppConfig, GenerationConfig
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.engine.generate_text import collect_generation

    model = mistral_model(dev)
    cfg = model.cfg
    app = AppConfig(model=cfg)
    app.inference.quant_compute = "w8a8"
    t0 = time.perf_counter()
    ex = Executor(model, StubTokenizer(), app)
    torch.cuda.synchronize()
    qkv = model.params["layers"][0]["qkv"]
    assert qkv.bits == 8 and qkv.act_quant
    log(f"  widened to int8 in place in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated")
    ex.warmup()
    prompt = np.random.default_rng(SEED + 7).integers(0, cfg.vocab_size, 512).tolist()
    reset_counts()
    t0 = time.perf_counter()
    res = collect_generation(ex, prompt, GenerationConfig(max_tokens=128, temperature=0.0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n = len(res.tokens)
    assert n == 128 and all(0 <= t < cfg.vocab_size for t in res.tokens), n
    forwards = n                       # one prefill + n - 1 decode steps
    per_forward = 4 * cfg.num_layers
    log(f"  Executor w8a8, {cfg.num_layers} layers, prompt 512, {n} greedy tokens: "
        f"TTFT {res.prompt_eval_duration * 1e3:.1f} ms, "
        f"{res.eval_duration / (n - 1) * 1e3:.2f} ms per decode token, "
        f"{n / wall:.1f} tok/s end to end, {(n - 1) / res.eval_duration:.1f} tok/s "
        f"decode ({card})")
    log(f"  launches: {launches} ({forwards} forwards x {per_forward} projections)")
    assert launches["qmm_int8"] == forwards * per_forward, launches
    assert launches["qmm"] == 0 and launches["qmm_stream"] == 0, launches
    # Where a decode step's time goes: 16 more greedy tokens under the
    # profiler, kernel time against wall time.
    wall_p, busy, kernels = device_busy(lambda: collect_generation(
        ex, prompt[:16], GenerationConfig(max_tokens=17, temperature=0.0)))
    log(f"  profiled 16-token prompt + 17 tokens: wall {wall_p * 1e3:.1f} ms, CUDA "
        f"kernels {busy * 1e3:.1f} ms over {kernels} kernels "
        f"({kernels / 17:.0f} per token); device idle share "
        + (f"{1 - busy / wall_p:.2f}" if busy > 0 else "not measured (no device events)"))
    del ex, model
    torch.cuda.empty_cache()
    return dict(launches, ttft_ms=res.prompt_eval_duration * 1e3,
                ms_per_token=res.eval_duration / (n - 1) * 1e3, tok_s=n / wall)


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


def time_b3(dev, gen) -> dict:
    """B3 at the gate+up shape for w4a8 and w8a8 at m ∈ {8, 512, 4096}, with
    its bound, plain version, B1 on the same 4-bit weight, torch.matmul on a
    pre-dequantized bf16 weight and torch._int_mm at the same (m, K, N)
    (the int8 GEMM rate: not the same function; it takes m > 16)."""
    import torch

    from blazr_tpu_torch.quant.int8 import qmm_int8, qmm_int8_reference
    from blazr_tpu_torch.quant.kernels import qmm
    from blazr_tpu_torch.quant.qtensor import dequantize_planes, unpack

    k, n = B1_SHAPES["gateup"]
    gs = 128
    rows = {}
    qw4, s, mn = rand_planes(k, n, 4, gs, gen, dev)
    w_bf16 = dequantize_planes(qw4, s, mn, 4, True, gs, torch.bfloat16)
    for mode, bits in (("w4a8", 4), ("w8a8", 8)):
        qw = qw4 if bits == 4 else rand_planes(k, n, 8, gs, gen, dev)[0]
        w_i8 = unpack(qw, bits, True).to(torch.int8).t().contiguous().t()
        for m in (8, 512, 4096):
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            ms = time_ms(lambda: qmm_int8(x, qw, s, mn, bits=bits, group_size=gs,
                                          device=dev), iters=20)
            plain_ms = time_ms(lambda: qmm_int8_reference(x, qw, s, mn, bits=bits,
                                                          group_size=gs),
                               iters=2, warmup=1)
            lib_ms = time_ms(lambda: torch.matmul(x, w_bf16), iters=20)
            int_mm_ms = None
            if m > 16:
                xq = torch.randint(-127, 128, (m, k), device=dev, generator=gen,
                                   dtype=torch.int8)
                int_mm_ms = time_ms(lambda: torch._int_mm(xq, w_i8), iters=20)
            b1_ms = (time_ms(lambda: qmm(x, qw4, s, mn, bits=4, signed=True,
                                         group_size=gs, device=dev), iters=20)
                     if bits == 4 else None)
            nbytes = qw.numel() * 4 + s.numel() * 8 + m * k * 2 + m * n * 2
            bms, by = bound(nbytes, 2.0 * m * k * n, H100_INT8_OPS)
            rows[(mode, m)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                   int_mm_ms=int_mm_ms, b1_ms=b1_ms, bound_ms=bms,
                                   bound_by=by, mbytes=nbytes / 1e6)
            log(f"  B3 gateup {mode} m={m}: kernel {ms:.4f} ms "
                f"({2.0 * m * k * n / ms / 1e9:.1f} TOP/s), bound {bms:.4f} ms ({by}, "
                f"{nbytes / 1e6:.1f} MB), plain {plain_ms:.3f} ms, torch.matmul(bf16 "
                f"dequantized) {lib_ms:.4f} ms, torch._int_mm (int8 GEMM rate, not the "
                f"same function) {'n/a (m <= 16)' if int_mm_ms is None else f'{int_mm_ms:.4f} ms'}"
                + ("" if b1_ms is None else f", B1 w4a16 {b1_ms:.4f} ms"))
    return rows


def time_b4(dev, gen) -> dict:
    """B4 at m ∈ {1, 8, 32} on the four projections beside B1 on the same
    weights, in turns (B4, B1, B1, B4), best of each pair; the gate+up rows
    also with the plain version and torch.matmul on a dequantized weight."""
    import torch

    from blazr_tpu_torch.quant.kernels import qmm, qmm_stream, qmm_stream_reference
    from blazr_tpu_torch.quant.qtensor import dequantize_planes

    gs = 128
    rows = {}
    for pname, (k, n) in B1_SHAPES.items():
        qw, s, mn = rand_planes(k, n, 4, gs, gen, dev)
        w_bf16 = (dequantize_planes(qw, s, mn, 4, True, gs, torch.bfloat16)
                  if pname == "gateup" else None)
        line = []
        for m in (1, 8, 32):
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            t = {"b4": [], "b1": []}
            for name in ("b4", "b1", "b1", "b4"):
                fn = qmm_stream if name == "b4" else qmm
                kw = dict(bits=4, group_size=gs, device=dev)
                if name == "b1":
                    kw["signed"] = True
                t[name].append(time_ms(lambda: fn(x, qw, s, mn, **kw), iters=50))
            ms, b1_ms = min(t["b4"]), min(t["b1"])
            nbytes = qw.numel() * 4 + s.numel() * 8 + m * k * 2 + m * n * 2
            bms, by = bound(nbytes, 2.0 * m * k * n)
            row = dict(ms=ms, b1_ms=b1_ms, bound_ms=bms, bound_by=by, plain_ms=None,
                       library_ms=None)
            if w_bf16 is not None:
                row["plain_ms"] = time_ms(lambda: qmm_stream_reference(
                    x, qw, s, mn, bits=4, group_size=gs), iters=5, warmup=1)
                row["library_ms"] = time_ms(lambda: torch.matmul(x, w_bf16), iters=50)
            rows[(pname, m)] = row
            line.append(f"m={m} {ms:.4f}/{b1_ms:.4f} (bound {bms:.4f})")
        log(f"  B4/B1 {pname} K={k} N={n} ms: " + ", ".join(line))
    for m in (1, 8, 32):
        r = rows[("gateup", m)]
        log(f"  B4 gateup m={m}: plain {r['plain_ms']:.4f} ms, torch.matmul(bf16 "
            f"dequantized) {r['library_ms']:.4f} ms")
    return rows


def timings(dev, gen, res: dict) -> list:
    """Phase 6: every kernel's time, bound, plain and library time, and the
    launches of the serving phase that ran it; returns the kernels line."""
    t1 = time_b1(dev, gen)
    b1_variants(dev, gen)
    t2 = time_b2(dev, gen)
    t3 = time_b3(dev, gen)
    t4 = time_b4(dev, gen)
    t5 = time_layout(dev, gen, "wide")
    t6 = time_layout(dev, gen, "headmajor")

    def got(phase, key):
        return res.get(phase, {}).get(key)

    b3 = t3[("w8a8", 512)]
    b4 = t4[("gateup", 8)]
    k, n = B1_SHAPES["gateup"]
    return [
        dict(name="qmm_w4a16 (B1)", route="cuda", source="blazr_tpu_torch/csrc/qmm.cu",
             replaces="blazr_tpu/quant/pallas/int_matmul.py:69",
             launches=got("serve", "qmm"), max_abs_err=got("b1", "max_abs_err"),
             ms=t1["ms"], plain_ms=t1["plain_ms"], bound_ms=t1["bound_ms"],
             bound_by=t1["bound_by"], library_ms=t1["library_ms"], shape=t1["shape"]),
        dict(name="paged_attention_decode (B2)", route="cuda",
             source="blazr_tpu_torch/csrc/paged_attention.cu",
             replaces="blazr_tpu/attention/paged_attention.py:34",
             launches=got("serve", "paged_attention"), max_abs_err=got("b2", "max_abs_err"),
             ms=t2["ms"], plain_ms=t2["plain_ms"], bound_ms=t2["bound_ms"],
             bound_by=t2["bound_by"], library_ms=t2["library_ms"], shape=t2["shape"]),
        dict(name="qmm_int8 (B3)", route="cuda", source="blazr_tpu_torch/csrc/qmm_int8.cu",
             replaces="blazr_tpu/quant/pallas/int_matmul.py:276",
             launches=got("executor", "qmm_int8"), max_abs_err=got("b3", "max_abs_err"),
             ms=b3["ms"], plain_ms=b3["plain_ms"], bound_ms=b3["bound_ms"],
             bound_by=b3["bound_by"], library_ms=b3["library_ms"],
             int_mm_ms=b3["int_mm_ms"], shape=f"w8a8 m=512 K={k} N={n}"),
        dict(name="qmm_stream (B4)", route="cuda",
             source="blazr_tpu_torch/csrc/qmm_stream.cu",
             replaces="blazr_tpu/quant/pallas/int_matmul.py:170",
             launches=got("serve_int8", "qmm_stream"), max_abs_err=got("b4", "max_abs_err"),
             ms=b4["ms"], plain_ms=b4["plain_ms"], bound_ms=b4["bound_ms"],
             bound_by=b4["bound_by"], library_ms=b4["library_ms"],
             shape=f"w4 m=8 K={k} N={n}"),
        dict(name="pa_wide (B5)", route="cuda", source="blazr_tpu_torch/csrc/pa_wide.cu",
             replaces="tools/bench_pa_wide.py:31",
             launches=got("tools", "pa_wide"), max_abs_err=got("b5", "max_abs_err"),
             ms=t5["ms"], plain_ms=t5["plain_ms"], bound_ms=t5["bound_ms"],
             bound_by=t5["bound_by"], library_ms=t5["library_ms"], shape=t5["shape"]),
        dict(name="pa_headmajor (B6)", route="cuda",
             source="blazr_tpu_torch/csrc/pa_headmajor.cu",
             replaces="tools/bench_pa_headmajor.py:27",
             launches=got("tools", "pa_headmajor"), max_abs_err=got("b6", "max_abs_err"),
             ms=t6["ms"], plain_ms=t6["plain_ms"], bound_ms=t6["bound_ms"],
             bound_by=t6["bound_by"], library_ms=t6["library_ms"], shape=t6["shape"]),
    ]


PHASES = ("build", "b1", "b2", "b3", "b4", "b5", "b6", "tools", "forward",
          "forward_w8a8", "ppl", "serve", "executor", "serve_int8", "http", "timings")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default: all; a subset prints no result lines)")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
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
    sources = ["qmm", "paged_attention", "qmm_int8", "qmm_stream", "pa_wide",
               "pa_headmajor"]
    logs = cuda_build.build_all(sources)
    log(f"  built {', '.join(f'csrc/{n}.cu' for n in sources)} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    (cuda_build.BUILD_DIR / "build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    res: dict = {}
    steps = [
        ("b1", "phase 2: B1 fused dequant-matmul vs plain", lambda: check_b1(dev, gen)),
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
        ("serve", "phase 5: 32-layer Mistral-7B AWQ BatchEngine (w4a16), 8 requests "
         "in two waves", lambda: full_depth(dev, card)),
        ("executor", "phase 5b: 32-layer Mistral-7B AWQ Executor under w8a8, 512-token "
         "prompt, 128 greedy tokens", lambda: serve_executor(dev, card)),
        ("serve_int8", "phase 5c: 32-layer BatchEngine under w4a8-prefill with "
         "BLAZR_TPU_STREAM_KERNEL=1", lambda: serve_stream(dev, card)),
        ("http", "phase 7: AWQ checkpoint on disk -> load_model -> OpenAI HTTP server "
         "(8 concurrent requests) and the CLI serve subprocess",
         lambda: serve_http(dev, card)),
        ("timings", "phase 8: kernel timings", lambda: timings(dev, gen, res)),
    ]
    for name, title, fn in steps:
        if name in phases:
            log(title)
            res[name] = fn()
    log(f"total {time.perf_counter() - t_start:.1f} s; card: {card}")
    if phases != list(PHASES):
        log("subset of phases: no result lines")
        return 0
    print(json.dumps({"kernels": res["timings"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
