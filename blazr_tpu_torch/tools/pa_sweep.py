"""The decode-attention layout sweep shared by ``bench_pa_wide`` and
``bench_pa_headmajor``: the JAX tools' grid (bs ∈ {64, 128}, B ∈ {8, 32},
context 1024 with seq_len 1023, G=8 kv heads, 4 query heads each, D=128,
bf16), kernel B2 and the layout's kernel timed in turns with CUDA events,
and the maximum difference of their outputs."""

from __future__ import annotations

import math
import sys
from typing import Callable, Optional, Sequence

import torch

from ..attention.paged_attention import paged_attention_decode
from ..utils.device import resolve_device

G, HPG, D = 8, 4, 128
H = G * HPG
CTX = 1024
ITERS = 128


def time_us(fn: Callable[[], object], iters: int = ITERS) -> float:
    """Microseconds per call over ``iters`` back-to-back calls, after two
    warm-up calls, between CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def sweep_inputs(b: int, bs: int, gen: torch.Generator, dev: torch.device,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """The JAX tools' inputs at (B, bs): one sequence per table row, tables
    ``arange(NB).reshape(B, MB)``, every seq_len CTX - 1."""
    mb = CTX // bs
    nb = b * mb
    q = torch.randn((b, H, D), generator=gen, device=dev).to(dtype)
    kf = torch.randn((nb * bs + 1, G, D), generator=gen, device=dev).to(dtype)
    vf = torch.randn((nb * bs + 1, G, D), generator=gen, device=dev).to(dtype)
    bt = torch.arange(nb, dtype=torch.int32, device=dev).reshape(b, mb)
    sl = torch.full((b,), CTX - 1, dtype=torch.int32, device=dev)
    return dict(q=q, kf=kf, vf=vf, bt=bt, sl=sl, nb=nb, bs=bs)


def run_sweep(label: str, prepare: Callable[[dict], tuple],
              kernel: Callable[..., torch.Tensor],
              argv: Optional[Sequence[str]] = None) -> list[dict]:
    """For bs ∈ {64, 128} and each B (``argv`` or 8 and 32): B2 and
    ``kernel(q, *prepare(inputs), bt, sl, block_size=, num_blocks=)`` on the
    same inputs, timed in turns (B2, layout, layout, B2; best of each pair),
    one line each as the JAX tools print them. Needs the card."""
    dev = resolve_device(None)                 # the card; raises without one
    batches = [int(a) for a in (argv if argv is not None else sys.argv[1:])] or [8, 32]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for bs in (64, 128):
        for b in batches:
            s = sweep_inputs(b, bs, gen, dev)
            kv = prepare(s)
            kw = dict(block_size=bs, num_blocks=s["nb"])

            def cur():
                return paged_attention_decode(s["q"], s["kf"], s["vf"], s["bt"], s["sl"],
                                              device=dev, **kw)

            def new():
                return kernel(s["q"], *kv, s["bt"], s["sl"], device=dev, **kw)

            err = (cur().float() - new().float()).abs().max().item()
            t = {"cur": [], "new": []}
            for name, fn in (("cur", cur), ("new", new), ("new", new), ("cur", cur)):
                t[name].append(time_us(fn))
            t_cur, t_new = min(t["cur"]), min(t["new"])
            if not math.isfinite(err):
                raise RuntimeError(f"{label} bs={bs} B={b}: non-finite output")
            print(f"bs={bs:3d} B={b:3d}  cur {t_cur:7.1f}  {label} {t_new:7.1f} "
                  f"us/call  (maxerr {err:.3e})", flush=True)
            rows.append(dict(bs=bs, B=b, cur_us=t_cur, us=t_new, maxerr=err))
            del s, kv
    print("done", flush=True)
    return rows
