"""Kernels B1 and B2 of blazr_tpu_torch against their plain versions on the
card. A CUDA kernel has no interpret mode, so these tests need an NVIDIA GPU
with nvcc and skip without one; ``python3 chip_smoke.py`` runs the same
checks at the served shapes.

Tolerances are in bf16: the kernels and the plain versions sum in f32, so
they differ by the bf16 rounding of the outputs (2^-9 relative) and, for
B2, of the probabilities; 1e-2 of the largest output covers both."""

import math

import pytest
import torch

from blazr_tpu_torch.attention.paged_attention import (
    paged_attention_decode, paged_attention_reference)
from blazr_tpu_torch.quant.kernels import qmm, qmm_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _planes(k, n, bits, gs, gen, dev):
    qw = torch.randint(-2 ** 31, 2 ** 31 - 1, (k * bits // 32, n), dtype=torch.int32,
                       device=dev, generator=gen)
    s = torch.rand((k // gs, n), device=dev, generator=gen) * 0.01 + 0.001
    m = torch.rand((k // gs, n), device=dev, generator=gen) * 0.05
    return qw, s, m


@pytest.mark.parametrize("m,k,n,bits,signed,gs", [
    (1, 512, 384, 4, True, 128), (8, 4096, 640, 4, True, 128),
    (70, 384, 200, 4, False, 128), (5, 256, 128, 2, False, 16),
    (100, 256, 128, 2, False, 16), (33, 256, 96, 8, True, 32),
    (3, 256, 130, 8, False, 64), (17, 512, 256, 4, True, 256),
])
def test_qmm_kernel_matches_plain(cuda, m, k, n, bits, signed, gs):
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + bits)
    qw, s, mn = _planes(k, n, bits, gs, gen, cuda)
    x = torch.randn((m, k), device=cuda, generator=gen).to(torch.bfloat16)
    got = qmm(x, qw, s, mn, bits=bits, signed=signed, group_size=gs)
    ref = qmm_reference(x.float(), qw, s, mn, bits=bits, signed=signed,
                        group_size=gs)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    assert err <= 1e-2 * ref.abs().max().item(), err


@pytest.mark.parametrize("d,bs,window,softcap,alibi,int8", [
    (128, 64, None, None, False, False), (128, 64, 96, None, False, False),
    (128, 16, None, 30.0, False, True), (64, 16, 40, None, True, False),
])
def test_paged_attention_kernel_matches_plain(cuda, d, bs, window, softcap,
                                              alibi, int8):
    gen = torch.Generator(device=cuda).manual_seed(d + bs)
    b, h_q, h_kv, nb = 4, 8, 2, 64
    seq_lens = torch.tensor([1, 37, 200, 150], dtype=torch.int32, device=cuda)
    mb = -(-200 // bs)
    perm = torch.randperm(nb, device=cuda, generator=gen)[: b * mb]
    tables = perm.reshape(b, mb).to(torch.int32)
    shape = (nb * bs + 1, h_kv, d)
    ks = vs = None
    if int8:
        kc = torch.randint(-127, 128, shape, device=cuda, generator=gen).to(torch.int8)
        vc = torch.randint(-127, 128, shape, device=cuda, generator=gen).to(torch.int8)
        ks = torch.full(shape[:2], 1 / 64, device=cuda)
        vs = torch.full(shape[:2], 1 / 64, device=cuda)
    else:
        kc = torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16)
        vc = torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16)
    q = torch.randn((b, h_q, d), device=cuda, generator=gen).to(torch.bfloat16)
    slopes = (torch.tensor([2 ** -(i + 1) for i in range(h_q)], device=cuda)
              / math.sqrt(d)) if alibi else None
    kw = dict(block_size=bs, k_scale=ks, v_scale=vs, sliding_window=window,
              logit_softcap=softcap, alibi=slopes)
    got = paged_attention_decode(q, kc, vc, tables, seq_lens, num_blocks=nb, **kw)
    ref = paged_attention_reference(q.float(), kc, vc, tables, seq_lens, **kw)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    assert err <= 1e-2 * max(1.0, ref.abs().max().item()), err
