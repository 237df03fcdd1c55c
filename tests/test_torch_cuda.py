"""Kernels B1-B6 of blazr_tpu_torch against their plain versions on the
card, and the w8a8 Executor on a tiny config. A CUDA kernel has no interpret
mode, so these tests need an NVIDIA GPU with nvcc and skip without one;
``python3 chip_smoke.py`` runs the same checks at the served shapes.

Tolerances are in bf16 where the output is bf16: the kernels and the plain
versions sum in f32, so they differ by the bf16 rounding of the outputs
(2^-9 relative) and, for B2, of the probabilities; 1e-2 of the largest
output covers both. With f32 outputs B3 and B4 differ only in the order of
their f32 sums: 1e-3. In f16 (2^-11 relative per rounding) 4e-3 of the
largest output. B5 and B6 keep the probabilities in f32: 2e-2 absolute in
bf16 and 1e-4 in f32 on outputs of order max|v|."""

import math

import pytest
import torch

from blazr_tpu_torch.attention.paged_attention import (
    paged_attention_decode, paged_attention_reference)
from blazr_tpu_torch.quant import qtensor
from blazr_tpu_torch.quant.int8 import qmm_int8, qmm_int8_reference
from blazr_tpu_torch.quant.kernels import (qmm, qmm_reference, qmm_stream,
                                           qmm_stream_reference)
from blazr_tpu_torch.quant.matmul import quant_matmul
from blazr_tpu_torch.tools.bench_pa_headmajor import pa_headmajor, to_head_major
from blazr_tpu_torch.tools.bench_pa_wide import pa_wide, pa_wide_reference

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


def _rel_tol(dtype):
    return 1e-2 if dtype == torch.bfloat16 else 1e-3


@pytest.mark.parametrize("m,k,n,bits,gs,dtype", [
    (1, 512, 256, 4, 128, torch.bfloat16), (17, 1024, 384, 8, 128, torch.float32),
    (300, 512, 256, 4, 64, torch.bfloat16), (5, 512, 128, 4, 16, torch.float32),
    (70, 256, 256, 8, 32, torch.bfloat16), (3, 2048, 128, 4, 256, torch.bfloat16),
    (64, 512, 128, 8, 16, torch.bfloat16),
])
def test_qmm_int8_kernel_matches_plain(cuda, m, k, n, bits, gs, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m * 3 + bits)
    qw, s, mn = _planes(k, n, bits, gs, gen, cuda)
    x = torch.randn((m, k), device=cuda, generator=gen).to(dtype)
    if m > 2:
        x[1] = 0                                    # an all-zero row
    got = qmm_int8(x, qw, s, mn, bits=bits, group_size=gs)
    ref = qmm_int8_reference(x.float(), qw, s, mn, bits=bits, group_size=gs)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    assert err <= _rel_tol(dtype) * ref.abs().max().item(), err


@pytest.mark.parametrize("m,k,n,bits,gs,dtype", [
    (1, 1024, 256, 4, 128, torch.bfloat16), (8, 512, 384, 8, 128, torch.bfloat16),
    (32, 2048, 128, 4, 256, torch.bfloat16), (3, 1024, 256, 4, 64, torch.float32),
])
def test_qmm_stream_kernel_matches_plain(cuda, m, k, n, bits, gs, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m * 5 + bits)
    qw, s, mn = _planes(k, n, bits, gs, gen, cuda)
    x = torch.randn((m, k), device=cuda, generator=gen).to(dtype)
    got = qmm_stream(x, qw, s, mn, bits=bits, group_size=gs)
    ref = qmm_stream_reference(x.float(), qw, s, mn, bits=bits, group_size=gs)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    assert err <= _rel_tol(dtype) * ref.abs().max().item(), err


def test_w4a8_prefill_launches_b3_from_256_rows(cuda):
    gen = torch.Generator(device=cuda).manual_seed(11)
    qw, s, mn = _planes(512, 256, 4, 128, gen, cuda)
    qt = qtensor.QuantTensor(qweight=qw, scales=s, mins=mn, perm=None, bits=4,
                             group_size=128, signed=True, in_features=512,
                             out_features=256, fmt="awq")
    tagged = qtensor.apply_quant_compute({"w": qt}, "w4a8-prefill")["w"]
    b1, b3 = qmm.launches, qmm_int8.launches
    quant_matmul(torch.randn((255, 512), device=cuda).to(torch.bfloat16), tagged)
    assert (qmm.launches - b1, qmm_int8.launches - b3) == (1, 0)
    quant_matmul(torch.randn((256, 512), device=cuda).to(torch.bfloat16), tagged)
    assert (qmm.launches - b1, qmm_int8.launches - b3) == (1, 1)


def test_executor_w8a8_runs_b3_only(cuda):
    """A 2-layer config the JAX tiles accept, under w8a8 on the card: every
    projection of every forward launches B3 and none launches B1."""
    from blazr_tpu_torch.config import AppConfig, GenerationConfig
    from blazr_tpu_torch.config.model_config import AttentionConfig, UniversalConfig
    from blazr_tpu_torch.engine.executor import Executor
    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.utils.synthetic import synth_llama_params

    cfg = UniversalConfig(model_type="llama", vocab_size=256, hidden_size=256,
                          num_layers=2, max_seq_len=512, intermediate_size=512,
                          attention=AttentionConfig(num_heads=4, num_kv_heads=2,
                                                    head_dim=64))
    params = synth_llama_params(cfg, quant="awq", dtype=torch.bfloat16, seed=0,
                                device=cuda)
    app = AppConfig(model=cfg)
    app.inference.quant_compute = "w8a8"

    class Tok:
        def is_eos(self, t):
            return False

        def decode(self, ids):
            return "x"

    ex = Executor(Model(cfg, params, torch.bfloat16), Tok(), app)
    b1, b3 = qmm.launches, qmm_int8.launches
    toks = [t.token_id for t in ex.generate(list(range(1, 40)),
                                            GenerationConfig(max_tokens=6,
                                                             temperature=0.0))]
    torch.cuda.synchronize()
    assert len(toks) == 6 and all(0 <= t < 256 for t in toks)
    assert qmm.launches == b1 and qmm_int8.launches - b3 == 6 * 4 * 2


@pytest.mark.parametrize("kernel", ["b1_decode", "b1_prefill", "b3", "b4"])
def test_f16_matmul_kernels_match_plain(cuda, kernel):
    gen = torch.Generator(device=cuda).manual_seed(len(kernel))
    k, n, gs = 1024, 256, 128
    qw, s, mn = _planes(k, n, 4, gs, gen, cuda)
    m = 40 if kernel == "b1_prefill" else 5
    x = torch.randn((m, k), device=cuda, generator=gen).to(torch.float16)
    if kernel.startswith("b1"):
        got = qmm(x, qw, s, mn, bits=4, signed=True, group_size=gs)
        ref = qmm_reference(x.cpu(), qw.cpu(), s.cpu(), mn.cpu(), bits=4, signed=True,
                            group_size=gs)
    elif kernel == "b3":
        got = qmm_int8(x, qw, s, mn, bits=4, group_size=gs)
        ref = qmm_int8_reference(x.cpu(), qw.cpu(), s.cpu(), mn.cpu(), bits=4,
                                 group_size=gs)
    else:
        got = qmm_stream(x, qw, s, mn, bits=4, group_size=gs)
        ref = qmm_stream_reference(x.cpu(), qw.cpu(), s.cpu(), mn.cpu(), bits=4,
                                   group_size=gs)
    torch.cuda.synchronize()
    assert got.dtype == torch.float16 and ref.dtype == torch.float16
    err = (got.float().cpu() - ref.float()).abs().max().item()
    assert err <= 4e-3 * ref.float().abs().max().item(), err


def test_f16_paged_attention_matches_plain(cuda):
    gen = torch.Generator(device=cuda).manual_seed(16)
    b, h_q, h_kv, d, bs, nb = 4, 8, 2, 128, 16, 64
    seq_lens = torch.tensor([1, 37, 200, 150], dtype=torch.int32, device=cuda)
    mb = -(-200 // bs)
    tables = torch.randperm(nb, device=cuda, generator=gen)[: b * mb].reshape(b, mb)
    tables = tables.to(torch.int32)
    kc = torch.randn((nb * bs + 1, h_kv, d), device=cuda, generator=gen).half()
    vc = torch.randn((nb * bs + 1, h_kv, d), device=cuda, generator=gen).half()
    q = torch.randn((b, h_q, d), device=cuda, generator=gen).half()
    got = paged_attention_decode(q, kc, vc, tables, seq_lens, block_size=bs,
                                 num_blocks=nb, sliding_window=96)
    ref = paged_attention_reference(q.float(), kc, vc, tables, seq_lens, block_size=bs,
                                    sliding_window=96)
    torch.cuda.synchronize()
    assert got.dtype == torch.float16
    assert (got.float() - ref).abs().max().item() <= 4e-3 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("layout", ["wide", "headmajor"])
@pytest.mark.parametrize("dtype,bs", [(torch.bfloat16, 64), (torch.bfloat16, 128),
                                      (torch.float32, 128), (torch.float16, 64)])
def test_layout_kernels_match_plain(cuda, layout, dtype, bs):
    """B5 and B6 at the tools' geometry (G=8, 4 query heads each, D=128),
    ragged lengths including 1 and a partial last block."""
    gen = torch.Generator(device=cuda).manual_seed(bs)
    seq_lens = torch.tensor([1, 1023, bs + 5, 300, 64], dtype=torch.int32, device=cuda)
    b, mb = 5, -(-1023 // bs)
    nb = b * mb + 3
    tables = torch.randperm(nb, device=cuda, generator=gen)[: b * mb].reshape(b, mb)
    tables = tables.to(torch.int32)
    kf = torch.randn((nb * bs + 1, 8, 128), device=cuda, generator=gen).to(dtype)
    vf = torch.randn((nb * bs + 1, 8, 128), device=cuda, generator=gen).to(dtype)
    q = torch.randn((b, 32, 128), device=cuda, generator=gen).to(dtype)
    if layout == "wide":
        got = pa_wide(q, kf, vf, tables, seq_lens, block_size=bs, num_blocks=nb)
    else:
        got = pa_headmajor(q, to_head_major(kf), to_head_major(vf), tables, seq_lens,
                           block_size=bs, num_blocks=nb)
    ref = pa_wide_reference(q.float(), kf.float(), vf.float(), tables, seq_lens,
                            block_size=bs)
    torch.cuda.synchronize()
    tol = {torch.bfloat16: 2e-2, torch.float16: 4e-3, torch.float32: 1e-4}[dtype]
    assert (got.float() - ref).abs().max().item() <= tol
