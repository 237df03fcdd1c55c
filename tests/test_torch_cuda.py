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
bf16, 4e-3 in f16 and 1e-4 in f32 on outputs of order max|v|."""

import math

import pytest
import torch

from blazr_tpu_torch.attention.paged_attention import (
    paged_attention_decode, paged_attention_reference)
from blazr_tpu_torch.quant import qtensor
from blazr_tpu_torch.quant import int8 as b3
from blazr_tpu_torch.quant.int8 import (qmm_int8, qmm_int8_reference, quantize_activations,
                                        quantize_activations_reference)
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


_QMM_CASES = [
    (1, 512, 384, 4, True, 128, torch.bfloat16), (8, 4096, 640, 4, True, 128, torch.bfloat16),
    (70, 384, 200, 4, False, 128, torch.bfloat16), (5, 256, 128, 2, False, 16, torch.bfloat16),
    (100, 256, 128, 2, False, 16, torch.bfloat16), (33, 256, 96, 8, True, 32, torch.bfloat16),
    (3, 256, 130, 8, False, 64, torch.bfloat16), (17, 512, 256, 4, True, 256, torch.bfloat16),
]
# The tile edges of B1's two variants: rows around TC_MIN_ROWS, 64 and 128,
# N=200 against 128-column tiles.
_QMM_CASES += [(m, 1024, 200, 4, True, 128, torch.bfloat16)
               for m in (1, 8, 15, 16, 17, 63, 64, 65, 127, 128, 129, 512)]
_QMM_CASES += [
    (8, 128, 256, 4, True, 128, torch.bfloat16),      # K of a single group
    (64, 64, 136, 8, True, 64, torch.bfloat16),
    (16, 512, 256, 4, True, 16, torch.bfloat16),      # group sizes 16 ... 256
    (16, 512, 256, 4, False, 32, torch.bfloat16),
    (16, 512, 256, 4, True, 64, torch.bfloat16),
    (24, 1024, 256, 4, False, 256, torch.bfloat16),
    (20, 480, 256, 4, True, 48, torch.bfloat16),      # gs 48: the split-K variant
    (40, 512, 256, 2, True, 32, torch.bfloat16),      # 2- and 8-bit on tensor cores
    (40, 512, 256, 2, False, 16, torch.bfloat16),
    (40, 512, 128, 8, True, 128, torch.bfloat16),
    (40, 512, 130, 8, False, 64, torch.bfloat16),     # N % 4 != 0: 4-byte copies
    (3, 512, 130, 2, True, 32, torch.bfloat16),
    (6, 512, 256, 4, True, 128, torch.float16),       # f16 x, rounded to bf16
    (100, 512, 200, 4, False, 128, torch.float16),
    (1, 512, 70, 4, False, 64, torch.float32),        # f32 x: CUDA cores
    (129, 512, 200, 8, True, 128, torch.float32),
    (40, 512, 256, 4, True, 8, torch.bfloat16),       # gs 8: one group per chunk
    (40, 512, 128, 8, True, 4, torch.bfloat16),       # 8-bit gs 4: split-K variant
    (40, 512, 128, 8, False, 4, torch.float32),       # ... 16-row tile too large
]


@pytest.mark.parametrize("m,k,n,bits,signed,gs,dtype", _QMM_CASES)
def test_qmm_kernel_matches_plain(cuda, m, k, n, bits, signed, gs, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + bits)
    qw, s, mn = _planes(k, n, bits, gs, gen, cuda)
    x = torch.randn((m, k), device=cuda, generator=gen).to(dtype)
    got = qmm(x, qw, s, mn, bits=bits, signed=signed, group_size=gs)
    # f16 x: the plain version rounds it to bf16 as the kernel does.
    ref = qmm_reference(x if dtype == torch.float16 else x.float(), qw, s, mn,
                        bits=bits, signed=signed, group_size=gs).float()
    torch.cuda.synchronize()
    assert got.dtype == dtype
    err = (got.float() - ref).abs().max().item()
    assert err <= _rel_tol(dtype) * ref.abs().max().item(), err


_PA_RAGGED = (1, 37, 200, 150)
_PA_CASES = [
    (128, 64, None, None, False, False, _PA_RAGGED), (128, 64, 96, None, False, False, _PA_RAGGED),
    (128, 16, None, 30.0, False, True, _PA_RAGGED), (64, 16, 40, None, True, False, _PA_RAGGED),
    # B2's sequence splits (attention/paged_attention.py::split_plan and
    # split_spans): block 16, window 700 gives a grid of 5 splits; the
    # 1400-token row walks its 45 in-window slots in 5 runs of 9 from a slot
    # the window starts inside, the 100-token row takes one split (1-4
    # empty), 288 and 289 tokens two (18 and 19 slots).
    (128, 16, 700, None, False, False, (1400, 100, 288, 289)),
    (128, 64, None, None, False, True, (1, 600, 513, 1024)),   # int8 KV, 8 splits
    (64, 64, None, 30.0, True, False, (1, 600, 513, 1024)),    # softcap + ALiBi
    (128, 64, None, None, False, False, (4096,)),              # B=1: 32 splits
    (128, 64, 4096, None, False, False, (4096,)),
]


@pytest.mark.parametrize("d,bs,window,softcap,alibi,int8,lens", _PA_CASES)
def test_paged_attention_kernel_matches_plain(cuda, d, bs, window, softcap,
                                              alibi, int8, lens):
    gen = torch.Generator(device=cuda).manual_seed(d + bs + len(lens))
    b, h_q, h_kv = len(lens), 8, 2
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    mb = -(-max(lens) // bs)
    nb = b * mb + 8
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
    return {torch.bfloat16: 1e-2, torch.float16: 4e-3, torch.float32: 1e-3}[dtype]


_B3_CASES = [
    (1, 512, 256, 4, 128, torch.bfloat16), (17, 1024, 384, 8, 128, torch.float32),
    (300, 512, 256, 4, 64, torch.bfloat16), (5, 512, 128, 4, 16, torch.float32),
    (70, 256, 256, 8, 32, torch.bfloat16), (3, 2048, 128, 4, 256, torch.bfloat16),
    (64, 512, 128, 8, 16, torch.bfloat16),
]
# The row edges of B3's variants (decode tiles of 8/16/32 x rows, the wgmma
# variant's 64- and 128-row tiles past DEC_MAX_ROWS), its group sizes (32-256
# on both; 16 and 48 only on the decode variant, tiled over M), K with a short
# last stage (320, 192), f16 and f32 x, and split K (N=128: few tiles).
_B3_CASES += [(m, 1024, 256, bits, 128, torch.bfloat16)
              for m in (8, 9, 16, 31, 32, 33, 64, 65, 128, 129) for bits in (4, 8)]
_B3_CASES += [
    (40, 512, 256, 4, 32, torch.bfloat16), (40, 512, 256, 8, 64, torch.float16),
    (200, 1024, 128, 8, 256, torch.bfloat16), (100, 512, 256, 4, 512, torch.float32),
    (40, 384, 128, 4, 48, torch.bfloat16), (100, 512, 128, 8, 16, torch.float16),
    (7, 320, 256, 8, 64, torch.bfloat16), (70, 320, 256, 4, 64, torch.bfloat16),
    (150, 192, 128, 8, 64, torch.float32), (12, 4096, 128, 4, 128, torch.bfloat16),
    (512, 4096, 128, 8, 128, torch.bfloat16), (24, 1024, 128, 4, 32, torch.float16),
]


@pytest.mark.parametrize("m,k,n,bits,gs,dtype", _B3_CASES)
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
    # the n8 tiles of x rows (1, 2 or 4), groups 16-256, f16, split K
    (5, 1024, 256, 8, 32, torch.bfloat16), (9, 1024, 256, 4, 16, torch.bfloat16),
    (16, 1024, 256, 8, 64, torch.float16), (17, 512, 128, 4, 128, torch.bfloat16),
    (31, 4096, 128, 8, 128, torch.float32), (2, 4096, 640, 4, 32, torch.float16),
    # groups of 8 and 4 rows, which end inside a k16 step
    (8, 512, 256, 8, 8, torch.bfloat16), (20, 1024, 256, 4, 8, torch.float16),
    (3, 512, 128, 8, 4, torch.float32), (32, 256, 128, 8, 4, torch.bfloat16),
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


# (lens, table width in slots or None for the longest sequence's, ids
# outside [0, NB) after each sequence's end and one inside a sequence)
_LAYOUT_CASES = {
    "ragged": ([1, 1023, 69, 300, 64], None, False),
    "b1_ctx4096": ([4096], None, False),          # one sequence over many splits
    "b32": ([1, 700, 1023, 64] * 8, None, False),
    "b32_ctx4096": ([4096, 1, 4000, 2049] * 8, None, False),
    # a table 4096 keys wide over short sequences: most splits hold no key;
    # seq_len 0 gives exact zeros (the TPU kernel's result)
    "wide_table_bad_ids": ([0, 5, 300, 0, 64, 129, 1, 200], 4096, True),
}


@pytest.mark.parametrize("layout", ["wide", "headmajor"])
@pytest.mark.parametrize("dtype,bs", [(torch.bfloat16, 64), (torch.bfloat16, 128),
                                      (torch.float32, 128), (torch.float16, 64),
                                      (torch.float16, 16)])
@pytest.mark.parametrize("case", sorted(_LAYOUT_CASES))
def test_layout_kernels_match_plain(cuda, layout, dtype, bs, case):
    """B5 and B6 at the tools' geometry (G=8, 4 query heads each, D=128):
    ragged lengths including 1 and a partial last block, B=1 and B=32 up to
    4096 tokens, and a wide table with ids outside [0, NB) (they read block
    0) and seq_len 0 (exact zeros; the plain version gives the uniform mean
    there, so those rows are compared with 0)."""
    from blazr_tpu_torch.kvcache.paged import PAD_BLOCK

    lens, width, bad_ids = _LAYOUT_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(bs)
    b = len(lens)
    used = [-(-n // bs) for n in lens]
    mb = width // bs if width else max(used)
    nb = b * max(used) + 3
    tables = torch.randint(0, nb, (b, mb), device=cuda, generator=gen, dtype=torch.int32)
    if bad_ids:
        bad = torch.tensor([-1, PAD_BLOCK, nb + 7], dtype=torch.int32, device=cuda)
        for i, u in enumerate(used):
            tables[i, u:] = bad.repeat(mb)[: mb - u]
        tables[2, 0] = nb + 2
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kf = torch.randn((nb * bs + 1, 8, 128), device=cuda, generator=gen).to(dtype)
    vf = torch.randn((nb * bs + 1, 8, 128), device=cuda, generator=gen).to(dtype)
    q = torch.randn((b, 32, 128), device=cuda, generator=gen).to(dtype)
    if layout == "wide":
        got = pa_wide(q, kf, vf, tables, seq_lens, block_size=bs, num_blocks=nb)
    else:
        got = pa_headmajor(q, to_head_major(kf), to_head_major(vf), tables, seq_lens,
                           block_size=bs, num_blocks=nb)
    read = torch.where((tables < 0) | (tables >= nb), torch.zeros_like(tables), tables)
    ref = pa_wide_reference(q.float(), kf.float(), vf.float(), read, seq_lens,
                            block_size=bs)
    ref[seq_lens == 0] = 0.0
    torch.cuda.synchronize()
    tol = {torch.bfloat16: 2e-2, torch.float16: 4e-3, torch.float32: 1e-4}[dtype]
    assert got.dtype == dtype and torch.equal(got[seq_lens == 0].float(),
                                              ref[seq_lens == 0])
    assert (got.float() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("m,k,gs,dtype", [
    (1, 4096, 128, torch.bfloat16), (5, 14336, 32, torch.float16), (17, 512, 16, torch.float32),
    (300, 1024, 64, torch.bfloat16), (3, 4096, 256, torch.float32), (8, 320, 64, torch.float16),
])
def test_quantize_activations_kernel_equals_cpu(cuda, m, k, gs, dtype):
    """B3's quant kernel gives the CPU's integers exactly: xq, xs and the
    group sums, with an all-zero row and ties at .5 (a row whose absmax is
    127, so xs = 1 and x / xs = x)."""
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    x = (torch.randn((m, k), device=cuda, generator=gen) * 3).to(dtype)
    if m > 2:
        x[1] = 0
        ties = torch.arange(k, device=cuda) % 9 - 4.5
        ties[0] = 127.0
        x[2] = ties.to(dtype)
    got = quantize_activations(x, group_size=gs)
    want = quantize_activations_reference(x.cpu(), gs)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def test_qmm_int8_launches_at_most_three_kernels(cuda):
    """A B3 call on the card is the quant, one product and, with K split,
    the split reduction: three device kernels at most."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(3)
    qw, s, mn = _planes(4096, 4096, 8, 128, gen, cuda)
    for m in (1, 512):
        x = torch.randn((m, 4096), device=cuda, generator=gen).to(torch.bfloat16)
        qmm_int8(x, qw, s, mn, bits=8, group_size=128)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                qmm_int8(x, qw, s, mn, bits=8, group_size=128)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        splits = b3.b3_plan(m, 4096, 4096, 128, 8)[2]
        assert len(kernels) == 4 * (2 + (splits > 1)), [e.name for e in kernels]


# ---------------------------------------------------------------------------
# B2's split plan from the device, and the decode graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [64, 512])
@pytest.mark.parametrize("window", [None, 1000, 4096])
def test_paged_attention_full_width_tables(cuda, width, window):
    """Tables max_blocks_per_seq wide (the decode graphs'), PAD past each
    sequence, over 1 to 4095 tokens: B2 equals B2 on tables trimmed to the
    longest sequence and the plain version."""
    from blazr_tpu_torch.kvcache.paged import PAD_BLOCK

    gen = torch.Generator(device=cuda).manual_seed(width + (window or 0))
    lens = (1, 63, 64, 65, 577, 1024, 2049, 4095)
    b, h_q, h_kv, d, bs = len(lens), 8, 2, 128, 64
    need = [-(-n // bs) for n in lens]
    nb = sum(need) + 8
    perm = torch.randperm(nb, device=cuda, generator=gen).to(torch.int32)
    tables = torch.full((b, width), PAD_BLOCK, dtype=torch.int32, device=cuda)
    used = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[used:used + n]
        used += n
    kc = torch.randn((nb * bs + 1, h_kv, d), device=cuda, generator=gen).to(torch.bfloat16)
    vc = torch.randn((nb * bs + 1, h_kv, d), device=cuda, generator=gen).to(torch.bfloat16)
    q = torch.randn((b, h_q, d), device=cuda, generator=gen).to(torch.bfloat16)
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(block_size=bs, sliding_window=window)
    full = paged_attention_decode(q, kc, vc, tables, sl, num_blocks=nb, **kw)
    trim = paged_attention_decode(q, kc, vc, tables[:, :max(need)].contiguous(), sl,
                                  num_blocks=nb, **kw)
    ref = paged_attention_reference(q.float(), kc, vc, tables, sl, **kw)
    torch.cuda.synchronize()
    tol = 1e-2 * max(1.0, ref.abs().max().item())
    assert (full.float() - ref).abs().max().item() <= tol
    assert (full.float() - trim.float()).abs().max().item() <= tol


def _tiny_model(cuda):
    from blazr_tpu_torch.config.model_config import AttentionConfig, UniversalConfig
    from blazr_tpu_torch.models.registry import Model
    from blazr_tpu_torch.utils.synthetic import synth_llama_params

    cfg = UniversalConfig(model_type="mistral", vocab_size=256, hidden_size=256,
                          num_layers=2, max_seq_len=512, intermediate_size=512,
                          attention=AttentionConfig(num_heads=4, num_kv_heads=2,
                                                    head_dim=64, sliding_window=128))
    params = synth_llama_params(cfg, quant="awq", dtype=torch.bfloat16, seed=0,
                                device=cuda)
    return Model(cfg, params, torch.bfloat16)


class _Tok:
    eos_token_id = -1

    def is_eos(self, t):
        return False

    def decode(self, ids):
        return "x"


def _reset_counts():
    from blazr_tpu_torch.engine.decode_graph import counted

    for w in counted():
        w.launches = 0
    return lambda: [w.launches for w in counted()]


def test_batch_engine_graphs_equal_eager(cuda):
    """One wave of 5 requests (greedy, a seeded sampled row, a penalty row,
    logprobs) through the BatchEngine at depth 2 and horizon 4: with decode
    graphs the streams and every kernel's launch count equal the eager
    run's, and graphs were captured."""
    import asyncio

    from blazr_tpu_torch.config import AppConfig, GenerationConfig
    from blazr_tpu_torch.engine.batch_engine import BatchEngine

    model = _tiny_model(cuda)
    cfgs = [GenerationConfig(max_tokens=12, temperature=0.0),
            GenerationConfig(max_tokens=7, temperature=0.8, seed=5, top_p=0.9),
            GenerationConfig(max_tokens=10, temperature=0.0, repeat_penalty=1.3),
            GenerationConfig(max_tokens=9, temperature=0.0, logprobs=True, top_logprobs=3),
            GenerationConfig(max_tokens=4, temperature=0.0)]
    prompts = [list(range(1, 1 + n)) for n in (5, 40, 130, 9, 64)]

    async def serve(eng):
        task = asyncio.create_task(eng.run())
        handles = [eng.submit(p, c) for p, c in zip(prompts, cfgs)]

        async def collect(h):
            return [(t.token_id, t.logprob) async for t in h.tokens()]
        out = await asyncio.gather(*[asyncio.wait_for(collect(h), 300) for h in handles])
        eng.stop()
        await task
        return out

    runs = {}
    for graphs in (True, False):
        app = AppConfig(model=model.cfg)
        app.inference.decode_horizon = 4
        app.inference.graphs = graphs
        eng = BatchEngine(model, _Tok(), app)
        read = _reset_counts()
        out = asyncio.run(serve(eng))
        torch.cuda.synchronize()
        runs[graphs] = (out, read(), eng.graphs.captured)
    assert runs[True][0] == runs[False][0]
    assert [len(s) for s in runs[True][0]] == [c.max_tokens for c in cfgs]
    assert runs[True][1] == runs[False][1]
    assert runs[True][2] > 0 and runs[False][2] == 0


def test_executor_graphs_equal_eager(cuda):
    """The Executor's graphed step gives the eager step's tokens and
    logprobs (greedy with top-20 logprobs, and a seeded sampled request),
    with equal launch counts."""
    from blazr_tpu_torch.config import AppConfig, GenerationConfig
    from blazr_tpu_torch.engine.executor import Executor

    model = _tiny_model(cuda)
    reqs = [([3, 1, 4, 1, 5, 9, 2, 6], GenerationConfig(max_tokens=10, temperature=0.0,
                                                         logprobs=True, top_logprobs=5)),
            (list(range(7, 40)), GenerationConfig(max_tokens=10, temperature=0.9, seed=3))]
    runs = {}
    for graphs in (True, False):
        app = AppConfig(model=model.cfg)
        app.inference.graphs = graphs
        ex = Executor(model, _Tok(), app)
        read = _reset_counts()
        out = [[(t.token_id, t.logprob, [x.token_id for x in t.top_logprobs or []])
                for t in ex.generate(p, c)] for p, c in reqs]
        torch.cuda.synchronize()
        runs[graphs] = (out, read(), ex.graphs.captured)
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] == runs[False][1]
    assert runs[True][2] == 2 and runs[False][2] == 0


def test_replays_count_their_launches(cuda):
    """A captured step's first call runs eagerly, later calls replay it; the
    launch count is the kernels' real launches and the output the eager
    one's."""
    from blazr_tpu_torch.engine.decode_graph import StepGraphs

    gen = torch.Generator(device=cuda).manual_seed(4)
    qw, s, mn = _planes(512, 256, 4, 128, gen, cuda)
    x = torch.randn((8, 512), device=cuda, generator=gen).to(torch.bfloat16)
    y = torch.zeros((8, 256), dtype=torch.bfloat16, device=cuda)
    graphs = StepGraphs(cuda, True)

    def step():
        y.copy_(qmm(x, qw, s, mn, bits=4, signed=True, group_size=128))

    before = qmm.launches
    for _ in range(4):
        graphs.run("k", step)
    torch.cuda.synchronize()
    assert qmm.launches - before == 4 and graphs.captured == 1
    ref = qmm(x, qw, s, mn, bits=4, signed=True, group_size=128)
    assert torch.equal(y, ref)


def test_graph_capture_error_is_raised_not_run_eagerly(cuda):
    """With graphs on, a step the card cannot capture (here a host read of a
    device value inside the sampler) raises from generate(); the Executor
    does not fall back to running it eagerly. In a subprocess: a failed
    capture may leave the process's CUDA state unusable."""
    import os
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import torch
        import test_torch_cuda as t
        from blazr_tpu_torch.config import AppConfig, GenerationConfig
        from blazr_tpu_torch.engine import decode_graph
        from blazr_tpu_torch.engine.executor import Executor

        real = decode_graph.sample_tokens

        def syncing(logits, *a, **k):
            float(logits.sum().item())        # a host read: not capturable
            return real(logits, *a, **k)

        decode_graph.sample_tokens = syncing
        model = t._tiny_model(torch.device("cuda"))
        ex = Executor(model, t._Tok(), AppConfig(model=model.cfg))
        try:
            list(ex.generate([1, 2, 3], GenerationConfig(max_tokens=4, temperature=0.0)))
        except RuntimeError as e:
            print("RAISED", type(e).__name__)
        else:
            print("NO ERROR")
    """)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(here), here]))
    out = subprocess.run([sys.executable, "-c", code], cwd=here, env=env, text=True,
                         capture_output=True, timeout=600)
    assert "RAISED" in out.stdout, (out.stdout, out.stderr[-2000:])


# ---------------------------------------------------------------------------
# The dense families' shapes (chip_smoke.py phase 10)
# ---------------------------------------------------------------------------

_FAMILY_PA_CASES = [  # d, H_q, H_kv, window, softcap, score scale
    (96, 32, 32, 2047, None, None),                  # phi3: one query head a kv head
    (96, 32, 32, None, None, None),
    (256, 16, 16, None, None, None),                 # gemma
    (256, 16, 8, 4096, 50.0, 256 ** -0.5),           # gemma2, a sliding (even) layer
    (256, 16, 8, None, 50.0, 256 ** -0.5),           # ... and a global (odd) one
    (64, 71, 1, None, None, None),                   # falcon: 71 on one kv head
    (128, 28, 4, None, None, None),                  # qwen2: 7 a kv head
    (128, 32, 16, None, 50.0, 144 ** -0.5),          # a query_pre_attn_scalar scale
]


@pytest.mark.parametrize("d,h_q,h_kv,window,softcap,scale", _FAMILY_PA_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_family_shapes(cuda, d, h_q, h_kv, window, softcap, scale, dtype):
    """B2 at head_dim 96 and 256, 1, 2, 7 and 71 query heads a kv head,
    softcap 50, the score scale, and a window past which the odd layer of
    the same cache still attends, against its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(d + h_q)
    lens = (1, 63, 700, 4097, 5000, 64)
    b, bs = len(lens), 64
    mb = -(-max(lens) // bs)
    nb = b * mb + 4
    tables = torch.randperm(nb, device=cuda, generator=gen)[: b * mb].reshape(b, mb)
    kc = torch.randn((nb * bs + 1, h_kv, d), device=cuda, generator=gen).to(dtype)
    vc = torch.randn((nb * bs + 1, h_kv, d), device=cuda, generator=gen).to(dtype)
    q = torch.randn((b, h_q, d), device=cuda, generator=gen).to(dtype)
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    kw = dict(block_size=bs, sliding_window=window, logit_softcap=softcap, scale=scale)
    got = paged_attention_decode(q, kc, vc, tables.to(torch.int32), sl, num_blocks=nb, **kw)
    ref = paged_attention_reference(q.float(), kc, vc, tables.to(torch.int32), sl, **kw)
    torch.cuda.synchronize()
    tol = (1e-2 if dtype == torch.bfloat16 else 1e-4) * max(1.0, ref.abs().max().item())
    assert (got.float() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("k", [3072, 3584, 4608])
@pytest.mark.parametrize("n", [9216, 18432, 37888])
@pytest.mark.parametrize("m", [1, 8, 64, 300])
def test_qmm_family_shapes(cuda, m, k, n):
    """B1 at the dense families' K and N (both variants: m below and from
    TC_MIN_ROWS), groups of 128, bf16 x."""
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    qw, s, mn = _planes(k, n, 4, 128, gen, cuda)
    x = torch.randn((m, k), device=cuda, generator=gen).to(torch.bfloat16)
    got = qmm(x, qw, s, mn, bits=4, signed=True, group_size=128)
    ref = qmm_reference(x.float(), qw, s, mn, bits=4, signed=True, group_size=128).float()
    torch.cuda.synchronize()
    assert (got.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


@pytest.mark.parametrize("family", ["qwen2", "qwen3", "phi3", "gemma", "gemma2",
                                    "starcoder2", "falcon"])
def test_family_forward_on_card_matches_cpu(cuda, tmp_path, family):
    """Each family at its published width, 2 layers, from its HF-layout
    checkpoint (AWQ; Falcon plain bf16) through load_model: a 64-token
    prefill and 2 decode steps of forward_paged on the card (bf16, B1 and
    B2) within 5e-2 of the largest logit of the CPU f32 forward."""
    import dataclasses

    from blazr_tpu_torch.kvcache.paged import (compute_slot_mapping, init_paged_cache,
                                               pad_block_table)
    from blazr_tpu_torch.loader import load_model
    from blazr_tpu_torch.models.llama_paged import forward_paged
    from blazr_tpu_torch.quant.qtensor import QuantTensor
    from blazr_tpu_torch.utils.synthetic import FAMILY_CONFIGS, write_hf_checkpoint

    cfg = FAMILY_CONFIGS[family]()
    cfg.num_layers = 2
    write_hf_checkpoint(tmp_path, cfg, quant="plain" if family == "falcon" else "awq",
                        dtype="bfloat16")
    model, _ = load_model(tmp_path, dtype="bf16", device=cuda)

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cpu(v) for v in tree]
        if isinstance(tree, QuantTensor):
            return dataclasses.replace(tree, qweight=tree.qweight.cpu(),
                                       scales=tree.scales.cpu(), mins=tree.mins.cpu())
        return tree.float().cpu() if isinstance(tree, torch.Tensor) else tree

    cpu_params = cpu(model.params)
    att = model.cfg.attention
    bs, n = 64, 64
    toks = torch.randint(0, cfg.vocab_size, (1, n + 2),
                         generator=torch.Generator().manual_seed(0))
    table = torch.tensor(pad_block_table([0, 1], 2)[None], dtype=torch.int32)
    results = {}
    for name, d, params, dt in (("card", cuda, model.params, torch.bfloat16),
                                ("cpu", torch.device("cpu"), cpu_params, torch.float32)):
        cache = init_paged_cache(2, 2, bs, att.kv_heads(), att.resolved_head_dim(
            cfg.hidden_size), dtype=dt, device=d)
        out = []
        for lo, hi in ((0, n), (n, n + 1), (n + 1, n + 2)):
            slots = torch.tensor(compute_slot_mapping([0, 1], lo, hi - lo, bs,
                                                      cache.trash_slot))[None]
            logits, cache = forward_paged(
                params, model.cfg, toks[:, lo:hi].to(d), cache,
                torch.arange(lo, hi)[None].to(d), slots.to(d), table.to(d),
                torch.tensor([hi], dtype=torch.int32, device=d),
                last_idx=torch.tensor([hi - lo - 1], device=d), device=d)
            out.append(logits.float().cpu())
        results[name] = out
    for g, c in zip(results["card"], results["cpu"]):
        assert torch.isfinite(g).all()
        assert (g - c).abs().max().item() <= 5e-2 * c.abs().max().item()


def test_tied_head_takes_no_f32_table(cuda):
    """The tied-embedding head on the card: bf16 products summed in f32, as
    the CPU's f32 product of the same bf16 values, without an f32 copy of
    the [V, H] table (Gemma's 256k vocab: 3.7 GB)."""
    from blazr_tpu_torch.config.model_config import UniversalConfig
    from blazr_tpu_torch.models.llama import forward_head

    gen = torch.Generator(device=cuda).manual_seed(0)
    v, h = 64000, 1024
    params = {"embed": (torch.randn((v, h), device=cuda, generator=gen) * 0.02).bfloat16(),
              "final_norm": torch.ones(h, device=cuda, dtype=torch.bfloat16),
              "lm_head": None}
    cfg = UniversalConfig(model_type="gemma", vocab_size=v, hidden_size=h,
                          tie_word_embeddings=True, final_logit_softcapping=30.0)
    x = torch.randn((4, 1, h), device=cuda, generator=gen).bfloat16()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = forward_head(params, cfg, x)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < v * h * 2
    # The same bf16 values on the CPU: its plain f32 product of them.
    cpu = {k: None if t is None else t.cpu() for k, t in params.items()}
    ref = forward_head(cpu, cfg, x.cpu())
    assert got.dtype == torch.float32 and got.shape == (4, 1, v)
    assert (got.cpu() - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


# ---------------------------------------------------------------------------
# B1 at the GGUF layouts of Mistral-7B-Instruct-v0.2 Q4_K_M, full width:
# Q4_K (signed 4-bit after the sign bias, groups of 32) gate/up, Q6_K
# (signed 8-bit, groups of 16) ffn_down at K 14336 (896 groups a column)
# and the Q6_K output head (N 32000). Weights from the ggml encoder and
# from_ggml, so the planes are real ggml planes.
# ---------------------------------------------------------------------------

_GGUF_B1 = {("Q4_K", 4096, 14336), ("Q6_K", 14336, 4096), ("Q6_K", 4096, 32000)}


@pytest.fixture(scope="module")
def gguf_weights():
    cache = {}

    def get(gt, k, n):
        if (gt, k, n) not in cache:
            import numpy as np

            from blazr_tpu_torch.formats.ggml_quants import quantize_ggml
            from blazr_tpu_torch.formats.gguf import GgmlType

            w = np.random.default_rng(k + n).standard_normal((n, k), dtype=np.float32)
            raw = quantize_ggml(w * 0.02, GgmlType[gt])
            cache[(gt, k, n)] = qtensor.from_ggml(raw, GgmlType[gt], (n, k), device="cuda")
        return cache[(gt, k, n)]
    return get


@pytest.mark.parametrize("gt,k,n", sorted(_GGUF_B1))
@pytest.mark.parametrize("m", [1, 8, 512])
def test_qmm_gguf_full_width_layouts(cuda, gguf_weights, gt, k, n, m):
    qt = gguf_weights(gt, k, n)
    assert (qt.bits, qt.group_size, qt.signed) == ((4, 32, True) if gt == "Q4_K"
                                                   else (8, 16, True))
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn((m, k), device=cuda, generator=gen).to(torch.bfloat16)
    got = qmm(x, qt.qweight, qt.scales, qt.mins, bits=qt.bits, signed=qt.signed,
              group_size=qt.group_size)
    ref = qmm_reference(x.float(), qt.qweight, qt.scales, qt.mins, bits=qt.bits,
                        signed=qt.signed, group_size=qt.group_size)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    assert err <= _rel_tol(torch.bfloat16) * ref.abs().max().item(), err


# ---------------------------------------------------------------------------
# The MoE FFN on the card (ROADMAP §C check 4): a small stacked AWQ-INT4
# expert tensor (groups of 32), f32 activations, against the CPU f32 plain
# path on the same params: the decode form (every expert over every row)
# inside a captured CUDA graph, and the routed prefill form eagerly. B1's
# split-K variant runs f32 x, so the two differ only in the order of f32
# sums: 1e-4 of the largest output.
# ---------------------------------------------------------------------------

def _moe_case(dev):
    from blazr_tpu_torch.config.model_config import MoeConfig
    from blazr_tpu_torch.utils.synthetic import _rand_awq_qt

    h, inter, e = 256, 128, 4
    gen = torch.Generator(device="cpu").manual_seed(8)
    p = {"router": torch.randn((h, e), generator=gen) * 0.1, "correction_bias": None,
         "experts_gate": qtensor.stack_quant([_rand_awq_qt(gen, h, inter, 32, torch.device("cpu"))
                                              for _ in range(e)]),
         "experts_up": qtensor.stack_quant([_rand_awq_qt(gen, h, inter, 32, torch.device("cpu"))
                                            for _ in range(e)]),
         "experts_down": qtensor.stack_quant([_rand_awq_qt(gen, inter, h, 32,
                                                           torch.device("cpu"))
                                              for _ in range(e)])}
    moe = MoeConfig(num_experts=e, experts_per_tok=2, norm_topk_prob=True)

    def to(dev_):
        import dataclasses

        return {k: (None if v is None else v.to(dev_) if isinstance(v, torch.Tensor)
                    else dataclasses.replace(v, qweight=v.qweight.to(dev_),
                                             scales=v.scales.to(dev_), mins=v.mins.to(dev_)))
                for k, v in p.items()}
    return to(dev), to("cpu"), moe, h


def _rel_err(got, ref):
    return (got.float().cpu() - ref).abs().max().item() / ref.abs().max().item()


def test_moe_ffn_decode_form_in_a_cuda_graph(cuda):
    from blazr_tpu_torch.models.moe import moe_ffn
    from blazr_tpu_torch.quant import kernels

    p_dev, p_cpu, moe, h = _moe_case(cuda)
    x = torch.randn((8, 1, h), generator=torch.Generator().manual_seed(2))
    ref = moe_ffn(x, p_cpu, moe)
    static_x = x.to(cuda)
    moe_ffn(static_x, p_dev, moe)                 # build the kernels outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = moe_ffn(static_x, p_dev, moe)
    before = kernels.qmm.launches
    for _ in range(2):
        static_x.copy_(x.to(cuda))
        graph.replay()
    torch.cuda.synchronize()
    assert _rel_err(static_out, ref) < 1e-4
    x2 = torch.randn((8, 1, h), generator=torch.Generator().manual_seed(3))
    static_x.copy_(x2.to(cuda))
    graph.replay()
    torch.cuda.synchronize()
    assert _rel_err(static_out, moe_ffn(x2, p_cpu, moe)) < 1e-4
    assert kernels.qmm.launches == before          # replays run no Python


def test_moe_ffn_routed_prefill_form(cuda):
    from blazr_tpu_torch.models.moe import moe_ffn

    p_dev, p_cpu, moe, h = _moe_case(cuda)
    x = torch.randn((2, 24, h), generator=torch.Generator().manual_seed(4))
    got = moe_ffn(x.to(cuda), p_dev, moe)
    torch.cuda.synchronize()
    assert got.shape == x.shape
    assert _rel_err(got, moe_ffn(x, p_cpu, moe)) < 1e-4


def _to(tree, dev):
    """A param tree on ``dev`` (QuantTensors plane by plane)."""
    import dataclasses as dc

    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    if isinstance(tree, qtensor.QuantTensor):
        return dc.replace(tree, qweight=tree.qweight.to(dev), scales=tree.scales.to(dev),
                          mins=tree.mins.to(dev))
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("family", ["deepseek", "mamba2", "bamba"])
def test_recurrent_decode_step_in_a_cuda_graph(cuda, family):
    """The engine's decode step of DeepSeek (latent pages), Mamba2 (state
    rows) and the hybrid (both, B2 on the attention layer) captured in a
    CUDA graph on the card (AWQ-INT4 weights through B1, f32 activations)
    against the CPU f32 path: two sequences prefilled alone, then a warm
    decode step, then the graph replayed twice with new tokens, the caches
    written in place each time: every step's logits within 1e-4 of the
    largest, the replays launching no Python."""
    import dataclasses

    import numpy as np

    from blazr_tpu_torch.kvcache.paged import compute_slot_mapping, pad_block_table
    from blazr_tpu_torch.models.registry import init_engine_cache, make_paged_forward
    from blazr_tpu_torch.quant import kernels
    from blazr_tpu_torch.utils.synthetic import synth_recurrent_params, tiny_recurrent_config

    cpu = torch.device("cpu")
    cfg = tiny_recurrent_config(family)
    if cfg.hybrid_layers:                                   # B2 takes head_dim 32 and up
        cfg.attention = dataclasses.replace(cfg.attention, head_dim=32)
    params = {cpu: synth_recurrent_params(cfg, quant="awq", dtype=torch.float32,
                                          group_size=32, seed=1, device=cpu)}
    params[cuda] = _to(params[cpu], cuda)
    fwd = make_paged_forward(cfg)
    caches = {d: init_engine_cache(cfg, 8, 8, 2, dtype=torch.float32, device=d)[0]
              for d in (cpu, cuda)}
    trash = 64
    rng = np.random.default_rng(3)
    lens, blocks, rows = [7, 12], [[3, 0, 5], [1, 6, 2]], [1, 0]
    bt = np.stack([pad_block_table(b, 3) for b in blocks])
    for n, b, r in zip(lens, blocks, rows):                 # prefills, one sequence each
        tok = rng.integers(0, cfg.vocab_size, (1, n))
        for d in (cpu, cuda):
            fwd(params[d], cfg, torch.from_numpy(tok).to(d), caches[d],
                torch.arange(n, device=d)[None],
                torch.from_numpy(compute_slot_mapping(b, 0, n, 8, trash)
                                 .astype(np.int64))[None].to(d),
                torch.from_numpy(pad_block_table(b, 3))[None].to(d),
                torch.tensor([n], dtype=torch.int32, device=d), torch.tensor([r], device=d),
                last_idx=torch.tensor([n - 1], device=d))

    def inputs(j):
        pos = np.array([[n + j] for n in lens])
        return [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1))), torch.from_numpy(pos),
                torch.from_numpy(np.stack([compute_slot_mapping(b, int(p[0]), 1, 8, trash)
                                           for b, p in zip(blocks, pos)]).astype(np.int64)),
                torch.from_numpy(bt), torch.from_numpy((pos[:, 0] + 1).astype(np.int32)),
                torch.tensor(rows)]

    def step_cpu(args):
        return fwd(params[cpu], cfg, args[0], caches[cpu], *args[1:5], args[5])[0]

    static = [a.to(cuda) for a in inputs(0)]

    def step_card():
        return fwd(params[cuda], cfg, static[0], caches[cuda], *static[1:5], static[5])[0]

    ref = step_cpu([a.cpu() for a in static])
    assert _rel_err(step_card(), ref) < 1e-4                # the warm step, eager
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step_card()
    before = kernels.qmm.launches
    for j in (1, 2):
        args = inputs(j)
        for s, a in zip(static, args):
            s.copy_(a.to(cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert _rel_err(out, step_cpu(args)) < 1e-4, f"replay {j}"
    assert kernels.qmm.launches == before                   # replays run no Python
