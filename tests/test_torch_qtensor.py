"""Port parity: canonical quant layout and quantized matmul (B1's plain
version) of blazr_tpu_torch against blazr_tpu on the CPU.

Integer data must be exactly equal (packed words, unpacked values); float
results state their tolerance beside the assertion."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blazr_tpu.formats import GgmlType, quantize_ggml
from blazr_tpu.quant import qtensor as jq
from blazr_tpu.quant.pallas.int_matmul import quant_matmul_pallas
from blazr_tpu.utils.synthetic import _rand_awq_qt
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.quant import qtensor as tq
from blazr_tpu_torch.quant.kernels import qmm, qmm_reference
from blazr_tpu_torch.quant.matmul import quant_matmul

from test_qtensor import _make_awq, _make_gptq

CPU = "cpu"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(qt_jax):
    return params_from_jax(_np_tree(qt_jax), device=CPU)


def _same_layout(port_qt, jax_qt):
    np.testing.assert_array_equal(port_qt.qweight.numpy().view(np.uint32),
                                  np.asarray(jax_qt.qweight))
    np.testing.assert_array_equal(port_qt.scales.numpy(), np.asarray(jax_qt.scales))
    np.testing.assert_array_equal(port_qt.mins.numpy(), np.asarray(jax_qt.mins))
    assert (port_qt.bits, port_qt.group_size, port_qt.signed, port_qt.fmt) == (
        jax_qt.bits, jax_qt.group_size, jax_qt.signed, jax_qt.fmt)
    if jax_qt.perm is None:
        assert port_qt.perm is None
    else:
        np.testing.assert_array_equal(port_qt.perm.numpy(), np.asarray(jax_qt.perm))


@pytest.mark.parametrize("bits,signed", [(2, False), (2, True), (4, False),
                                         (4, True), (8, True), (8, False)])
def test_pack_unpack_bit_equal(bits, signed):
    rng = np.random.default_rng(bits * 10 + signed)
    lo, hi = (-(1 << bits - 1), 1 << bits - 1) if signed else (0, 1 << bits)
    q = rng.integers(lo, hi, (64, 24)).astype(np.int32)
    words = tq._pack_k(q, bits)
    np.testing.assert_array_equal(words, jq._pack_k(q, bits))
    np.testing.assert_array_equal(tq.unpack_k(words, bits, signed),
                                  jq.unpack_k(words, bits, signed))
    # The torch unpack of the int32 view equals numpy's unpack of the u32 words.
    got = tq.unpack(tq.words_to_torch(words, torch.device(CPU)), bits, signed)
    np.testing.assert_array_equal(got.numpy(), q)


def test_awq_canonical_bit_equal():
    qweight, s, qzeros, ref = _make_awq(np.random.default_rng(0))
    jt = jq.from_awq(qweight, s, qzeros, 32)
    pt = tq.from_awq(qweight, s, qzeros, 32, device=CPU)
    _same_layout(pt, jt)
    # Same affine in f32, same order of operations: bit-equal.
    np.testing.assert_array_equal(tq.dequantize(pt).numpy(),
                                  np.asarray(jq.dequantize_jnp(jt)))
    np.testing.assert_allclose(tq.dequantize_np(pt), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("desc_act", [False, True])
def test_gptq_canonical_bit_equal(desc_act):
    qweight, s, qzeros, g_idx, ref = _make_gptq(np.random.default_rng(1),
                                                desc_act=desc_act)
    jt = jq.from_gptq(qweight, s, qzeros, g_idx, 32)
    pt = tq.from_gptq(qweight, s, qzeros, g_idx, 32, device=CPU)
    _same_layout(pt, jt)
    assert (pt.perm is not None) == desc_act
    np.testing.assert_array_equal(tq.dequantize(pt).numpy(),
                                  np.asarray(jq.dequantize_jnp(jt)))
    # x[perm] @ W_sorted == x @ W_logical; f32 sums of 64 terms: 1e-5.
    x = np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32)
    got = quant_matmul(torch.from_numpy(x), pt).numpy()
    np.testing.assert_allclose(got, x @ ref, rtol=1e-5, atol=1e-5)


def test_params_from_jax_keeps_words():
    jt = jq.from_awq(*_make_awq(np.random.default_rng(3))[:3], 32)
    _same_layout(_port(jt), jt)


def _ggml_qt(gt, rng, n=32, k=256):
    raw = quantize_ggml(rng.standard_normal((n, k)).astype(np.float32), gt)
    return jq.from_ggml(raw, gt, (n, k))


def _direct_qt(bits, signed, rng, k=256, n=40, gs=32):
    lo, hi = (-(1 << bits - 1), 1 << bits - 1) if signed else (0, 1 << bits)
    q = rng.integers(lo, hi, (k, n))
    s = (rng.random((k // gs, n)) * 0.01 + 0.001).astype(np.float32)
    m = (rng.random((k // gs, n)) * 0.05).astype(np.float32)
    return jq._finish(q, s, m, bits=bits, group_size=gs, signed=signed,
                      fmt="test")


_CASES = {
    "q2k_2bit_unsigned": lambda r: _ggml_qt(GgmlType.Q2_K, r),
    "q4k_4bit_biased": lambda r: _ggml_qt(GgmlType.Q4_K, r),
    "q8_0_8bit_signed": lambda r: _ggml_qt(GgmlType.Q8_0, r),
    "2bit_signed": lambda r: _direct_qt(2, True, r),
    "8bit_unsigned_ragged_n": lambda r: _direct_qt(8, False, r, n=40),
    "awq_4bit_gs128": lambda r: _rand_awq_qt(jax.random.key(7), 256, 136,
                                             group_size=128),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_quant_matmul_matches_jax_dequant(case):
    """f32 activations: the port's plain B1 (dequantize + f32 matmul) against
    the JAX dequantize_jnp + dot, 1e-5 (f32 sums of 256 products in
    another order)."""
    rng = np.random.default_rng(sorted(_CASES).index(case))
    jt = _CASES[case](rng)
    pt = _port(jt)
    x = rng.standard_normal((5, jt.in_features)).astype(np.float32)
    ref = np.asarray(jnp.dot(jnp.asarray(x), jq.dequantize_jnp(jt),
                             preferred_element_type=jnp.float32))
    got = quant_matmul(torch.from_numpy(x), pt).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits,signed", [(4, True), (8, True), (2, False)])
def test_qmm_plain_matches_pallas_interpret(bits, signed):
    """Against the Pallas kernel B1 itself (interpret mode): 2e-2, because
    the kernel casts x to bf16 in its body (int_matmul.py:94)."""
    rng = np.random.default_rng(40 + bits)
    jt = _direct_qt(bits, signed, rng, k=256, n=128, gs=128)
    pt = _port(jt)
    x = (rng.standard_normal((3, 256)) * 0.5).astype(np.float32)
    ref = np.asarray(quant_matmul_pallas(jnp.asarray(x), jt))
    got = qmm(torch.from_numpy(x), pt.qweight, pt.scales, pt.mins, bits=bits,
              signed=pt.signed, group_size=pt.group_size, device=CPU).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


def test_qmm_wrapper_checks_shapes():
    pt = _port(_direct_qt(4, True, np.random.default_rng(5), k=64, n=16))
    x = torch.zeros((2, 32))
    with pytest.raises(ValueError):
        qmm(x, pt.qweight, pt.scales, pt.mins, bits=4, signed=True,
            group_size=32, device=CPU)
    with pytest.raises(ValueError):
        qmm(torch.zeros((2, 64)), pt.qweight, pt.scales, pt.mins, bits=4,
            signed=True, group_size=16 * 3, device=CPU)


def test_qmm_reference_is_grouped_affine():
    """The plain version equals the per-group formula of the Pallas kernel,
    Σ_g s_g·(x_g@q_g) − (Σ_{k∈g} x)·m_g, in f32 (1e-5: sum order)."""
    rng = np.random.default_rng(6)
    pt = _port(_direct_qt(4, True, rng, k=128, n=24, gs=32))
    x = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    q = tq.unpack(pt.qweight, 4, True).float()
    xg = x.reshape(4, 4, 32)
    grouped = (torch.einsum("mgk,gkn->mgn", xg, q.reshape(4, 32, 24))
               * pt.scales[None]).sum(1) - xg.sum(-1) @ pt.mins
    got = qmm_reference(x, pt.qweight, pt.scales, pt.mins, bits=4, signed=True,
                        group_size=32)
    np.testing.assert_allclose(got.numpy(), grouped.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", [None, "auto", "w4a16"])
def test_apply_quant_compute_noop(mode):
    tree = {"w": 1}
    assert tq.apply_quant_compute(tree, mode) is tree


@pytest.mark.parametrize("mode", ["w4a8", "w8a8", "w4a8-prefill"])
def test_apply_quant_compute_int8_modes_name_b3(mode):
    """The int8-activation modes tag signed 4/8-bit weights for kernel B3
    (w8a8 also widens them to 8 bits); 2-bit and None leaves pass through."""
    qt = _port(_rand_awq_qt(jax.random.key(1), 256, 128, group_size=64))
    two = _port(_direct_qt(2, False, np.random.default_rng(0), k=256, n=128))
    out = tq.apply_quant_compute({"w": qt, "two": two, "b": None}, mode)
    assert out["w"].act_quant and out["two"] is two and out["b"] is None
    assert out["w"].bits == (8 if mode == "w8a8" else 4)
    assert out["w"].act_quant_min_m == (256 if mode == "w4a8-prefill" else 0)
    assert not qt.act_quant                    # the input tree is not changed


@pytest.mark.parametrize("bits,signed", [(4, True), (8, True), (2, False)])
def test_qmm_plain_f16_matches_pallas_interpret(bits, signed):
    """f16 activations, the compute dtype the AWQ/GPTQ loaders default to:
    the plain version rounds x to bf16, sums in f32 and writes f16, as the
    Pallas kernel B1 does (interpret mode). 2e-3 of max|y|: one f16 rounding
    of the output (2^-11 relative) with room for f32 sums in another
    order."""
    rng = np.random.default_rng(60 + bits)
    jt = _direct_qt(bits, signed, rng, k=256, n=128, gs=128)
    pt = _port(jt)
    x = (rng.standard_normal((4, 256)) * 0.5).astype(np.float16)
    ref = np.asarray(quant_matmul_pallas(jnp.asarray(x), jt))
    assert ref.dtype == np.float16
    got = qmm(torch.from_numpy(x), pt.qweight, pt.scales, pt.mins, bits=bits,
              signed=pt.signed, group_size=pt.group_size, device=CPU)
    assert got.dtype == torch.float16
    tol = 2e-3 * float(np.abs(ref.astype(np.float32)).max())
    np.testing.assert_allclose(got.float().numpy(), ref.astype(np.float32),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("bits,signed", [(2, False), (4, False), (4, True), (8, True)])
def test_torch_packing_equals_the_numpy_reference(bits, signed):
    """The loaders' ``_pack_words`` (torch integer ops) gives ``_pack_k``'s
    words bit for bit, negative (two's complement) rows included."""
    rng = np.random.default_rng(bits)
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed else (0, 1 << bits)
    q = rng.integers(lo, hi, (64, 24)).astype(np.int8 if signed else np.uint8)
    got = tq._pack_words(torch.from_numpy(q), bits).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, tq._pack_k(q, bits))
