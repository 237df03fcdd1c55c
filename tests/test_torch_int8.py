"""Port parity: the int8-activation tier (kernel B3's plain version), the
streaming decode matmul (kernel B4's plain version) and their routing in
blazr_tpu_torch against blazr_tpu on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do.
Tolerances: float results within 1e-4 × max(1, max|y|) in f32. Both sides sum
exact integer (B3) or exact bf16 × int (B4) products in f32 in another order;
the quantized activations must be equal as integers. The weight geometry is
one that the JAX tiles accept (``_choose_tiles``), so both packages really
take the kernels under test."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blazr_tpu.quant import qtensor as jq
from blazr_tpu.quant.pallas import int_matmul as im
from blazr_tpu.utils.synthetic import _rand_awq_qt
from blazr_tpu_torch.convert import params_from_jax
from blazr_tpu_torch.quant import matmul as tm
from blazr_tpu_torch.quant import qtensor as tq
from blazr_tpu_torch.quant.int8 import qmm_int8, quantize_rows
from blazr_tpu_torch.quant.kernels import qmm_stream

CPU = "cpu"


def _port(qt_jax):
    return params_from_jax(jax.tree.map(np.asarray, qt_jax), device=CPU)


def _jax_qt(mode, k=512, n=256, gs=128, seed=2):
    qt = _rand_awq_qt(jax.random.key(seed), k, n, group_size=gs)
    return jq.widen_to_int8(qt) if mode == "w8a8" else jq.mark_act_quant(qt)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("m", [1, 5, 17, 300])
@pytest.mark.parametrize("mode", ["w4a8", "w8a8"])
def test_b3_plain_matches_jax_int8mxu(mode, m, monkeypatch):
    """B3's plain version against ``quant_matmul_int8mxu`` (interpret): the
    quantized activations the JAX kernel receives equal the port's as
    integers, and the outputs agree."""
    jt = _jax_qt(mode)
    pt = _port(jt)
    assert pt.act_quant and pt.bits == jt.bits
    seen = {}
    real = im._qmm_int8

    def spy(xq, xs, *a, **kw):
        seen["xq"], seen["xs"] = np.asarray(xq), np.asarray(xs)
        return real(xq, xs, *a, **kw)

    monkeypatch.setattr(im, "_qmm_int8", spy)
    rng = np.random.default_rng(m)
    x = (rng.standard_normal((m, 512)) * rng.random((m, 1)) * 4).astype(np.float32)
    if m > 1:
        x[m // 2] = 0                                   # an all-zero row
    ref = np.asarray(im.quant_matmul_int8mxu(jnp.asarray(x), jt))
    xq, xs = quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(xq.numpy(), seen["xq"][:m])
    np.testing.assert_array_equal(xs.numpy(), seen["xs"][:m])
    got = qmm_int8(torch.from_numpy(x), pt.qweight, pt.scales, pt.mins,
                   bits=pt.bits, group_size=pt.group_size, device=CPU).numpy()
    _close(got, ref)


@pytest.mark.parametrize("m", [1, 5, 17])
@pytest.mark.parametrize("bits", [4, 8])
def test_b4_plain_matches_jax_stream_kernel(bits, m, monkeypatch):
    """B4's plain version against ``quant_matmul_pallas`` under
    BLAZR_TPU_STREAM_KERNEL=1 (as ``tests/test_qtensor.py:167``, with K=1024
    so that K // bk = 2 and the JAX package really takes its stream
    kernel)."""
    monkeypatch.setenv("BLAZR_TPU_STREAM_KERNEL", "1")
    jt = _rand_awq_qt(jax.random.key(3), 1024, 256, group_size=128)
    if bits == 8:
        jt = jq.widen_to_int8(jt)
    pt = _port(jt)
    calls = []
    real = im._qmm_stream
    monkeypatch.setattr(im, "_qmm_stream",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = np.random.default_rng(m).standard_normal((m, 1024)).astype(np.float32)
    ref = np.asarray(im.quant_matmul_pallas(jnp.asarray(x), jt))
    assert calls, "the JAX package did not take its stream kernel"
    got = qmm_stream(torch.from_numpy(x), pt.qweight, pt.scales, pt.mins,
                     bits=bits, group_size=128, device=CPU).numpy()
    _close(got, ref)


def test_widen_to_int8_exact_and_bit_equal():
    """Widening keeps the integers and the affine (dequantize is exact) and
    packs the same words as the JAX package."""
    jt = _rand_awq_qt(jax.random.key(4), 512, 256, group_size=128)
    pt = _port(jt)
    wide = tq.widen_to_int8(pt)
    assert wide.bits == 8 and wide.act_quant and wide.qweight.shape[0] == 128
    assert torch.equal(tq.dequantize(wide), tq.dequantize(pt))
    np.testing.assert_array_equal(wide.qweight.numpy().view(np.uint32),
                                  np.asarray(jq.widen_to_int8(jt).qweight))
    assert tq.widen_to_int8(wide) is wide
    with pytest.raises(NotImplementedError):
        tq.mark_act_quant(tq.QuantTensor(**{**pt.__dict__, "signed": False}))


def _spy_routes(monkeypatch):
    calls = []
    for name in ("qmm", "qmm_int8", "qmm_stream"):
        real = getattr(tm, name)

        def spy(x, *a, _real=real, _name=name, **kw):
            calls.append((_name, x.shape[0]))
            return _real(x, *a, **kw)
        monkeypatch.setattr(tm, name, spy)
    return calls


def test_w4a8_prefill_routing(monkeypatch):
    """Below 256 rows a w4a8-prefill tensor gives exactly the untagged
    route's output; from 256 rows it takes B3, as the JAX package does."""
    pt = _port(_rand_awq_qt(jax.random.key(5), 256, 128, group_size=64))
    tagged = tq.apply_quant_compute({"w": pt}, "w4a8-prefill")["w"]
    assert tagged.act_quant_min_m == tq._PREFILL_A8_MIN_M == jq._PREFILL_A8_MIN_M
    calls = _spy_routes(monkeypatch)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((255, 256)).astype(np.float32))
    assert torch.equal(tm.quant_matmul(x, tagged), tm.quant_matmul(x, pt))
    assert [c[0] for c in calls] == ["qmm", "qmm"]
    x = torch.from_numpy(rng.standard_normal((2, 128, 256)).astype(np.float32))
    y = tm.quant_matmul(x, tagged)
    assert calls[-1] == ("qmm_int8", 256) and y.shape == (2, 128, 128)
    ref = qmm_int8(x.reshape(256, 256), pt.qweight, pt.scales, pt.mins, bits=4,
                   group_size=64, device=CPU)
    assert torch.equal(y.reshape(256, 128), ref)


def test_stream_knob_is_read_per_call(monkeypatch):
    pt = _port(_rand_awq_qt(jax.random.key(6), 1024, 256, group_size=128))
    calls = _spy_routes(monkeypatch)
    x = torch.ones((4, 1024))
    monkeypatch.delenv("BLAZR_TPU_STREAM_KERNEL", raising=False)
    tm.quant_matmul(x, pt)
    monkeypatch.setenv("BLAZR_TPU_STREAM_KERNEL", "1")
    tm.quant_matmul(x, pt)
    tm.quant_matmul(torch.ones((33, 1024)), pt)          # m > 32: B1
    monkeypatch.setenv("BLAZR_TPU_STREAM_KERNEL", "0")
    tm.quant_matmul(x, pt)
    assert [c[0] for c in calls] == ["qmm", "qmm_stream", "qmm", "qmm"]


@pytest.mark.parametrize("k,n,bits,gs", [
    (512, 256, 4, 128), (1024, 256, 8, 128), (384, 256, 4, 128), (256, 200, 4, 64),
    (4096, 28672, 4, 128), (14336, 4096, 8, 128), (640, 128, 4, 32), (96, 128, 4, 32),
    (1024, 128, 4, 256), (512, 384, 8, 1024),
])
def test_tile_predicate_is_jax_choose_tiles(k, n, bits, gs):
    """The port's geometry test is ``_choose_tiles``' acceptance: a shape the
    JAX package does not tile goes to B1 in both packages."""
    tiles = im._choose_tiles(8, k, n, bits, gs)
    assert tm.tile_k(k, n, bits, gs) == (None if tiles is None else tiles[1])


def test_untiled_tagged_tensor_takes_b1(monkeypatch):
    """A tagged tensor whose N the JAX tiles reject (200) runs B1, bit-equal
    to the untagged route, as the JAX package falls through to its dequant
    path."""
    jt = _rand_awq_qt(jax.random.key(7), 256, 200, group_size=64)
    pt = _port(jt)
    tagged = tq.mark_act_quant(pt)
    calls = _spy_routes(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((3, 256)).astype(np.float32))
    assert torch.equal(tm.quant_matmul(x, tagged), tm.quant_matmul(x, pt))
    assert {c[0] for c in calls} == {"qmm"}
    monkeypatch.setenv("BLAZR_TPU_FORCE_PALLAS_QUANT", "1")
    from blazr_tpu.quant.matmul import quant_matmul as jax_qm

    ref = np.asarray(jax_qm(jnp.asarray(x.numpy()), jq.mark_act_quant(jt)))
    _close(tm.quant_matmul(x, tagged).numpy(), ref)


def test_params_from_jax_carries_tags():
    jt = jq.apply_quant_compute({"a": _rand_awq_qt(jax.random.key(8), 256, 128,
                                                   group_size=64)}, "w4a8-prefill")
    pt = params_from_jax(jax.tree.map(np.asarray, jt), device=CPU)
    assert pt["a"].act_quant and pt["a"].act_quant_min_m == 256


@pytest.mark.parametrize("path", ["b3_w4a8", "b3_w8a8", "b4_stream"])
def test_f16_plain_matches_jax_kernels(path, monkeypatch):
    """f16 activations (the AWQ/GPTQ loader default) through B3's and B4's
    plain versions against the JAX kernels in interpret mode: both quantize
    (B3) or round to bf16 (B4) from the f16 values, sum in f32 and write
    f16. 2e-3 of max|y|: one f16 rounding of the output (2^-11 relative)
    with room for the sum order."""
    rng = np.random.default_rng(len(path))
    if path == "b4_stream":
        monkeypatch.setenv("BLAZR_TPU_STREAM_KERNEL", "1")
        jt = _rand_awq_qt(jax.random.key(5), 1024, 256, group_size=128)
        x = rng.standard_normal((3, 1024)).astype(np.float16)
        ref = np.asarray(im.quant_matmul_pallas(jnp.asarray(x), jt))
        pt = _port(jt)
        got = qmm_stream(torch.from_numpy(x), pt.qweight, pt.scales, pt.mins,
                         bits=4, group_size=128, device=CPU)
    else:
        jt = _jax_qt(path[3:])
        x = rng.standard_normal((5, 512)).astype(np.float16)
        ref = np.asarray(im.quant_matmul_int8mxu(jnp.asarray(x), jt))
        pt = _port(jt)
        got = qmm_int8(torch.from_numpy(x), pt.qweight, pt.scales, pt.mins,
                       bits=pt.bits, group_size=pt.group_size, device=CPU)
    assert ref.dtype == np.float16 and got.dtype == torch.float16
    tol = 2e-3 * float(np.abs(ref.astype(np.float32)).max())
    np.testing.assert_allclose(got.float().numpy(), ref.astype(np.float32),
                               rtol=0, atol=tol)
