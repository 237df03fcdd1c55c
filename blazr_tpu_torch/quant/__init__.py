from .int8 import (qmm_int8, qmm_int8_reference, quantize_activations,
                   quantize_activations_reference, quantize_rows)
from .kernels import qmm, qmm_reference, qmm_stream, qmm_stream_reference
from .matmul import quant_matmul
from .qtensor import (
    QuantTensor,
    apply_quant_compute,
    dequantize,
    dequantize_np,
    from_awq,
    from_gptq,
    mark_act_quant,
    unpack,
    unpack_k,
    widen_to_int8,
)

__all__ = [
    "QuantTensor",
    "apply_quant_compute",
    "dequantize",
    "dequantize_np",
    "from_awq",
    "from_gptq",
    "mark_act_quant",
    "qmm",
    "qmm_int8",
    "qmm_int8_reference",
    "qmm_reference",
    "qmm_stream",
    "qmm_stream_reference",
    "quant_matmul",
    "quantize_activations",
    "quantize_activations_reference",
    "quantize_rows",
    "unpack",
    "unpack_k",
    "widen_to_int8",
]
