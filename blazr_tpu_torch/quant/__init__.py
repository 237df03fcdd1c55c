from .kernels import qmm, qmm_reference
from .matmul import quant_matmul
from .qtensor import (
    QuantTensor,
    apply_quant_compute,
    dequantize,
    dequantize_np,
    from_awq,
    from_gptq,
    unpack,
    unpack_k,
)

__all__ = [
    "QuantTensor",
    "apply_quant_compute",
    "dequantize",
    "dequantize_np",
    "from_awq",
    "from_gptq",
    "qmm",
    "qmm_reference",
    "quant_matmul",
    "unpack",
    "unpack_k",
]
