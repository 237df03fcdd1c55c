"""Checkpoint formats: SafeTensors and GGUF reading and writing, the ggml
codecs, and source detection."""

from .detect import (ModelFormat, ModelSource, QuantMethod, detect_model_source,
                     detect_st_quant_method, read_quant_group_size)
from .ggml_quants import dequantize_ggml, quantize_ggml
from .gguf import GGML_BLOCK_INFO, GgmlType, Gguf, GgufMetadata, GgufTensorInfo, write_gguf
from .safetensors import SafeTensorsReader, TensorInfo, write_safetensors

__all__ = ["GGML_BLOCK_INFO", "GgmlType", "Gguf", "GgufMetadata", "GgufTensorInfo",
           "ModelFormat", "ModelSource", "QuantMethod", "SafeTensorsReader",
           "TensorInfo", "dequantize_ggml", "detect_model_source",
           "detect_st_quant_method", "quantize_ggml", "read_quant_group_size",
           "write_gguf", "write_safetensors"]
