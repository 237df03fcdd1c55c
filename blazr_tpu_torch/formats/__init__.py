"""Checkpoint formats: SafeTensors reading/writing and source detection."""

from .detect import (ModelFormat, ModelSource, QuantMethod, detect_model_source,
                     detect_st_quant_method, read_quant_group_size)
from .safetensors import SafeTensorsReader, TensorInfo, write_safetensors

__all__ = ["ModelFormat", "ModelSource", "QuantMethod", "SafeTensorsReader",
           "TensorInfo", "detect_model_source", "detect_st_quant_method",
           "read_quant_group_size", "write_safetensors"]
