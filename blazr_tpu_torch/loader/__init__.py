"""Checkpoint loading: VarMap loaders and the ``load_model`` facade."""

from .api import load_model, load_varmap, resolve_config
from .varmap import (VarMap, varmap_from_awq, varmap_from_gptq,
                     varmap_from_safetensors)

__all__ = ["VarMap", "load_model", "load_varmap", "resolve_config",
           "varmap_from_awq", "varmap_from_gptq", "varmap_from_safetensors"]
