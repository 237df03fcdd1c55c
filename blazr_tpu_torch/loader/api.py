"""Unified model-loading API.

Counterpart of ``blazr_tpu/loader/api.py``: auto-detect the format
(SafeTensors plain/AWQ/GPTQ or GGUF), build the AppConfig by the JAX
package's chain (``config.json``, else GGUF metadata, else tensor names and
shapes), fill a VarMap and build the Model on the device. AWQ and GPTQ
checkpoints compute in f16 by default (their scales are f16), GGUF and
inferred configs in bf16, as in the JAX package. A vision tower, in the
checkpoint (HF LLaVA) or in an ``mmproj`` sidecar (given, or found beside
the model), is attached by ``loader/vision.py`` (JAX api.py:103-107). Layer
offload (``device_layers``, else ``inference.num_device_layers``) below the
model's depth keeps the first layers on the card and streams the others from
host RAM (``loader/offloading.py``'s map, ``engine/offload_stream.py``; JAX
api.py:108-115).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

from ..config.app import AppConfig, parse_dtype
from ..config.model_config import UniversalConfig, universal_from_hf_config
from ..formats.detect import ModelFormat, ModelSource, QuantMethod, detect_model_source
from ..formats.detect_arch import detect_architecture_from_names, infer_config_from_shapes
from ..formats.gguf import Gguf
from ..models.registry import Model, build_model
from ..utils.device import DeviceLike, resolve_device
from .gguf_config import universal_from_gguf_metadata
from .varmap import (VarMap, varmap_from_awq, varmap_from_gguf, varmap_from_gptq,
                     varmap_from_safetensors)

logger = logging.getLogger(__name__)


def load_varmap(source: ModelSource, work_device=None) -> VarMap:
    """The checkpoint's tensors on the CPU; AWQ and GGUF words are packed on
    ``work_device`` (the card ``load_model`` loads onto, where one is)."""
    if source.format == ModelFormat.GGUF:
        vm = varmap_from_gguf(source.path, work_device=work_device)
    elif source.quant == QuantMethod.AWQ:
        vm = varmap_from_awq(source.path, work_device=work_device)
    elif source.quant == QuantMethod.GPTQ:
        vm = varmap_from_gptq(source.path)
    else:
        vm = varmap_from_safetensors(source.path)
    # HF multimodal (LLaVA) checkpoints nest the LLM under "language_model.";
    # strip it so the text builders see canonical names.
    for n in [n for n in vm.names() if n.startswith("language_model.")]:
        vm.insert(n[len("language_model."):], vm.take(n))
    return vm


def resolve_config(source: ModelSource, vm: Optional[VarMap] = None) -> AppConfig:
    """Config chain (the JAX package's api.py:54-77): an explicit
    ``config.json`` (ours or HF), then GGUF metadata, then the architecture
    and dimensions inferred from the tensor names and shapes."""
    if source.config_path is not None:
        raw = json.loads(Path(source.config_path).read_text())
        if "inference" in raw or "generation" in raw:
            return AppConfig.from_dict(raw)         # our flattened AppConfig
        cfg = AppConfig()
        cfg.model = universal_from_hf_config(raw)
        if source.quant in (QuantMethod.AWQ, QuantMethod.GPTQ):
            cfg.inference.dtype = "f16"             # quant scales are f16
        return cfg
    if source.format == ModelFormat.GGUF:
        with Gguf.open(source.path) as g:
            model = universal_from_gguf_metadata(g.metadata())
        return AppConfig.from_universal_with_dtype(model, "bf16")
    if vm is None:
        raise ValueError(f"{source.model_dir} has no config.json: inferring the "
                         "config from tensor shapes needs the loaded VarMap")
    names = vm.names()
    model = infer_config_from_shapes(names, vm.logical_shape,
                                     detect_architecture_from_names(names))
    return AppConfig.from_universal_with_dtype(model, "bf16")


def load_model(path: str | Path, dtype: Optional[str] = None,
               device_layers: Optional[int] = None, mmproj: Optional[str] = None,
               device: DeviceLike = None) -> tuple[Model, AppConfig]:
    """Auto-detect and load a model onto ``device`` (default ``cuda``);
    with ``device_layers`` below its depth, a ``StreamingModel``."""
    dev = resolve_device(device)
    source = detect_model_source(path)
    logger.info("Loading %s model from %s (quant=%s)",
                source.format.value, source.path, source.quant.value)
    vm = load_varmap(source, work_device=dev if dev.type == "cuda" else None)
    app_cfg = resolve_config(source, vm)
    if dtype is not None:
        app_cfg.inference.dtype = dtype
    if device_layers is None:
        device_layers = app_cfg.inference.num_device_layers
    _reconcile_config_with_weights(app_cfg.model, vm)
    model = build_model(app_cfg.model, vm, dtype=parse_dtype(app_cfg.inference.dtype),
                        device=dev)
    from .vision import attach_vision

    attach_vision(model, app_cfg.model, source.path, vm, mmproj_path=mmproj)
    if device_layers is not None and device_layers < model.num_layers:
        from ..engine.offload_stream import maybe_stream
        from .offloading import LayerDeviceMap

        app_cfg.inference.num_device_layers = device_layers
        model = maybe_stream(model, LayerDeviceMap.with_device_layers(model.num_layers,
                                                                      device_layers))
    return model, app_cfg


def _reconcile_config_with_weights(model_cfg: UniversalConfig, vm: VarMap) -> None:
    """Vocab and hidden size from the embedding's shape (Falcon names it
    ``transformer.word_embeddings``)."""
    for name in ("model.embed_tokens.weight", "embed_tokens.weight",
                 "transformer.word_embeddings.weight"):
        if name in vm:
            v, h = vm.logical_shape(name)
            if model_cfg.vocab_size != v:
                logger.info("vocab_size %d → %d (from embed shape)",
                            model_cfg.vocab_size, v)
                model_cfg.vocab_size = v
            model_cfg.hidden_size = h
            break
