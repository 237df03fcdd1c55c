"""Checkpoint format / source detection.

Counterpart of ``blazr_tpu/formats/detect.py``: probe a file or directory
for SafeTensors (single, sharded, AWQ, GPTQ) or GGUF checkpoints;
SafeTensors is preferred when both exist.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


class ModelFormat(enum.Enum):
    SAFETENSORS = "safetensors"
    GGUF = "gguf"


class QuantMethod(enum.Enum):
    NONE = "none"
    AWQ = "awq"
    GPTQ = "gptq"
    GGUF = "gguf"  # ggml block quants inside a GGUF file


@dataclass
class ModelSource:
    format: ModelFormat
    path: Path                      # the file (gguf / st) or index to open
    model_dir: Path                 # directory holding config/tokenizer files
    quant: QuantMethod = QuantMethod.NONE
    config_path: Optional[Path] = None

    @property
    def is_sharded(self) -> bool:
        return self.path.name.endswith(".index.json")


def detect_model_source(path: str | Path) -> ModelSource:
    """Probe ``path`` (file or directory) for a loadable checkpoint.

    Priority (reference src/loader/detect.rs:33-146):
      1. explicit file path (by suffix)
      2. model.safetensors / model-*-of-*.safetensors in a directory
      3. any *.safetensors
      4. *.gguf
    """
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Model path does not exist: {path}")

    if path.is_file():
        return _source_from_file(path)

    # Directory probing — SafeTensors preferred over GGUF.
    idx = path / "model.safetensors.index.json"
    if idx.exists():
        return _finish(ModelFormat.SAFETENSORS, idx, path)
    single = path / "model.safetensors"
    if single.exists():
        return _finish(ModelFormat.SAFETENSORS, single, path)
    shards = sorted(path.glob("model-*-of-*.safetensors"))
    if shards:
        return _finish(ModelFormat.SAFETENSORS, shards[0].parent, path)
    any_st = sorted(path.glob("*.safetensors"))
    if any_st:
        return _finish(ModelFormat.SAFETENSORS, any_st[0], path)
    ggufs = sorted(path.glob("*.gguf"))
    if ggufs:
        return _finish(ModelFormat.GGUF, ggufs[0], path)
    raise FileNotFoundError(f"No model files (safetensors/gguf) found in {path}")


def _source_from_file(path: Path) -> ModelSource:
    suffix = path.suffix.lower()
    if suffix == ".gguf":
        return _finish(ModelFormat.GGUF, path, path.parent)
    if suffix == ".safetensors" or path.name.endswith(".index.json"):
        return _finish(ModelFormat.SAFETENSORS, path, path.parent)
    raise ValueError(f"Unrecognized model file type: {path}")


def _finish(fmt: ModelFormat, path: Path, model_dir: Path) -> ModelSource:
    config_path = model_dir / "config.json"
    src = ModelSource(
        format=fmt,
        path=path,
        model_dir=model_dir,
        config_path=config_path if config_path.exists() else None,
    )
    if fmt == ModelFormat.GGUF:
        src.quant = QuantMethod.GGUF
    else:
        src.quant = detect_st_quant_method(model_dir)
    return src


def detect_st_quant_method(model_dir: Path) -> QuantMethod:
    """Detect AWQ/GPTQ from quantization config files
    (reference detect_arch.rs:61-132: quant_config.json / quantize_config.json
    / config.json["quantization_config"]["quant_method"])."""
    for fname in ("quant_config.json", "quantize_config.json"):
        p = model_dir / fname
        if p.exists():
            try:
                cfg = json.loads(p.read_text())
            except json.JSONDecodeError:
                continue
            method = (cfg.get("quant_method") or cfg.get("method") or "").lower()
            if method == "awq":
                return QuantMethod.AWQ
            if method == "gptq":
                return QuantMethod.GPTQ
            # quantize_config.json without quant_method is GPTQ's convention
            if fname == "quantize_config.json" and "bits" in cfg:
                return QuantMethod.GPTQ
    cfg_path = model_dir / "config.json"
    if cfg_path.exists():
        try:
            cfg = json.loads(cfg_path.read_text())
        except json.JSONDecodeError:
            cfg = {}
        qc = cfg.get("quantization_config") or {}
        method = (qc.get("quant_method") or "").lower()
        if method == "awq":
            return QuantMethod.AWQ
        if method == "gptq":
            return QuantMethod.GPTQ
    return QuantMethod.NONE


def read_quant_group_size(model_dir: Path, default: int = 128) -> int:
    """Group size from quant config files (reference detect_arch.rs:168-197;
    default 128)."""
    candidates = ["quant_config.json", "quantize_config.json", "config.json"]
    for fname in candidates:
        p = Path(model_dir) / fname
        if not p.exists():
            continue
        try:
            cfg = json.loads(p.read_text())
        except json.JSONDecodeError:
            continue
        if fname == "config.json":
            cfg = cfg.get("quantization_config") or {}
        gs = cfg.get("group_size", cfg.get("q_group_size"))
        if isinstance(gs, int) and gs > 0:
            return gs
    return default
