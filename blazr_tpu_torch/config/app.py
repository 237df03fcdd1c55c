"""Top-level application config.

Counterpart of ``blazr_tpu/config/app.py``: a model ``UniversalConfig`` plus
``inference``, ``server`` and ``generation`` sections, loadable from YAML or
JSON. The dtype names map to ``torch`` dtypes here.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch

from .generation import GenerationConfig
from .inference import InferenceConfig
from .model_config import UniversalConfig
from .server import ServerConfig

_DTYPE_MAP = {
    "f32": torch.float32,
    "float32": torch.float32,
    "f16": torch.float16,
    "float16": torch.float16,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
}


def parse_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPE_MAP[name.lower()]
    except KeyError:
        raise ValueError(f"Unknown dtype '{name}' (want f32/f16/bf16)") from None


@dataclass
class AppConfig:
    """model ⊕ inference ⊕ server ⊕ generation — the full app config."""

    model: UniversalConfig = field(default_factory=UniversalConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    server: ServerConfig = field(default_factory=ServerConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)

    @property
    def dtype(self) -> torch.dtype:
        return parse_dtype(self.inference.dtype)

    def effective_max_seq_len(self) -> int:
        """inference.max_seq_len overrides the model's natural context."""
        if self.inference.max_seq_len is not None:
            return min(self.inference.max_seq_len, self.model.max_seq_len) \
                if self.model.max_seq_len else self.inference.max_seq_len
        return self.model.max_seq_len

    def to_dict(self) -> dict[str, Any]:
        # The model config is flattened at top level.
        d = self.model.to_dict()
        d["inference"] = self.inference.to_dict()
        d["server"] = self.server.to_dict()
        d["generation"] = self.generation.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "AppConfig":
        d = dict(d)
        inference = InferenceConfig.from_dict(d.pop("inference", {}) or {})
        server = ServerConfig.from_dict(d.pop("server", {}) or {})
        generation = GenerationConfig.from_dict(d.pop("generation", {}) or {})
        model = UniversalConfig.from_dict(d)
        return cls(model=model, inference=inference, server=server,
                   generation=generation)

    @classmethod
    def from_universal_with_dtype(cls, model: UniversalConfig, dtype: str) -> "AppConfig":
        cfg = cls(model=model)
        cfg.inference.dtype = dtype
        return cfg

    @classmethod
    def from_file(cls, path: str | Path) -> "AppConfig":
        path = Path(path)
        text = path.read_text()
        if path.suffix in (".yaml", ".yml"):
            import yaml      # optional dependency: only YAML files need it

            return cls.from_dict(yaml.safe_load(text) or {})
        return cls.from_dict(json.loads(text))
