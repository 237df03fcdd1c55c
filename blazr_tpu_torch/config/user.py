"""Persistent per-user defaults (``~/.blazr_tpu/config.yaml``).

Counterpart of ``blazr_tpu/config/user.py``, the reference UserConfig
(src/config/user.rs:11-39), read-only (the server reads it), with PyYAML
imported only when a file is read (the JAX module imports it at load).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


def user_config_path() -> Path:
    return Path(os.environ.get("BLAZR_TPU_HOME", Path.home() / ".blazr_tpu")) / "config.yaml"


@dataclass
class UserConfig:
    model: Optional[str] = None
    device: Optional[str] = None
    num_ctx: Optional[int] = None
    port: Optional[int] = None
    temperature: Optional[float] = None
    max_tokens: Optional[int] = None

    @classmethod
    def from_dict(cls, data: Optional[dict]) -> "UserConfig":
        """The known keys of ``data``; the others are ignored."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in (data or {}).items() if k in known})

    @classmethod
    def load(cls, path: Optional[Path] = None) -> "UserConfig":
        path = path or user_config_path()
        if not path.exists():
            return cls()
        import yaml         # optional dependency: only a file on disk needs it

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))

