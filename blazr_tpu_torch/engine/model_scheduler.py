"""Named-model lifecycle scheduler (LRU + keep-alive).

Counterpart of ``blazr_tpu/engine/model_scheduler.py``: load-on-demand from
a model directory onto the scheduler's device (default ``cuda``), LRU
eviction at ``max_loaded``, Ollama-style ``keep_alive`` TTLs with a reaper,
and model discovery. Each loaded model is served by the port's ``Executor``.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ..config.app import AppConfig
from ..loader import load_model
from ..tokenizer import load_tokenizer
from ..utils.device import DeviceLike, resolve_device
from .executor import Executor

logger = logging.getLogger(__name__)


def parse_keep_alive(value) -> Optional[float]:
    """Parse Ollama-style keep_alive: seconds (int/float), '5m'/'1h'/'30s',
    0 → unload now, negative → keep forever (reference scheduler.rs:34-62).
    Returns TTL seconds (None = forever)."""
    if value is None:
        return 300.0
    if isinstance(value, (int, float)):
        v = float(value)
    else:
        s = str(value).strip()
        try:
            if s.endswith("ms"):
                v = float(s[:-2]) / 1000.0
            elif s and s[-1] in "smh":
                mult = {"s": 1.0, "m": 60.0, "h": 3600.0}[s[-1]]
                v = float(s[:-1]) * mult
            else:
                v = float(s)
        except ValueError:
            return 300.0
    if v < 0:
        return None
    return v


@dataclass
class LoadedEntry:
    name: str
    executor: Executor
    app_cfg: AppConfig
    last_used: float = field(default_factory=time.time)
    expires_at: Optional[float] = None   # None = keep forever
    load_duration: float = 0.0
    size_bytes: int = 0


class ModelScheduler:
    """Thread-safe named-model cache."""

    def __init__(self, model_dir: str | Path, max_loaded: int = 1,
                 dtype: Optional[str] = None, quant_compute: Optional[str] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model_dir = Path(model_dir)
        self.max_loaded = max_loaded
        self.dtype = dtype
        self.quant_compute = quant_compute
        self._models: dict[str, LoadedEntry] = {}
        self._lock = threading.Lock()
        self.loads = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    def discover_models(self) -> list[str]:
        """List loadable models in the model dir (reference model-dir
        discovery): subdirectories with checkpoints, plus *.gguf files."""
        out = []
        if not self.model_dir.exists():
            return out
        if self._is_model_dir(self.model_dir):
            out.append(self.model_dir.name)
        for p in sorted(self.model_dir.iterdir()):
            if p.is_dir() and self._is_model_dir(p):
                out.append(p.name)
            elif p.suffix == ".gguf":
                out.append(p.name)
        return out

    @staticmethod
    def _is_model_dir(p: Path) -> bool:
        return any(p.glob("*.safetensors")) or any(p.glob("*.gguf")) \
            or (p / "model.safetensors.index.json").exists()

    def _resolve_path(self, name: str) -> Path:
        if name in ("", "default") and self._is_model_dir(self.model_dir):
            return self.model_dir
        cand = self.model_dir / name
        if cand.exists():
            return cand
        if self._is_model_dir(self.model_dir):
            return self.model_dir
        raise FileNotFoundError(f"model {name!r} not found under {self.model_dir}")

    # ------------------------------------------------------------------
    def get_executor(self, name: str = "default",
                     keep_alive=None) -> Executor:
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                entry = self._load(name)
            entry.last_used = time.time()
            ttl = parse_keep_alive(keep_alive)
            if keep_alive is not None and ttl is not None and ttl == 0:
                # keep_alive=0 → unload after this request
                entry.expires_at = time.time()
            elif ttl is None:
                entry.expires_at = None
            else:
                entry.expires_at = time.time() + ttl
            return entry.executor

    def _load(self, name: str) -> LoadedEntry:
        while len(self._models) >= self.max_loaded:
            self._evict_lru()
        path = self._resolve_path(name)
        t0 = time.time()
        logger.info("loading model %r from %s", name, path)
        model, app_cfg = load_model(path, dtype=self.dtype, device=self.device)
        if self.quant_compute:
            app_cfg.inference.quant_compute = self.quant_compute
        gguf_path = path if path.suffix == ".gguf" else None
        tok_dir = path.parent if path.is_file() else path
        tokenizer = load_tokenizer(tok_dir, gguf_path=gguf_path)
        executor = Executor(model, tokenizer, app_cfg)
        entry = LoadedEntry(
            name=name, executor=executor, app_cfg=app_cfg,
            load_duration=time.time() - t0,
        )
        self._models[name] = entry
        self.loads += 1
        logger.info("model %r loaded in %.1fs", name, entry.load_duration)
        return entry

    @staticmethod
    def _close_entry(entry) -> None:
        """Release executor-held resources, where the executor has any."""
        close = getattr(entry.executor, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                logger.exception("executor close failed for %r", entry.name)

    def _evict_lru(self) -> None:
        if not self._models:
            return
        victim = min(self._models.values(), key=lambda e: e.last_used)
        logger.info("evicting model %r (LRU)", victim.name)
        del self._models[victim.name]
        self._close_entry(victim)
        self.evictions += 1

    # ------------------------------------------------------------------
    def evict_expired(self) -> int:
        """Reaper tick (reference scheduler.rs:316): unload expired models."""
        now = time.time()
        with self._lock:
            expired = [n for n, e in self._models.items()
                       if e.expires_at is not None and e.expires_at <= now]
            for n in expired:
                logger.info("unloading model %r (keep_alive expired)", n)
                entry = self._models.pop(n)
                self._close_entry(entry)
        return len(expired)

    def unload(self, name: str) -> bool:
        with self._lock:
            entry = self._models.pop(name, None)
            if entry is not None:
                self._close_entry(entry)
            return entry is not None

    def loaded_models(self) -> list[LoadedEntry]:
        with self._lock:
            return list(self._models.values())

    @property
    def num_loaded(self) -> int:
        return len(self._models)
