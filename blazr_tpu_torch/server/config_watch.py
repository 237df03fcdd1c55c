"""Config hot-reload watcher.

Counterpart of ``blazr_tpu/server/config_watch.py``, the reference config
watcher (src/server/config_watch.rs:13-47): polls the user config file and
hands changed contents to a callback without a restart. PyYAML is imported
only when a changed file is read (the JAX watcher imports it at start):
without it a change is logged as a failed reload and the server runs on.
"""

from __future__ import annotations

import asyncio
import logging
from pathlib import Path
from typing import Callable, Optional

logger = logging.getLogger(__name__)

POLL_INTERVAL_S = 5.0


async def watch_config(path: str | Path, on_change: Callable[[dict], None],
                       poll_interval: float = POLL_INTERVAL_S,
                       stop_event: Optional[asyncio.Event] = None) -> None:
    """Poll ``path`` for mtime changes; parse it and call ``on_change``."""
    path = Path(path)
    last_mtime = path.stat().st_mtime if path.exists() else None
    while stop_event is None or not stop_event.is_set():
        await asyncio.sleep(poll_interval)
        try:
            if not path.exists():
                continue
            mtime = path.stat().st_mtime
            if last_mtime is not None and mtime == last_mtime:
                continue
            last_mtime = mtime
            import yaml     # optional dependency: only a changed file needs it

            data = yaml.safe_load(path.read_text()) or {}
            logger.info("config file %s changed; applying", path)
            on_change(data)
        except Exception:
            logger.exception("config reload failed")
