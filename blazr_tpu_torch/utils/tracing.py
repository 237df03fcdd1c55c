"""Structured phase spans and profiling.

Counterpart of ``blazr_tpu/utils/tracing.py``: ``span`` logs
``phase=X_start`` and ``phase=X_end ... elapsed_ms=`` lines (with any
key=value fields) on the ``blazr_tpu_torch.trace`` logger at DEBUG, around
the Executor's prefill and the BatchEngine's prefill and decode phases;
``setup_logging`` reads ``BLAZR_TPU_LOG`` (trace|debug|info|warn|error);
``profile`` records a ``torch.profiler`` trace (CPU and, on the card, CUDA
activity) of a region and writes it as a Chrome trace into
``BLAZR_TPU_PROFILE_DIR`` (or the directory given), where the JAX package
takes a ``jax.profiler`` trace.

A span measures host wall time around work that is queued, not run: the
engines call it outside any captured graph, and it reads nothing from the
device.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from pathlib import Path
from typing import Iterator, Optional

logger = logging.getLogger("blazr_tpu_torch.trace")

_LEVELS = {"trace": logging.DEBUG, "debug": logging.DEBUG, "info": logging.INFO,
           "warn": logging.WARNING, "error": logging.ERROR}


def setup_logging(default: str = "info") -> None:
    """Configure the root logger from ``BLAZR_TPU_LOG`` (the reference's
    RUST_LOG); an unknown name means INFO."""
    level = _LEVELS.get(os.environ.get("BLAZR_TPU_LOG", default).lower(), logging.INFO)
    logging.basicConfig(level=level,
                        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")


@contextlib.contextmanager
def span(phase: str, **fields) -> Iterator[None]:
    """Log ``phase=<phase>_start <fields>`` and, when the block ends,
    ``phase=<phase>_end <fields> elapsed_ms=<ms>`` (host wall time)."""
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    logger.debug("phase=%s_start %s", phase, extra)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = (time.perf_counter() - t0) * 1e3
        logger.debug("phase=%s_end %s elapsed_ms=%.2f", phase, extra, dt)


@contextlib.contextmanager
def profile(log_dir: Optional[str] = None) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block, written as
    ``<log_dir>/trace_<pid>_<ns>.json`` (Chrome trace format); nothing when
    neither ``log_dir`` nor ``BLAZR_TPU_PROFILE_DIR`` is set."""
    log_dir = log_dir or os.environ.get("BLAZR_TPU_PROFILE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(path))
    logger.info("profiler trace written to %s", path)
