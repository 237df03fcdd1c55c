"""Ollama-style model management and named slots.

Counterpart of the JAX server's management and slot handlers
(``blazr_tpu/server/app.py:827-995``, the reference management.rs and
handlers.rs:366-416): ``/api/tags`` (models on disk with size and mtime),
``/api/ps`` (loaded models), ``/api/show``, ``DELETE /api/delete``
(unload), ``/api/copy`` (copy a model on disk), ``/api/pull`` (a Hub
download, NDJSON status lines; gated on ``huggingface_hub`` as in JAX) and
``/api/slots``. Two answers differ from the JAX handlers' on purpose
(ROADMAP §C): ``/api/tags`` gives the size and mtime of a model directory
that is the server's ``--model`` itself (JAX reports 0 and null), and
``/api/show`` answers 404 for a model that is not there (JAX: 500).
"""

from __future__ import annotations

import asyncio
import json
import logging
import shutil
import time
from pathlib import Path

from .api_types import ApiError
from .app import Response, StreamResponse

logger = logging.getLogger(__name__)


def _model_path(sched, name: str) -> Path:
    """Where model ``name`` lies: under the model dir, or the model dir
    itself when that is the model."""
    p = sched.model_dir / name
    if not p.exists() and sched.model_dir.name == name:
        p = sched.model_dir
    return p


def _stamp(t: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))


async def api_tags(request):
    sched = request.app.state.scheduler
    models = []
    for name in sched.discover_models():
        p = _model_path(sched, name)
        size, mtime = 0, 0.0
        if p.exists():
            for f in [p] if p.is_file() else list(p.glob("*")):
                if f.is_file():
                    st = f.stat()
                    size += st.st_size
                    mtime = max(mtime, st.st_mtime)
        models.append({"name": name, "model": name, "size": size,
                       "modified_at": _stamp(mtime) if mtime else None})
    return Response.json({"models": models})


async def api_ps(request):
    return Response.json({"models": [
        {"name": e.name, "model": e.name,
         "expires_at": _stamp(e.expires_at) if e.expires_at else "never",
         "size_vram": e.size_bytes}
        for e in request.app.state.scheduler.loaded_models()]})


async def api_show(request):
    body = request.json()
    name = body.get("name", body.get("model", "default"))
    try:
        executor = await asyncio.to_thread(request.app.state.scheduler.get_executor, name)
    except FileNotFoundError as e:
        raise ApiError(404, str(e), "not_found_error")
    cfg = executor.model.cfg
    return Response.json({
        "model_info": {
            "model_type": cfg.model_type, "hidden_size": cfg.hidden_size,
            "num_layers": cfg.num_layers, "vocab_size": cfg.vocab_size,
            "max_seq_len": cfg.max_seq_len,
            "num_heads": cfg.attention.num_heads if cfg.attention else None,
            "num_kv_heads": executor.model.num_kv_heads},
        "details": {"family": cfg.model_type, "format": "auto"}})


async def api_delete(request):
    body = request.json()
    name = body.get("name", body.get("model"))
    if not name:
        raise ApiError(400, "name required")
    return Response.json({"unloaded": request.app.state.scheduler.unload(name)})


async def api_copy(request):
    sched = request.app.state.scheduler
    body = request.json()
    source, destination = body.get("source"), body.get("destination")
    if not source or not destination:
        raise ApiError(400, "source and destination required")
    if "/" in destination or destination in (".", ".."):
        raise ApiError(400, "destination must be a plain model name")
    src = _model_path(sched, source)
    if source not in sched.discover_models() or not src.exists():
        raise ApiError(404, f"source model '{source}' not found", "not_found_error")
    dest = src.parent / destination
    if dest.exists():
        raise ApiError(409, f"destination '{destination}' already exists")

    def do_copy():
        if src.is_dir():
            shutil.copytree(src, dest)
        else:
            shutil.copy2(src, dest)

    await asyncio.to_thread(do_copy)
    logger.info("copied model '%s' -> '%s'", source, destination)
    return Response.json({"copied": destination})


async def api_pull(request):
    """NDJSON status lines of a Hub download into the model dir; without
    ``huggingface_hub``, or when the download fails, the last line is an
    error. The body ends when the connection closes."""
    body = request.json()
    name = body.get("name") or body.get("model")
    if not name:
        raise ApiError(400, "name required")
    resp = StreamResponse(request, {"Content-Type": "application/x-ndjson"})
    await resp.prepare()

    async def send(obj: dict) -> None:
        await resp.write((json.dumps(obj) + "\n").encode())

    await send({"status": f"pulling manifest for {name}"})
    dest = request.app.state.scheduler.model_dir / name.split("/")[-1]
    try:
        from huggingface_hub import snapshot_download
    except ImportError:
        await send({"error": "huggingface_hub is not installed"})
        return resp
    try:
        await send({"status": "downloading"})
        await asyncio.to_thread(snapshot_download, name, local_dir=dest,
                                allow_patterns=["*.safetensors", "*.json", "*.gguf",
                                                "*.model"])
        await send({"status": "success", "path": str(dest)})
    except Exception as e:          # no network, a bad repo id, ...
        await send({"error": f"pull failed: {e}"})
    return resp


async def slots_list(request):
    return Response.json({"slots": request.app.state.slots.list()})


async def slots_create(request):
    slot = request.app.state.slots.create(request.json().get("model", "default"))
    return Response.json(slot, 201)


async def slots_delete(request):
    sid = request.match_info["slot_id"]
    if not request.app.state.slots.delete(sid):
        raise ApiError(404, f"slot {sid} not found", "not_found_error")
    return Response.json({"deleted": sid})
