"""LoRA management routes.

Counterpart of ``blazr_tpu/server/lora_routes.py``: ``POST /v1/lora``
loads an HF-PEFT adapter into the server's registry and activates it on the
served model (201; a bad path, or an adapter with modules the model cannot
take, 400), ``GET /v1/lora`` lists the registry,
``DELETE /v1/lora/{name}`` unloads an adapter (200, 404 for an unknown
name) and deactivates it where it is live. A generation request's
``lora_adapter`` is ``app.apply_request_lora``'s. Unlike the JAX merge, an
adapter the model cannot wholly take answers 400 naming its modules
(ROADMAP §C).
"""

from __future__ import annotations

import asyncio

from .api_types import ApiError
from .app import Response, _get_executor, set_live_lora


async def lora_load(request):
    state = request.app.state
    body = request.json()
    path = body.get("path")
    if not path:
        raise ApiError(400, "path required")
    try:
        adapter = await asyncio.to_thread(state.lora_registry.load, path, body.get("name"))
    except (FileNotFoundError, ValueError) as e:
        raise ApiError(400, str(e))
    # Loading activates the adapter on the serving model (the last loaded
    # adapter is the live one).
    try:
        executor = await asyncio.to_thread(_get_executor, state, body)
    except ApiError:
        executor = None                # no model loaded yet: applied on use
    if executor is not None:
        try:
            await set_live_lora(executor, adapter)
        except ApiError:
            state.lora_registry.unload(adapter.name)
            raise
    return Response.json({"name": adapter.name, "rank": adapter.rank,
                          "alpha": adapter.alpha, "modules": adapter.num_modules()},
                         status=201)


async def lora_list(request):
    return Response.json({"adapters": request.app.state.lora_registry.list()})


async def lora_delete(request):
    state = request.app.state
    name = request.match_info["name"]
    if not state.lora_registry.unload(name):
        raise ApiError(404, f"adapter {name!r} not found", "not_found_error")
    for entry in state.scheduler.loaded_models():
        if entry.executor.active_lora == name:
            await set_live_lora(entry.executor, None)
    return Response.json({"deleted": name})
