"""/v1/embeddings endpoint.

Counterpart of ``blazr_tpu/server/embeddings.py``, the reference embeddings
endpoint (src/server/embeddings.rs): string-or-array input (a flat id array
is one pre-tokenized input), mean/cls/last pooling, optional L2
normalization, float or base64 output. The vectors pool the model's token
embedding rows (``Executor.get_embeddings``; a lockstep op under a
multi-process mesh, ``app.embed_ids``), as the JAX package's do.
"""

from __future__ import annotations

import asyncio

from .api_types import ApiError, usage_dict
from .encoding import encode_embedding
from .pooling import pool
from .app import Response, _get_executor, embed_ids


async def embeddings_handler(request):
    body = request.json()
    executor = await asyncio.to_thread(_get_executor, request.app.state, body)
    inputs = body.get("input")
    if inputs is None:
        raise ApiError(400, "input required")
    if isinstance(inputs, str):
        inputs = [inputs]
    if not isinstance(inputs, list) or not inputs:
        raise ApiError(400, "input must be a non-empty string or array")
    if all(isinstance(t, int) for t in inputs):
        inputs = [list(inputs)]          # flat token-id array: one input
    strategy = body.get("pooling", "mean")
    if strategy not in ("mean", "cls", "last"):
        raise ApiError(400, f"unknown pooling strategy {strategy!r} (mean | cls | last)")
    normalize = bool(body.get("normalize", True))
    fmt = body.get("encoding_format", "float")
    if fmt not in ("float", "base64"):
        raise ApiError(400, f"unknown encoding_format {fmt!r} (float | base64)")
    data = []
    total_tokens = 0
    for i, item in enumerate(inputs):
        ids = (executor.tokenizer.encode(item) if isinstance(item, str)
               else [int(t) for t in item])
        if not ids:
            raise ApiError(400, f"input[{i}] is empty after tokenization")
        total_tokens += len(ids)
        emb = await embed_ids(request.app.state, executor, ids)
        data.append({"object": "embedding", "index": i,
                     "embedding": encode_embedding(pool(emb, strategy, normalize), fmt)})
    return Response.json({"object": "list", "data": data,
                          "model": body.get("model", "default"),
                          "usage": usage_dict(total_tokens, 0)})
