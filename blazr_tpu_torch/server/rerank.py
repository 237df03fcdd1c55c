"""Rerank endpoint (Cohere/Jina-compatible).

Counterpart of ``blazr_tpu/server/rerank.py``, the reference rerank module
(src/server/rerank.rs:314): the query and each document embedded
(mean-pooled, L2-normalized token embedding rows), ranked by cosine
similarity, the top-n returned with an optional document echo.
"""

from __future__ import annotations

import asyncio

import numpy as np

from .api_types import ApiError
from .pooling import pool
from .app import Response, _get_executor, embed_ids


async def rerank_handler(request):
    body = request.json()
    executor = await asyncio.to_thread(_get_executor, request.app.state, body)
    query = body.get("query")
    documents = body.get("documents")
    if not query or not documents:
        raise ApiError(400, "query and documents are required")
    top_n = int(body.get("top_n", len(documents)))
    return_docs = bool(body.get("return_documents", True))

    async def embed(text: str):
        ids = await asyncio.to_thread(executor.tokenizer.encode, text)
        if not ids:
            return None               # an empty document scores 0
        return pool(await embed_ids(request.app.state, executor, ids), "mean", True)

    q_vec = await embed(query)
    if q_vec is None:
        raise ApiError(400, "query must not be empty")
    results = []
    for i, doc in enumerate(documents):
        text = doc if isinstance(doc, str) else doc.get("text", "")
        d_vec = await embed(text)
        entry = {"index": i,
                 "relevance_score": 0.0 if d_vec is None else float(np.dot(q_vec, d_vec))}
        if return_docs:
            entry["document"] = {"text": text}
        results.append(entry)
    results.sort(key=lambda r: -r["relevance_score"])
    return Response.json({"model": body.get("model", "default"), "results": results[:top_n]})
