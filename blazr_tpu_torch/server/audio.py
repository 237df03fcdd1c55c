"""Audio endpoints: TTS and transcription.

Counterpart of ``blazr_tpu/server/audio.py``: the reference ships these as
501 stubs pending TTS/ASR model support (src/server/audio.rs:4-5), and so
does the JAX package. The bodies are the JAX stubs' own, so clients get a
well-formed not-implemented error rather than a 404.
"""

from __future__ import annotations

from .app import Response


def _not_implemented(message: str) -> dict:
    return {"error": {"message": message, "type": "not_implemented_error"}}


async def speech_handler(request):
    return Response.json(_not_implemented(
        "text-to-speech is not implemented yet (no TTS model support)"), 501)


async def transcriptions_handler(request):
    return Response.json(_not_implemented(
        "audio transcription is not implemented yet (no ASR model support)"), 501)
