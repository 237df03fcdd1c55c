"""OpenAI-compatible HTTP server (standard-library asyncio)."""

from .app import create_app, run_server, serve

__all__ = ["create_app", "run_server", "serve"]
