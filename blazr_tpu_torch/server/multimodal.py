"""Multimodal message content: string-or-parts, image and audio decode.

Counterpart of ``blazr_tpu/server/multimodal.py``: OpenAI content arrays
(``{"type": "text"|"image_url"|"input_audio", ...}``), images from data
URIs, http(s) URLs or plain base64, MIME sniffing from magic bytes, and
audio (pcm16 and 16-bit PCM WAV) as f32 samples. The port's server is the
standard library's, so a URL is fetched with ``http.client`` on a worker
thread, behind a guard against addresses that are not public that the
JAX one (which checks the first URL's name, then lets its client resolve
it again and follow redirects anywhere) is not: every hop is checked and
connected to the address checked. The same ``MAX_MEDIA_BYTES`` cap. ``MultimodalError`` (from ``utils/preprocess.py``,
where the image decoders raise it too) becomes a 400.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
from typing import Any

import numpy as np

from ..utils.preprocess import MultimodalError

__all__ = ["MultimodalError", "content_text", "has_images", "has_audio", "image_urls",
           "audio_inputs", "b64_decode", "detect_image_mime", "decode_image",
           "decode_audio", "extract_media", "AUDIO_FORMATS", "MAX_MEDIA_BYTES"]


# ---------------------------------------------------------------------------
# MessageContent helpers (string-or-parts)
# ---------------------------------------------------------------------------

def content_text(content: Any) -> str:
    """All text parts, newline-joined."""
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "\n".join(p.get("text", "") for p in content
                         if isinstance(p, dict) and p.get("type") == "text")
    return str(content)


def _parts(content: Any) -> list[dict]:
    return content if isinstance(content, list) else []


def has_images(content: Any) -> bool:
    return any(isinstance(p, dict) and p.get("type") == "image_url"
               for p in _parts(content))


def has_audio(content: Any) -> bool:
    return any(isinstance(p, dict) and p.get("type") == "input_audio"
               for p in _parts(content))


def image_urls(content: Any) -> list[dict]:
    """Each entry: {"url": ..., "detail": "auto"|"low"|"high"}."""
    out = []
    for p in _parts(content):
        if isinstance(p, dict) and p.get("type") == "image_url":
            img = p.get("image_url")
            if isinstance(img, str):              # lenient: a bare string
                img = {"url": img}
            if not isinstance(img, dict) or "url" not in img:
                raise MultimodalError("image_url part missing 'url'")
            out.append({"url": img["url"], "detail": img.get("detail", "auto")})
    return out


def audio_inputs(content: Any) -> list[dict]:
    """Each entry: {"data": <b64>, "format": "wav"|"pcm16"|...}."""
    out = []
    for p in _parts(content):
        if isinstance(p, dict) and p.get("type") == "input_audio":
            a = p.get("input_audio")
            if not isinstance(a, dict) or "data" not in a or "format" not in a:
                raise MultimodalError("input_audio part requires 'data' and 'format'")
            out.append(a)
    return out


# ---------------------------------------------------------------------------
# base64 / image decode
# ---------------------------------------------------------------------------

def b64_decode(data: str) -> bytes:
    """Permissive base64: standard or URL-safe alphabet, padding optional."""
    s = "".join(data.split()).replace("-", "+").replace("_", "/")
    s += "=" * (-len(s) % 4)
    try:
        return base64.b64decode(s, validate=True)
    except (binascii.Error, ValueError) as e:
        raise MultimodalError(f"invalid base64: {e}")


def detect_image_mime(data: bytes) -> str:
    """MIME from magic bytes."""
    if data.startswith(b"\x89PNG"):
        return "image/png"
    if data.startswith(b"\xff\xd8\xff"):
        return "image/jpeg"
    if data.startswith(b"RIFF") and len(data) > 12 and data[8:12] == b"WEBP":
        return "image/webp"
    if data.startswith(b"GIF8"):
        return "image/gif"
    return "application/octet-stream"


# Remote media fetch cap (32 MiB — larger than any sane image/audio clip).
MAX_MEDIA_BYTES = 32 << 20


MAX_REDIRECTS = 5
REDIRECTS = (301, 302, 303, 307, 308)


def _public_address(host: str, port: int) -> str:
    """The address to connect to for ``host``: every address it resolves to
    must be public (not loopback, private, link-local, reserved, multicast
    or unspecified: cloud metadata endpoints live there), since the fetch is
    a server-side request on the user's behalf."""
    import ipaddress
    import socket

    try:
        infos = socket.getaddrinfo(host, port, type=socket.SOCK_STREAM)
    except (OSError, UnicodeError) as e:
        raise MultimodalError(f"cannot resolve media host {host}: {e}")
    addrs = []
    for info in infos:
        ip = ipaddress.ip_address(info[4][0])
        if ip.version == 6 and ip.ipv4_mapped is not None:
            ip = ip.ipv4_mapped
        if (ip.is_private or ip.is_loopback or ip.is_link_local or ip.is_reserved
                or ip.is_multicast or ip.is_unspecified):
            raise MultimodalError(f"refusing to fetch media from non-public address {host}")
        addrs.append(info[4][0])
    if not addrs:
        raise MultimodalError(f"cannot resolve media host {host}")
    return addrs[0]


def _connection(scheme: str, host: str, port: int, address: str):
    """An HTTP(S) connection to ``host`` that connects to ``address``, the
    one that was checked, and never resolves the name again (a second
    lookup could answer another address). The Host header, TLS's server
    name and its certificate check keep the name."""
    import http.client
    import socket
    import ssl

    if scheme == "https":
        conn = http.client.HTTPSConnection(host, port, timeout=30,
                                           context=ssl.create_default_context())
    else:
        conn = http.client.HTTPConnection(host, port, timeout=30)
    conn._create_connection = lambda addr, *a, **k: socket.create_connection(
        (address, addr[1]), *a, **k)
    return conn


def _fetch(url: str) -> tuple[bytes, str]:
    """GET ``url`` (30 s timeout a hop), read at most MAX_MEDIA_BYTES. Each
    hop, redirects included (at most MAX_REDIRECTS), goes through
    ``_public_address`` and connects to the address it checked."""
    from urllib.parse import urljoin, urlsplit

    try:
        for _ in range(MAX_REDIRECTS + 1):
            parts = urlsplit(url)
            if parts.scheme not in ("http", "https"):
                raise MultimodalError(f"refusing to fetch media from {url}")
            host = parts.hostname or ""
            port = parts.port or (443 if parts.scheme == "https" else 80)
            conn = _connection(parts.scheme, host, port, _public_address(host, port))
            try:
                target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
                conn.request("GET", target, headers={"Accept": "*/*"})
                resp = conn.getresponse()
                if resp.status in REDIRECTS and resp.getheader("Location"):
                    url = urljoin(url, resp.getheader("Location"))
                    continue
                if resp.status != 200:
                    raise MultimodalError(
                        f"image fetch failed with status {resp.status}: {url}")
                mime = resp.getheader("Content-Type", "image/png")
                data = b""
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        return data, mime
                    data += chunk
                    if len(data) > MAX_MEDIA_BYTES:
                        raise MultimodalError(
                            f"media exceeds {MAX_MEDIA_BYTES} byte limit")
            finally:
                conn.close()
        raise MultimodalError(f"more than {MAX_REDIRECTS} redirects fetching media")
    except MultimodalError:
        raise
    except Exception as e:
        raise MultimodalError(f"failed to fetch image from {url}: {e}")


async def decode_image(url: str) -> tuple[bytes, str]:
    """URL string → (raw image bytes, mime type): a ``data:`` URI, an
    http(s) URL (fetched on a worker thread), or plain base64."""
    if url.startswith("data:"):
        rest = url[len("data:"):]
        if "," not in rest:
            raise MultimodalError("invalid data URI: missing comma")
        meta, data = rest.split(",", 1)
        mime = meta.split(";")[0] or "image/png"
        return b64_decode(data), mime
    if url.startswith(("http://", "https://")):
        return await asyncio.to_thread(_fetch, url)
    data = b64_decode(url)
    return data, detect_image_mime(data)


# ---------------------------------------------------------------------------
# audio decode
# ---------------------------------------------------------------------------

AUDIO_FORMATS = ("pcm16", "wav", "mp3", "flac", "ogg")


def _pcm16_to_f32(raw: bytes) -> np.ndarray:
    n = len(raw) // 2
    samples = np.frombuffer(raw[: n * 2], dtype="<i2").astype(np.float32)
    return samples / 32768.0


def _wav_to_pcm16(raw: bytes) -> bytes:
    """The data chunk of a 16-bit PCM WAV, found by walking word-aligned
    chunks (encoders put JUNK/LIST chunks before fmt)."""
    if len(raw) < 44:
        raise MultimodalError("WAV data too short for valid header")
    if raw[0:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise MultimodalError("invalid WAV header: missing RIFF/WAVE signature")
    fmt_seen = False
    data_chunk = None
    off = 12
    while off + 8 <= len(raw):
        cid = raw[off:off + 4]
        size = int.from_bytes(raw[off + 4:off + 8], "little")
        start = off + 8
        if cid == b"fmt ":
            if start + 16 > len(raw):
                raise MultimodalError("WAV fmt chunk truncated")
            audio_fmt = int.from_bytes(raw[start:start + 2], "little")
            if audio_fmt != 1:
                raise MultimodalError(f"unsupported WAV audio format {audio_fmt}: only "
                                      "PCM (1) is supported")
            bits = int.from_bytes(raw[start + 14:start + 16], "little")
            if bits != 16:
                raise MultimodalError(f"unsupported WAV bit depth {bits}: only 16-bit "
                                      "is supported")
            fmt_seen = True
        elif cid == b"data":
            data_chunk = raw[start: min(start + size, len(raw))]
        off = start + size
        if off % 2:
            off += 1
    if not fmt_seen:
        raise MultimodalError("WAV file missing 'fmt ' chunk")
    if data_chunk is None:
        raise MultimodalError("WAV file missing 'data' chunk")
    return data_chunk


def decode_audio(input_audio: dict) -> np.ndarray:
    """InputAudio payload → f32 samples in [-1, 1]: pcm16 and wav; the
    compressed formats are refused."""
    fmt = input_audio.get("format", "")
    if fmt not in AUDIO_FORMATS:
        raise MultimodalError(f"Unsupported audio format '{fmt}'. Supported: "
                              + ", ".join(AUDIO_FORMATS))
    raw = b64_decode(input_audio.get("data", ""))
    if fmt == "pcm16":
        return _pcm16_to_f32(raw)
    if fmt == "wav":
        return _pcm16_to_f32(_wav_to_pcm16(raw))
    raise MultimodalError(f"Audio format '{fmt}' is not yet supported. "
                          "Currently supported: pcm16, wav")


# ---------------------------------------------------------------------------
# request-level extraction
# ---------------------------------------------------------------------------

async def extract_media(messages: list[dict]) -> tuple[list[bytes], list[np.ndarray]]:
    """Decode every image and audio part across all messages; raises
    MultimodalError on any failure."""
    images: list[bytes] = []
    audio: list[np.ndarray] = []
    for m in messages:
        content = m.get("content")
        for img in image_urls(content):
            data, _mime = await decode_image(img["url"])
            images.append(data)
        for a in audio_inputs(content):
            audio.append(decode_audio(a))
    return images, audio
