"""Multimodal preprocessing: image → pixel tensor, audio → mel spectrogram.

Counterpart of ``blazr_tpu/utils/preprocess.py``. The JAX package decodes
images with Pillow; the card's machine has no Pillow, so the port decodes
them itself, and the formats it takes are checked from the header before
any pixel is decoded (``check_image``):

* PNG with ``zlib`` and numpy: 8-bit greyscale, RGB, palette, grey+alpha
  and RGBA, not interlaced, all five row filters (undone on anti-diagonal
  wavefronts: a pixel needs its left, upper and upper-left neighbours, so
  one numpy step takes every pixel of one diagonal);
* baseline JPEG with ``native/jpeg.cpp`` (built with g++ on first use):
  libjpeg's integer IDCT, fancy upsampling and colour tables, as Pillow
  decodes it.

Anything else (GIF, WebP, interlaced or 16-bit PNG, progressive JPEG)
raises ``MultimodalError``, which the server answers with 400; the JAX
package decodes those through Pillow (ROADMAP §C). So does an image of
more than ``MAX_PIXELS``, refused from its header before anything is
allocated (Pillow's decompression-bomb limit, which the JAX package gets
from Pillow), and a PNG's data is inflated only as far as its header's
rows need. Resizing follows
Pillow's bicubic filter through ``torch.nn.functional.interpolate(...,
mode="bicubic", antialias=True)``, rounded to 8 bits as Pillow's is. The
mel spectrogram is a numpy copy of the JAX one.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional

import numpy as np

# CLIP normalization constants (public).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type → samples a pixel (8-bit): grey, RGB, palette, grey+alpha, RGBA.
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Pillow's decompression-bomb limit: Image.MAX_IMAGE_PIXELS (89,478,485)
# twice over, above which Pillow refuses to open an image.
MAX_PIXELS = 2 * 89_478_485
# jpeg.cpp's error codes.
JPEG_ERRORS = {-1: "not a JPEG file", -2: "progressive JPEG is not supported",
               -3: "unsupported JPEG (lossless, arithmetic-coded, 12-bit, CMYK or "
                   "non-interleaved)", -4: "corrupt JPEG data", -5: "output buffer too small",
               -6: "JPEG image too large", -7: "JPEG decoder out of memory"}


class MultimodalError(ValueError):
    """A media part that cannot be decoded → 400 invalid_request_error
    (the JAX ``server/multimodal.py`` class; the server re-exports it)."""


# ---------------------------------------------------------------------------
# header check
# ---------------------------------------------------------------------------

def _png_chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) < length:
            raise MultimodalError("truncated PNG chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length


def _check_pixels(w: int, h: int) -> None:
    if w * h > MAX_PIXELS:
        raise MultimodalError(f"image of {w}x{h} pixels exceeds the limit of {MAX_PIXELS}")


def _png_header(data: bytes) -> tuple[int, int, int]:
    """(width, height, colour type) of a PNG this decoder takes."""
    if len(data) < 33 or data[12:16] != b"IHDR":
        raise MultimodalError("PNG without an IHDR header")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    if interlace:
        raise MultimodalError("interlaced PNG is not supported")
    if depth != 8 or ctype not in PNG_CHANNELS:
        raise MultimodalError(f"PNG of bit depth {depth}, colour type {ctype} is not "
                              "supported (8-bit grey, RGB, palette, grey+alpha, RGBA)")
    if comp or filt or not w or not h:
        raise MultimodalError("malformed PNG header")
    _check_pixels(w, h)
    return w, h, ctype


def _jpeg_header(data: bytes) -> tuple[int, int]:
    """(width, height) of a baseline JPEG, from its frame header."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise MultimodalError("corrupt JPEG marker stream")
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if m in (0xC0, 0xC1):
            if pos + 9 > len(data):
                raise MultimodalError("truncated JPEG frame header")
            h, w = struct.unpack(">HH", data[pos + 5:pos + 9])
            if data[pos + 4] != 8 or data[pos + 9] not in (1, 3):
                raise MultimodalError(JPEG_ERRORS[-3])
            _check_pixels(w, h)
            return w, h
        if m in (0xC2, 0xC6, 0xCA, 0xCE):
            raise MultimodalError(JPEG_ERRORS[-2])
        if 0xC3 <= m <= 0xCF and m not in (0xC4, 0xC8):
            raise MultimodalError(JPEG_ERRORS[-3])
        if m in (0xD9, 0xDA):
            break
        pos += 2 + length
    raise MultimodalError("JPEG without a frame header")


def check_image(data: bytes) -> tuple[str, int, int]:
    """(format, width, height) of an image this module decodes, read from
    its header alone; ``MultimodalError`` for any other format or variant."""
    if data.startswith(PNG_SIGNATURE):
        w, h, _ = _png_header(data)
        return "png", w, h
    if data.startswith(b"\xff\xd8\xff"):
        return ("jpeg",) + _jpeg_header(data)
    if data.startswith(b"GIF8"):
        raise MultimodalError("GIF images are not supported (PNG or baseline JPEG)")
    if data.startswith(b"RIFF") and data[8:12] == b"WEBP":
        raise MultimodalError("WebP images are not supported (PNG or baseline JPEG)")
    raise MultimodalError("unrecognised image format (PNG or baseline JPEG)")


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filters: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """PNG rows [H, W, C] (filtered bytes) and their filter types [H] → the
    reconstructed [H, W, C] uint8 samples. out[r, c] depends on out[r, c-1],
    out[r-1, c] and out[r-1, c-1], so the pixels of one anti-diagonal
    r + c = d are independent: H + W - 1 vectorized steps."""
    h, w, ch = rows.shape
    if not np.isin(filters, (0, 1, 2, 3, 4)).all():
        raise MultimodalError("PNG row with an unknown filter type")
    out = np.zeros((h + 1, w + 1, ch), np.int16)     # a zero row above, a zero column left
    x = rows.astype(np.int16)                        # sums stay within ±510
    f = filters.astype(np.int16)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        a, b, cc = out[r + 1, c], out[r, c + 1], out[r, c]
        t = f[r][:, None]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, _paeth(a, b, cc), 0))))
        out[r + 1, c + 1] = (x[r, c] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced PNG → [H, W, 3] uint8 RGB, as Pillow's
    ``convert("RGB")`` gives it (alpha dropped, the palette looked up)."""
    w, h, ctype = _png_header(data)
    ch = PNG_CHANNELS[ctype]
    idat, palette = [], None
    for kind, body in _png_chunks(data):
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    stride = w * ch
    try:                                     # no further than the rows need
        raw = zlib.decompressobj().decompress(b"".join(idat), h * (stride + 1))
    except zlib.error as e:
        raise MultimodalError(f"corrupt PNG data: {e}")
    if len(raw) < h * (stride + 1):
        raise MultimodalError("truncated PNG image data")
    lines = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(h, stride + 1)
    px = _unfilter(lines[:, 0], lines[:, 1:].reshape(h, w, ch))
    if ctype == 3:
        if palette is None:
            raise MultimodalError("palette PNG without a PLTE chunk")
        idx = px[..., 0]
        if idx.max() >= len(palette):
            raise MultimodalError("PNG palette index out of range")
        return palette[idx]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline JPEG → [H, W, 3] uint8 RGB, decoded by ``native/jpeg.cpp``."""
    from ..native import load_library

    w, h = _jpeg_header(data)
    lib = load_library("jpeg")
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                ctypes.c_size_t]
    lib.jpeg_decode.restype = ctypes.c_int
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.jpeg_decode(data, len(data), out.ctypes.data, out.nbytes)
    if rc:
        raise MultimodalError(JPEG_ERRORS.get(rc, f"JPEG decode failed ({rc})"))
    return out


def decode_rgb(data: bytes) -> np.ndarray:
    """PNG or baseline JPEG bytes → [H, W, 3] uint8 RGB."""
    kind, _, _ = check_image(data)
    return decode_png(data) if kind == "png" else decode_jpeg(data)


def resize_bicubic(rgb: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H, W, 3] uint8 → [height, width, 3] uint8: bicubic (a = −0.5) with
    Pillow's antialiasing support when shrinking, as Pillow's
    ``Image.resize(..., BICUBIC)``: the horizontal pass, then the vertical
    one, each rounded and clipped to 8 bits (a sharp edge overshoots, and
    Pillow clips between the passes)."""
    import torch
    import torch.nn.functional as F

    x = torch.from_numpy(np.ascontiguousarray(rgb)).permute(2, 0, 1)[None].float()
    for size in ((x.shape[2], width), (height, width)):
        if tuple(x.shape[2:]) != size:
            x = F.interpolate(x, size=size, mode="bicubic", align_corners=False,
                              antialias=True).round().clamp(0, 255)
    return x[0].permute(1, 2, 0).to(torch.uint8).numpy()


def preprocess_image(data: bytes, size: int = 336) -> np.ndarray:
    """Decode + shortest side resized to ``size`` + centre crop + CLIP
    normalisation → [3, size, size] f32 (the JAX ``preprocess_image``)."""
    img = decode_rgb(data)
    h, w = img.shape[:2]
    scale = size / min(w, h)
    img = resize_bicubic(img, max(size, round(w * scale)), max(size, round(h * scale)))
    h, w = img.shape[:2]
    left = (w - size) // 2
    top = (h - size) // 2
    img = img[top:top + size, left:left + size]
    arr = img.astype(np.float32) / 255.0                  # [H, W, 3]
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr.transpose(2, 0, 1)                          # [3, H, W]


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------

def hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m: np.ndarray | float) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft//2+1] (Slaney-style)."""
    fmax = fmax or sample_rate / 2
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sample_rate).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), dtype=np.float32)
    for i in range(n_mels):
        lo, c, hi = bins[i], bins[i + 1], bins[i + 2]
        for b in range(lo, min(c, fb.shape[1])):
            if c > lo:
                fb[i, b] = (b - lo) / (c - lo)
        for b in range(c, min(hi, fb.shape[1])):
            if hi > c:
                fb[i, b] = (hi - b) / (hi - c)
    return fb


def compute_mel_spectrogram(samples: np.ndarray, n_mels: int = 80,
                            sample_rate: int = 16000, n_fft: int = 400,
                            hop: int = 160) -> np.ndarray:
    """Whisper-style log-mel spectrogram → [n_mels, frames] f32."""
    samples = np.asarray(samples, dtype=np.float32)
    window = np.hanning(n_fft).astype(np.float32)
    n_frames = 1 + max(0, (len(samples) - n_fft)) // hop
    if n_frames < 1:
        samples = np.pad(samples, (0, n_fft - len(samples)))
        n_frames = 1
    frames = np.lib.stride_tricks.sliding_window_view(
        samples, n_fft)[::hop][:n_frames]
    spec = np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2   # [T, F]
    fb = mel_filterbank(n_mels, n_fft, sample_rate)
    mel = fb @ spec.T                                           # [n_mels, T]
    log_mel = np.log10(np.maximum(mel, 1e-10))
    log_mel = np.maximum(log_mel, log_mel.max() - 8.0)
    return ((log_mel + 4.0) / 4.0).astype(np.float32)
