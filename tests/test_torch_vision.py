"""Port parity: the image path of blazr_tpu_torch (its own PNG and baseline
JPEG decoders, ``preprocess_image``, the mel spectrogram, the vision tower
and the mmproj loader) against Pillow, the JAX package and transformers on
the CPU.

The images in ``tests/data/vision_*`` are 64×48: a smooth colour field plus
N(0, 10) noise from ``numpy.random.default_rng(16)``, saved with Pillow 12
as PNG (RGB, L, P, LA, RGBA), baseline JPEG at quality 90 (4:4:4, 4:2:2,
4:2:0, greyscale), a progressive JPEG and a GIF. Tolerances: PNG decodes
exactly; JPEG within 2 levels of Pillow's (libjpeg's integer IDCT, fancy
upsampling and colour tables are followed: 0 measured); ``preprocess_image``
within 0.031 of the JAX one in normalised pixels (two 8-bit levels over
CLIP's smallest std: Pillow's fixed-point bicubic passes against
``interpolate(..., antialias=True)``, each pass rounded to 8 bits as
Pillow's is; under 1% of pixels differ, by one level, rarely two); the tower within 1e-5 of the JAX
``encode_images`` at its defaults and 1e-4 of transformers'
``get_image_features`` with ``quick_gelu`` and feature layer −2."""

import io
import struct
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from blazr_tpu.config.model_config import VisionConfig as JVisionConfig
from blazr_tpu.formats.gguf import GgmlType, write_gguf
from blazr_tpu.loader import vision as jvision
from blazr_tpu.models.vision import encode_images as jax_encode
from blazr_tpu.models.vision import init_vision_params
from blazr_tpu.utils import preprocess as jpre
from blazr_tpu_torch.config.model_config import VisionConfig, vision_config_from_hf
from blazr_tpu_torch.formats.gguf import Gguf
from blazr_tpu_torch.loader import vision as tvision
from blazr_tpu_torch.loader.varmap import VarMap
from blazr_tpu_torch.models.vision import encode_images, vision_flops
from blazr_tpu_torch.utils import preprocess as tpre
from blazr_tpu_torch.utils.preprocess import MultimodalError

from test_multimodal import _mmproj_tensors

DATA = Path(__file__).resolve().parent / "data"
REPO = Path(__file__).resolve().parent.parent
PNGS = ["vision_rgb.png", "vision_l.png", "vision_p.png", "vision_la.png", "vision_rgba.png"]
JPEGS = ["vision_444.jpg", "vision_422.jpg", "vision_420.jpg", "vision_gray.jpg"]
CPU = "cpu"


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _png_with_filters(px: np.ndarray, interlace: int = 0) -> bytes:
    """An RGB PNG whose rows cycle through the five filter types."""
    h, w, _ = px.shape
    x = px.astype(np.int32)
    rows = []
    for r in range(h):
        t = r % 5
        cur = x[r]
        up = x[r - 1] if r else np.zeros_like(cur)
        left = np.vstack([np.zeros((1, 3), np.int32), cur[:-1]])
        ul = np.vstack([np.zeros((1, 3), np.int32), up[:-1]])
        pred = [np.zeros_like(cur), left, up, (left + up) >> 1,
                tpre._paeth(left, up, ul)][t]
        rows.append(bytes([t]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, interlace)
    return (tpre.PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PNGS + ["five-filters"])
def test_png_decodes_as_pillow(name):
    if name == "five-filters":
        data = _png_with_filters(np.random.default_rng(1).integers(0, 256, (23, 31, 3)))
    else:
        data = (DATA / name).read_bytes()
    got = tpre.decode_rgb(data)
    assert got.dtype == np.uint8 and np.array_equal(got, _pillow(data))


@pytest.mark.parametrize("name", JPEGS)
def test_jpeg_decodes_as_pillow(name):
    data = (DATA / name).read_bytes()
    got = tpre.decode_rgb(data).astype(int)
    ref = _pillow(data).astype(int)
    assert got.shape == ref.shape and np.abs(got - ref).max() <= 2


def _png_16bit() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.arange(64 * 48, dtype=np.uint16).reshape(48, 64)).save(buf, "PNG")
    return buf.getvalue()


@pytest.mark.parametrize("kind,match", [
    ("vision.gif", "GIF"), ("vision_progressive.jpg", "progressive"),
    ("interlaced", "interlaced"), ("16-bit", "bit depth 16"), ("webp", "WebP"),
    ("junk", "unrecognised")])
def test_unsupported_images_are_refused(kind, match):
    """Refused from the header, before any pixel is decoded (the JAX package
    decodes these through Pillow: ROADMAP §C)."""
    data = {"interlaced": lambda: _png_with_filters(np.zeros((4, 4, 3), np.uint8), 1),
            "16-bit": _png_16bit, "webp": lambda: b"RIFF\0\0\0\0WEBPVP8 ",
            "junk": lambda: b"not an image"}.get(kind, lambda: (DATA / kind).read_bytes())()
    with pytest.raises(MultimodalError, match=match):
        tpre.check_image(data)
    with pytest.raises(MultimodalError, match=match):
        tpre.preprocess_image(data, 32)


def _sof0(w: int, h: int) -> bytes:
    """A greyscale baseline frame header."""
    return b"\xff\xc0\x00\x0b\x08" + struct.pack(">HH", h, w) + b"\x01\x01\x11\x00"


@pytest.mark.parametrize("kind", ["jpeg", "png"])
def test_oversized_images_are_refused_from_the_header(kind):
    """A header that declares 65535×65535 pixels is refused before anything
    is allocated (Pillow's decompression-bomb limit, MAX_PIXELS)."""
    if kind == "jpeg":
        data = b"\xff\xd8" + _sof0(65535, 65535) + b"\xff\xd9"
    else:
        data = (tpre.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 65535, 65535,
                                                                  8, 2, 0, 0, 0))
                + _chunk(b"IEND", b""))
    for fn in (tpre.check_image, tpre.decode_rgb, lambda d: tpre.preprocess_image(d, 32)):
        with pytest.raises(MultimodalError, match="exceeds the limit"):
            fn(data)


def test_png_inflates_no_further_than_its_rows():
    """A 64×64 PNG whose IDAT inflates to 64 MiB of zeros decodes from its
    first rows, without inflating the rest."""
    import tracemalloc

    z = zlib.compressobj()
    idat = b"".join(z.compress(bytes(1 << 20)) for _ in range(64)) + z.flush()
    data = (tpre.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 64, 64, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))
    tracemalloc.start()
    try:
        got = tpre.decode_png(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert got.shape == (64, 64, 3) and not got.any()
    assert peak < (4 << 20), peak


@pytest.mark.parametrize("case,code", [
    ("dqt-truncated", -4), ("dqt-truncated-last", -4), ("dri-short", -4),
    ("sos-short", -4), ("frame-too-large", -6)])
def test_jpeg_decoder_refuses_bad_segments(case, code):
    """``native/jpeg.cpp`` reads no byte outside a marker segment and
    allocates no plane for a frame above MAX_PIXELS: each case returns its
    error code (the headers pass ``check_image``'s walk where they can)."""
    import ctypes

    from blazr_tpu_torch.native import load_library

    soi, eoi = b"\xff\xd8", b"\xff\xd9"
    data = {
        "dqt-truncated": soi + b"\xff\xdb\x00\x0d\x00" + bytes(10) + _sof0(8, 8) + eoi,
        "dqt-truncated-last": soi + b"\xff\xdb\x00\x03\x00",
        "dri-short": soi + b"\xff\xdd\x00\x02" + _sof0(8, 8) + eoi,
        "sos-short": soi + _sof0(8, 8) + b"\xff\xda\x00\x02",
        "frame-too-large": soi + _sof0(65535, 65535) + eoi,
    }[case]
    lib = load_library("jpeg")
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                ctypes.c_size_t]
    buf = ctypes.create_string_buffer(8 * 8 * 3)
    assert lib.jpeg_decode(data, len(data), buf, len(buf)) == code
    if case in ("dqt-truncated", "dri-short"):
        with pytest.raises(MultimodalError, match="corrupt"):
            tpre.decode_jpeg(data)


@pytest.mark.parametrize("name,size", [("vision_rgb.png", 32), ("vision_420.jpg", 32),
                                       ("vision_p.png", 56), ("vision_444.jpg", 112)])
def test_preprocess_image_matches_jax(name, size):
    """Shrunk (32), cropped and enlarged (112) against the JAX function
    (Pillow's decode and bicubic resize)."""
    data = (DATA / name).read_bytes()
    got, ref = tpre.preprocess_image(data, size), jpre.preprocess_image(data, size)
    assert got.shape == ref.shape == (3, size, size) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 0.031


def test_decode_needs_no_pillow():
    """PNG and JPEG decode and preprocess with PIL unimportable (the card's
    machine has no Pillow)."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules['PIL'] = None
        from blazr_tpu_torch.utils.preprocess import preprocess_image
        for name in ('vision_rgb.png', 'vision_420.jpg'):
            out = preprocess_image(open({str(DATA)!r} + '/' + name, 'rb').read(), 32)
            assert out.shape == (3, 32, 32)
        assert 'PIL' not in {{k.split('.')[0] for k, v in sys.modules.items() if v}}
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("n", [16000, 2000])
def test_mel_spectrogram_matches_jax(n):
    samples = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 0.1
    np.testing.assert_allclose(tpre.compute_mel_spectrogram(samples),
                               jpre.compute_mel_spectrogram(samples), atol=1e-5)
    np.testing.assert_array_equal(tpre.mel_filterbank(80, 400, 16000),
                                  jpre.mel_filterbank(80, 400, 16000))


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

TINY = dict(hidden_size=32, num_layers=2, num_heads=4, image_size=32, patch_size=8,
            intermediate_size=64, projection_dim=64)


def _jax_params(post_norm: bool):
    jcfg = JVisionConfig(**TINY)
    params = init_vision_params(jcfg, None)
    rng = np.random.default_rng(5)
    for p in params["layers"]:                  # biases and norms away from 0 and 1
        for k in ("norm1", "norm2"):
            p[k] = jnp.asarray(1 + 0.1 * rng.standard_normal(32), jnp.float32)
        for k in ("q_bias", "fc1_bias"):
            p[k] = jnp.asarray(0.02 * rng.standard_normal(p[k].shape), jnp.float32)
    if post_norm:
        params["post_norm"] = jnp.asarray(1 + 0.1 * rng.standard_normal(32), jnp.float32)
        params["post_norm_bias"] = jnp.asarray(0.02 * rng.standard_normal(32), jnp.float32)
    return jcfg, params


@pytest.mark.parametrize("post_norm", [False, True])
def test_encode_images_matches_jax(post_norm):
    """At the JAX defaults (exact GELU, every layer, the post-norm, CLS
    dropped), on the weights carried across by ``vision_params_from_jax``."""
    jcfg, jparams = _jax_params(post_norm)
    pixels = np.random.default_rng(2).standard_normal((2, 3, 32, 32)).astype(np.float32)
    ref = np.asarray(jax_encode(jparams, jcfg, jnp.asarray(pixels)))
    tparams = tvision.vision_params_from_jax(jax.tree.map(np.asarray, jparams), CPU)
    got = encode_images(tparams, VisionConfig(**TINY), torch.from_numpy(pixels)).numpy()
    assert got.shape == ref.shape == (2, 16, 64)
    assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


def _hf_llava(layers: int = 3):
    from transformers import CLIPVisionConfig, LlamaConfig, LlavaConfig
    from transformers import LlavaForConditionalGeneration

    torch.manual_seed(0)
    vc = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=layers,
                          num_attention_heads=4, image_size=32, patch_size=8,
                          hidden_act="quick_gelu", projection_dim=16)
    tc = LlamaConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                     num_attention_heads=4, vocab_size=256)
    cfg = LlavaConfig(vision_config=vc, text_config=tc, vision_feature_layer=-2,
                      vision_feature_select_strategy="default", image_token_index=255)
    model = LlavaForConditionalGeneration(cfg).eval()
    with torch.no_grad():                 # LayerNorms and biases away from 1 and 0
        for name, p in model.named_parameters():
            if "vision_tower" in name or "multi_modal_projector" in name:
                if name.endswith("bias") or "norm" in name:
                    p.add_(0.05 * torch.randn_like(p))
    return model, cfg


def _published_names(model) -> VarMap:
    """The tower and projector under llava-hf's published names
    (``vision_tower.vision_model.*``, ``multi_modal_projector.linear_{1,2}.*``)."""
    vm = VarMap()
    for k, v in model.state_dict().items():
        for new, old in (("vision_tower.", "model.vision_tower."),
                         ("multi_modal_projector.", "model.multi_modal_projector.")):
            if k.startswith(old):
                vm.insert(new + k[len(old):], v.detach().clone())
    return vm


def test_tower_follows_transformers():
    """``quick_gelu`` and ``vision_feature_layer`` −2 (no post-norm, CLS
    dropped) as the config names them: the port equals
    ``get_image_features``; the JAX tower on the same weights (exact GELU,
    every layer and the post-norm) does not (ROADMAP §C)."""
    model, cfg = _hf_llava()
    vcfg = vision_config_from_hf(cfg.vision_config.to_dict(), cfg.to_dict())
    assert (vcfg.hidden_act, vcfg.feature_layer) == ("quick_gelu", -2)
    params = tvision.build_vision_params(_published_names(model), vcfg, CPU)
    assert vcfg.projection_dim == 64 and params["post_norm"] is not None
    pixels = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ref = model.get_image_features(pixels, vision_feature_layer=-2,
                                       vision_feature_select_strategy="default")
    ref = ref if isinstance(ref, torch.Tensor) else torch.stack(list(ref))
    got = encode_images(params, vcfg, pixels)
    assert got.shape == ref.shape == (2, 16, 64)
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-4 * scale
    jax_way = encode_images(params, VisionConfig(**dict(TINY, num_layers=3)), pixels)
    assert (jax_way - ref).abs().max().item() > 1e-2 * scale


def test_vision_flops_count_the_tower():
    """LLaVA-1.5's CLIP ViT-L/14-336 at feature layer −2: 23 of 24 blocks
    and the projector, about 0.4 TFLOP an image."""
    vcfg = VisionConfig(hidden_size=1024, num_layers=24, num_heads=16, image_size=336,
                        patch_size=14, intermediate_size=4096, projection_dim=4096,
                        hidden_act="quick_gelu", feature_layer=-2)
    assert 3.5e11 < vision_flops(vcfg) < 4.5e11


# ---------------------------------------------------------------------------
# the mmproj loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "v.enc.blk.0.attn_q.weight", "v.blk.11.attn_k.bias", "v.enc.blk.5.attn_out.weight",
    "v.blk.3.ffn_down.weight", "v.blk.3.ffn_up.bias", "v.blk.0.ln1.weight",
    "v.patch_embd.weight", "v.class_embd", "v.position_embd.weight", "v.pre_ln.weight",
    "v.post_ln.bias", "mm.0.weight", "mm.2.bias", "other.tensor"])
def test_remap_mmproj_names_match_jax(name):
    assert tvision.remap_mmproj_name(name) == jvision.remap_mmproj_name(name)


def _flat(tree, prefix="") -> dict:
    """{path: tensor} of a params tree (None leaves left out)."""
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items() for k, v in _flat(t, f"{prefix}{n}.").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{prefix}{i}.").items()}
    return {} if tree is None else {prefix: tree}


def test_mmproj_loader_matches_jax(tmp_path):
    """The JAX test's mmproj tensors in a GGUF file: the same config, the
    same remapped names, and the same tower params (ffn_down/ffn_up
    swapped by shape), so ``encode_images`` agrees at 1e-5."""
    tensors = _mmproj_tensors(np.random.default_rng(0))
    path = tmp_path / "mmproj-model-f32.gguf"
    write_gguf(path, {"clip.vision.image_size": 32, "clip.vision.patch_size": 8,
                      "clip.vision.embedding_length": 32, "clip.vision.block_count": 2,
                      "clip.vision.head_count": 4, "clip.vision.feed_forward_length": 64},
               {k: (v, GgmlType.F32, v.shape) for k, v in tensors.items()})
    assert tvision.find_mmproj(tmp_path) == jvision.find_mmproj(tmp_path) == path
    with Gguf.open(path) as g:
        tcfg = tvision.detect_vision_config_from_mmproj(g)
    from blazr_tpu.formats.gguf import Gguf as JGguf
    with JGguf.open(path) as g:
        jcfg = jvision.detect_vision_config_from_mmproj(g)
    assert {k: getattr(tcfg, k) for k in TINY} == {k: getattr(jcfg, k) for k in TINY}
    tvm, jvm = tvision.varmap_from_mmproj(path), jvision.varmap_from_mmproj(path)
    assert tvm.names() == jvm.names()
    tp = tvision.build_vision_params(tvm, tcfg, CPU)
    jp = jvision.build_vision_params(jvm, jcfg)
    assert tcfg.projection_dim == jcfg.projection_dim == 64
    carried = tvision.vision_params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    assert _flat(tp).keys() == _flat(carried).keys()
    for k, v in _flat(tp).items():
        np.testing.assert_array_equal(v.numpy(), _flat(carried)[k].numpy(), err_msg=k)
    pixels = np.random.default_rng(4).standard_normal((1, 3, 32, 32)).astype(np.float32)
    ref = np.asarray(jax_encode(jp, jcfg, jnp.asarray(pixels)))
    got = encode_images(tp, tcfg, torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_vision_config_defaults_are_the_jax_tower():
    """A vision_config that names nothing gets the JAX tower; a LLaVA config
    that names the activation and layer gets them; an activation, strategy
    or layer list that no served configuration has raises."""
    vc = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
          "image_size": 32, "patch_size": 8, "intermediate_size": 64}
    plain = vision_config_from_hf(vc)
    assert (plain.hidden_act, plain.feature_layer) == ("gelu", None)
    named = vision_config_from_hf(dict(vc, hidden_act="quick_gelu"),
                                  {"vision_feature_layer": -2,
                                   "vision_feature_select_strategy": "default"})
    assert (named.hidden_act, named.feature_layer) == ("quick_gelu", -2)
    with pytest.raises(NotImplementedError, match="'full'"):
        vision_config_from_hf(vc, {"vision_feature_select_strategy": "full"})
    with pytest.raises(NotImplementedError, match="gelu_new"):
        vision_config_from_hf(dict(vc, hidden_act="gelu_new"))
    with pytest.raises(NotImplementedError, match="list"):
        vision_config_from_hf(vc, {"vision_feature_layer": [-2, -5]})
