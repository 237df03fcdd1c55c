"""Vision tower / mmproj loading for multimodal checkpoints.

Counterpart of ``blazr_tpu/loader/vision.py``: a GGUF ``mmproj`` sidecar
(llama.cpp's clip names, ``v.*``/``mm.*``) or an HF LLaVA checkpoint's
tower (``vision_tower.vision_model.*`` + ``multi_modal_projector.*``) is
normalized into the parameter dict of ``models/vision.py::encode_images``,
f32 on the model's device, through the port's GGUF reader and VarMap. An
mmproj file is read as the JAX package reads it: its clip metadata names
no activation or feature layer this loader takes (ROADMAP §C, open
questions), so the tower keeps ``VisionConfig``'s defaults there.
``vision_params_from_jax`` carries a JAX vision pytree across, so tests
give both packages the same weights.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..config.model_config import UniversalConfig, VisionConfig
from ..formats.gguf import Gguf
from ..utils.device import DeviceLike, resolve_device
from .varmap import VarMap

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# mmproj discovery + metadata
# ---------------------------------------------------------------------------

def find_mmproj(model_path: str | Path) -> Optional[Path]:
    """A GGUF mmproj sidecar next to the model (llama.cpp's convention:
    ``mmproj-*.gguf`` / ``*mmproj*.gguf``)."""
    p = Path(model_path)
    d = p if p.is_dir() else p.parent
    if not d.exists():
        return None
    for f in sorted(d.glob("*.gguf")):
        if "mmproj" in f.name.lower():
            return f
    return None


def detect_vision_config_from_mmproj(g: Gguf) -> Optional[VisionConfig]:
    """``clip.vision.*`` metadata → VisionConfig."""
    meta = g.metadata()
    image_size = meta.get_u32("clip.vision.image_size")
    patch_size = meta.get_u32("clip.vision.patch_size")
    hidden = meta.get_u32("clip.vision.embedding_length")
    layers = meta.get_u32("clip.vision.block_count")
    heads = meta.get_u32("clip.vision.head_count")
    if None in (image_size, patch_size, hidden, layers, heads):
        return None
    inter = meta.get_u32("clip.vision.feed_forward_length") or hidden * 4
    proj = meta.get_u32("clip.vision.projection_dim") or hidden
    return VisionConfig(hidden_size=hidden, num_layers=layers, num_heads=heads,
                        image_size=image_size, patch_size=patch_size,
                        intermediate_size=inter, projection_dim=proj)


# ---------------------------------------------------------------------------
# GGUF mmproj tensor remap
# ---------------------------------------------------------------------------

def remap_mmproj_name(name: str) -> str:
    """GGUF clip tensor name → HF-style ``vision_model.*`` name; both
    ``v.enc.blk.`` and llama.cpp's ``v.blk.`` encoder prefixes."""
    for pre in ("v.enc.blk.", "v.blk."):
        if name.startswith(pre):
            rest = name[len(pre):]
            rest = (rest.replace("attn_q.", "q_proj.")
                        .replace("attn_k.", "k_proj.")
                        .replace("attn_v.", "v_proj.")
                        .replace("attn_out.", "out_proj.")
                        .replace("ln1.", "layer_norm1.")
                        .replace("ln2.", "layer_norm2.")
                        .replace("ffn_down.", "fc1.")
                        .replace("ffn_up.", "fc2."))
            return f"vision_model.encoder.layers.{rest}"
    if name.startswith("v."):
        rest = (name[2:].replace("patch_embd", "patch_embedding")
                        .replace("position_embd.weight", "position_embedding")
                        .replace("position_embd", "position_embedding")
                        .replace("class_embd", "class_embedding")
                        .replace("pre_ln", "ln_pre")
                        .replace("post_ln", "ln_post"))
        return f"vision_model.{rest}"
    if name.startswith("mm."):
        rest = name[3:]
        if rest.startswith("0."):
            rest = "linear1." + rest[2:]
        elif rest.startswith("2."):
            rest = "linear2." + rest[2:]
        return f"vision_model.projector.{rest}"
    return f"vision_model.{name}"


def varmap_from_mmproj(path: str | Path) -> VarMap:
    """A GGUF mmproj file, remapped, as dense f32 CPU tensors in HF
    orientation (vision weights are small: always dense)."""
    vm = VarMap()
    with Gguf.open(path) as g:
        for name in g.tensor_names():
            vm.insert(remap_mmproj_name(name), torch.from_numpy(
                np.ascontiguousarray(g.load_numpy(name), dtype=np.float32)))
    logger.info("loaded %d tensors from mmproj %s", len(vm), path)
    return vm


# ---------------------------------------------------------------------------
# vision params builder (GGUF-remapped and HF names)
# ---------------------------------------------------------------------------

def _get(vm: VarMap, *names: str, required: bool = True) -> Optional[torch.Tensor]:
    for n in names:
        if n in vm:
            return torch.as_tensor(vm.take(n)).to(torch.float32)
    if required:
        raise KeyError(f"Missing vision tensor (tried {names})")
    return None


def build_vision_params(vm: VarMap, vcfg: VisionConfig,
                        device: DeviceLike = None) -> dict[str, Any]:
    """HF-convention vision tensors → the ``encode_images`` params, f32 on
    ``device``: the GGUF-remapped names (``vision_model.*``,
    ``vision_model.projector.linear{1,2}``) or HF LLaVA's
    (``vision_tower.vision_model.*``, ``multi_modal_projector.linear_{1,2}``).
    Linear weights arrive [out, in] and are stored [in, out]; fc1 and fc2
    swap by shape where a GGUF file's ffn_down/up names land swapped.
    Sets ``vcfg.projection_dim`` to the projector's output width."""
    dev = resolve_device(device)
    P = ("vision_model.", "vision_tower.vision_model.")

    def g(suffixes, required=True):
        if isinstance(suffixes, str):
            suffixes = (suffixes,)
        return _get(vm, *[p + s for s in suffixes for p in P], required=required)

    def lin(w):                                   # [out, in] → [in, out]
        return None if w is None else w.t().contiguous().to(dev)

    def vec(w):
        return None if w is None else w.to(dev)

    patch = g(("embeddings.patch_embedding.weight", "patch_embedding.weight"))
    h = patch.shape[0]
    # Conv kernel [h, 3, ps, ps] → [3*ps*ps, h] in the unfold's order.
    patch = patch.reshape(h, -1).t().contiguous()
    cls = g(("embeddings.class_embedding", "class_embedding"), required=False)
    pos = g(("embeddings.position_embedding.weight", "position_embedding"))

    layers = []
    for i in range(vcfg.num_layers):
        def lg(suffixes, required=True, _i=i):
            if isinstance(suffixes, str):
                suffixes = (suffixes,)
            return g(tuple(f"encoder.layers.{_i}." + s for s in suffixes), required)

        fc1 = lg(("mlp.fc1.weight", "fc1.weight"))
        fc2 = lg(("mlp.fc2.weight", "fc2.weight"))
        fc1_b = lg(("mlp.fc1.bias", "fc1.bias"), required=False)
        fc2_b = lg(("mlp.fc2.bias", "fc2.bias"), required=False)
        if fc1.shape[1] != h:                     # GGUF ffn_down/up swapped
            fc1, fc2 = fc2, fc1
            fc1_b, fc2_b = fc2_b, fc1_b
        layers.append({
            "norm1": vec(lg(("layer_norm1.weight", "ln1.weight"))),
            "norm1_bias": vec(lg(("layer_norm1.bias", "ln1.bias"), required=False)),
            "norm2": vec(lg(("layer_norm2.weight", "ln2.weight"))),
            "norm2_bias": vec(lg(("layer_norm2.bias", "ln2.bias"), required=False)),
            "q": lin(lg(("self_attn.q_proj.weight", "q_proj.weight"))),
            "k": lin(lg(("self_attn.k_proj.weight", "k_proj.weight"))),
            "v": lin(lg(("self_attn.v_proj.weight", "v_proj.weight"))),
            "o": lin(lg(("self_attn.out_proj.weight", "out_proj.weight"))),
            "q_bias": vec(lg(("self_attn.q_proj.bias", "q_proj.bias"), required=False)),
            "k_bias": vec(lg(("self_attn.k_proj.bias", "k_proj.bias"), required=False)),
            "v_bias": vec(lg(("self_attn.v_proj.bias", "v_proj.bias"), required=False)),
            "o_bias": vec(lg(("self_attn.out_proj.bias", "out_proj.bias"), required=False)),
            "fc1": lin(fc1), "fc1_bias": vec(fc1_b),
            "fc2": lin(fc2), "fc2_bias": vec(fc2_b),
        })

    proj_fc1 = _get(vm, "vision_model.projector.linear1.weight",
                    "multi_modal_projector.linear_1.weight",
                    "multi_modal_projector.linear1.weight")
    proj_fc2 = _get(vm, "vision_model.projector.linear2.weight",
                    "multi_modal_projector.linear_2.weight",
                    "multi_modal_projector.linear2.weight")
    # The projector's output IS the LLM embedding width (HF CLIP's
    # projection_dim is the contrastive head, not LLaVA's projector).
    vcfg.projection_dim = proj_fc2.shape[0]
    return {
        "patch_embed": patch.to(dev),
        "cls_token": None if cls is None else cls.reshape(1, -1).to(dev),
        "pos_embed": pos.to(dev),
        "pre_norm": vec(g(("pre_layrnorm.weight", "pre_layernorm.weight", "ln_pre.weight"),
                          required=False)),
        "pre_norm_bias": vec(g(("pre_layrnorm.bias", "pre_layernorm.bias", "ln_pre.bias"),
                               required=False)),
        "post_norm": vec(g(("post_layernorm.weight", "ln_post.weight"), required=False)),
        "post_norm_bias": vec(g(("post_layernorm.bias", "ln_post.bias"), required=False)),
        "layers": layers,
        "proj_fc1": lin(proj_fc1),
        "proj_fc1_bias": vec(_get(vm, "vision_model.projector.linear1.bias",
                                  "multi_modal_projector.linear_1.bias", required=False)),
        "proj_fc2": lin(proj_fc2),
        "proj_fc2_bias": vec(_get(vm, "vision_model.projector.linear2.bias",
                                  "multi_modal_projector.linear_2.bias", required=False)),
    }


def vision_params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """A JAX vision pytree with numpy leaves (``jax.tree.map(np.asarray,
    ...)``) → the same dict of f32 torch tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: vision_params_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [vision_params_from_jax(v, dev) for v in tree]
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(dev)


# ---------------------------------------------------------------------------
# top-level attach
# ---------------------------------------------------------------------------

def has_vision_tensors(vm: VarMap) -> bool:
    return any(n.startswith(("vision_tower.", "vision_model.")) for n in vm.names())


def attach_vision(model, model_cfg: UniversalConfig, source_path: str | Path,
                  vm: VarMap, mmproj_path: Optional[str | Path] = None) -> None:
    """Set ``model.vision_params``/``model.vision_cfg`` from an mmproj
    sidecar (``mmproj_path``, else one found beside the model) or the
    checkpoint's own tower, where either exists."""
    vcfg = model_cfg.vision
    vvm: Optional[VarMap] = None
    mmproj = Path(mmproj_path) if mmproj_path else find_mmproj(source_path)
    if mmproj is not None and mmproj.exists():
        with Gguf.open(mmproj) as g:
            detected = detect_vision_config_from_mmproj(g)
        vcfg = vcfg or detected
        vvm = varmap_from_mmproj(mmproj)
    elif has_vision_tensors(vm):
        vvm = vm
    if vvm is None or vcfg is None:
        if vvm is not None:
            logger.warning("vision tensors present but no vision config; "
                           "skipping vision tower")
        return
    model_cfg.vision = vcfg
    model.vision_params = build_vision_params(vvm, vcfg, model.device)
    model.vision_cfg = vcfg
    logger.info("vision tower attached: %d layers, image %d, patch %d",
                vcfg.num_layers, vcfg.image_size, vcfg.patch_size)
