"""LoRA adapters: loading, the registry, the merge, and the live switch.

Counterpart of ``blazr_tpu/engine/lora.py``: HF-PEFT adapter directories
(``adapter_model.safetensors``: lora_A [r, in] and lora_B [out, r] a
module; ``adapter_config.json``: ``r`` and ``lora_alpha``), read with the
port's ``formats/safetensors.py``; the rank is inferred from A and the scale
is alpha/r. ``LoraAdapterRegistry`` is the thread-safe named registry of
the ``/v1/lora`` routes.

``merge_lora`` returns a param tree with an adapter applied, as the JAX
merge does: a dense weight gets ``W + A^T (s·B^T)`` in its own dtype; a
packed one (AWQ, GPTQ, every ggml and IQ layout) stays packed inside a
``models.layers.LoraLinear``, whose ``(x·A)·B`` term ``layers.linear`` adds
beside the base's kernel. A projection inside a fused ``qkv`` or ``gateup``
weight is placed by its output slice (``_fused_slot``), B zero-padded to the
fused width, and several modules on one fused weight widen the rank by
concatenation. A merge always starts from the clean base, so adapters
replace each other and never stack. Unlike the JAX merge, which skips
without a word a module it cannot place (``lm_head``, MoE experts, MLA's
latent projections, Mamba2's projections, a width that does not match),
``merge_lora`` raises ``ValueError`` naming them (ROADMAP §C).

``LoraState`` (one a model, ``lora_state``) switches the live adapter of a
model that engines serve, in place, so that the decode graphs captured over
its weights stay valid:
  * a dense weight is rewritten with ``copy_``, from a copy of its clean
    value kept while an adapter touches it;
  * a packed weight's ``LoraLinear`` keeps its ``a``/``b`` buffers when the
    next adapter has the same shapes there (the same targets and rank):
    they are rewritten in place and no graph is captured again. Any other
    change replaces buffers and bumps ``sig``: each engine drops its graphs
    at its next step and captures them again;
  * every switch bumps ``epoch``: K/V computed under the previous weights
    (the BatchEngine's prefix cache and host tier, the Executor's session)
    is dropped by its owner before it could be served again (the JAX
    engines keep it; ROADMAP §C).
Writes hold ``lock``, which each engine holds while it queues device work,
so a switch lands between two steps, stream-ordered after the work queued
before it.
"""

from __future__ import annotations

import json
import logging
import threading
import weakref
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..formats.safetensors import SafeTensorsReader
from ..models.layers import LoraLinear
from ..quant.qtensor import QuantTensor

logger = logging.getLogger(__name__)


def lora_under_mesh() -> ValueError:
    """Either engine's refusal of an adapter on a model sliced to a mesh's
    rank: the JAX Executor's error, word for word
    (``blazr_tpu/engine/executor.py:572-574``)."""
    return ValueError("LoRA under mesh-sharded serving is not supported yet")


@dataclass
class LoraAdapter:
    """One loaded adapter (JAX ``LoraAdapter``)."""

    name: str
    rank: int
    alpha: float
    # module path (e.g. "model.layers.0.self_attn.q_proj") → (A [r, in], B [out, r]) f32
    weights: dict[str, tuple[np.ndarray, np.ndarray]]

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    def num_modules(self) -> int:
        return len(self.weights)


def load_lora_adapter(path: str | Path, name: Optional[str] = None) -> LoraAdapter:
    """Load a HF-PEFT adapter directory."""
    path = Path(path)
    cfg_path = path / "adapter_config.json"
    rank, alpha = 8, 16.0
    if cfg_path.exists():
        cfg = json.loads(cfg_path.read_text())
        rank = int(cfg.get("r", rank))
        alpha = float(cfg.get("lora_alpha", alpha))
    st = path / "adapter_model.safetensors"
    if not st.exists():
        raise FileNotFoundError(f"no adapter_model.safetensors in {path}")
    pairs: dict[str, dict[str, np.ndarray]] = {}
    with SafeTensorsReader(st) as r:
        for tname in r.tensor_names():
            # base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight
            if ".lora_A." in tname:
                key, part = tname.split(".lora_A."), "A"
            elif ".lora_B." in tname:
                key, part = tname.split(".lora_B."), "B"
            else:
                continue
            module = key[0].replace("base_model.model.", "")
            pairs.setdefault(module, {})[part] = (
                r.load_torch(tname).to(torch.float32).numpy())
    weights = {m: (ab["A"], ab["B"]) for m, ab in pairs.items() if "A" in ab and "B" in ab}
    if not weights:
        raise ValueError(f"no LoRA weight pairs found in {st}")
    inferred_rank = next(iter(weights.values()))[0].shape[0]
    return LoraAdapter(name=name or path.name, rank=inferred_rank or rank,
                       alpha=alpha, weights=weights)


class LoraAdapterRegistry:
    """Thread-safe named registry (JAX ``LoraAdapterRegistry``)."""

    @staticmethod
    def lookup(registry: Optional["LoraAdapterRegistry"], name: str) -> LoraAdapter:
        """``registry``'s adapter ``name``; ``KeyError`` when it (or the
        registry) is missing: an engine's request-time lookup."""
        adapter = registry.get(name) if registry is not None else None
        if adapter is None:
            raise KeyError(f"LoRA adapter {name!r} not loaded")
        return adapter

    def __init__(self) -> None:
        self._adapters: dict[str, LoraAdapter] = {}
        self._lock = threading.Lock()

    def load(self, path: str | Path, name: Optional[str] = None) -> LoraAdapter:
        adapter = load_lora_adapter(path, name)
        with self._lock:
            self._adapters[adapter.name] = adapter
        logger.info("loaded LoRA adapter %r (rank=%d, %d modules)",
                    adapter.name, adapter.rank, adapter.num_modules())
        return adapter

    def get(self, name: str) -> Optional[LoraAdapter]:
        with self._lock:
            return self._adapters.get(name)

    def unload(self, name: str) -> bool:
        with self._lock:
            return self._adapters.pop(name, None) is not None

    def list(self) -> list[dict]:
        with self._lock:
            return [{"name": a.name, "rank": a.rank, "alpha": a.alpha,
                     "modules": a.num_modules()}
                    for a in self._adapters.values()]


# ---------------------------------------------------------------------------
# Placement and merge over a llama-family param tree
# ---------------------------------------------------------------------------

_MODULE_TO_KEY = {
    "q_proj": "q", "k_proj": "k", "v_proj": "v", "o_proj": "o",
    "gate_proj": "gate", "up_proj": "up", "down_proj": "down",
}


def _fused_slot(layer: dict, key: str, model_cfg) -> Optional[tuple[str, int, int]]:
    """(fused_key, out_offset, out_width) when ``key``'s projection lives
    inside a fused qkv / gateup weight, else None."""
    if model_cfg is None:
        return None
    att = getattr(model_cfg, "attention", None)
    if key in ("q", "k", "v") and layer.get("qkv") is not None and att:
        hd = att.resolved_head_dim(model_cfg.hidden_size)
        q_dim = att.num_heads * hd
        kv_dim = att.kv_heads() * hd
        off = {"q": 0, "k": q_dim, "v": q_dim + kv_dim}[key]
        return "qkv", off, q_dim if key == "q" else kv_dim
    if key in ("gate", "up") and layer.get("gateup") is not None:
        inter = model_cfg.resolved_intermediate_size()
        return "gateup", (0 if key == "gate" else inter), inter
    return None


def _shape(w: Any) -> tuple[int, int]:
    """(in, out) of a dense [in, out] weight, a QuantTensor or a LoraLinear."""
    if isinstance(w, LoraLinear):
        w = w.base
    if isinstance(w, QuantTensor):
        return w.in_features, w.out_features
    return tuple(w.shape[-2:])


def place_adapter(adapter: LoraAdapter, layers: list, model_cfg) -> dict[int, list]:
    """Each layer's modules of ``adapter`` in the adapter's order: layer →
    [(key, A, B)]. Raises ``ValueError`` naming every module that has no
    weight to go to or whose widths do not match it."""
    plan: dict[int, list] = {}
    bad: list[str] = []
    for module, (a, b) in adapter.weights.items():
        parts = module.split(".")
        try:
            at = parts.index("layers") + 1
            li = int(parts[at])
        except (ValueError, IndexError):
            bad.append(module)
            continue
        # layers.{i}.{self_attn|mlp}.{proj}: an expert's or a shared
        # expert's projection lies deeper and has no weight here.
        key = _MODULE_TO_KEY.get(parts[-1]) if len(parts) == at + 3 else None
        if key is None or li >= len(layers):
            bad.append(module)
            continue
        layer = layers[li]
        if layer.get(key) is not None:
            fits = _shape(layer[key]) == (a.shape[1], b.shape[0])
        else:
            fused = _fused_slot(layer, key, model_cfg)
            fits = (fused is not None and fused[2] == b.shape[0]
                    and _shape(layer[fused[0]])[0] == a.shape[1])
        if not fits or a.shape[0] != b.shape[1]:
            bad.append(module)
            continue
        plan.setdefault(li, []).append((key, a, b))
    if bad:
        shown = ", ".join(bad[:6]) + (f" and {len(bad) - 6} more" if len(bad) > 6 else "")
        raise ValueError(f"LoRA adapter {adapter.name!r}: no weight of this model to "
                         f"apply these modules to: {shown}")
    return plan


def merge_layer(layer: dict, items: list, scale: float, model_cfg,
                dtype: torch.dtype) -> dict:
    """A copy of one layer's params with its adapter modules ``items``
    (``place_adapter``'s) applied; untouched entries are the same objects."""
    out = dict(layer)
    for key, a, b in items:
        base = out.get(key)
        b_scaled = b.T * scale                               # [r, out]
        if base is None:
            fkey, off, width = _fused_slot(out, key, model_cfg)
            base = out[fkey]
            bf = np.zeros((b_scaled.shape[0], _shape(base)[1]), dtype=np.float32)
            bf[:, off:off + width] = b_scaled
            key, b_scaled = fkey, bf
        if isinstance(base, (QuantTensor, LoraLinear)):
            dev = (base.base if isinstance(base, LoraLinear) else base).device
            at = torch.from_numpy(np.ascontiguousarray(a.T)).to(dev, dtype)
            bt = torch.from_numpy(np.ascontiguousarray(b_scaled)).to(dev, dtype)
            if isinstance(base, LoraLinear):
                # Another module of this adapter on the same fused weight:
                # the rank widens.
                at = torch.cat([base.a, at], dim=1)
                bt = torch.cat([base.b, bt], dim=0)
                base = base.base
            out[key] = LoraLinear(base=base, a=at, b=bt)
        else:
            # [in, out] in f32 on the weight's device, then in its dtype.
            delta = (torch.from_numpy(np.ascontiguousarray(a.T)).to(base.device)
                     @ torch.from_numpy(np.ascontiguousarray(b_scaled)).to(base.device))
            out[key] = base + delta.to(base.dtype)
    return out


def merge_lora(params: dict[str, Any], adapter: LoraAdapter,
               model_cfg=None) -> dict[str, Any]:
    """``params`` with ``adapter`` applied (JAX ``merge_lora``): the layers
    are new dicts, the other entries shared. The low-rank terms take the
    embedding's dtype, the activations'."""
    dtype = params["embed"].dtype
    plan = place_adapter(adapter, params["layers"], model_cfg)
    new = dict(params)
    new["layers"] = [merge_layer(layer, plan.get(i, []), adapter.scale, model_cfg, dtype)
                     for i, layer in enumerate(params["layers"])]
    logger.info("merged LoRA %r into %d modules", adapter.name, adapter.num_modules())
    return new


# ---------------------------------------------------------------------------
# The live switch
# ---------------------------------------------------------------------------

class LoraState:
    """The active adapter of one served model and the switch that writes it
    into the model's params in place (module docstring)."""

    def __init__(self, model) -> None:
        self.model = model
        self.lock = threading.RLock()
        self.adapter: Optional[LoraAdapter] = None
        self.epoch = 0                 # every switch
        self.sig = 0                   # a switch that replaced LoRA buffers
        self._engine = None
        # (layer, key) → the clean value of a dense weight an adapter holds.
        self._clean: dict[tuple[int, str], torch.Tensor] = {}

    def attach(self, engine) -> None:
        """Make ``engine`` (a BatchEngine) the one that applies this
        model's switches, at its step boundaries; held weakly."""
        self._engine = weakref.ref(engine)

    @property
    def engine(self):
        """The attached BatchEngine, or None: switches then apply at once."""
        return self._engine() if self._engine is not None else None

    def _clean_layer(self, li: int, layer: dict) -> dict:
        out = dict(layer)
        for key, w in layer.items():
            if isinstance(w, LoraLinear):
                out[key] = w.base
            elif (li, key) in self._clean:
                out[key] = self._clean[(li, key)]
        return out

    def activate(self, adapter: Optional[LoraAdapter]) -> None:
        """Make ``adapter`` (None: the base) the model's weights, in place
        where the shapes allow. An adapter that does not fit the model raises
        before any weight is written."""
        with self.lock:
            params, cfg = self.model.params, self.model.cfg
            plan = place_adapter(adapter, params["layers"], cfg) if adapter else {}
            replaced = False
            for li, layer in enumerate(params["layers"]):
                clean = self._clean_layer(li, layer)
                merged = (merge_layer(clean, plan[li], adapter.scale, cfg, self.model.dtype)
                          if li in plan else clean)
                replaced |= self._install(li, layer, merged)
            self.adapter = adapter
            self.epoch += 1
            self.sig += replaced
        logger.info("LoRA adapter %r active", self.active)

    @property
    def active(self) -> Optional[str]:
        """The live adapter's name; None: the base."""
        return self.adapter.name if self.adapter is not None else None

    def _install(self, li: int, layer: dict, merged: dict) -> bool:
        """Write ``merged`` into ``layer`` in place; True when a LoRA buffer
        had to be replaced (the graphs that read it are stale)."""
        replaced = False
        for key, new in merged.items():
            live = layer.get(key)
            if new is live:
                continue
            if isinstance(new, LoraLinear):
                if (isinstance(live, LoraLinear) and live.base is new.base
                        and live.a.shape == new.a.shape and live.b.shape == new.b.shape):
                    live.a.copy_(new.a)
                    live.b.copy_(new.b)
                else:
                    layer[key] = new
                    replaced = True
            elif isinstance(live, LoraLinear):
                layer[key] = new                  # the packed base again
                replaced = True
            else:
                clean = self._clean.get((li, key))
                if clean is None:
                    self._clean[(li, key)] = live.clone()
                live.copy_(new)
                if new is clean:                   # restored: the copy goes
                    del self._clean[(li, key)]
        return replaced


def lora_state(model) -> LoraState:
    """The model's ``LoraState``, made at the first call."""
    st = getattr(model, "lora", None)
    if st is None:
        st = model.lora = LoraState(model)
    return st
