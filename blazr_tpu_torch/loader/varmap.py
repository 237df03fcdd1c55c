"""VarMap: the name → weight store filled by checkpoint loaders.

Counterpart of ``blazr_tpu/loader/varmap.py``: loaders normalize every
checkpoint format into a flat dict of HF-convention names mapping to either
a dense CPU tensor or a canonical :class:`~blazr_tpu_torch.quant.qtensor.QuantTensor`
(built on the CPU); the model builder then ``take``s what it needs and
places it on the device.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..formats.detect import read_quant_group_size
from ..formats.ggml_quants import dequantize_ggml
from ..formats.gguf import Gguf, GgmlType
from ..formats.iq_quants import IQ_GRID_TYPES, IQ_GRIDS_META_KEY, check_grid_stamp
from ..formats.names import gguf_to_hf_name, qk_heads_of, qk_rows
from ..formats.safetensors import SafeTensorsReader
from ..quant.qtensor import (CANONICAL_GGML_TYPES, QuantTensor, from_awq, from_ggml,
                             from_gptq, stack_quant)
from .gguf_config import gguf_qk_heads

Weight = Union[torch.Tensor, QuantTensor]
_CPU = torch.device("cpu")


class VarMap:
    """Flat tensor-name → weight store with HF-convention names."""

    def __init__(self) -> None:
        self._store: dict[str, Weight] = {}

    def insert(self, name: str, value: Weight) -> None:
        self._store[name] = value

    def get(self, name: str, default=None) -> Optional[Weight]:
        return self._store.get(name, default)

    def take(self, name: str) -> Weight:
        """Remove and return (frees host memory as weights move to device)."""
        return self._store.pop(name)

    def __contains__(self, name: str) -> bool:
        return name in self._store

    def __len__(self) -> int:
        return len(self._store)

    def names(self) -> list[str]:
        return sorted(self._store)

    def logical_shape(self, name: str) -> tuple[int, ...]:
        """Shape in HF orientation ([out, in] for linear weights)."""
        w = self._store[name]
        if isinstance(w, QuantTensor):
            return (w.out_features, w.in_features)
        return tuple(w.shape)


# ---------------------------------------------------------------------------
# SafeTensors loaders (plain / AWQ / GPTQ)
# ---------------------------------------------------------------------------

def varmap_from_safetensors(path: str | Path) -> VarMap:
    """Load a plain (fp) SafeTensors checkpoint."""
    vm = VarMap()
    with SafeTensorsReader(path) as r:
        for name in r.tensor_names():
            vm.insert(name, r.load_torch(name))
    return vm


def varmap_from_awq(path: str | Path, group_size: Optional[int] = None,
                    work_device=None) -> VarMap:
    """Load an AWQ checkpoint: .qweight/.qzeros/.scales triplets become
    QuantTensors stored under ``base.weight`` (held on the CPU; repacked on
    ``work_device`` where given, the card when loading onto it)."""
    path = Path(path)
    model_dir = path if path.is_dir() else path.parent
    if group_size is None:
        group_size = read_quant_group_size(model_dir)
    vm = VarMap()
    with SafeTensorsReader(path) as r:
        names = r.tensor_names()
        bases = {n[: -len(".qweight")] for n in names if n.endswith(".qweight")}
        for name in names:
            if any(name.endswith(suf) for suf in (".qweight", ".qzeros", ".scales")):
                continue
            vm.insert(name, r.load_torch(name))
        for base in sorted(bases):
            qw = r.load_numpy(base + ".qweight", dtype=np.uint32)
            sc = r.load_numpy(base + ".scales").astype(np.float32)
            qz = r.load_numpy(base + ".qzeros", dtype=np.uint32)
            vm.insert(base + ".weight", from_awq(qw, sc, qz, group_size, device=_CPU,
                                                 work_device=work_device))
    return vm


def varmap_from_gptq(path: str | Path, group_size: Optional[int] = None,
                     v2: bool = False) -> VarMap:
    """Load a GPTQ checkpoint: 5-tensor groups become QuantTensors (desc-act
    checkpoints carry the activation permutation)."""
    path = Path(path)
    model_dir = path if path.is_dir() else path.parent
    if group_size is None:
        group_size = read_quant_group_size(model_dir)
    vm = VarMap()
    with SafeTensorsReader(path) as r:
        names = set(r.tensor_names())
        bases = {n[: -len(".qweight")] for n in names if n.endswith(".qweight")}
        for name in sorted(names):
            if any(name.endswith(s) for s in (".qweight", ".qzeros", ".scales", ".g_idx")):
                continue
            if name.endswith(".bias") and name[: -len(".bias")] in bases:
                vm.insert(name, r.load_torch(name).to(torch.float32))
                continue
            vm.insert(name, r.load_torch(name))
        for base in sorted(bases):
            qw = r.load_numpy(base + ".qweight", dtype=np.uint32)
            sc = r.load_numpy(base + ".scales").astype(np.float32)
            qz = r.load_numpy(base + ".qzeros", dtype=np.uint32)
            gi = (r.load_numpy(base + ".g_idx", dtype=np.int32)
                  if base + ".g_idx" in names else None)
            if gi is not None:
                gi = gi.reshape(-1)
            vm.insert(base + ".weight", from_gptq(qw, sc, qz, gi, group_size, v2=v2,
                                                  device=_CPU))
    return vm


# ---------------------------------------------------------------------------
# GGUF loader
# ---------------------------------------------------------------------------

# Tensors that must be dense (gathered / broadcast) even when quantized in
# the file: embeddings and norms.
_DENSE_PATTERNS = re.compile(
    r"(embed_tokens|token_embd|norm|layernorm|ln_|_bias|\.bias|A_log|\.D\b)", re.IGNORECASE
)


def _stacked_from_ggml(raw, gt: GgmlType, shape: tuple[int, ...],
                       work_device=None) -> QuantTensor:
    """A pre-stacked [E, N, K] expert tensor → a stacked QuantTensor, one
    ``from_ggml`` per expert slice (the JAX loader dequantizes it to dense
    f32: ROADMAP §C)."""
    e, n, k = shape
    per = len(raw) // e
    return stack_quant([from_ggml(raw[i * per:(i + 1) * per], gt, (n, k), device=_CPU,
                                  work_device=work_device)
                        for i in range(e)])


def varmap_from_gguf(path: str | Path, work_device=None) -> VarMap:
    """Load a GGUF checkpoint with GGUF→HF name mapping (the JAX package's
    varmap.py:151-184). 2-D weights in a canonical ggml type stay quantized
    (QuantTensor), and so do pre-stacked 3-D expert tensors (one stacked
    QuantTensor); embeddings, norms and the other types dequantize to dense
    float32. ``attn_q``/``attn_k`` rows of a llama-architecture file are
    un-permuted first (``formats.names.qk_permuted``)."""
    vm = VarMap()
    with Gguf.open(path) as g:
        if any(g.tensor_info(n).ggml_type in IQ_GRID_TYPES for n in g.tensor_names()):
            check_grid_stamp(g.metadata().get(IQ_GRIDS_META_KEY), f"GGUF file {path}")
        heads = gguf_qk_heads(g.metadata())
        for name in g.tensor_names():
            info = g.tensor_info(name)
            hf_name = gguf_to_hf_name(name)
            gt = info.ggml_type
            raw = g.tensor_bytes(name)
            n_head = qk_heads_of(name, heads)
            if n_head:
                raw = qk_rows(raw, info.shape, n_head, to_gguf=False)
            quantized = (gt in CANONICAL_GGML_TYPES
                         and _DENSE_PATTERNS.search(hf_name) is None)
            if quantized and len(info.shape) == 2:
                vm.insert(hf_name, from_ggml(raw, gt, info.shape, device=_CPU,
                                             work_device=work_device))
            elif quantized and len(info.shape) == 3:
                vm.insert(hf_name, _stacked_from_ggml(raw, gt, info.shape, work_device))
            else:
                vm.insert(hf_name, torch.from_numpy(
                    np.ascontiguousarray(dequantize_ggml(raw, gt, info.shape))))
    return vm
