"""VarMap: the name → weight store filled by checkpoint loaders.

Counterpart of ``blazr_tpu/loader/varmap.py``: loaders normalize every
checkpoint format into a flat dict of HF-convention names mapping to either
a dense CPU tensor or a canonical :class:`~blazr_tpu_torch.quant.qtensor.QuantTensor`
(built on the CPU); the model builder then ``take``s what it needs and
places it on the device. GGUF checkpoints raise (ROADMAP queue A item 10).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..formats.detect import read_quant_group_size
from ..formats.safetensors import SafeTensorsReader
from ..quant.qtensor import QuantTensor, from_awq, from_gptq

Weight = Union[torch.Tensor, QuantTensor]
_CPU = torch.device("cpu")


class VarMap:
    """Flat tensor-name → weight store with HF-convention names."""

    def __init__(self) -> None:
        self._store: dict[str, Weight] = {}

    def insert(self, name: str, value: Weight) -> None:
        self._store[name] = value

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


def varmap_from_awq(path: str | Path, group_size: Optional[int] = None) -> VarMap:
    """Load an AWQ checkpoint: .qweight/.qzeros/.scales triplets become
    QuantTensors stored under ``base.weight``."""
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
            vm.insert(base + ".weight", from_awq(qw, sc, qz, group_size, device=_CPU))
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


def varmap_from_gguf(path: str | Path, keep_quantized: bool = True) -> VarMap:
    raise NotImplementedError(
        f"GGUF checkpoints ({path}) are not loaded by blazr_tpu_torch yet "
        "(ROADMAP queue A item 10)")
