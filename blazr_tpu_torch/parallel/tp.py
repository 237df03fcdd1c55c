"""Tensor-parallel sharding rules: one rank's slice of every weight.

Counterpart of ``blazr_tpu/parallel/tp.py`` (:36-313). The JAX package
gives each leaf a ``PartitionSpec`` and lets GSPMD split the matmuls and
insert the psums. The port turns the same key rules (``_leaf_spec``,
:47-72) into the slice a rank keeps, and marks where a collective follows:

  * column keys (``q k v gate up lm_head``, MLA's ``q_b``, and
    Starcoder2/Falcon's plain ``fc``, which the JAX package leaves to GSPMD
    to reshard) split N of a dense weight, or of ``qweight``, ``scales`` and
    ``mins``; their biases split alike;
  * row keys (``o down``) split K: a QuantTensor's packed rows and its
    scale and min planes in whole groups. The rank's slice is wrapped in
    ``layers.RowParallel``, whose ``linear`` sums the ranks' partials over
    tp before the (whole) bias;
  * the embedding splits its vocab rows (``VocabShard`` in
    ``params["rank"]``: the lookup is masked, then summed over tp), and the
    head its vocab columns, gathered whole on every rank, tied or not;
  * expert stacks split on ep (E/ep experts a rank), then on tp (gate/up N,
    down K); the router and shared experts stay whole. ``params[...]
    ["moe"]["mesh"]`` (``MoeShard``) gives the layer its experts and the
    ep×tp group its routed sum is reduced over.
  * MLA's absorbed halves ``kv_b_k``/``kv_b_v`` ([r, H, d]) are sliced on
    their head axis to the rank's heads. The JAX layout keeps them whole
    (no key set names them) and GSPMD reshards them to the q heads' split;
    the rank computes the same function on its heads. ``q_a``, ``kv_a``,
    the latent norms and the latent cache stay whole.
  * every other key stays whole on every rank, as in the JAX package: the
    norms, the router and shared experts, and the Mamba2/Mamba3 mixer
    (``in_proj``, ``out_proj``, ``conv_w``, the gated norm, ``A_log``,
    ``D``, ``dt_bias``, ``lam``, ``omega``), whose whole state rows every
    rank runs. A hybrid's attention and MLP split like the llama family's.

kv heads that do not divide tp (MQA under wide tp, JAX :260-262) are not
split: the ranks whose q heads share one kv head each hold that head's k and
v columns (with one kv head, the whole k and v on every rank). Each rank's
``rank_config`` has its own head counts, so its caches allocate its own kv
heads (``shard_paged_cache``/``shard_cache``'s work, done at allocation).
Fused ``qkv``/``gateup`` are unfused first (``unfuse_projections``, :101) and
stay unfused on a rank: one B1 launch a projection, as in the JAX layout.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import torch

from ..models.layers import RowParallel
from ..quant.qtensor import QuantTensor
from .comm import Axis
from .mesh import MeshConfig, RankMesh, validate_tp_size

_COL_KEYS = {"q", "k", "v", "gate", "up", "lm_head", "fc", "q_b"}
_ROW_KEYS = {"o", "down"}
_COL_BIAS = {"q_bias", "k_bias", "v_bias", "fc_bias"}
_EXPERT_COL = {"experts_gate", "experts_up"}      # [E, K, N] stacked
_EXPERT_ROW = {"experts_down"}
_HEAD_KEYS = {"kv_b_k", "kv_b_v"}                 # MLA [r, H, d], split on H


@dataclasses.dataclass
class VocabShard:
    """The vocab rows [start, start + rows) of the embedding this rank
    holds, and the tp axis the lookup and the head's logits cross."""

    axis: Axis
    start: int
    rows: int


@dataclasses.dataclass
class MoeShard:
    """A MoE layer's experts on this rank ([first, first + count) of E) and
    the ep×tp axis its routed sum is reduced over."""

    axis: Axis
    first: int
    count: int


def _slice_n(w, a: int, b: int):
    """Slice a weight along out_features (the lane axis of qweight, scales
    and mins alike; the last axis of a dense [.., K, N])."""
    if isinstance(w, QuantTensor):
        return dataclasses.replace(
            w, qweight=w.qweight[..., a:b], scales=w.scales[..., a:b],
            mins=w.mins[..., a:b], out_features=b - a)
    return w[..., a:b]


def unfuse_projections(params: dict, model_cfg) -> dict:
    """Split fused qkv / gateup projections into per-role weights (JAX
    :101-141): fused they cannot be column-split per head."""
    att = model_cfg.attention
    if att is None or not params.get("layers"):
        return params
    hd = att.resolved_head_dim(model_cfg.hidden_size)
    q_dim = att.num_heads * hd
    kv_dim = att.kv_heads() * hd
    inter = model_cfg.resolved_intermediate_size()
    out_layers = []
    changed = False
    for layer in params["layers"]:
        layer = dict(layer)
        qkv = layer.pop("qkv", None)
        if qkv is not None:
            layer["q"] = _slice_n(qkv, 0, q_dim)
            layer["k"] = _slice_n(qkv, q_dim, q_dim + kv_dim)
            layer["v"] = _slice_n(qkv, q_dim + kv_dim, q_dim + 2 * kv_dim)
            bias = layer.pop("qkv_bias", None)
            if bias is not None:
                layer["q_bias"] = bias[:q_dim]
                layer["k_bias"] = bias[q_dim:q_dim + kv_dim]
                layer["v_bias"] = bias[q_dim + kv_dim:]
            changed = True
        gu = layer.pop("gateup", None)
        if gu is not None:
            layer["gate"] = _slice_n(gu, 0, inter)
            layer["up"] = _slice_n(gu, inter, 2 * inter)
            changed = True
        out_layers.append(layer)
    if not changed:
        return params
    out = dict(params)
    out["layers"] = out_layers
    return out


def _iter_named_quant(params: dict):
    def walk(d):
        for key, val in d.items():
            if isinstance(val, QuantTensor):
                yield key, val
            elif isinstance(val, dict):
                yield from walk(val)

    for layer in params.get("layers", []):
        yield from walk(layer)
    if isinstance(params.get("lm_head"), QuantTensor):
        yield "lm_head", params["lm_head"]


def validate_quant_tp(params: dict, tp: int) -> None:
    """Quantized-weight divisibility (JAX :179-226, the same errors):
    column weights need N % tp == 0; row weights split K in whole groups,
    their packed rows evenly, and carry no desc-act permutation."""
    if tp <= 1:
        return
    for key, qt in _iter_named_quant(params):
        if key in ("qkv", "gateup"):
            if qt.out_features % tp:
                raise ValueError(
                    f"cannot tensor-parallel fused weight {key!r}: "
                    f"out_features {qt.out_features} not divisible by "
                    f"tp={tp}")
            continue
        if key in _COL_KEYS or key in _EXPERT_COL:
            if qt.out_features % tp:
                raise ValueError(
                    f"cannot tensor-parallel quantized weight {key!r}: "
                    f"out_features {qt.out_features} not divisible by tp={tp}")
        elif key in _ROW_KEYS or key in _EXPERT_ROW:
            k = qt.in_features
            if k % tp or (k // tp) % qt.group_size:
                raise ValueError(
                    f"cannot tensor-parallel quantized weight {key!r}: "
                    f"in_features {k} / tp={tp} must be a multiple of "
                    f"group_size {qt.group_size}")
            if qt.qweight.shape[-2] % tp:
                raise ValueError(
                    f"cannot tensor-parallel quantized weight {key!r}: "
                    f"{qt.qweight.shape[-2]} packed rows not divisible by "
                    f"tp={tp}")
            if qt.perm is not None:
                raise ValueError(
                    f"cannot tensor-parallel {key!r}: GPTQ desc-act "
                    f"activation permutation is incompatible with "
                    f"row-parallel sharding")


def _own(t: torch.Tensor) -> torch.Tensor:
    """A slice's own storage, so the whole weight can be freed."""
    return t.contiguous().clone()


def col_slice(w, index: int, parts: int):
    """Part ``index`` of ``parts`` along N (dense or quantized, plain or
    stacked)."""
    n = w.out_features if isinstance(w, QuantTensor) else w.shape[-1]
    a, b = index * n // parts, (index + 1) * n // parts
    s = _slice_n(w, a, b)
    if isinstance(s, QuantTensor):
        return dataclasses.replace(s, qweight=_own(s.qweight), scales=_own(s.scales),
                                   mins=_own(s.mins))
    return _own(s)


def row_slice(w, index: int, parts: int):
    """Part ``index`` of ``parts`` along K: a QuantTensor's packed rows and
    its scale/min planes in whole groups (the axis before N, so stacked
    experts too); a dense weight's rows."""
    if isinstance(w, QuantTensor):
        kw, g = w.qweight.shape[-2], w.scales.shape[-2]
        return dataclasses.replace(
            w, qweight=_own(w.qweight[..., index * kw // parts:(index + 1) * kw // parts, :]),
            scales=_own(w.scales[..., index * g // parts:(index + 1) * g // parts, :]),
            mins=_own(w.mins[..., index * g // parts:(index + 1) * g // parts, :]),
            in_features=w.in_features // parts)
    k = w.shape[-2]
    return _own(w[..., index * k // parts:(index + 1) * k // parts, :])


def expert_range(w, first: int, count: int):
    """Experts [first, first + count) of a stacked weight."""
    if isinstance(w, QuantTensor):
        return dataclasses.replace(w, qweight=w.qweight[first:first + count],
                                   scales=w.scales[first:first + count],
                                   mins=w.mins[first:first + count])
    return w[first:first + count]


def _kv_cols(w, cfg, tp_index: int, tp: int):
    """k/v (or their bias) columns of this rank's kv heads."""
    att = cfg.attention
    kv = att.kv_heads()
    if kv % tp == 0:
        return col_slice(w, tp_index, tp)
    hd = att.resolved_head_dim(cfg.hidden_size)
    head = tp_index * (att.num_heads // tp) // (att.num_heads // kv)
    n = w.out_features if isinstance(w, QuantTensor) else w.shape[-1]
    return col_slice(w, head, n // hd)


def _shard_moe(p: dict, mesh: RankMesh, num_experts: int) -> dict:
    ep, ep_i = mesh.size("ep"), mesh.index("ep")
    tp, tp_i = mesh.size("tp"), mesh.index("tp")
    if num_experts % ep:
        raise ValueError(f"num_experts {num_experts} not divisible by ep={ep}")
    count = num_experts // ep
    first = ep_i * count
    out = dict(p)
    for key in _EXPERT_COL | _EXPERT_ROW:
        w = expert_range(p[key], first, count)
        split = col_slice if key in _EXPERT_COL else row_slice
        out[key] = split(w, tp_i, tp) if tp > 1 else (
            dataclasses.replace(w, qweight=_own(w.qweight), scales=_own(w.scales),
                                mins=_own(w.mins)) if isinstance(w, QuantTensor)
            else _own(w))
    out["mesh"] = MoeShard(mesh.axis("moe"), first, count)
    return out


def shard_params(params: dict, mesh: RankMesh, model_cfg) -> dict:
    """This rank's params under the TP/EP rules (unfused first, validated
    like the JAX ``shard_params``)."""
    tp, tp_i = mesh.size("tp"), mesh.index("tp")
    if tp > 1:
        params = unfuse_projections(params, model_cfg)
        validate_quant_tp(params, tp)
    layers = []
    for layer in params["layers"]:
        out = {}
        for key, val in layer.items():
            if val is None or tp == 1 and key != "moe":
                out[key] = val
            elif key == "moe":
                out[key] = (_shard_moe(val, mesh, model_cfg.moe.num_experts)
                            if tp > 1 or mesh.size("ep") > 1 else val)
            elif key in ("k", "v", "k_bias", "v_bias"):
                out[key] = _kv_cols(val, model_cfg, tp_i, tp)
            elif key in _COL_KEYS or key in _COL_BIAS:
                out[key] = col_slice(val, tp_i, tp)
            elif key in _ROW_KEYS:
                out[key] = RowParallel(row_slice(val, tp_i, tp), mesh.axis("tp"))
            elif key in _HEAD_KEYS:
                h = val.shape[1]
                out[key] = _own(val[:, tp_i * h // tp:(tp_i + 1) * h // tp])
            else:
                out[key] = val
        layers.append(out)
    sharded = dict(params)
    sharded["layers"] = layers
    if tp > 1:
        emb = params["embed"]
        rows = emb.shape[0] // tp
        sharded["embed"] = _own(emb[tp_i * rows:(tp_i + 1) * rows])
        sharded["rank"] = VocabShard(mesh.axis("tp"), tp_i * rows, rows)
        if params.get("lm_head") is not None:
            sharded["lm_head"] = col_slice(params["lm_head"], tp_i, tp)
    return sharded


def rank_config(cfg, mesh: RankMesh):
    """The model config as one rank computes it: its q and kv heads (the
    head dim fixed; an MLA rank's heads with d_nope, d_rope, v_head_dim and
    the latent width unchanged), its share of the intermediate width, and
    the EP route on when the mesh has an ep axis. The SSM widths stay
    whole: every rank runs the whole mixer."""
    rc = copy.deepcopy(cfg)
    tp, tp_i = mesh.size("tp"), mesh.index("tp")
    att = rc.attention
    if att is not None and tp > 1:
        kv = att.kv_heads()
        att.head_dim = att.resolved_head_dim(cfg.hidden_size)
        att.rank_heads = (tp_i * att.num_heads // tp, att.num_heads)
        att.num_heads //= tp
        att.num_kv_heads = kv // tp if kv % tp == 0 else 1
    if tp > 1 and rc.intermediate_size:
        rc.intermediate_size //= tp
    if rc.moe is not None and mesh.size("ep") > 1:
        rc.moe.use_ep = True
    return rc


def mesh_config(inference_cfg) -> MeshConfig:
    return MeshConfig(tp=inference_cfg.tensor_parallel_size,
                      ep=inference_cfg.expert_parallel_size,
                      sp=inference_cfg.sequence_parallel_size)


def check_mesh_model(model) -> None:
    """Raise for a model a mesh does not serve: one whose layers stream from
    host RAM. The JAX Executor keeps such a model on one device and ignores
    the mesh it was asked for (``executor.py:81-84``); the port refuses it
    (ROADMAP §C)."""
    if getattr(model, "is_streaming", False):
        raise NotImplementedError(
            "a model with layers streamed from host RAM (device_layers) is served on one "
            "device: it is not sharded over a tensor, expert or sequence parallel mesh "
            "(the JAX Executor ignores the mesh; ROADMAP §C)")


def maybe_serving_mesh(inference_cfg, model_cfg, params: Optional[dict] = None,
                       device: Optional[torch.device] = None) -> Optional[RankMesh]:
    """The serving mesh of the inference knobs, or None when tp, ep and sp
    are all 1 (dp is routing: no axis). Validates head, vocab and quantized
    divisibility before any weight is sliced (JAX :229-250)."""
    from .multihost import serving_mesh

    cfg = mesh_config(inference_cfg)
    if cfg.ranks <= 1:
        return None
    validate_tp_size(model_cfg, cfg.tp)
    if params is not None:
        validate_quant_tp(unfuse_projections(params, model_cfg), cfg.tp)
    return serving_mesh(cfg, device if device is not None else torch.device("cpu"))


def shard_model(model, inference_cfg) -> Optional[RankMesh]:
    """Slice ``model`` to this rank in place, once (an Executor and a
    BatchEngine over one model share it); the mesh, or None without one."""
    cfg = mesh_config(inference_cfg)
    mesh = getattr(model, "mesh", None)
    if mesh is not None:
        if mesh.cfg != cfg:
            raise ValueError(f"the model is sharded for {mesh.cfg}, not {cfg}")
        return mesh
    if cfg.ranks <= 1:
        return None
    check_mesh_model(model)
    mesh = maybe_serving_mesh(inference_cfg, model.cfg, model.params, model.device)
    model.params = shard_params(model.params, mesh, model.cfg)
    model.cfg = rank_config(model.cfg, mesh)
    model.mesh = mesh
    return mesh
