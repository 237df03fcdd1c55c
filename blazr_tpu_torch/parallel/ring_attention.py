"""Ring attention: sequence-parallel causal prefill.

Counterpart of ``blazr_tpu/parallel/ring_attention.py`` (:30-150). The
prompt's positions are split over the ``sp`` ranks, [S/p] each; every rank
runs the whole layer stack on its own positions, and attention passes K/V
blocks around the ring (``comm.shift``: send to the next rank, receive from
the previous one) while each rank accumulates its queries' attention with
an online softmax in f32. Visibility comes from GLOBAL positions (JAX
:93-96): key ``gk`` is visible to query ``gq`` when ``gk <= gq``, and under
a window when also ``gk > gq - W``. ``ring_hops`` stops the ring once no
later block can fall inside any query's window. Plain PyTorch, as the JAX
package computes it in XLA einsums, outside any Pallas kernel. K/V stay
grouped (GQA) on the ring: the blocks carry H_kv heads, not H.

``ring_prefill`` runs a llama-family model's layers so (both engines' sp
prefill: start position 0, the prompt in one pass). Each rank writes only
its own positions' K/V into its cache, then every rank's is gathered into
every rank's cache (``gather_written``), since decode reads the whole
history on every rank. The last real position's hidden row is broadcast
from the rank that holds it.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from .comm import Axis, all_gather, broadcast, shift


def _block_attend(q, k, v, m_prev, l_prev, acc_prev, mask, scale: float):
    """One online-softmax step (JAX :30-50). q [B,Sq,H,D] f32, k/v
    [B,Sk,G,D] f32 with H = G·r; m, l [B,H,Sq]; acc [B,Sq,H,D]; mask
    [Sq,Sk] (True = visible)."""
    b, sq, h, d = q.shape
    g = k.shape[2]
    qg = q.reshape(b, sq, g, h // g, d)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).reshape(b, h, sq, -1) * scale
    logits = torch.where(mask[None, None], logits, torch.full_like(logits, -math.inf))
    m_new = torch.maximum(m_prev, logits.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    alpha = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - m_safe),
                        torch.zeros_like(m_prev))
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    l_new = l_prev * alpha + p.sum(dim=-1)
    pv = torch.einsum("bgrqk,bkgd->bqgrd", p.reshape(b, g, h // g, sq, -1), v)
    acc_new = acc_prev * alpha.permute(0, 2, 1)[..., None] + pv.reshape(b, sq, h, d)
    return m_new, l_new, acc_new


def ring_hops(p_size: int, s_local: int, sliding_window: Optional[int]) -> int:
    """Ring hops that can contribute under a sliding window (JAX
    :126-136): at most ceil((W-1)/S_local) + 1."""
    if sliding_window is None or s_local <= 0:
        return p_size
    return min(p_size, -(-(sliding_window - 1) // s_local) + 1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis: Axis,
                   sliding_window: Optional[int] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention of this rank's block of a sequence split over
    ``axis``: q [B, S_local, H, D], k/v [B, S_local, H_kv, D] (rank i holds
    global positions [i·S_local, (i+1)·S_local)) → [B, S_local, H, D] in
    q's dtype. The scale defaults to 1/sqrt(D)."""
    b, s_local, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n_hops = ring_hops(axis.size, s_local, sliding_window)
    qf = q.to(torch.float32)
    kb, vb = k.to(torch.float32), v.to(torch.float32)
    m = torch.full((b, h, s_local), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s_local, h, d), dtype=torch.float32, device=q.device)
    pos = torch.arange(s_local, device=q.device)
    gq = axis.index * s_local + pos
    for s in range(n_hops):
        src = (axis.index - s) % axis.size
        gk = src * s_local + pos
        mask = gk[None, :] <= gq[:, None]
        if sliding_window is not None:
            mask &= gk[None, :] > gq[:, None] - sliding_window
        m, l, acc = _block_attend(qf, kb, vb, m, l, acc, mask, scale)
        if s + 1 < n_hops:
            kb, vb = shift([kb, vb], axis)
    denom = l.clamp_min(1e-30).permute(0, 2, 1)[..., None]
    return (acc / denom).to(q.dtype)


def reference_causal_attention(q, k, v, sliding_window: Optional[int] = None):
    """Dense causal attention (the ring tests' reference, JAX :138-150)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).to(torch.float32)
    v = v.repeat_interleave(rep, dim=2).to(torch.float32)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k) / math.sqrt(d)
    pos = torch.arange(s)
    mask = pos[None, :] <= pos[:, None]
    if sliding_window is not None:
        mask &= pos[None, :] > pos[:, None] - sliding_window
    logits = torch.where(mask[None, None], logits, torch.full_like(logits, -math.inf))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def ring_eligible(cfg) -> bool:
    """The JAX engines' ring-prefill families (executor.py:233-243,
    batch_engine.py:499-505): the llama forward, no ALiBi, no attention
    softcap."""
    from ..models.registry import resolve_paged_kind

    att = cfg.attention
    return (resolve_paged_kind(cfg) == "llama" and att is not None and not att.use_alibi
            and not cfg.attn_logit_softcapping)


def split_bucket(n: int, sp: int, index: int, step: int) -> tuple[int, int, int]:
    """(bucket, first, count): a prompt of ``n`` tokens padded to a multiple
    of ``step`` (itself a multiple of sp) and this rank's share of it."""
    bucket = -(-n // step) * step
    s_local = bucket // sp
    return bucket, index * s_local, s_local


@torch.no_grad()
def ring_prefill(params: dict[str, Any], cfg, prompt: list[int], slots: np.ndarray,
                 trash: int, axis: Axis,
                 write_kv: Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor], None],
                 planes: list[torch.Tensor]) -> torch.Tensor:
    """A whole prompt from position 0 in one sequence-parallel pass (the
    engines' sp prefill): padded to a multiple of sp·16 tokens, this rank's
    block through the decoder layers with ring attention, each layer's
    block K/V written by ``write_kv(layer, k, v, index)`` at ``index``
    [1, S_local] (the block's ``slots``, pads at ``trash``; pads may sit at
    any position: the global-index mask hides them from real queries), then
    every rank's block gathered into every rank's cache ``planes``
    (``gather_written``). The logits [1, 1, V] of the prompt's last
    position, on every rank."""
    from ..models.layers import linear
    from ..models.llama import (decoder_layer, forward_embed, forward_head, project_qkv,
                                rope_and_alibi)

    n = len(prompt)
    bucket, first, count = split_bucket(n, axis.size, axis.index, axis.size * 16)
    dev = planes[0].device
    toks = np.zeros(bucket, dtype=np.int64)
    toks[:n] = prompt
    where = np.full(bucket, trash, dtype=np.int64)
    where[:n] = slots[:n]
    mine = torch.from_numpy(where[first:first + count]).to(dev)
    att = cfg.attention
    x = forward_embed(params, cfg, torch.from_numpy(toks[first:first + count])[None].to(dev))
    cos, sin, _ = rope_and_alibi(cfg, torch.arange(first, first + count, device=dev)[None])
    for li, p in enumerate(params["layers"]):
        def attn(h, li=li, p=p):
            q, k, v = project_qkv(p, cfg, h, cos, sin)
            write_kv(li, k, v, mine[None])
            out = ring_attention(q, k, v, axis, sliding_window=att.layer_window(li),
                                 scale=att.score_scale(q.shape[-1]))
            return linear(out.reshape(1, count, -1).to(h.dtype), p["o"], p.get("o_bias"))

        x = decoder_layer(p, cfg, x, attn)
    gather_written(planes, mine, torch.from_numpy(where).to(dev), axis)
    last = n - 1
    row = x[:, last % count:last % count + 1].contiguous()
    return forward_head(params, cfg, broadcast(row, axis, last // count))


def gather_written(planes: list[torch.Tensor], index: torch.Tensor,
                   all_index: torch.Tensor, axis: Axis) -> None:
    """Copy every rank's block of each cache plane into every rank's:
    ``index`` [S_local] is where this rank wrote its positions along the
    plane's slot axis (dim 1: [L, slots, ...]), ``all_index`` [S] where
    each rank wrote, in axis order. One all-gather a plane."""
    for plane in planes:
        mine = plane.index_select(1, index)
        every = all_gather(mine, axis, dim=1)
        plane.index_copy_(1, all_index, every)
