"""Mamba2 selective-state-space model.

Counterpart of ``blazr_tpu/models/mamba2.py`` (``gated_rms_norm`` :31,
``_split_proj`` :39, ``_conv_prefill`` :63, ``_ssm_scan`` :79,
``_scan_associative`` :114 and ``_scan_chunked`` :144 (one form here),
``mamba2_block`` :399,
``forward`` :429, ``build_mamba2_params`` :463) for the Mamba2 variant:

  * in_proj (kernel B1 when quantized) → [z | xBC | dt] (HF ordering);
  * the causal depthwise conv over xBC with its rolling [conv_dim, k-1]
    window, in f32;
  * the selective scan s_t = exp(dt_t·A)·s_{t-1} + dt_t·B_t ⊗ x_t,
    y_t = C_t·s_t + D·x_t in f32: the step form at one token, else the
    chunked SSD form in chunks of ``_CHUNK`` tokens (one chunk up to it;
    the JAX package takes its associative scan up to 128 tokens and its
    chunked one above, the same function);
  * the gated RMSNorm norm(y · silu(z)) over all of d_inner (as the JAX
    package and transformers' ``MambaRMSNormGated``), then out_proj (B1).

The conv, the scan and the norm are XLA in the JAX package, no Pallas
kernel, so they stay plain PyTorch. A block reads and writes its layer of
the state IN PLACE, all rows or the rows ``rows`` names (the engine's state
slots), so a captured decode graph holds the state. Mamba3 is not served
(``models/llama.py::check_config``, ROADMAP queue A item 11).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..config.model_config import UniversalConfig
from ..kvcache.ssm_state import SSMState
from . import llama
from .layers import linear, rms_norm

# The chunked scan's chunk: a call of up to this many tokens is one chunk.
_CHUNK = 128


def gated_rms_norm(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """HF ``MambaRMSNormGated``: the variance of y·silu(z) over d_inner."""
    g = (y * F.silu(z.to(y.dtype))).to(torch.float32)
    var = (g * g).mean(dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * weight.to(torch.float32)).to(y.dtype)


def _split_proj(cfg: UniversalConfig, zxbcdt: torch.Tensor):
    ssm = cfg.ssm
    d_inner = ssm.inner_size
    g_state = ssm.n_groups * ssm.state_size
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:2 * d_inner + 2 * g_state],
            zxbcdt[..., 2 * d_inner + 2 * g_state:])


def _conv(xbc: torch.Tensor, conv_state: torch.Tensor, conv_w: torch.Tensor,
          conv_b: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, T, C] causal depthwise conv over the window ``conv_state`` [B, C,
    k-1], in f32; (silu(out) [B, T, C], the new window)."""
    t = xbc.shape[1]
    k = conv_w.shape[-1]
    w = conv_w.to(torch.float32)
    seq = torch.cat([conv_state.transpose(1, 2), xbc.to(torch.float32)], dim=1)
    out = seq[:, 0:t] * w[:, 0]
    for j in range(1, k):
        out = out + seq[:, j:j + t] * w[:, j]
    if conv_b is not None:
        out = out + conv_b.to(torch.float32)
    return F.silu(out), seq[:, t:].transpose(1, 2)


def _scan_step(xh, bw, ch, ldec, state):
    """One token: xh [B, 1, H, hd], bw/ch [B, 1, H, N], ldec [B, 1, H]."""
    s = (torch.exp(ldec[:, 0])[..., None, None] * state
         + xh[:, 0, :, :, None] * bw[:, 0, :, None, :])
    return torch.einsum("bhn,bhdn->bhd", ch[:, 0], s)[:, None], s


def _scan_chunked(xh, bw, ch, ldec, state, chunk: int = _CHUNK):
    """The chunked SSD form (the JAX package's ``_scan_chunked``) in chunks
    of ``min(chunk, T)`` tokens. Within a chunk the closed form
    y_t = Σ_{s≤t} exp(L_t − L_s)·(C_t·B_s)·x_s + exp(L_t)·C_t·S_0, with L
    the running sum of the log-decays; across chunks a short recurrence
    over the [B, H, hd, N] states. The tail is zero-padded (a zero
    log-decay and a zero input change neither y nor the state)."""
    b, t, h, hd = xh.shape
    n = bw.shape[-1]
    q = min(chunk, t)
    pad = (-t) % q
    if pad:
        xh, bw, ch, ldec = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                            for a in (xh, bw, ch, ldec))
    nc = (t + pad) // q
    xc = xh.reshape(b, nc, q, h, hd)
    bc = bw.reshape(b, nc, q, h, n)
    cc = ch.reshape(b, nc, q, h, n)
    lcum = torch.cumsum(ldec.reshape(b, nc, q, h), dim=2)             # [B, NC, Q, H]
    lt = lcum.permute(0, 1, 3, 2)                                     # [B, NC, H, Q]
    causal = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    ldiff = torch.where(causal, lt[..., :, None] - lt[..., None, :],
                        torch.full_like(lt[..., None], float("-inf")))
    att = torch.exp(ldiff) * torch.einsum("bcthn,bcshn->bchts", cc, bc)
    y = torch.einsum("bchts,bcshd->bcthd", att, xc)
    lend = lcum[:, :, -1]                                             # [B, NC, H]
    wend = torch.exp(lend[:, :, None, :] - lcum)                      # [B, NC, Q, H]
    chunk_state = torch.einsum("bcsh,bcshd,bcshn->bchdn", wend, xc, bc)
    chunk_decay = torch.exp(lend)
    before = []
    s = state
    for c in range(nc):
        before.append(s)
        s = chunk_decay[:, c, :, None, None] * s + chunk_state[:, c]
    s_before = torch.stack(before, dim=1)                             # [B, NC, H, hd, N]
    y = y + torch.einsum("bcthn,bchdn->bcthd", cc * torch.exp(lcum)[..., None], s_before)
    return y.reshape(b, nc * q, h, hd)[:, :t], s


def _ssm_scan(cfg: UniversalConfig, x: torch.Tensor, b_in: torch.Tensor,
              c_in: torch.Tensor, dt: torch.Tensor, state: torch.Tensor,
              p: dict[str, Any], chunk: Optional[int] = None):
    """The selective scan of x [B, T, d_inner] with B/C [B, T, G·N] and dt
    [B, T, H] from ``state`` [B, H, hd, N]: (y [B, T, d_inner], the new
    state), all f32. One token takes the step form, more the chunked one;
    ``chunk`` sets its chunk length (tests; default ``_CHUNK``)."""
    ssm = cfg.ssm
    b, t, _ = x.shape
    h, hd, n, g = ssm.num_heads, ssm.head_dim, ssm.state_size, ssm.n_groups
    a = -torch.exp(p["A_log"].to(torch.float32))
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))   # [B, T, H]
    xh = x.reshape(b, t, h, hd).to(torch.float32)
    bh = b_in.reshape(b, t, g, n).to(torch.float32).repeat_interleave(h // g, dim=2)
    ch = c_in.reshape(b, t, g, n).to(torch.float32).repeat_interleave(h // g, dim=2)
    ldec = dt * a
    bw = bh * dt[..., None]
    if chunk is None and t == 1:
        y, final = _scan_step(xh, bw, ch, ldec, state)
    else:
        y, final = _scan_chunked(xh, bw, ch, ldec, state, chunk or _CHUNK)
    y = y + p["D"].to(torch.float32)[:, None] * xh
    return y.reshape(b, t, h * hd), final


def mamba2_block(p: dict[str, Any], cfg: UniversalConfig, x: torch.Tensor,
                 state: SSMState, layer: int,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Mamba2 mixer over x [B, T, H]. Reads layer ``layer`` of
    ``state`` (its rows ``rows`` [B] where given: the engine's state slots)
    and writes the new conv window and SSM state back in place."""
    ssm = cfg.ssm
    z, xbc, dt = _split_proj(cfg, linear(x, p["in_proj"]))
    conv0 = state.conv[layer] if rows is None else state.conv[layer].index_select(0, rows)
    ssm0 = state.ssm[layer] if rows is None else state.ssm[layer].index_select(0, rows)
    xbc, conv1 = _conv(xbc, conv0, p["conv_w"], p.get("conv_b"))
    d_inner = ssm.inner_size
    g_state = ssm.n_groups * ssm.state_size
    y, ssm1 = _ssm_scan(cfg, xbc[..., :d_inner], xbc[..., d_inner:d_inner + g_state],
                        xbc[..., d_inner + g_state:], dt, ssm0, p)
    if rows is None:
        state.conv[layer].copy_(conv1)
        state.ssm[layer].copy_(ssm1)
    else:
        state.conv[layer].index_copy_(0, rows, conv1)
        state.ssm[layer].index_copy_(0, rows, ssm1)
    y = gated_rms_norm(y, z, p["norm"], cfg.rms_norm_eps)
    return linear(y.to(x.dtype), p["out_proj"])


def decoder_layer(p: dict[str, Any], cfg: UniversalConfig, x: torch.Tensor,
                  mixer) -> torch.Tensor:
    """One layer of a Mamba2 or hybrid model around ``mixer(h)`` (a Mamba2
    mixer or attention): the pre-norm residual block, then the layer's FFN
    where it has one (dense, fused, plain or MoE: ``llama.mlp``; the JAX
    hybrid forward's :91-114)."""
    x = x + mixer(rms_norm(x, p["input_norm"], cfg.rms_norm_eps))
    if any(p.get(k) is not None for k in ("gate", "moe", "gateup", "fc")):
        x = x + llama.mlp(p, cfg, rms_norm(x, p["post_norm"], cfg.rms_norm_eps))
    return x


def forward(params: dict[str, Any], cfg: UniversalConfig, tokens: torch.Tensor,
            state: SSMState, positions: torch.Tensor,
            seq_lens: Optional[torch.Tensor] = None,
            last_idx: Optional[torch.Tensor] = None,
            rows: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, SSMState]:
    """Logits [B, T (or 1), V] f32 and the state (written in place).
    ``positions`` and ``seq_lens`` are unused (the state is O(1)); every
    token of ``tokens`` enters the scan, so a caller never pads."""
    x = llama.forward_embed(params, cfg, tokens)
    for i, p in enumerate(params["layers"]):
        x = decoder_layer(p, cfg, x, lambda h: mamba2_block(p, cfg, h, state, i, rows))
    if rows is None:
        state.length.add_(tokens.shape[1])
    else:
        state.length.index_add_(0, rows, torch.full_like(rows, tokens.shape[1],
                                                         dtype=torch.int32))
    return llama.forward_head(params, cfg, llama.last_positions(x, last_idx)), state


def mamba_layer_params(pb, pfxs: tuple[str, ...],
                       norms: tuple[str, ...] = ("norm.weight", "input_layernorm.weight")
                       ) -> dict:
    """A Mamba2 layer's mixer under the first prefix that has it (HF
    ``backbone.layers.{i}.`` / ``model.layers.{i}.`` with ``mixer.*``, or a
    hybrid's ``mamba.*``) and its input norm, the first of ``norms``; the
    conv weight [C, 1, k] as [C, k]."""
    def get(*leaves, **kw):
        return pb.get(*(pf + leaf for leaf in leaves for pf in pfxs), **kw)

    conv_w = get("mixer.conv1d.weight", "mamba.conv1d.weight")
    if conv_w.dim() == 3:
        conv_w = conv_w[:, 0, :].contiguous()
    f32 = torch.float32
    return {
        "input_norm": get(*norms),
        "in_proj": get("mixer.in_proj.weight", "mamba.in_proj.weight", transpose=True),
        "conv_w": conv_w,
        "conv_b": get("mixer.conv1d.bias", "mamba.conv1d.bias", required=False),
        "A_log": get("mixer.A_log", "mixer.A_log.weight", "mamba.A_log", dtype=f32),
        "D": get("mixer.D", "mixer.D.weight", "mamba.D", dtype=f32),
        "dt_bias": get("mixer.dt_bias", "mixer.dt_bias.weight", "mamba.dt_bias",
                       dtype=f32),
        "norm": get("mixer.norm.weight", "mamba.norm.weight"),
        "out_proj": get("mixer.out_proj.weight", "mamba.out_proj.weight", transpose=True),
    }


def build_mamba2_params(cfg: UniversalConfig, vm, dtype: torch.dtype,
                        device: torch.device) -> dict:
    """HF ``Mamba2ForCausalLM`` names (``backbone.*``) or ``model.*``."""
    from .registry import ParamBuilder

    pb = ParamBuilder(vm, dtype, device)
    layers = [mamba_layer_params(pb, (f"backbone.layers.{i}.", f"model.layers.{i}."))
              for i in range(cfg.num_layers)]
    params = {
        "embed": pb.get("backbone.embeddings.weight", "backbone.embedding.weight",
                        "model.embed_tokens.weight"),
        "final_norm": pb.get("backbone.norm_f.weight", "model.norm.weight"),
        "layers": layers,
        "lm_head": pb.get("lm_head.weight", transpose=True, required=False),
    }
    if params["lm_head"] is None and not cfg.tie_word_embeddings:
        cfg.tie_word_embeddings = True
    return params
