"""Inference engine feature flags.

Counterpart of ``blazr_tpu/config/inference.py``: the same fields and
defaults, so a config file reads the same in both packages. The port serves
the paged KV cache, batched prefill and the pipelined multi-step decode
horizon in CUDA graphs with the prefix cache and its host tier
(``engine/batch_engine.py``), the contiguous cache with session reuse
(``engine/executor.py``) and every ``quant_compute``
mode; the other knobs are kept for layout and are rejected where they would
change behaviour.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class SpeculativeDecodingConfig:
    """Speculative decoding knobs (not served by this slice)."""

    draft_model: Optional[str] = None
    num_speculative_tokens: int = 5
    adaptive_depth: bool = True


@dataclass
class InferenceConfig:
    # Device / precision
    device: str = "auto"             # auto | cuda | cpu
    dtype: str = "bf16"              # f32 | f16 | bf16
    flash_attention: bool = True

    # KV cache
    kv_cache: bool = True
    # auto (model dtype) | int8 (per-token-per-head absmax scales) | int4
    # (the Executor's contiguous cache only: int4 values held in int8
    # storage; refused on the paged path instead of being downgraded).
    kv_cache_dtype: str = "auto"
    max_batch_size: int = 8
    max_seq_len: Optional[int] = None

    # Quantized-matmul compute mode for signed 4/8-bit weights:
    #   auto / w4a16 — int4 weight stream, bf16 activations (kernel B1;
    #     ``auto`` stays w4a16 on every device, ROADMAP §C)
    #   w4a8 — int8 activations on the int4 weights (kernel B3)
    #   w8a8 — weights widened to int8, int8 activations (kernel B3)
    #   w4a8-prefill — B3 for matmuls of 256+ rows, B1 below
    quant_compute: str = "auto"

    # Paged attention.
    paged_attention: bool = True
    block_size: int = 64
    num_blocks: Optional[int] = None
    kv_pool_blocks: Optional[int] = None

    # Prefix caching: full prompt blocks shared across sequences (at most
    # max_cached_blocks registered); with gpu_prefix_cache, evicted blocks
    # go to a host-RAM tier of prefix_cache_ram_tier blocks (fewer if they
    # would take more than kvcache/host_tier.py's MAX_BYTES: its pool is
    # allocated, and pinned on CUDA, when the engine is built).
    prefix_cache: bool = False
    max_cached_blocks: int = 10000
    gpu_prefix_cache: bool = False
    prefix_cache_ram_tier: int = 5000

    # Chunked prefill (interleaves decode between chunks to protect ITL)
    prefill_chunk_size: Optional[int] = None

    # Prefill-priority pacing: a burst of FINISHING prefill rows dispatches
    # in groups of this size so early requests' first tokens land early.
    # 0 disables the ramp (always full-width groups).
    prefill_first_group: int = 8

    # With decode rows active, at most this many finishing prefill rows run
    # per engine step, so a decode round runs between prefill groups.
    # None = prefill_first_group; 0 disables the cap.
    mixed_prefill_rows: Optional[int] = None

    # Prompt tokens the scheduler may admit per scheduling round.
    # None = prefill_chunk_size x 32 (one full prefill group).
    max_batch_tokens: Optional[int] = None

    # Decode horizon: up to this many decode steps per round with the
    # sampled tokens fed back on the device and ONE host fetch per round.
    # 1 disables.
    decode_horizon: int = 8
    # Dispatched-but-unread decode rounds the BatchEngine keeps in flight:
    # round N+1 is queued from round N's device carries before round N is
    # read.
    decode_pipe_depth: int = 2

    # Speculative decoding (not served by this slice)
    speculative: Optional[SpeculativeDecodingConfig] = None

    # Parallelism (not served by this slice)
    tensor_parallel_size: int = 1
    data_parallel_size: int = 1
    expert_parallel_size: int = 1
    sequence_parallel_size: int = 1
    sp_prefill_threshold: int = 256

    # MoE / layer offload (not served by this slice)
    moe_offload: Optional[str] = None
    moe_gpu_experts: Optional[int] = None
    moe_device_experts: Optional[int] = None
    moe_rebalance_interval: int = 64
    num_device_layers: Optional[int] = None

    # Decode graphs: on CUDA each fixed-shape decode step of the BatchEngine
    # and the Executor is a CUDA graph, captured on first use of its shape
    # (engine/decode_graph.py); False runs the same steps eagerly. The CPU
    # always runs them eagerly.
    graphs: bool = True

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "InferenceConfig":
        d = dict(d)
        if isinstance(d.get("speculative"), dict):
            known = {f.name for f in dataclasses.fields(SpeculativeDecodingConfig)}
            d["speculative"] = SpeculativeDecodingConfig(
                **{k: v for k, v in d["speculative"].items() if k in known}
            )
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
