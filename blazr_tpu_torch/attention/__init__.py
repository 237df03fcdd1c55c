from .paged_attention import paged_attention_decode, paged_attention_reference

__all__ = ["paged_attention_decode", "paged_attention_reference"]
