from .batch_engine import BatchEngine, RequestHandle
from .sampling import SamplingParams, sample_tokens
from .types import FinishReason, GeneratedToken

__all__ = ["BatchEngine", "FinishReason", "GeneratedToken", "RequestHandle",
           "SamplingParams", "sample_tokens"]
