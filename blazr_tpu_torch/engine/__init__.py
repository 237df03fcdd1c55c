from .batch_engine import BatchEngine, RequestHandle
from .executor import Executor
from .sampling import SamplingParams, sample_tokens
from .types import FinishReason, GeneratedToken, GenerationResult

__all__ = ["BatchEngine", "Executor", "FinishReason", "GeneratedToken",
           "GenerationResult", "RequestHandle", "SamplingParams", "sample_tokens"]
