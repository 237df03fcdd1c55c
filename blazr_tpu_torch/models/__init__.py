from .llama import forward
from .llama_paged import forward_paged
from .registry import Model, init_engine_cache, make_paged_forward

__all__ = ["Model", "forward", "forward_paged", "init_engine_cache",
           "make_paged_forward"]
