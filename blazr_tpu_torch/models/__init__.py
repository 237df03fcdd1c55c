from .llama import forward
from .llama_paged import forward_paged
from .paged_multi import init_engine_cache, make_paged_forward
from .registry import Model

__all__ = ["Model", "forward", "forward_paged", "init_engine_cache",
           "make_paged_forward"]
