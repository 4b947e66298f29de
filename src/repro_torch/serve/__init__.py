from .engine import (ServeEngine, cache_max_len, make_decode_step,
                     make_prefill_step)

__all__ = ["ServeEngine", "cache_max_len", "make_prefill_step",
           "make_decode_step"]
