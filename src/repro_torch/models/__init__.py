from .api import (
    attn_chunk,
    cache_init,
    init_params,
    is_encdec,
    make_decode_step,
    make_prefill_step,
)

__all__ = [
    "attn_chunk", "cache_init", "init_params", "is_encdec",
    "make_decode_step", "make_prefill_step",
]
