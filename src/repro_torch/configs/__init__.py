"""Architecture registry: one module per assigned architecture."""

from .base import (
    ArchConfig,
    ShapeConfig,
    SHAPES,
    all_archs,
    cells,
    get_arch,
    pad_vocab,
    register,
)

from . import (  # noqa: F401  (import side effect: registry population)
    llama3_8b,
    gemma3_1b,
    internlm2_1_8b,
    llama3_2_3b,
    whisper_medium,
    recurrentgemma_9b,
    llava_next_34b,
    rwkv6_3b,
    olmoe_1b_7b,
    qwen3_moe_235b_a22b,
)

ALL_ARCHS = (
    "llama3-8b",
    "gemma3-1b",
    "internlm2-1.8b",
    "llama3.2-3b",
    "whisper-medium",
    "recurrentgemma-9b",
    "llava-next-34b",
    "rwkv6-3b",
    "olmoe-1b-7b",
    "qwen3-moe-235b-a22b",
)

__all__ = [
    "ArchConfig", "ShapeConfig", "SHAPES", "ALL_ARCHS",
    "all_archs", "cells", "get_arch", "pad_vocab", "register",
]
