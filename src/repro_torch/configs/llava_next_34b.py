"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000. Anyres tiling frontend is a STUB — ``input_specs()`` provides
precomputed patch embeddings for ``num_patches`` positions (anyres 2x2 grid +
base: up to 2880 patches; we use min(2304, seq//2)).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="llava-next-34b",
        family="vlm",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        head_dim=128,
        frontend="vision",
        num_patches=2304,
        rope_theta=5_000_000.0,
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
        sub_quadratic=False,
    )
)
