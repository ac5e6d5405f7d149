"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8. [arXiv:2409.02060; hf]
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="olmoe-1b-7b",
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        head_dim=128,
        num_experts=64,
        moe_top_k=8,
        rope_theta=10_000.0,
        source="arXiv:2409.02060",
        sub_quadratic=False,
    )
)
