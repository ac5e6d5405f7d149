"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8. head_dim 128 (q-proj dim 8192 > d_model,
as in the published config). [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        d_ff=1536,
        vocab_size=151936,
        head_dim=128,
        num_experts=128,
        moe_top_k=8,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-30B-A3B",
        sub_quadratic=False,
    )
)
