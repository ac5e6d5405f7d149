"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.

[arXiv:2403.17297; hf]
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="internlm2-1.8b",
        family="dense",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=92544,
        head_dim=128,
        rope_theta=1_000_000.0,
        source="arXiv:2403.17297",
        sub_quadratic=False,
    )
)
