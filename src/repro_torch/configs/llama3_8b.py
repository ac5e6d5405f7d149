"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

GQA + 128k vocab. [arXiv:2407.21783; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="llama3-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        head_dim=128,
        rope_theta=500_000.0,
        source="arXiv:2407.21783",
        sub_quadratic=False,
    )
)
