"""rwkv6-3b [ssm] — 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.

RWKV-6 "Finch": data-dependent decay WKV recurrence, head size 64 (40 heads).
Constant-size state => long_500k decode runs. [arXiv:2404.05892; hf]
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="rwkv6-3b",
        family="ssm",
        num_layers=32,
        d_model=2560,
        num_heads=0,
        num_kv_heads=0,
        d_ff=8960,
        vocab_size=65536,
        head_dim=0,
        layer_pattern=("W",),
        rwkv_head_dim=64,
        source="arXiv:2404.05892",
        sub_quadratic=True,
    )
)
