"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000. RG-LRU + local attention, 2 recurrent : 1 local-attn
(pattern R,R,L), window 2048, rnn width 4096. [arXiv:2402.19427; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        d_ff=12288,
        vocab_size=256000,
        head_dim=256,
        layer_pattern=("R", "R", "L"),
        window_size=2048,
        rnn_width=4096,
        conv_width=4,
        rope_theta=10_000.0,
        source="arXiv:2402.19427",
        sub_quadratic=True,
    )
)
