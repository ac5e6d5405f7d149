"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

5:1 local:global attention interleave, 128k-capable. Local window 512 (gemma3
report); head_dim 256. [hf:google/gemma-3-1b-pt; unverified]

sub_quadratic: the 5/6 local layers are windowed; global layers at decode are
one-query-vs-KV (linear per step), so long_500k decode runs (see DESIGN.md §5).
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="gemma3-1b",
        family="dense",
        num_layers=26,
        d_model=1152,
        num_heads=4,
        num_kv_heads=1,
        d_ff=6912,
        vocab_size=262144,
        head_dim=256,
        layer_pattern=("L", "L", "L", "L", "L", "A"),
        window_size=512,
        rope_theta=1_000_000.0,
        source="hf:google/gemma-3-1b-pt",
        sub_quadratic=True,
    )
)
