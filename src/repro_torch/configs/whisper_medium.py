"""whisper-medium [audio] — 24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.

Encoder-decoder; conv audio frontend is a STUB — ``input_specs()`` provides
precomputed frame embeddings [B, S_audio, d_model].  24 encoder + 24 decoder
layers (whisper-medium's published topology); decoder text length = seq//8
for train/prefill shapes (documented deviation, DESIGN.md §5).  Decode shapes
exercise the decoder with a seq_len self-attn KV cache + cross-attn KV over
seq_len frames. vocab 51865 padded to 52224. [arXiv:2212.04356; unverified]
"""
from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="whisper-medium",
        family="audio",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        head_dim=64,
        encoder_layers=24,
        decoder_layers=24,
        frontend="audio",
        rope_theta=10_000.0,
        source="arXiv:2212.04356",
        sub_quadratic=False,
    )
)
