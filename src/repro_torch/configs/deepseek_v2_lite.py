"""deepseek-v2-lite [moe] — 27L d_model=2048, MLA 16H (kv_lora_rank=512,
q_lora_rank none, qk 128 + 64 rope, v 128), YaRN rope (factor 40 over
4,096), layer 0 a dense SwiGLU of 10,944, layers 1-26 MoE: 64 routed
experts of 1,408, softmax top-6 gates not renormalised, 2 shared experts,
no token dropped; vocab 102,400.  [arXiv:2405.04434; hf config.json]

A port-only configuration: the JAX package has no latent attention, so
it stays out of ``ALL_ARCHS`` and out of the registry that the tests
parametrised over every architecture hold against that package.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    head_dim=192,
    num_experts=64,
    moe_top_k=6,
    rope_theta=10_000.0,
    norm_eps=1e-6,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_factor=40.0,
    rope_original_max_pos=4096,
    first_dense_layers=1,
    dense_d_ff=10944,
    shared_d_ff=2816,
    norm_topk_prob=False,
    dropless=True,
    source="arXiv:2405.04434",
    sub_quadratic=False,
)
