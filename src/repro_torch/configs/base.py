"""Architecture + shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; every workload shape
is a ``ShapeConfig``.  The dry-run / roofline machinery iterates the cross
product (40 cells).  ``reduced()`` derives the CPU-smoke-test variant of any
architecture (same family/topology, tiny dims).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

VOCAB_ALIGN = 512  # pad vocab to a multiple (MXU alignment + shardability)


def pad_vocab(v: int) -> int:
    return ((v + VOCAB_ALIGN - 1) // VOCAB_ALIGN) * VOCAB_ALIGN


@dataclass(frozen=True)
class ArchConfig:
    """One architecture from the assigned pool (exact published dims)."""

    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 => attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int
    # --- MoE ---
    num_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # --- layer pattern (hybrid stacks) ---
    # 'A' full attn, 'L' local/windowed attn, 'R' RG-LRU recurrent block,
    # 'W' RWKV6 time-mix. Empty pattern = all-'A'.
    layer_pattern: Tuple[str, ...] = ()
    window_size: int = 0         # local-attention window ('L' layers)
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    decoder_layers: int = 0
    # --- modality frontends (stubs per instructions) ---
    frontend: str = "none"       # none | audio | vision
    num_patches: int = 0         # vlm: patch positions within the sequence
    # --- misc ---
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    rnn_width: int = 0           # RG-LRU recurrence width
    rwkv_head_dim: int = 64
    conv_width: int = 4          # RG-LRU temporal conv
    source: str = ""             # provenance note
    sub_quadratic: bool = False  # eligible for long_500k decode
    # --- latent attention (MLA, DeepSeek-V2); kv_lora_rank 0 => none ---
    # head_dim is then the query/key head, qk_nope_head_dim + qk_rope_head_dim
    kv_lora_rank: int = 0        # the cached latent c_kv's width
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0    # the roped part, k_pe shared by the heads
    v_head_dim: int = 0
    # --- YaRN rotary scaling (rope_factor 0 => plain rope; its other
    # constants are the published model's, in models/layers.py) ---
    rope_factor: float = 0.0
    rope_original_max_pos: int = 0
    # --- DeepSeek-style MoE ---
    first_dense_layers: int = 0  # leading layers with a dense FFN of dense_d_ff
    dense_d_ff: int = 0
    shared_d_ff: int = 0         # the shared experts as one SwiGLU; 0 => none
    norm_topk_prob: bool = True  # renormalise the top-k gates to sum to 1
    dropless: bool = False       # capacity always holds the fullest expert

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def pattern(self) -> Tuple[str, ...]:
        """Full per-layer pattern (length == num_layers)."""
        if not self.layer_pattern:
            return ("A",) * self.num_layers
        reps = math.ceil(self.num_layers / len(self.layer_pattern))
        return tuple((self.layer_pattern * reps)[: self.num_layers])

    # ---------------------------------------------------------------- params
    def param_count(self) -> int:
        """Total parameters N (analytic; embeddings included)."""
        if self.kv_lora_rank:
            return self._mla_param_count(active=False)
        d, f = self.d_model, self.d_ff
        per_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        per_dense_ffn = 3 * d * f  # SwiGLU (gate, up, down)
        per_moe_ffn = self.num_experts * 3 * d * f + d * self.num_experts
        per_rglru = 0
        if self.rnn_width:
            w = self.rnn_width
            per_rglru = 2 * d * w + w * d + 2 * w * w // w + self.conv_width * w + 2 * w
        per_rwkv = 7 * d * d // 1  # r,k,v,g,o projections + decay LoRA approx
        n = 0
        for kind in self.pattern():
            n += 2 * d  # norms
            if kind in ("A", "L"):
                n += per_attn + (per_moe_ffn if self.num_experts else per_dense_ffn)
            elif kind == "R":
                n += per_rglru + per_dense_ffn
            elif kind == "W":
                n += per_rwkv + per_dense_ffn
        if self.encoder_layers:  # whisper: encoder + cross-attn in decoder
            n += self.encoder_layers * (per_attn + per_dense_ffn + 2 * d)
            n += self.decoder_layers * per_attn  # cross attention
        n += self.padded_vocab * d  # embeddings
        n += self.padded_vocab * d  # lm head (untied)
        return n

    def active_param_count(self) -> int:
        """N_active for MoE (6*N_active*D convention)."""
        if self.kv_lora_rank:
            return self._mla_param_count(active=True)
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_total = self.param_count()
        moe_all = self.num_layers * self.num_experts * 3 * d * f
        moe_active = self.num_layers * self.moe_top_k * 3 * d * f
        return dense_total - moe_all + moe_active

    def _mla_param_count(self, active: bool) -> int:
        """MLA decoder: leading dense layers, then MoE layers with a shared
        SwiGLU; ``active`` counts the top-k experts a token reaches."""
        d, h, r = self.d_model, self.num_heads, self.kv_lora_rank
        attn = (d * h * self.head_dim + d * (r + self.qk_rope_head_dim) + r
                + r * h * (self.qk_nope_head_dim + self.v_head_dim)
                + h * self.v_head_dim * d)
        experts = self.moe_top_k if active else self.num_experts
        moe = (experts * 3 * d * self.d_ff + d * self.num_experts
               + 3 * d * self.shared_d_ff)
        lead = self.first_dense_layers
        n = lead * (attn + 3 * d * self.dense_d_ff + 2 * d)
        n += (self.num_layers - lead) * (attn + moe + 2 * d)
        return n + d + 2 * self.padded_vocab * d

    def train_microbatches(self, global_batch: int) -> int:
        """Gradient-accumulation microbatches for the train step.

        Sized so per-device activation memory fits v5e HBM (16 GiB):
        large stacks accumulate grads over n sequential microbatches.
        """
        n_params = self.param_count()
        if n_params > 100e9:
            n = 8
        elif n_params > 20e9:
            n = 4
        elif n_params > 5e9:
            n = 2
        else:
            n = 1
        while n > 1 and global_batch % n:
            n //= 2
        return n

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: Dict = dict(
            num_layers=min(self.num_layers, 4),
            d_model=64,
            num_heads=max(1, min(self.num_heads, 4)),
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            rope_theta=10_000.0,
        )
        if self.num_experts:
            kw.update(num_experts=4, moe_top_k=2)
        if self.layer_pattern:
            kw.update(num_layers=max(4, len(self.layer_pattern)))
        if self.encoder_layers:
            kw.update(encoder_layers=2, decoder_layers=2, num_layers=2)
        if self.rnn_width:
            kw.update(rnn_width=64)
        if self.window_size:
            kw.update(window_size=16)
        if self.num_patches:
            kw.update(num_patches=8)
        if self.family == "ssm":
            kw.update(rwkv_head_dim=16, num_heads=0, num_kv_heads=0)
        if self.kv_lora_rank:
            kw.update(num_kv_heads=kw["num_heads"], kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16, head_dim=24)
        if self.first_dense_layers:
            kw.update(dense_d_ff=192)
        if self.shared_d_ff:
            kw.update(shared_d_ff=64)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    def reduced(self) -> "ShapeConfig":
        return ShapeConfig(self.name, self.kind, min(self.seq_len, 64), min(self.global_batch, 2))


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # populate registry lazily
        from . import ALL_ARCHS  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> Dict[str, ArchConfig]:
    from . import ALL_ARCHS  # noqa: F401
    return dict(_REGISTRY)


def cells(arch: ArchConfig) -> Tuple[ShapeConfig, ...]:
    """The shape cells that run for this arch (skips documented in DESIGN.md)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not arch.sub_quadratic:
            continue  # pure full-attention: sub-quadratic required (skip)
        out.append(s)
    return tuple(out)
