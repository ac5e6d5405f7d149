"""Seeded random weights in the port's parameter tree, made by the benchmark
itself and handed alike to the program and to the plain reference.

The tree is the port's input format for a decoder of full-attention
blocks ('A'), dense or MoE: ``embed`` [Vp, D], ``groups.b0`` stacked over
the layers (``norm1``, ``norm2``, ``attn`` {wq, wk, wv, wo}, and ``ffn``
{w_gate, w_up, w_down} or ``moe`` {router (f32), experts {w1, w3, w2}}),
``rem`` empty, ``final_norm`` and ``lm_head`` [D, Vp].  One ``randn`` call
a leaf, on the device, from one ``torch.Generator`` there: a leaf holds
every layer, so a model is a dozen calls.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

VOCAB_ALIGN = 512
BF16, F32 = torch.bfloat16, torch.float32


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_ALIGN) * VOCAB_ALIGN


def make_weights(arch: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    L, D, F = arch["num_layers"], arch["d_model"], arch["d_ff"]
    H, Hkv, Dh = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    Vp = padded_vocab(arch["vocab_size"])

    def normal(shape, fan_in, dtype=BF16):
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return w.mul_(1.0 / math.sqrt(fan_in))

    def scale(shape):
        w = torch.randn(shape, generator=gen, dtype=F32, device=device)
        return w.mul_(0.05).add_(1.0).to(BF16)

    block: Dict[str, Any] = {
        "norm1": {"scale": scale((L, D))},
        "norm2": {"scale": scale((L, D))},
        "attn": {"wq": normal((L, D, H * Dh), D), "wk": normal((L, D, Hkv * Dh), D),
                 "wv": normal((L, D, Hkv * Dh), D), "wo": normal((L, H * Dh, D), H * Dh)},
    }
    E = arch.get("num_experts", 0)
    if E:
        block["moe"] = {"router": normal((L, D, E), D, dtype=F32),
                        "experts": {"w1": normal((L, E, D, F), D),
                                    "w3": normal((L, E, D, F), D),
                                    "w2": normal((L, E, F, D), F)}}
    else:
        block["ffn"] = {"w_gate": normal((L, D, F), D), "w_up": normal((L, D, F), D),
                        "w_down": normal((L, F, D), F)}
    return {"embed": normal((Vp, D), D), "groups": {"b0": block}, "rem": [],
            "final_norm": {"scale": scale((D,))}, "lm_head": normal((D, Vp), D)}


def leaves(tree, prefix=""):
    """(path, tensor) pairs of a tree, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree
