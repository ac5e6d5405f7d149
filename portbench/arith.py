"""The yardstick's arithmetic: the card's peaks, and the operations and bytes
of the work a cell ran, from its shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit
(989 TFLOP/s bf16, 3.35 TB/s HBM).  Operations count two a multiply-add.
A forward pass's operations follow ``chip_smoke.py::forward_ops`` (the
matmuls, and the unmasked (query, key) pairs of causal attention); a train
step's useful operations are three forward passes' worth (6 a parameter a
token, plus attention forward and backward), without the recompute.
"""

from __future__ import annotations

from typing import Any, Dict

PEAK_FLOPS = 989e12          # bf16 dense
HBM_BW = 3.35e12             # bytes/s
BF16_BYTES = 2


def padded_vocab(v: int) -> int:
    return -(-v // 512) * 512


def _dims(arch: Dict[str, Any]):
    return (arch["num_layers"], arch["d_model"], arch["num_heads"],
            arch["num_kv_heads"], arch["head_dim"], arch["d_ff"])


def layer_matmul_params(arch: Dict[str, Any]) -> int:
    """Parameters of one layer that a token's forward multiplies by: the
    attention projections, and the dense FFN or the top-k experts a token
    routes to (the router too)."""
    L, D, H, Hkv, Dh, F = _dims(arch)
    attn = D * H * Dh * 2 + D * Hkv * Dh * 2
    E, K = arch.get("num_experts", 0), arch.get("moe_top_k", 0)
    ffn = K * 3 * D * F + D * E if E else 3 * D * F
    return attn + ffn


def attn_pair_ops(arch: Dict[str, Any]) -> int:
    """Operations of one (query, key) pair in one layer: q.k and p.v over
    every head."""
    _, _, H, _, Dh, _ = _dims(arch)
    return 4 * H * Dh


def prefill_ops(arch: Dict[str, Any], S: int) -> int:
    """A prefill of S tokens: every matmul on S positions, causal attention
    over S (S + 1) / 2 pairs a layer, the LM head on the last position."""
    L, D = arch["num_layers"], arch["d_model"]
    head = D * padded_vocab(arch["vocab_size"])
    return (2 * L * layer_matmul_params(arch) * S + 2 * head
            + L * attn_pair_ops(arch) * S * (S + 1) // 2)


def decode_ops(arch: Dict[str, Any], pos: int) -> int:
    """One decode token at position ``pos``: the matmuls, attention over the
    pos + 1 cached keys, the LM head."""
    L, D = arch["num_layers"], arch["d_model"]
    head = D * padded_vocab(arch["vocab_size"])
    return 2 * L * layer_matmul_params(arch) + 2 * head + L * attn_pair_ops(arch) * (pos + 1)


def attention_bound_s(arch: Dict[str, Any], kind: str, n: int) -> float:
    """The least time of the attention of one call over every layer:
    ``prefill`` of n tokens (causal), or ``decode`` of one token at
    position n - 1 (n keys).  max(operations / peak, bytes / HBM), the
    bytes each input read once and the output written once (bf16)."""
    L, _, H, Hkv, Dh, _ = _dims(arch)
    if kind == "prefill":
        ops = attn_pair_ops(arch) * n * (n + 1) // 2
        nbytes = BF16_BYTES * n * Dh * (2 * H + 2 * Hkv)
    elif kind == "decode":
        ops = attn_pair_ops(arch) * n
        nbytes = BF16_BYTES * Dh * (2 * H + 2 * Hkv * n)
    else:
        raise ValueError(kind)
    return L * max(ops / PEAK_FLOPS, nbytes / HBM_BW)


def train_step_ops(arch: Dict[str, Any], batch: int, seq: int) -> int:
    """Useful operations of one train step on [batch, seq] tokens: 6 a
    matmul parameter a token (the LM head on the seq - 1 positions the loss
    reads, over the padded vocabulary), and
    causal attention's pairs three times (forward, and backward's two
    products), not the recompute."""
    L, D = arch["num_layers"], arch["d_model"]
    head = D * padded_vocab(arch["vocab_size"])
    return (6 * L * layer_matmul_params(arch) * batch * seq
            + 6 * head * batch * (seq - 1)
            + 3 * L * attn_pair_ops(arch) * batch * seq * (seq + 1) // 2)
