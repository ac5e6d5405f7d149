"""The plain reference of the served decoders: one sequence, full forward,
in float32, written from the model's equations with plain ``torch`` and
nothing of the program.

A decoder of full-attention blocks: token embedding; per layer RMSNorm,
GQA attention with rotary positions (the half-split rotation, base
``rope_theta``) under a causal mask, the output projection and the
residual, RMSNorm, then a SwiGLU FFN or a mixture of experts, and the
residual; a final RMSNorm and the LM head over the vocabulary.

The mixture of experts is the port's configuration: softmax router, top-k
gates renormalised to sum to one, and a capacity of
``ceil(T * k / E * factor)`` rounded up to a multiple of 8 per expert over
each dispatch group of T tokens, where an expert keeps the first
assignments in (token, pick) order and drops the rest.  A served session's
dispatch groups are its prefill and then each decode step, so
``segments`` gives their lengths.

``precision="fp8"`` is the control: every matmul operand rounded to
float8 e4m3 with one scale a tensor, the rest as above.

The weights are the tree the benchmark made (``portbench/weights.py``),
read layer by layer and upcast, so the reference fits beside them.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence

import torch

F32 = torch.float32
FP8_MAX = 448.0


@contextmanager
def exact_f32():
    """float32 matmuls without TF32 for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


class Math:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def q(self, x):
        x = x.to(F32)
        return _fp8(x) if self.fp8 else x

    def mm(self, a, b):
        return self.q(a) @ self.q(b)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.to(F32)


def rope(x, pos, theta):
    """x [S, H, Dh] f32; the first and second halves rotated together."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float64, device=x.device) / half)
    ang = pos.to(torch.float64)[:, None] * freqs
    cos, sin = torch.cos(ang).to(F32)[:, None, :], torch.sin(ang).to(F32)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(M: Math, q, k, v, q_block: int):
    """Causal GQA: q [S, H, Dh], k/v [S, Hkv, Dh]; query head h reads KV
    head h // (H / Hkv).  Query rows in blocks, each against the keys up
    to its last row."""
    S, H, Dh = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    out = torch.empty_like(q)
    kh = M.q(k).permute(1, 0, 2)                        # [Hkv, S, Dh]
    vh = M.q(v).permute(1, 0, 2)
    qq = M.q(q)
    for lo in range(0, S, q_block):
        hi = min(S, lo + q_block)
        qb = qq[lo:hi].reshape(hi - lo, Hkv, rep, Dh).permute(1, 2, 0, 3)
        s = torch.einsum("grqd,gkd->grqk", qb, kh[:, :hi]) / math.sqrt(Dh)
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(hi, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        p = M.q(torch.softmax(s, dim=-1))
        o = torch.einsum("grqk,gkd->grqd", p, vh[:, :hi])       # [Hkv, rep, q, Dh]
        out[lo:hi] = o.permute(2, 0, 1, 3).reshape(hi - lo, H, Dh)
    return out


def capacity(T: int, k: int, E: int, factor: float, multiple: int = 8) -> int:
    c = int(math.ceil(T * k / E * factor))
    return max(multiple, -(-c // multiple) * multiple)


def moe(M: Math, x, p, l: int, E: int, K: int, factor: float, segments: Sequence[int]):
    """x [T, D] f32 through the experts of layer ``l``."""
    T = x.shape[0]
    probs = torch.softmax(M.mm(x, p["router"][l]), dim=-1)
    gate, pick = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    kept = torch.zeros((T, K), dtype=torch.bool, device=x.device)
    start = 0
    for n in segments:
        C = capacity(n, K, E, factor)
        if n <= C:          # an expert takes at most one pick a token: none dropped
            kept[start:start + n] = True
            start += n
            continue
        flat = pick[start:start + n].reshape(-1)             # (token, pick) order
        for e in torch.unique(flat).tolist():
            idx = torch.nonzero(flat == e)[:C, 0]
            kept[start:start + n].view(-1)[idx] = True
        start += n
    if start != T:
        raise ValueError(f"segments cover {start} of {T} tokens")
    out = torch.zeros_like(x)
    w = p["experts"]
    for e in torch.unique(pick).tolist():
        tok, slot = torch.nonzero((pick == e) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        g = M.mm(xe, w["w1"][l, e])
        u = M.mm(xe, w["w3"][l, e])
        y = M.mm(torch.nn.functional.silu(g) * u, w["w2"][l, e])
        out.index_add_(0, tok, y * gate[tok, slot][:, None])
    return out


def forward_logits(W: Dict[str, Any], arch: Dict[str, Any], tokens: torch.Tensor,
                   out_pos: Sequence[int], *, segments: Optional[List[int]] = None,
                   precision: str = "f32", q_block: int = 1024) -> torch.Tensor:
    """Logits [len(out_pos), vocab] at positions ``out_pos`` of the sequence
    ``tokens`` [S] (on the weights' device)."""
    M = Math(precision)
    L, H, Hkv, Dh = (arch["num_layers"], arch["num_heads"], arch["num_kv_heads"],
                     arch["head_dim"])
    eps, theta = arch.get("norm_eps", 1e-5), arch["rope_theta"]
    E = arch.get("num_experts", 0)
    S = tokens.shape[0]
    segments = list(segments) if segments is not None else [S]
    blk = W["groups"]["b0"]
    pos = torch.arange(S, device=tokens.device)
    with exact_f32(), torch.no_grad():
        h = W["embed"][tokens].to(F32)
        for l in range(L):
            x = rmsnorm(h, blk["norm1"]["scale"][l], eps)
            a = blk["attn"]
            q = rope(M.mm(x, a["wq"][l]).view(S, H, Dh), pos, theta)
            k = rope(M.mm(x, a["wk"][l]).view(S, Hkv, Dh), pos, theta)
            v = M.mm(x, a["wv"][l]).view(S, Hkv, Dh)
            o = attention(M, q, k, v, q_block)
            h = h + M.mm(o.reshape(S, H * Dh), a["wo"][l])
            x = rmsnorm(h, blk["norm2"]["scale"][l], eps)
            if E:
                h = h + moe(M, x, blk["moe"], l, E, arch["moe_top_k"],
                            arch.get("capacity_factor", 1.25), segments)
            else:
                f = blk["ffn"]
                g = M.mm(x, f["w_gate"][l])
                u = M.mm(x, f["w_up"][l])
                h = h + M.mm(torch.nn.functional.silu(g) * u, f["w_down"][l])
        idx = torch.as_tensor(list(out_pos), device=h.device)
        x = rmsnorm(h[idx], W["final_norm"]["scale"], eps)
        return M.mm(x, W["lm_head"])[:, :arch["vocab_size"]]
