"""Shared model layers on torch: norms, RoPE, GQA attention (direct and
chunked online-softmax), SwiGLU MLP, embeddings, LM head.

A port of the reference's ``models/layers.py`` for one device: the
``ShardCtx`` layout constraints are dropped.  Layouts are the reference's
(``[B, S, H, D]`` for attention).  Attention accumulates in fp32 from bf16
operands, as the reference's ``preferred_element_type=f32`` einsums do: the
operands are upcast (bf16 products are exact in fp32) and summed in fp32.
Prefill attention goes through the flash-attention kernel
(``kernels.flash_attention``); decode stays on the direct path, because the
kernel takes no key positions and cannot read a partly filled or ring cache.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import flash_attention

F32 = torch.float32
BF16 = torch.bfloat16
NEG_INF = -1e30


def dense_init(gen: torch.Generator, shape, in_axis=0, dtype=BF16, lead=()):
    """Normal / sqrt(fan_in) weights drawn from ``gen``, on its device.

    ``lead`` prepends stacking axes (the layer stack's ``groups`` axis) that
    do not count toward the fan-in.
    """
    if isinstance(in_axis, int):
        fan_in = shape[in_axis]
    else:
        fan_in = int(math.prod(shape[a] for a in in_axis))
    w = torch.randn(tuple(lead) + tuple(shape), generator=gen, dtype=F32,
                    device=gen.device)
    return (w / math.sqrt(max(1, fan_in))).to(dtype)


# ----------------------------------------------------------------- RMSNorm
def rmsnorm_init(d: int, device=None, lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=BF16, device=device)}


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.to(F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


# -------------------------------------------------------------------- RoPE
def rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [S] or [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[..., None] * freqs                          # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------- attention (GQA)
def attn_init(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
              lead=()):
    return {
        "wq": dense_init(gen, (d_model, n_heads * head_dim), lead=lead),
        "wk": dense_init(gen, (d_model, n_kv * head_dim), lead=lead),
        "wv": dense_init(gen, (d_model, n_kv * head_dim), lead=lead),
        "wo": dense_init(gen, (n_heads * head_dim, d_model), lead=lead),
    }


def _mask_bias(qpos, kpos, causal: bool, window: int):
    """[Sq, Skv] additive mask (0 allowed / NEG_INF blocked)."""
    ok = kpos[None, :] >= 0
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if window:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    zero = torch.zeros((), dtype=F32, device=ok.device)
    return torch.where(ok, zero, torch.full((), NEG_INF, dtype=F32, device=ok.device))


def _repeat_kv(x, rep: int):
    if rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, rep, d).reshape(b, s, h * rep, d)


def attention_core(q, k, v, qpos, kpos, *, causal: bool = True, window: int = 0,
                   chunk: int = 1024):
    """q: [B, Sq, H, Dh]; k, v: [B, Skv, Hkv, Dh]; qpos: [Sq]; kpos: [Skv].

    Direct path for Sq == 1 (decode) or Skv <= chunk; otherwise the chunked
    online softmax, whose transient is [B, H, Sq, chunk] fp32.
    """
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    rep = H // Hkv
    scale = Dh ** -0.5

    if Sq == 1 or Skv <= chunk:
        kk, vv = _repeat_kv(k, rep), _repeat_kv(v, rep)
        s = torch.einsum("bqhd,bkhd->bhqk", q.to(F32), kk.to(F32)) * scale
        s = s + _mask_bias(qpos, kpos, causal, window)[None, None]
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(F32), vv.to(F32))
        return o.to(q.dtype)

    assert Skv % chunk == 0, (Skv, chunk)
    o = torch.zeros((B, H, Sq, Dh), dtype=F32, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=F32, device=q.device)
    qf = q.to(F32)
    for start in range(0, Skv, chunk):
        kc = _repeat_kv(k[:, start:start + chunk], rep)
        vc = _repeat_kv(v[:, start:start + chunk], rep)
        kp = kpos[start:start + chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc.to(F32)) * scale
        s = s + _mask_bias(qpos, kp, causal, window)[None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vc.dtype).to(F32), vc.to(F32))
        m = m_new
    out = (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.permute(0, 2, 1, 3).contiguous()  # [B, Sq, H, Dh]


def attention_block(p, x, *, cfg, positions, causal=True, window=0,
                    kv_override: Optional[Tuple] = None, chunk=1024):
    """Projections + RoPE + attention + output proj.  x: [B, S, D].

    Full-sequence self-attention (no ``kv_override``, S > 1, positions
    0..S-1) runs the flash-attention kernel; everything else the direct or
    chunked ``attention_core``.
    """
    B, S, D = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = rope((x @ p["wq"]).reshape(B, S, H, Dh), positions, cfg.rope_theta)
    if kv_override is None:
        k = rope((x @ p["wk"]).reshape(B, S, Hkv, Dh), positions, cfg.rope_theta)
        v = (x @ p["wv"]).reshape(B, S, Hkv, Dh)
        kpos = positions
    else:
        k, v, kpos = kv_override
    if kv_override is None and S > 1:
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=window)
    else:
        o = attention_core(q, k, v, positions, kpos, causal=causal,
                           window=window, chunk=chunk)
    out = o.reshape(B, S, H * Dh) @ p["wo"]
    return out, (k, v)


# ------------------------------------------------------------------- MLP
def mlp_init(gen, d_model: int, d_ff: int, lead=()):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), lead=lead),
        "w_up": dense_init(gen, (d_model, d_ff), lead=lead),
        "w_down": dense_init(gen, (d_ff, d_model), lead=lead),
    }


def mlp(p, x):
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(g.to(F32)).to(x.dtype) * u
    return h @ p["w_down"]


# ------------------------------------------------------------- embeddings
def embed_init(gen, vocab: int, d_model: int):
    return {"embed": dense_init(gen, (vocab, d_model), in_axis=1)}


def embed_lookup(p, tokens):
    return p["embed"][tokens]


def logits_head(p, x, vocab_size: int):
    """LM head with padded-vocab masking."""
    logits = (x @ p["lm_head"]).to(F32)
    pad = logits.shape[-1] - vocab_size
    if pad > 0:
        mask = torch.arange(logits.shape[-1], device=logits.device) < vocab_size
        logits = torch.where(mask, logits,
                             torch.full((), NEG_INF, dtype=F32, device=logits.device))
    return logits
