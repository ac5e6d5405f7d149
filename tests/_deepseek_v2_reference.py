"""A plain float32 forward of DeepSeek-V2 (arXiv:2405.04434), the tests'
reference for the port's latent attention, YaRN rotary positions and
DeepSeek MoE.  Plain ``torch`` only: it imports neither JAX nor anything of
``repro_torch``, and turns TF32 off.

Written from the published model (``modeling_deepseek.py`` of
deepseek-ai/DeepSeek-V2-Lite): token embedding; per layer RMSNorm, MLA,
residual, RMSNorm, FFN, residual; final RMSNorm; LM head.

- MLA, expanded as the published model computes it: q = x W_q (no
  low-rank query, as V2-Lite), split per head into q_nope and q_pe;
  [c_kv, k_pe] = x W_kv_a; c_kv = RMSNorm(c_kv); [k_nope, v] = c_kv W_kv_b
  per head; q_pe and k_pe (one, shared by the heads) roped; causal softmax
  over q_nope.k_nope + q_pe.k_pe at scale mscale(factor, mscale_all_dim)^2
  / sqrt(qk head); out = attn W_o.
- YaRN (``DeepseekV2YarnRotaryEmbedding``): the correction range from
  beta_fast and beta_slow over the original context, a linear ramp between
  base^(-2i/d) and that over the factor, cos and sin times mscale(mscale) /
  mscale(mscale_all_dim), which is 1 at the published constants (below);
  the interleaved rope pairs de-interleaved before the half-split rotation
  (``apply_rotary_pos_emb``).
- Layers before ``first_dense_layers`` a dense SwiGLU of ``dense_d_ff``;
  the rest MoE: softmax over the experts in f32, greedy top-k, gates not
  renormalised (V2-Lite's ``routed_scaling_factor`` is 1), no token
  dropped, plus the shared SwiGLU for every token.

Departures from the published description: weights come in the port's
tree (``[in, out]`` matrices, the shared experts as one SwiGLU of their
summed width, which is the same function), the vocabulary may be padded
(the padded logits are dropped), and the training-time auxiliary losses
are left out (serving does not compute them).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
# ``rope_scaling`` of the published config.json besides its factor and
# original context
BETA_FAST, BETA_SLOW, MSCALE, MSCALE_ALL_DIM = 32.0, 1.0, 0.707, 0.707


def yarn_get_mscale(scale: float, mscale: float = 1.0) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def yarn_inv_freq(dim: int, base: float, factor: float, original: int,
                  beta_fast: float, beta_slow: float) -> torch.Tensor:
    """f32 [dim / 2], as ``DeepseekV2YarnRotaryEmbedding._set_cos_sin_cache``."""
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=F32) / dim))
    if not factor:
        return freq_extra
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=F32) / dim))

    def correction_dim(num_rotations):
        return (dim * math.log(original / (num_rotations * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=F32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def softmax_scale(arch) -> float:
    s = arch["head_dim"] ** -0.5
    if arch.get("rope_factor"):
        m = yarn_get_mscale(arch["rope_factor"], MSCALE_ALL_DIM)
        s = s * m * m
    return s


def rope(x, pos, arch):
    """x [S, H, d] f32 on the published pairing; positions ``pos`` [S]."""
    S, H, d = x.shape
    x = x.view(S, H, d // 2, 2).transpose(3, 2).reshape(S, H, d)
    factor = arch.get("rope_factor", 0.0)
    inv = yarn_inv_freq(d, arch["rope_theta"], factor, arch.get("rope_original_max_pos", 0),
                        BETA_FAST, BETA_SLOW)
    mag = 1.0
    if factor:
        mag = yarn_get_mscale(factor, MSCALE) / yarn_get_mscale(factor, MSCALE_ALL_DIM)
    freqs = torch.outer(pos.to(F32), inv.to(x.device))
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = (emb.cos() * mag)[:, None, :], (emb.sin() * mag)[:, None, :]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.to(F32)


def swiglu(x, p):
    g = x @ p["w_gate"].to(F32)
    u = x @ p["w_up"].to(F32)
    return (F.silu(g) * u) @ p["w_down"].to(F32)


def mla(x, a, arch):
    """x [S, D] f32 (normed) -> [S, D]: the expanded causal MLA."""
    S = x.shape[0]
    H, dn, dr, dv, r = (arch["num_heads"], arch["qk_nope_head_dim"], arch["qk_rope_head_dim"],
                        arch["v_head_dim"], arch["kv_lora_rank"])
    pos = torch.arange(S, device=x.device)
    q = (x @ a["wq"].to(F32)).view(S, H, dn + dr)
    q_nope, q_pe = q[..., :dn], rope(q[..., dn:], pos, arch)
    kv_a = x @ a["wkv_a"].to(F32)
    c_kv = rmsnorm(kv_a[:, :r], a["kv_norm"]["scale"], arch.get("norm_eps", 1e-6))
    k_pe = rope(kv_a[:, None, r:], pos, arch)                      # [S, 1, dr]
    kv = (c_kv @ a["wkv_b"].to(F32)).view(S, H, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe.expand(S, H, dr)], dim=-1)
    qq = torch.cat([q_nope, q_pe], dim=-1)
    s = torch.einsum("qhd,khd->hqk", qq, k) * softmax_scale(arch)
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1),
                      float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), kv[..., dn:])
    return o.reshape(S, H * dv) @ a["wo"].to(F32)


def moe(x, m, arch):
    """x [T, D] f32 -> [T, D]: dropless greedy top-k over softmax gates,
    not renormalised, plus the shared SwiGLU."""
    probs = torch.softmax(x @ m["router"].to(F32), dim=-1)
    gate, pick = torch.topk(probs, arch["moe_top_k"], dim=-1)
    if arch.get("norm_topk_prob", True):
        gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    w = m["experts"]
    for e in torch.unique(pick).tolist():
        tok, slot = torch.nonzero(pick == e, as_tuple=True)
        y = swiglu(x[tok], {"w_gate": w["w1"][e], "w_up": w["w3"][e],
                            "w_down": w["w2"][e]})
        out.index_add_(0, tok, y * gate[tok, slot][:, None])
    if "shared" in m:
        out = out + swiglu(x, m["shared"])
    return out


def _layer(tree, l):
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def forward(W, arch, tokens):
    """Logits [S, vocab_size] at every position of ``tokens`` [S]."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        eps = arch.get("norm_eps", 1e-6)
        blocks = list(W.get("lead", []))
        stacked = W["groups"]["b0"]
        n = stacked["norm1"]["scale"].shape[0]
        blocks += [_layer(stacked, l) for l in range(n)]
        with torch.no_grad():
            h = W["embed"][tokens].to(F32)
            for b in blocks:
                h = h + mla(rmsnorm(h, b["norm1"]["scale"], eps), b["attn"], arch)
                x = rmsnorm(h, b["norm2"]["scale"], eps)
                h = h + (moe(x, b["moe"], arch) if "moe" in b else swiglu(x, b["ffn"]))
            h = rmsnorm(h, W["final_norm"]["scale"], eps)
            return (h @ W["lm_head"].to(F32))[:, :arch["vocab_size"]]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
