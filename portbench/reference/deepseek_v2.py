"""The architecture of DeepSeek-V2 (arXiv:2405.04434): the one place in the
benchmark that knows it.  A configuration names this module
(``"reference": "deepseek_v2"``) and the harness reaches it only through
``Cell.reference`` (``spec.INTERFACE``), and the MoE readers through
``expert_bound_s``.

A decoder of latent-attention (MLA) blocks: token embedding; per layer
RMSNorm, MLA under a causal mask, the residual, RMSNorm, an FFN, the
residual; a final RMSNorm and the LM head.

- MLA, expanded, as the published ``modeling_deepseek.py`` computes it:
  q = x W_q (no low-rank query), per head [q_nope | q_pe]; [c_kv | k_pe]
  = x W_kv_a; c_kv = RMSNorm(c_kv); per head [k_nope | v] = c_kv W_kv_b;
  q_pe and k_pe (one, shared by the heads) roped; softmax over q_nope .
  k_nope + q_pe . k_pe at scale mscale(factor, mscale_all_dim)^2 /
  sqrt(qk head); out = o W_o.
- YaRN rotary positions (``DeepseekV2YarnRotaryEmbedding``): the
  correction range from beta_fast and beta_slow over the original
  context, a linear ramp between base^(-2i/d) and that over the factor,
  cos and sin unscaled (the published mscale and mscale_all_dim are
  equal, so their ratio is 1; the constants below); the interleaved pairs de-interleaved before the half-split rotation
  (``apply_rotary_pos_emb``).  Angles in float64 from the float32
  frequencies.
- The first ``first_dense_layers`` layers a dense SwiGLU of ``dense_d_ff``;
  the rest MoE: softmax over the experts, greedy top-k, the gates not
  renormalised (``norm_topk_prob`` false; the published
  ``routed_scaling_factor`` is 1), no token dropped, plus the shared
  experts (one SwiGLU of ``shared_d_ff``, the same function as the
  published ``n_shared_experts`` summed) for every token.

Departures from the published model: weights in the port's tree
(``[in, out]`` matrices, random from the seed), the auxiliary losses left
out (serving does not compute them).  Written in float32 with plain
``torch`` and nothing of the program.  ``precision="fp8"`` is the control:
every matmul operand rounded to float8 e4m3 with one scale a tensor (in
training, the gradient passed straight through the rounding).  The
weights are read layer by layer and upcast, the queries attended in
blocks, so the reference fits beside the weights at 16k tokens.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..arith import BF16_BYTES, HBM_BW, PEAK_FLOPS
from ..weights import padded_vocab
from .decoder import Math, exact_f32, rmsnorm

BF16, F32 = torch.bfloat16, torch.float32
# the CPU tests' widths (``tiny``): one dense layer and two MoE layers
TINY = dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, d_ff=32,
            vocab_size=256, head_dim=24, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, dense_d_ff=128, shared_d_ff=64,
            num_experts=8, moe_top_k=3)


def make_weights(arch: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """Seeded random weights in the port's parameter tree: ``embed`` [Vp,
    D]; ``lead``, one block a leading dense layer (``norm1``, ``norm2``,
    ``attn`` {wq, wkv_a, kv_norm, wkv_b, wo}, ``ffn`` {w_gate, w_up,
    w_down}); ``groups.b0`` stacked over the MoE layers (``norm1``,
    ``norm2``, ``attn``, ``moe`` {router (f32), experts {w1, w3, w2},
    shared {w_gate, w_up, w_down}}); ``rem`` empty; ``final_norm`` and
    ``lm_head`` [D, Vp].  One ``randn`` call a leaf, on the device, from
    one ``torch.Generator`` there."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    D, H, r = arch["d_model"], arch["num_heads"], arch["kv_lora_rank"]
    dq, dr = arch["head_dim"], arch["qk_rope_head_dim"]
    dkv = arch["qk_nope_head_dim"] + arch["v_head_dim"]
    E, Fe = arch["num_experts"], arch["d_ff"]
    n_lead = arch.get("first_dense_layers", 0)
    L = arch["num_layers"] - n_lead
    Vp = padded_vocab(arch["vocab_size"])

    def normal(shape, fan_in, dtype=BF16):
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return w.mul_(1.0 / math.sqrt(fan_in))

    def scale(shape):
        w = torch.randn(shape, generator=gen, dtype=F32, device=device)
        return w.mul_(0.05).add_(1.0).to(BF16)

    def swiglu(lead, width):
        return {"w_gate": normal(lead + (D, width), D), "w_up": normal(lead + (D, width), D),
                "w_down": normal(lead + (width, D), width)}

    def block(lead, dense):
        b = {"norm1": {"scale": scale(lead + (D,))}, "norm2": {"scale": scale(lead + (D,))},
             "attn": {"wq": normal(lead + (D, H * dq), D),
                      "wkv_a": normal(lead + (D, r + dr), D),
                      "kv_norm": {"scale": scale(lead + (r,))},
                      "wkv_b": normal(lead + (r, H * dkv), r),
                      "wo": normal(lead + (H * arch["v_head_dim"], D),
                                   H * arch["v_head_dim"])}}
        if dense:
            b["ffn"] = swiglu(lead, arch["dense_d_ff"])
        else:
            b["moe"] = {"router": normal(lead + (D, E), D, dtype=F32),
                        "experts": {"w1": normal(lead + (E, D, Fe), D),
                                    "w3": normal(lead + (E, D, Fe), D),
                                    "w2": normal(lead + (E, Fe, D), Fe)}}
            if arch.get("shared_d_ff"):
                b["moe"]["shared"] = swiglu(lead, arch["shared_d_ff"])
        return b

    out = {"embed": normal((Vp, D), D)}
    if n_lead:
        out["lead"] = [block((), True) for _ in range(n_lead)]
    out.update({"groups": {"b0": block((L,), False)}, "rem": [],
                "final_norm": {"scale": scale((D,))}, "lm_head": normal((D, Vp), D)})
    return out


def tiny(arch: Dict[str, Any]) -> Dict[str, Any]:
    """``arch`` at the CPU tests' widths: one dense layer and two MoE
    layers of width 64, four heads (qk 16 + 8 rope, v 16, a latent of 32),
    8 experts of 32, top-3, a shared SwiGLU of 64, a vocabulary of 256."""
    return dict(arch, **TINY)


# ------------------------------------------------------------ the forward
# YaRN's constants of the published config (``rope_scaling`` of
# deepseek-ai/DeepSeek-V2-Lite's config.json): the correction range's
# beta_fast and beta_slow, and mscale = mscale_all_dim, so that the
# rotation's magnitude mscale(mscale) / mscale(mscale_all_dim) is 1
BETA_FAST, BETA_SLOW, MSCALE_ALL_DIM = 32.0, 1.0, 0.707


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def inv_freq(arch: Dict[str, Any]) -> torch.Tensor:
    """float32 [rope / 2]: YaRN's frequencies (plain RoPE's without a
    ``rope_factor``)."""
    dim, base = arch["qk_rope_head_dim"], arch["rope_theta"]
    idx = torch.arange(0, dim, 2, dtype=F32) / dim
    extra = 1.0 / base ** idx
    factor = arch.get("rope_factor", 0.0)
    if not factor:
        return extra
    inter = 1.0 / (factor * base ** idx)

    def corr(rotations):
        return (dim * math.log(arch["rope_original_max_pos"] / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr(BETA_FAST)), 0)
    high = min(math.ceil(corr(BETA_SLOW)), dim - 1)
    high = high + 0.001 if low == high else high
    mask = 1.0 - torch.clamp((torch.arange(dim // 2, dtype=F32) - low) / (high - low), 0, 1)
    return inter * (1 - mask) + extra * mask


def softmax_scale(arch: Dict[str, Any]) -> float:
    s = arch["head_dim"] ** -0.5
    if arch.get("rope_factor"):
        m = yarn_mscale(arch["rope_factor"], MSCALE_ALL_DIM)
        s *= m * m
    return s


def rope(x, pos, arch):
    """x [S, H, d] f32 on the published (interleaved) pairing."""
    S, H, d = x.shape
    x = x.reshape(S, H, d // 2, 2).transpose(3, 2).reshape(S, H, d)
    ang = pos.to(torch.float64)[:, None] * inv_freq(arch).to(x.device, torch.float64)
    cos = torch.cos(ang).to(F32)[:, None, :]
    sin = torch.sin(ang).to(F32)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _at(tree, l: Optional[int]):
    if isinstance(tree, dict):
        return {k: _at(v, l) for k, v in tree.items()}
    return tree if l is None else tree[l]


def mla(M, x, a, arch, q_block: int):
    """x [S, D] f32 (normed) -> [S, D]: the expanded causal MLA, query rows
    in blocks, each against the keys up to its last row."""
    S = x.shape[0]
    H, dn, dr, dv, r = (arch["num_heads"], arch["qk_nope_head_dim"],
                        arch["qk_rope_head_dim"], arch["v_head_dim"], arch["kv_lora_rank"])
    pos = torch.arange(S, device=x.device)
    q = M.mm(x, a["wq"]).view(S, H, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, arch)], dim=-1)
    kv_a = M.mm(x, a["wkv_a"])
    c_kv = rmsnorm(kv_a[:, :r], a["kv_norm"]["scale"], arch.get("norm_eps", 1e-6))
    k_pe = rope(kv_a[:, None, r:], pos, arch)
    kv = M.mm(c_kv, a["wkv_b"]).view(S, H, dn + dv)
    kh = M.q(torch.cat([kv[..., :dn], k_pe.expand(S, H, dr)], dim=-1)).permute(1, 0, 2)
    vh = M.q(kv[..., dn:]).permute(1, 0, 2)
    qh = M.q(q).permute(1, 0, 2)
    scale = softmax_scale(arch)
    outs = []
    for lo in range(0, S, q_block):
        hi = min(S, lo + q_block)
        s = torch.einsum("hqd,hkd->hqk", qh[:, lo:hi], kh[:, :hi]) * scale
        qpos = torch.arange(lo, hi, device=x.device)[:, None]
        s = s.masked_fill(torch.arange(hi, device=x.device)[None, :] > qpos, float("-inf"))
        p = M.q(torch.softmax(s, dim=-1))
        outs.append(torch.einsum("hqk,hkd->qhd", p, vh[:, :hi]))
    return M.mm(torch.cat(outs).reshape(S, H * dv), a["wo"])


def swiglu(M, x, w_gate, w_up, w_down):
    return M.mm(F.silu(M.mm(x, w_gate)) * M.mm(x, w_up), w_down)


def moe(M, x, m, arch):
    """x [T, D] f32 through one layer's experts: dropless greedy top-k."""
    probs = torch.softmax(M.mm(x, m["router"]), dim=-1)
    gate, pick = torch.topk(probs, arch["moe_top_k"], dim=-1)
    if arch.get("norm_topk_prob", True):
        gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    w = m["experts"]
    for e in torch.unique(pick).tolist():
        tok, slot = torch.nonzero(pick == e, as_tuple=True)
        y = swiglu(M, x[tok], w["w1"][e], w["w3"][e], w["w2"][e])
        out = out.index_add(0, tok, y * gate[tok, slot][:, None])
    if "shared" in m:
        s = m["shared"]
        out = out + swiglu(M, x, s["w_gate"], s["w_up"], s["w_down"])
    return out


def _blocks(W):
    lead = [_at(b, None) for b in W.get("lead", [])]
    stacked = W["groups"]["b0"]
    return lead + [_at(stacked, l) for l in range(stacked["norm1"]["scale"].shape[0])]


def hidden(M, W, arch, tokens, q_block: int):
    """The last hidden states [S, D] of the sequence ``tokens`` [S]."""
    eps = arch.get("norm_eps", 1e-6)
    h = W["embed"][tokens].to(F32)
    for b in _blocks(W):
        h = h + mla(M, rmsnorm(h, b["norm1"]["scale"], eps), b["attn"], arch, q_block)
        x = rmsnorm(h, b["norm2"]["scale"], eps)
        if "moe" in b:
            h = h + moe(M, x, b["moe"], arch)
        else:
            f = b["ffn"]
            h = h + swiglu(M, x, f["w_gate"], f["w_up"], f["w_down"])
    return h


def forward_logits(W: Dict[str, Any], arch: Dict[str, Any], tokens: torch.Tensor,
                   out_pos: Sequence[int], *, segments: Optional[List[int]] = None,
                   precision: str = "f32", q_block: int = 1024) -> torch.Tensor:
    """Logits [len(out_pos), vocab] at positions ``out_pos`` of the sequence
    ``tokens`` [S] (on the weights' device).  ``segments``, the server's
    dispatch groups, change nothing: no token is dropped."""
    S = tokens.shape[0]
    if segments is not None and sum(segments) != S:
        raise ValueError(f"segments cover {sum(segments)} of {S} tokens")
    M = Math(precision)
    with exact_f32(), torch.no_grad():
        h = hidden(M, W, arch, tokens, q_block)
        idx = torch.as_tensor(list(out_pos), device=h.device)
        x = rmsnorm(h[idx], W["final_norm"]["scale"], arch.get("norm_eps", 1e-6))
        return M.mm(x, W["lm_head"])[:, :arch["vocab_size"]]


class _TrainMath(Math):
    """``Math`` for training: the fp8 control's rounding passes the
    gradient straight through."""

    def q(self, x):
        x = x.to(F32)
        return x + (super().q(x.detach()) - x).detach() if self.fp8 else x


def train_loss(P: Dict[str, Any], arch: Dict[str, Any], tokens: torch.Tensor,
               precision: str = "f32") -> torch.Tensor:
    """Mean next-token cross entropy on tokens [B, S]: positions 0 .. S-2
    predicting tokens 1 .. S-1 over the vocabulary.  The port serves this
    architecture and does not train it; the module gives the loss all
    the same."""
    o = _TrainMath(precision)
    B, S = tokens.shape
    V = arch["vocab_size"]
    logits = []
    for b in range(B):
        h = hidden(o, P, arch, tokens[b], S)
        x = rmsnorm(h[:-1], P["final_norm"]["scale"], arch.get("norm_eps", 1e-6))
        logits.append(o.mm(x, P["lm_head"][:, :V]))
    return F.cross_entropy(torch.cat(logits), tokens[:, 1:].reshape(-1))


# Operations and bytes, from the shapes.  Operations count two a
# multiply-add.  Prefill runs MLA expanded (the up-projection a token,
# then attention at qk ``head_dim`` / v ``v_head_dim``); decode runs it
# absorbed (W_UK and W_UV a token, attention over the latent).

def _widths(arch):
    return (arch["num_layers"], arch["d_model"], arch["num_heads"], arch["kv_lora_rank"],
            arch["qk_nope_head_dim"], arch["qk_rope_head_dim"], arch["v_head_dim"])


def _ffn_params(arch) -> int:
    """FFN parameters a token multiplies by over every layer: the dense
    layers' SwiGLU; the MoE layers' router, top-k experts and shared
    SwiGLU."""
    L, D = arch["num_layers"], arch["d_model"]
    lead = arch.get("first_dense_layers", 0)
    moe = (arch["moe_top_k"] * 3 * D * arch["d_ff"] + D * arch["num_experts"]
           + 3 * D * arch.get("shared_d_ff", 0))
    return lead * 3 * D * arch["dense_d_ff"] + (L - lead) * moe


def matmul_params(arch) -> int:
    """Parameters a token multiplies by: a layer's W_q, W_kv_a, W_kv_b and
    W_o, and the FFNs.  W_kv_b counts alike expanded (the latent up to
    every head's k_nope and v, prefill) and absorbed (W_UK on the query,
    W_UV on the latent output, decode): H r (nope + v) either way."""
    L, D, H, r, dn, dr, dv = _widths(arch)
    attn = D * H * (dn + dr) + D * (r + dr) + H * r * (dn + dv) + H * dv * D
    return L * attn + _ffn_params(arch)


def prefill_pair_ops(arch) -> int:
    """Operations of one (query, key) pair in one layer of the expanded
    prefill: q.k over qk ``head_dim`` and p.v over ``v_head_dim``, every
    head."""
    return 2 * arch["num_heads"] * (arch["head_dim"] + arch["v_head_dim"])


def decode_key_ops(arch) -> int:
    """Operations of one cached position in one layer of the absorbed
    decode: q_lat.c_kv + q_pe.k_pe and p.c_kv, every head."""
    L, D, H, r, dn, dr, dv = _widths(arch)
    return 2 * H * (r + dr + r)


def _head_ops(arch) -> int:
    return 2 * arch["d_model"] * padded_vocab(arch["vocab_size"])


def prefill_ops(arch: Dict[str, Any], S: int) -> int:
    """A prefill of S tokens: every matmul on S positions, causal attention
    over S (S + 1) / 2 pairs a layer, the LM head on the last position."""
    return (2 * matmul_params(arch) * S + _head_ops(arch)
            + arch["num_layers"] * prefill_pair_ops(arch) * S * (S + 1) // 2)


def decode_ops(arch: Dict[str, Any], pos: int) -> int:
    """One decode token at position ``pos``: the matmuls (W_UK and W_UV
    included), attention over the pos + 1 cached latents, the LM head."""
    return (2 * matmul_params(arch) + _head_ops(arch)
            + arch["num_layers"] * decode_key_ops(arch) * (pos + 1))


def attention_bound_s(arch: Dict[str, Any], kind: str, n: int) -> float:
    """The least time of the attention of one call over every layer:
    ``prefill`` of n tokens (causal, expanded: q and k of ``head_dim``, v
    and the output of ``v_head_dim`` a head, bf16, each read or written
    once), or ``decode`` of one token at position n - 1 (absorbed: n cached
    latents of r + rope, bf16, and the query and latent output)."""
    L, D, H, r, dn, dr, dv = _widths(arch)
    if kind == "prefill":
        ops = prefill_pair_ops(arch) * n * (n + 1) // 2
        nbytes = BF16_BYTES * n * H * (2 * arch["head_dim"] + 2 * dv)
    elif kind == "decode":
        ops = decode_key_ops(arch) * n
        nbytes = BF16_BYTES * ((r + dr) * n + H * (r + dr + r))
    else:
        raise ValueError(kind)
    return L * max(ops / PEAK_FLOPS, nbytes / HBM_BW)


def expert_bound_s(arch: Dict[str, Any], kind: str, n: int) -> float:
    """The least time of the routed experts' three GEMMs over every MoE
    layer for ``n`` tokens (``decode``: one token a step, so n = 1):
    max(operations / peak, bytes / HBM), the bytes the weights of the
    experts that n tokens can reach (at most all of them; at decode the
    top-k), read once, and each routed row read in and written out in
    bf16."""
    if kind not in ("prefill", "decode"):
        raise ValueError(kind)
    D, Fe, E, K = arch["d_model"], arch["d_ff"], arch["num_experts"], arch["moe_top_k"]
    layers = arch["num_layers"] - arch.get("first_dense_layers", 0)
    rows = n * K
    ops = 2 * rows * 3 * D * Fe
    nbytes = BF16_BYTES * (min(E, rows) * 3 * D * Fe + 2 * rows * D)
    return layers * max(ops / PEAK_FLOPS, nbytes / HBM_BW)


def train_step_ops(arch: Dict[str, Any], batch: int, seq: int) -> int:
    """Useful operations of one train step on [batch, seq] tokens: 6 a
    matmul parameter a token (the LM head on the seq - 1 positions the loss
    reads), and causal attention's pairs three times."""
    return (6 * matmul_params(arch) * batch * seq + 3 * _head_ops(arch) * batch * (seq - 1)
            + 3 * arch["num_layers"] * prefill_pair_ops(arch) * batch * seq * (seq + 1) // 2)
