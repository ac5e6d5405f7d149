"""The architecture of the served and trained decoders, dense or MoE: the
one place in the benchmark that knows it.  A configuration names this
module (``"reference": "decoder"``) and the harness reaches it only
through ``Cell.reference``: the weights (``make_weights``), the plain
reference of serving (``forward_logits``) and of training's loss
(``train_loss``), the operations and bytes the readers count
(``prefill_ops``, ``decode_ops``, ``attention_bound_s``,
``train_step_ops``), and the CPU tests' widths (``tiny``).

A decoder of full-attention blocks: token embedding; per layer RMSNorm,
GQA attention with rotary positions (the half-split rotation, base
``rope_theta``) under a causal mask, the output projection and the
residual, RMSNorm, then a SwiGLU FFN or a mixture of experts, and the
residual; a final RMSNorm and the LM head over the vocabulary.  Written
from the model's equations in float32 with plain ``torch`` and nothing
of the program.

The mixture of experts is the port's configuration: softmax router, top-k
gates renormalised to sum to one, and a capacity of
``ceil(T * k / E * factor)`` rounded up to a multiple of 8 per expert over
each dispatch group of T tokens, where an expert keeps the first
assignments in (token, pick) order and drops the rest.  A served session's
dispatch groups are its prefill and then each decode step, so
``segments`` gives their lengths.

``precision="fp8"`` is the control: every matmul operand rounded to
float8 e4m3 with one scale a tensor, the rest as above (in training, the
gradient passed straight through the rounding).

The weights are read layer by layer and upcast, so the reference fits
beside them.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..arith import BF16_BYTES, HBM_BW, PEAK_FLOPS
from ..weights import padded_vocab

BF16, F32 = torch.bfloat16, torch.float32
FP8_MAX = 448.0
# the CPU tests' widths (``tiny``)
TINY = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, vocab_size=256, head_dim=16)


def make_weights(arch: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """Seeded random weights in the port's parameter tree, handed alike to
    the program and to the reference: ``embed`` [Vp, D], ``groups.b0``
    stacked over the layers (``norm1``, ``norm2``, ``attn`` {wq, wk, wv,
    wo}, and ``ffn`` {w_gate, w_up, w_down} or ``moe`` {router (f32),
    experts {w1, w3, w2}}), ``rem`` empty, ``final_norm`` and ``lm_head``
    [D, Vp].  One ``randn`` call a leaf, on the device, from one
    ``torch.Generator`` there: a leaf holds every layer, so a model is a
    dozen calls."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    L, D, Fd = arch["num_layers"], arch["d_model"], arch["d_ff"]
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
                        "experts": {"w1": normal((L, E, D, Fd), D),
                                    "w3": normal((L, E, D, Fd), D),
                                    "w2": normal((L, E, Fd, D), Fd)}}
    else:
        block["ffn"] = {"w_gate": normal((L, D, Fd), D), "w_up": normal((L, D, Fd), D),
                        "w_down": normal((L, Fd, D), Fd)}
    return {"embed": normal((Vp, D), D), "groups": {"b0": block}, "rem": [],
            "final_norm": {"scale": scale((D,))}, "lm_head": normal((D, Vp), D)}


def tiny(arch: Dict[str, Any]) -> Dict[str, Any]:
    """``arch`` at the CPU tests' widths: two layers of 64, four heads of
    16 (two KV heads where the model groups them), FFN 128, a vocabulary
    of 256, and 8 experts, top-2, where it has experts."""
    a = dict(arch, **TINY)
    a["num_kv_heads"] = 2 if arch["num_kv_heads"] < arch["num_heads"] else 4
    if arch.get("num_experts"):
        a.update(num_experts=8, moe_top_k=2)
    return a


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


class _TrainMath:
    """``Math`` for training: the fp8 control's rounding passes the
    gradient straight through."""

    def __init__(self, precision: str):
        self.fp8 = precision == "fp8"

    def q(self, x):
        return x + (_fp8(x.detach()) - x).detach() if self.fp8 else x

    def mm(self, a, b):
        return self.q(a) @ self.q(b)


def train_loss(P: Dict[str, Any], arch: Dict[str, Any], tokens: torch.Tensor,
               precision: str = "f32") -> torch.Tensor:
    """Mean next-token cross entropy of a dense decoder on tokens [B, S]:
    positions 0 .. S-2 predicting tokens 1 .. S-1 over the vocabulary (the
    padded rows of the tables are parameters that no logit reads)."""
    if arch.get("num_experts"):
        raise NotImplementedError("the training reference is written for dense FFNs")
    o = _TrainMath(precision)
    B, S = tokens.shape
    L, H, Hkv, Dh = (arch["num_layers"], arch["num_heads"], arch["num_kv_heads"],
                     arch["head_dim"])
    eps, theta, V = arch.get("norm_eps", 1e-5), arch["rope_theta"], arch["vocab_size"]
    blk = P["groups"]["b0"]
    pos = torch.arange(S, device=tokens.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=tokens.device).triu(1)
    h = P["embed"][tokens]                                        # [B, S, D]
    for l in range(L):
        x = rmsnorm(h, blk["norm1"]["scale"][l], eps)
        a = blk["attn"]
        q = rope(o.mm(x, a["wq"][l]).view(B * S, H, Dh), pos.repeat(B), theta)
        k = rope(o.mm(x, a["wk"][l]).view(B * S, Hkv, Dh), pos.repeat(B), theta)
        v = o.mm(x, a["wv"][l]).view(B, S, Hkv, Dh)
        q = q.view(B, S, Hkv, H // Hkv, Dh).permute(0, 2, 3, 1, 4)   # [B, g, r, S, Dh]
        k = k.view(B, S, Hkv, Dh).permute(0, 2, 1, 3)[:, :, None]   # [B, g, 1, S, Dh]
        v = v.permute(0, 2, 1, 3)[:, :, None]
        s = o.q(q) @ o.q(k).transpose(-1, -2) / math.sqrt(Dh)
        p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        att = (o.q(p) @ o.q(v)).permute(0, 3, 1, 2, 4).reshape(B, S, H * Dh)
        h = h + o.mm(att, a["wo"][l])
        x = rmsnorm(h, blk["norm2"]["scale"][l], eps)
        f = blk["ffn"]
        h = h + o.mm(F.silu(o.mm(x, f["w_gate"][l])) * o.mm(x, f["w_up"][l]), f["w_down"][l])
    x = rmsnorm(h[:, :-1], P["final_norm"]["scale"], eps)
    logits = o.mm(x, P["lm_head"][:, :V])
    return F.cross_entropy(logits.reshape(-1, V), tokens[:, 1:].reshape(-1))


# Operations and bytes, from the shapes.  Operations count two a
# multiply-add.  A forward pass's operations follow
# ``chip_smoke.py::forward_ops`` (the matmuls, and the unmasked (query,
# key) pairs of causal attention); a train step's useful operations are
# three forward passes' worth (6 a parameter a token, plus attention
# forward and backward), without the recompute.

def _dims(arch: Dict[str, Any]):
    return (arch["num_layers"], arch["d_model"], arch["num_heads"],
            arch["num_kv_heads"], arch["head_dim"], arch["d_ff"])


def layer_matmul_params(arch: Dict[str, Any]) -> int:
    """Parameters of one layer that a token's forward multiplies by: the
    attention projections, and the dense FFN or the top-k experts a token
    routes to (the router too)."""
    L, D, H, Hkv, Dh, Fd = _dims(arch)
    attn = D * H * Dh * 2 + D * Hkv * Dh * 2
    E, K = arch.get("num_experts", 0), arch.get("moe_top_k", 0)
    ffn = K * 3 * D * Fd + D * E if E else 3 * D * Fd
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
