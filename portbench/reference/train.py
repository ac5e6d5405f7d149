"""The plain reference of a training step: the next-token loss of the
decoder in ``decoder.py``'s equations on a batch, its gradient by
autograd, and AdamW with global-norm clipping, in float32, with nothing
of the program.

The loss is the mean cross entropy of positions 0 .. S-2 predicting
tokens 1 .. S-1 over the vocabulary (the padded rows of the tables are
parameters that no logit reads).  AdamW: the gradient scaled by
min(1, clip / global norm); m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
p -= lr_t (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p), with lr_t
the base rate times a linear warm-up and a cosine decay to a tenth.  The
parameters are stored in bfloat16, as the configuration states: each
update is rounded to it.

``precision="fp8"`` is the control: the forward's matmul operands rounded
to float8 e4m3 (one scale a tensor), the gradient passed straight through
the rounding.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import torch
import torch.nn.functional as F

from .decoder import F32, _fp8, exact_f32, rmsnorm, rope


def lr_scale(step: int, warmup: int, total: int, min_ratio: float = 0.1) -> float:
    warm = min(step / max(1, warmup), 1.0)
    prog = min(max((step - warmup) / max(1, total - warmup), 0.0), 1.0)
    return warm * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * prog)))


class _Ops:
    def __init__(self, precision: str):
        self.fp8 = precision == "fp8"

    def q(self, x):
        return x + (_fp8(x.detach()) - x).detach() if self.fp8 else x

    def mm(self, a, b):
        return self.q(a) @ self.q(b)


def loss(P: Dict[str, Any], arch: Dict[str, Any], tokens: torch.Tensor,
         precision: str = "f32") -> torch.Tensor:
    """Mean next-token cross entropy of a dense decoder on tokens [B, S]."""
    if arch.get("num_experts"):
        raise NotImplementedError("the training reference is written for dense FFNs")
    o = _Ops(precision)
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


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _unflatten(template, values: Dict[str, torch.Tensor], prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten(template[k], values, f"{prefix}/{k}" if prefix else k)
                for k in template}
    if isinstance(template, (list, tuple)):
        return [_unflatten(v, values, f"{prefix}/{i}") for i, v in enumerate(template)]
    return values[prefix]


def train_steps(W: Dict[str, Any], arch: Dict[str, Any], batches: Sequence[torch.Tensor],
                opt: Dict[str, Any], schedule: Dict[str, int], device,
                precision: str = "f32") -> Dict[str, Any]:
    """AdamW steps from the weights ``W`` (any device, bf16) on ``batches``.
    Returns each step's loss, each leaf's clipped gradient norm at step 1,
    and each leaf's change after the last step, by path."""
    paths = [p for p, _ in _leaves(W)]
    params = {p: x.to(device=device, dtype=F32) for p, x in _leaves(W)}
    first = {p: x.clone() for p, x in params.items()}
    m = {p: torch.zeros_like(x) for p, x in params.items()}
    v = {p: torch.zeros_like(x) for p, x in params.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    with exact_f32():
        for t, tokens in enumerate(batches, start=1):
            leaves = {p: params[p].requires_grad_(True) for p in paths}
            value = loss(_unflatten(W, leaves), arch, tokens.to(device), precision)
            grads = torch.autograd.grad(value, [leaves[p] for p in paths])
            losses.append(float(value.detach()))
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                clip = torch.clamp(opt["grad_clip"] / torch.clamp(gnorm, min=1e-9), max=1.0)
                lr = opt["lr"] * lr_scale(t, schedule["warmup"], schedule["total"])
                for p, g in zip(paths, grads):
                    g = g * clip
                    if t == 1:
                        grad_norms[p] = float(torch.linalg.vector_norm(g))
                    m[p].mul_(b1).add_(g, alpha=1 - b1)
                    v[p].mul_(b2).addcmul_(g, g, value=1 - b2)
                    delta = (m[p] / (1 - b1 ** t)) / (torch.sqrt(v[p] / (1 - b2 ** t)) + eps)
                    new = params[p].detach() - lr * (delta + wd * params[p].detach())
                    params[p] = new.to(torch.bfloat16).to(F32)
            del grads, leaves, value
    change = {p: float(torch.linalg.vector_norm(params[p] - first[p])) for p in paths}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
