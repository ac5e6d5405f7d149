"""The plain reference of a training step: the next-token loss of the
cell's architecture on a batch (its module's ``train_loss``), its gradient
by autograd, and AdamW with global-norm clipping, in float32, with nothing
of the program.

AdamW: the gradient scaled by min(1, clip / global norm);
m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
p -= lr_t (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p), with lr_t
the base rate times a linear warm-up and a cosine decay to a tenth.  The
parameters are stored in bfloat16, as the configuration states: each
update is rounded to it.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence

import torch

from .decoder import F32, exact_f32


def lr_scale(step: int, warmup: int, total: int, min_ratio: float = 0.1) -> float:
    warm = min(step / max(1, warmup), 1.0)
    prog = min(max((step - warmup) / max(1, total - warmup), 0.0), 1.0)
    return warm * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * prog)))


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


def train_steps(loss: Callable[..., torch.Tensor], W: Dict[str, Any], arch: Dict[str, Any],
                batches: Sequence[torch.Tensor], opt: Dict[str, Any],
                schedule: Dict[str, int], device, precision: str = "f32") -> Dict[str, Any]:
    """AdamW steps from the weights ``W`` (any device, bf16) on ``batches``,
    with the loss ``loss(params, arch, tokens, precision)`` (the
    architecture's ``train_loss``; ``precision="fp8"`` is its control).
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
