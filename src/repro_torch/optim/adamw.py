"""AdamW (decoupled weight decay) on torch: bf16 params, f32 moments.

A port of the reference's ``optim/adamw.py``: plain functions on trees of
tensors (nested dicts and lists) with the reference's state tree
(``{"m", "v", "step"}``, plus ``"ms"`` and ``"vs"`` for 8-bit moments), and
``step`` an int32 0-d tensor on the params' device.  The update runs in
f32 leaf by leaf, in the reference's order of operations, and casts each
param back to its storage dtype.  Every function returns new tensors and
changes none of its arguments.  Global-norm clipping included.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw_init(params) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": _step0(params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaves summed in
    the reference's order."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(F32)))
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


def _prologue(grads, opt_state, cfg: AdamWConfig, lr_scale):
    """(step, grad norm, clip factor, bias corrections, lr), all f32 0-d
    tensors but ``step`` (int32).  ``b ** step`` is taken in f32, as the
    reference's ``b ** step.astype(f32)``."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    s = step.to(F32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=s.device), s)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=s.device), s)
    lr = cfg.lr * lr_scale
    return step, gnorm, clip, b1c, b2c, lr


def adamw_update(grads, opt_state, params, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_opt_state, metrics)."""
    step, gnorm, clip, b1c, b2c, lr = _prologue(grads, opt_state, cfg, lr_scale)

    def upd(g, m, v, p):
        g = g.to(F32) * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(F32)
        return (p.to(F32) - lr * delta).to(p.dtype), m, v

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(opt_state["m"]),
        tree_leaves(opt_state["v"]), tree_leaves(params))]
    unf = lambda i: tree_unflatten(params, [o[i] for o in out])
    return unf(0), {"m": unf(1), "v": unf(2), "step": step}, {"grad_norm": gnorm}


# ------------------------------------------------------------ 8-bit moments
# Dettmers-style quantized optimizer state (arXiv:2110.02861): m in int8 and
# v in uint8 with per-row (last-axis) f32 absmax scales, 2 bytes a param of
# state instead of 8.  The reference switches to it above 100 B params.


def _row_scale(x, eps=1e-12):
    return torch.clamp(torch.abs(x).amax(dim=-1, keepdim=True), min=eps)


def _q_m(m):
    s = _row_scale(m) / 127.0
    return torch.clamp(torch.round(m / s), -127, 127).to(torch.int8), s.to(F32)


def _q_v(v):
    s = _row_scale(v) / 255.0
    return torch.clamp(torch.round(v / s), 0, 255).to(torch.uint8), s.to(F32)


def adamw8bit_init(params) -> Dict[str, Any]:
    def zm(p):
        return torch.zeros(p.shape, dtype=torch.int8, device=p.device)

    def zv(p):
        return torch.zeros(p.shape, dtype=torch.uint8, device=p.device)

    def zs(p):
        shape = tuple(p.shape[:-1]) + (1,) if p.ndim else (1,)
        return torch.zeros(shape, dtype=F32, device=p.device)

    return {"m": tree_map(zm, params), "v": tree_map(zv, params),
            "ms": tree_map(zs, params), "vs": tree_map(zs, params),
            "step": _step0(params)}


def adamw8bit_update(grads, opt_state, params, cfg: AdamWConfig, lr_scale=1.0):
    step, gnorm, clip, b1c, b2c, lr = _prologue(grads, opt_state, cfg, lr_scale)

    def upd(g, mq, vq, ms, vs, p):
        g = g.to(F32) * clip
        m = mq.to(F32) * ms
        v = vq.to(F32) * vs
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.to(F32)
        new_p = (p.to(F32) - lr * delta).to(p.dtype)
        mq2, ms2 = _q_m(m)
        vq2, vs2 = _q_v(v)
        return new_p, mq2, vq2, ms2, vs2

    parts = [tree_leaves(grads)] + [tree_leaves(opt_state[k])
                                    for k in ("m", "v", "ms", "vs")]
    out = [upd(*leaf) for leaf in zip(*parts, tree_leaves(params))]
    unf = lambda i: tree_unflatten(params, [o[i] for o in out])
    return unf(0), {"m": unf(1), "v": unf(2), "ms": unf(3), "vs": unf(4),
                    "step": step}, {"grad_norm": gnorm}


def cosine_schedule(step, *, warmup: int, total: int, min_ratio: float = 0.1):
    """Linear warmup, then cosine decay to ``min_ratio``; f32 0-d tensor."""
    s = step.to(F32)
    warm = torch.clamp(s / max(1, warmup), max=1.0)
    prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
