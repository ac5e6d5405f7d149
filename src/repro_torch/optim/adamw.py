"""AdamW (decoupled weight decay) on torch: bf16 params, f32 moments.

A port of the reference's ``optim/adamw.py``: plain functions on trees of
tensors (nested dicts and lists) with the reference's state tree
(``{"m", "v", "step"}``, plus ``"ms"`` and ``"vs"`` for 8-bit moments), and
``step`` an int32 0-d tensor on the params' device.  The update runs in
f32, in the reference's order of operations, and casts each param back to
its storage dtype.  Every function returns new tensors and changes none of
its arguments.  Global-norm clipping included.

``adamw_update`` takes its path from the tensors it is given, in one place
(``_update_leaves``): CPU tensors, DTensors on CPU ranks included, go
through the plain version (``kernels/adamw/ref.py``); plain CUDA tensors
through the fused kernels (``kernels/adamw``: the global norm and the
update, one launch each for up to 48 leaves); CUDA DTensors through the
update kernel on each rank's local shards, given the norm that DTensor
reduces across ranks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import torch

from ..kernels.adamw.ops import adamw_fused
from ..kernels.adamw.ref import adamw_ref, clip_factor, global_norm_ref
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
    return global_norm_ref(tree_leaves(tree))


def _schedule(opt_state, cfg: AdamWConfig, lr_scale):
    """(step, bias corrections, lr): f32 0-d tensors but ``step`` (int32)
    and ``lr`` (a tensor when ``lr_scale`` is one).  ``b ** step`` is taken
    in f32, as the reference's ``b ** step.astype(f32)``."""
    step = opt_state["step"] + 1
    s = step.to(F32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=s.device), s)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=s.device), s)
    lr = cfg.lr * lr_scale
    return step, b1c, b2c, lr


def _prologue(grads, opt_state, cfg: AdamWConfig, lr_scale):
    """(step, grad norm, clip factor, bias corrections, lr)."""
    step, b1c, b2c, lr = _schedule(opt_state, cfg, lr_scale)
    gnorm = global_norm(grads)
    return step, gnorm, clip_factor(gnorm, cfg.grad_clip), b1c, b2c, lr


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _on_shards(grads, ms, vs, params, b1c, b2c, lr, **hyper):
    """``adamw_fused`` on each rank's local shards of a CUDA DTensor tree:
    the norm over the whole tree as DTensor reduces it, every leaf laid out
    as its param before the update (a grad may come out of backward as a
    partial sum), results put back as DTensors of the params' layouts."""
    from torch.distributed.tensor import DTensor

    def like(x, p):
        if not _is_dtensor(x):
            raise TypeError("adamw: a tree of DTensor params takes DTensor grads and moments")
        if x.placements != p.placements:
            x = x.redistribute(p.device_mesh, p.placements)
        return x.to_local()

    def value(x):
        return x.full_tensor() if _is_dtensor(x) else x

    gnorm = global_norm_ref(grads)
    shards = [[like(x, p) for x, p in zip(xs, params)] for xs in (grads, ms, vs)]
    new_p, new_m, new_v, _ = adamw_fused(
        *shards, [p.to_local() for p in params], value(b1c), value(b2c), value(lr),
        gnorm=value(gnorm), **hyper)
    wrap = lambda xs: [DTensor.from_local(x, p.device_mesh, p.placements, run_check=False,
                                          shape=p.shape, stride=p.stride())
                       for x, p in zip(xs, params)]
    return wrap(new_p), wrap(new_m), wrap(new_v), gnorm


def _update_leaves(grads, ms, vs, params, b1c, b2c, lr, **hyper):
    """(new params, new m, new v, grad norm) of lists of leaves, by the
    path their tensors call for."""
    if not params or params[0].device.type == "cpu":
        return adamw_ref(grads, ms, vs, params, b1c, b2c, lr, **hyper)
    if _is_dtensor(params[0]):
        return _on_shards(grads, ms, vs, params, b1c, b2c, lr, **hyper)
    return adamw_fused(grads, ms, vs, params, b1c, b2c, lr, **hyper)


def adamw_update(grads, opt_state, params, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_opt_state, metrics)."""
    step, b1c, b2c, lr = _schedule(opt_state, cfg, lr_scale)
    leaves = [tree_leaves(t) for t in (grads, opt_state["m"], opt_state["v"], params)]
    new_p, new_m, new_v, gnorm = _update_leaves(
        *leaves, b1c, b2c, lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
        weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip)
    unf = lambda xs: tree_unflatten(params, xs)
    return unf(new_p), {"m": unf(new_m), "v": unf(new_v), "step": step}, {"grad_norm": gnorm}


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
