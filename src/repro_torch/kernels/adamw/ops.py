"""Wrapper for the fused AdamW kernels (``csrc/adamw.cu``).

``adamw_fused(grads, ms, vs, params, b1c, b2c, lr, ...)`` takes lists of
leaves on one CUDA device and returns (new params, new m, new v, grad norm),
as ``ref.adamw_ref``: pass 1 sums every grad's squares into the norm and the
clip factor on the card, one launch a table of leaves; pass 2 updates every
leaf, one launch a table.  A table holds up to ``adamw_limits``' leaves (48):
a tree of up to 48 leaves takes two launches a step.  Leaves are contiguous;
p and g bfloat16 or float32 each, m and v float32.  Anything else raises.
Every call returns new tensors and changes none of its arguments.
``adamw_fused.launches`` counts its launches.  Which trees take this path
(plain CUDA tensors, and a CUDA DTensor tree's local shards) is chosen in
``optim/adamw.py``.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from .. import _build
from .ref import clip_factor

F32, BF16 = torch.float32, torch.bfloat16
_F = ctypes.c_float
_SIGNATURES = {
    "adamw_limits": [_build.P, _build.P],
    "adamw_norm": [_build.P] * 3 + [_build.I, _build.P, _build.I, _build.I, _build.P, _F]
                  + [_build.P] * 3,
    "adamw_update": [_build.P] * 3 + [_build.I] + [_F] * 6 + [_build.P] * 4
                    + [_F, _build.P],
}


def _lib() -> Tuple[ctypes.CDLL, int, int]:
    """(library, leaves a table, elements a chunk)."""
    lib = _build.library("adamw", _SIGNATURES)
    leaves, chunk = ctypes.c_int(), ctypes.c_longlong()
    _build.check(lib.adamw_limits(ctypes.byref(leaves), ctypes.byref(chunk)), "adamw_limits")
    return lib, leaves.value, chunk.value


def _check(kind: str, leaves: Sequence[torch.Tensor], dtypes, device) -> None:
    for x in leaves:
        if x.device != device:
            raise ValueError(f"adamw: every leaf on one CUDA device; a {kind} leaf is "
                             f"on {x.device}, the first on {device}")
        if x.dtype not in dtypes:
            raise TypeError(f"adamw: a {kind} leaf is {x.dtype}; the kernel takes "
                            f"{' or '.join(str(d) for d in dtypes)}")
        if not x.is_contiguous():
            raise ValueError(f"adamw: a {kind} leaf of shape {tuple(x.shape)} is not "
                             "contiguous")


def _device(leaves: Sequence[torch.Tensor]) -> torch.device:
    dev = leaves[0].device
    if dev.type != "cuda":
        raise ValueError(f"the adamw kernels take CUDA tensors; the leaves are on {dev}")
    return dev


def _scalar(name: str, x, device) -> torch.Tensor:
    if not (isinstance(x, torch.Tensor) and x.dtype == F32 and x.ndim == 0
            and x.device == device):
        raise ValueError(f"adamw: {name} must be a float32 0-d tensor on {device}")
    return x


def _tables(n: int, size: int) -> List[range]:
    return [range(i, min(i + size, n)) for i in range(0, n, size)]


def _ptrs(ctype, values):
    return (ctype * len(values))(*values)


def _validate(grads, ms, vs, params) -> torch.device:
    """The leaves' CUDA device, or raise: one device, one shape a leaf, the
    kernel's dtypes, contiguous, plain tensors that need no grad."""
    if not (len(grads) == len(ms) == len(vs) == len(params)):
        raise ValueError(f"adamw: {len(grads)} grads, {len(ms)} m, {len(vs)} v and "
                         f"{len(params)} params")
    for g, m, v, p in zip(grads, ms, vs, params):
        if not (g.shape == m.shape == v.shape == p.shape):
            raise ValueError(f"adamw: a leaf's grad {tuple(g.shape)}, m {tuple(m.shape)}, "
                             f"v {tuple(v.shape)} and param {tuple(p.shape)} differ")
    dev = _device(params)
    _check("param", params, (BF16, F32), dev)
    _check("grad", grads, (BF16, F32), dev)
    _check("moment", ms + vs, (F32,), dev)
    _build.refuse_grad("adamw", *grads, *ms, *vs, *params)
    _build.refuse_dtensor("adamw", *grads, *ms, *vs, *params)
    return dev


def _launch_norm(lib, size, chunk, grads, grad_clip, dev):
    """Pass 1 over validated leaves: (gnorm, clip) on ``dev``."""
    tables = _tables(len(grads), size)
    # one partial a chunk (one for a table of no elements), then the counter
    blocks = [max(1, sum(-(-grads[i].numel() // chunk) for i in t)) for t in tables]
    scratch = torch.empty(sum(blocks) + 1, dtype=torch.float64, device=dev)
    gnorm = torch.empty((), dtype=F32, device=dev)
    clip = torch.empty((), dtype=F32, device=dev)
    offset = 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    for k, (t, nb) in enumerate(zip(tables, blocks)):
        err = lib.adamw_norm(
            _ptrs(ctypes.c_void_p, [grads[i].data_ptr() for i in t]),
            _ptrs(ctypes.c_longlong, [grads[i].numel() for i in t]),
            _ptrs(ctypes.c_int, [int(grads[i].dtype == BF16) for i in t]),
            len(t), scratch.data_ptr(), offset, int(k == len(tables) - 1),
            scratch[-1:].data_ptr(), float(grad_clip), gnorm.data_ptr(), clip.data_ptr(),
            stream)
        _build.check(err, "adamw_norm")
        adamw_fused.launches += 1
        offset += nb
    return gnorm, clip


def _launch_update(lib, size, grads, ms, vs, params, clip, b1c, b2c, lr, hyper, dev):
    """Pass 2 over validated leaves: new (params, m, v) lists."""
    clip, b1c, b2c = (_scalar(k, x, dev) for k, x in (("clip", clip), ("b1c", b1c),
                                                      ("b2c", b2c)))
    if isinstance(lr, torch.Tensor):
        lr_t, lr_value = _scalar("lr", lr, dev).data_ptr(), 0.0
    else:
        lr_t, lr_value = None, float(lr)
    b1, b2 = hyper["b1"], hyper["b2"]
    new_p = [torch.empty_like(p) for p in params]
    new_m = [torch.empty_like(m) for m in ms]
    new_v = [torch.empty_like(v) for v in vs]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for t in _tables(len(params), size):
        if all(params[i].numel() == 0 for i in t):
            continue
        ptrs = [x.data_ptr() for i in t for x in (grads[i], params[i], ms[i], vs[i],
                                                  new_p[i], new_m[i], new_v[i])]
        codes = [int(params[i].dtype == BF16) + 2 * int(grads[i].dtype == BF16) for i in t]
        err = lib.adamw_update(
            _ptrs(ctypes.c_void_p, ptrs), _ptrs(ctypes.c_longlong, [params[i].numel() for i in t]),
            _ptrs(ctypes.c_int, codes), len(t), b1, 1 - b1, b2, 1 - b2, hyper["eps"],
            hyper["weight_decay"], clip.data_ptr(), b1c.data_ptr(), b2c.data_ptr(), lr_t,
            lr_value, stream)
        _build.check(err, "adamw_update")
        adamw_fused.launches += 1
    return new_p, new_m, new_v


def adamw_fused(grads, ms, vs, params, b1c, b2c, lr, *, b1: float, b2: float, eps: float,
                weight_decay: float, grad_clip: float, gnorm=None):
    """(new params, new m, new v, grad norm) of lists of CUDA leaves, as
    ``ref.adamw_ref``: pass 1 (the norm and the clip factor) and pass 2 (the
    update).  ``gnorm``: the grad norm already taken, an f32 0-d tensor on
    the leaves' device (the leaves are then one rank's shards of a larger
    tree, whose norm the shards alone do not give): pass 1 is left out and
    the clip factor is ``ref.clip_factor``'s of it."""
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    grads, ms, vs, params = (list(x) for x in (grads, ms, vs, params))
    dev = _validate(grads, ms, vs, params)
    lib, size, chunk = _lib()
    with torch.cuda.device(dev):
        if gnorm is None:
            gnorm, clip = _launch_norm(lib, size, chunk, grads, grad_clip, dev)
        else:
            clip = clip_factor(_scalar("gnorm", gnorm, dev), grad_clip)
        return (*_launch_update(lib, size, grads, ms, vs, params, clip, b1c, b2c, lr, hyper,
                                dev), gnorm)


adamw_fused.launches = 0

__all__ = ["adamw_fused"]
