"""Plain PyTorch AdamW step (the oracle of ``csrc/adamw.cu``).

The arithmetic of the port's ``optim/adamw.py``, itself a port of the
reference's ``optim/adamw.py``: the global norm as the sum of every leaf's
f32 sum of squares, leaves summed in order; the clip factor; and each leaf's
update in f32, in the reference's order of operations, cast back to the
param's dtype.  Lists of leaves in, new tensors out; no argument changes.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def global_norm_ref(leaves) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaves summed in
    the reference's order."""
    total = 0
    for leaf in leaves:
        total = total + torch.sum(torch.square(leaf.to(F32)))
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


def clip_factor(gnorm, grad_clip: float) -> torch.Tensor:
    """min(grad_clip / max(gnorm, 1e-9), 1), f32 0-d."""
    return torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)


def adamw_apply_ref(grads, ms, vs, params, clip, b1c, b2c, lr, *, b1, b2, eps,
                    weight_decay):
    """(new params, new m, new v) of lists of leaves, given the clip factor."""
    def upd(g, m, v, p):
        g = g.to(F32) * clip
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(F32)
        return (p.to(F32) - lr * delta).to(p.dtype), m, v

    out = [upd(g, m, v, p) for g, m, v, p in zip(grads, ms, vs, params)]
    return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]


def adamw_ref(grads, ms, vs, params, b1c, b2c, lr, *, b1, b2, eps, weight_decay,
              grad_clip):
    """(new params, new m, new v, grad norm) of lists of leaves."""
    gnorm = global_norm_ref(grads)
    clip = clip_factor(gnorm, grad_clip)
    return (*adamw_apply_ref(grads, ms, vs, params, clip, b1c, b2c, lr, b1=b1, b2=b2,
                             eps=eps, weight_decay=weight_decay), gnorm)
