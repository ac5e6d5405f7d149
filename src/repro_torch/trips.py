"""Loops over time, counted by their trip count under a cost trace.

A loop whose iterations do the same work (a recurrence over time steps, or
over equal chunks of them) runs through ``scan``.  Outside a trace it is
the plain Python loop: every step runs, in order, and the values are those
of the loop written out.

Under ``launch.op_analysis.trace_step``, which alone turns the switch on
(``counting``), a loop of n > 3 steps runs three: the first, the second
and the last.  The second stands for steps 1 to n - 2: the trace counts
its ops n - 2 times, its backward ops too (the autograd sequence numbers
of the nodes it made), and the bytes it leaves live n - 2 times (its
carry-out's copies as long as its carry-in lives, which it holds as the
later steps hold theirs).  The first and the last run on their own
because they differ from the rest: the first's carry-in may need no grad,
the last's carry-out may feed nothing.  Steps 2 to n - 2 run nothing: one
uncounted tensor of their outputs' shape and layout, holding no values,
joins the other three, so the stack over the steps reads and writes all n;
the per-step inputs are split, not unbound, and in backward the skipped
block hands its slice an uncounted grad, so the split's backward joins all
n grads as the unbind's would.  Nested marked loops multiply their trip
counts.  Under a trace the loop's outputs are not values to use: they are
shapes to count.

This is the counterpart of the reference's ``while`` with its
``known_trip_count``, whose body XLA's cost analysis counts once and
multiplies.  The module imports torch only; the models and the kernels'
plain versions import it.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Sequence, Tuple

import torch

# the counting mode of the trace in progress (``op_analysis._Counter``), or
# None: every loop runs every step
_hook = None

# the time axis: every marked loop runs over dim 1 of (batch, time, ...)
_T = 1


@contextlib.contextmanager
def counting(hook):
    """Loops count by trip count for the duration: ``hook`` gives
    ``trip(k, carry)`` (a context around the step that stands for k, given
    its carry-in, yielding its mark), ``carried(mark, carry)`` (its
    carry-out), ``quiet(track)`` (a context whose ops are not counted;
    ``track``: their outputs still count as live memory) and
    ``retain(mark)`` (what the marked step left live counts k times)."""
    global _hook
    prev, _hook = _hook, hook
    try:
        yield
    finally:
        _hook = prev


def _meta(x: torch.Tensor):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        loc = x._local_tensor
        return (loc.shape, loc.dtype, loc.device, (x.device_mesh, x.placements,
                                                   x.shape, x.stride()))
    return x.shape, x.dtype, x.device, None


def _empty(meta) -> torch.Tensor:
    shape, dtype, device, dist = meta
    t = torch.empty(shape, dtype=dtype, device=device)
    if dist is None:
        return t
    from torch.distributed.tensor import DTensor

    mesh, placements, gshape, gstride = dist
    return DTensor.from_local(t, mesh, placements, run_check=False, shape=gshape,
                              stride=gstride)


def _block_meta(step, meta, k: int):
    """The meta of the skipped block's grad for one per-step input: the
    counted step's grad for that input (``step``, a ``_meta``; None: the
    input's own ``meta``) with the block's ``k`` steps along the time axis,
    laid out as that grad is (a Shard past it moves one dim on), so the
    split's backward joins grads of one layout."""
    if step is None or step[3] is None:
        return meta
    from torch.distributed.tensor import Shard

    shape, dtype, device, (mesh, placements, _, _) = step
    gshape = meta[3][2]
    stride, acc = [], 1
    for n in reversed(gshape):
        stride.insert(0, acc)
        acc *= n
    placements = tuple(Shard(p.dim + (p.dim >= _T)) if isinstance(p, Shard) else p
                       for p in placements)
    return ((*shape[:_T], k, *shape[_T:]), dtype, device,
            (mesh, placements, gshape, tuple(stride)))


class _Skipped(torch.autograd.Function):
    """The joined outputs of the ``k`` steps a trace skips, uncounted: one
    tensor of ``k`` copies of ``like`` along the time axis (``join``: stacked or
    concatenated); in backward, an uncounted grad for each input (the
    skipped steps' slices of the per-step inputs), laid out as the counted
    step's grads (``grads``: {input index: ``_meta`` of that grad}, filled
    by hooks while the counted step's backward runs, which is first)."""

    @staticmethod
    def forward(ctx, like, k, join, grads, *inputs):
        ctx.metas = [_meta(x) for x in inputs]
        ctx.k, ctx.grads = k, grads
        with _hook.quiet(track=False):
            if join == "stack":
                like = like.unsqueeze(_T)
            return like.repeat(*(k if i == _T else 1 for i in range(like.ndim)))

    @staticmethod
    def backward(ctx, grad):
        hook = _hook
        with (hook.quiet(track=True) if hook is not None else contextlib.nullcontext()):
            return (None,) * 4 + tuple(
                _empty(_block_meta(ctx.grads.get(j), m, ctx.k))
                for j, m in enumerate(ctx.metas))


def _note(grads, j, g):
    grads[j] = _meta(g)


def scan(n: int, body: Callable, carry, xs: Sequence[torch.Tensor] = (), *,
         join: str = "stack") -> Tuple[object, torch.Tensor]:
    """``for t in range(n): carry, y_t = body(t, carry, *(x_t for x in xs))``
    with each ``x`` unbound along the time axis, dim 1 (one ``unbind`` a
    tensor, as the loop written out does); returns ``(carry, y)``, the
    ``y_t`` stacked along dim 1 (``join="cat"``: concatenated), n >= 1."""
    hook = _hook
    if hook is None or n <= 3:
        steps = [x.unbind(_T) for x in xs]
        ys = []
        for t in range(n):
            carry, y = body(t, carry, *(s[t] for s in steps))
            ys.append(y)
        return carry, (torch.stack(ys, _T) if join == "stack" else torch.cat(ys, _T))
    # steps 0, 1, 2 to n - 2 and n - 1: one split a tensor, whose backward
    # joins the n steps' grads as the unbind's does
    parts = [torch.split(x, [1, 1, n - 3, 1], _T) for x in xs]

    def step(t, i, carry):
        return body(t, carry, *(p[i].squeeze(_T) for p in parts))

    carry, first = step(0, 0, carry)
    # made before the counted step, so that in backward it runs after it
    # (as steps n - 2 to 2 run after step n - 1), shaped as the first step
    grads = {}
    skipped = _Skipped.apply(first, n - 3, join, grads, *(p[2] for p in parts))
    ins = [p[1].squeeze(_T) for p in parts]
    for j, x in enumerate(ins):
        if x.requires_grad:
            x.register_hook(functools.partial(_note, grads, j))
    with hook.trip(n - 2, carry) as mark:
        carry, rep = body(1, carry, *ins)
    hook.carried(mark, carry)
    if (rep.shape, rep.dtype, getattr(rep, "placements", None)) != (
            first.shape, first.dtype, getattr(first, "placements", None)):
        raise ValueError("a marked loop's steps must give outputs of one shape and layout")
    try:
        carry, last = step(n - 1, 3, carry)
    finally:
        # also when a checkpoint's recompute stops inside the last step
        hook.retain(mark)
    ys = [first, rep, last]
    if join == "stack":
        ys = [y.unsqueeze(_T) for y in ys]
    return carry, torch.cat([ys[0], ys[1], skipped, ys[2]], _T)
